#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card of this machine.

    python3 portbench/run.py --workload plate.fused-plastic --seed 7 --seconds 10 --trace 0

Prints the cell's metrics as one JSON line, the last of standard output
(``--trace 0``: its end-to-end metrics; ``--trace 1``: its per-layer
metrics, read from an instrumented and a profiled window), and, as the last
lines of standard error, each number compared against the plain reference
beside its limit. Exits non-zero, printing no result, when no CUDA card is
visible or fewer than the cell asks for, or when a module of JAX or of the
JAX package is loaded once the window has closed.

Kernel and compiler caches stay in ``build/`` inside this checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda_cache"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import core

    cell = core.Cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), {n} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, lines = core.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"portbench: modules of JAX or the JAX package were loaded: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
