#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference, computed one
precision below the configuration's (float32 for float64), put in the
program's place and judged by the cell's own comparison at the cell's own
size. Each seed's numbers are printed beside the cell's limits; the control
has to come out not correct.

    python3 portbench/control.py --workload plate.fused-plastic --seeds 11 12 13

The plate's control solves the seed's first load program; the points'
solves the increments that a window of the seed would keep first.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed, device, sizes=None):
    """The control's compared numbers for ``seed``: ``{name: {value,
    limit}}``."""
    import numpy as np
    import torch

    cfg = dict(cell.config, **(sizes or {}))
    params, limits = cell.spec["params"], cell.spec["limits"]
    ref = cell.reference()
    drv = cell.driver()
    if cell.spec["kind"] == "load_steps":
        incs = next(drv.programs(params, seed))
        outputs = ref.solve(cfg, incs, device, dtype=torch.float32)
        return drv.compare(cfg, incs, outputs, limits, ref, device)
    n_inc = int(params["increments"])
    path = drv.strain_path(int(cfg["n_points"]), float(params["strain_std"]), n_inc, seed,
                           getattr(torch, cfg["dtype"]), device)
    ks = sorted(np.random.default_rng([seed, 1]).choice(n_inc, size=int(params["kept"]), replace=False).tolist())
    low = ref.run(cfg, params["law"], path, set(ks), dtype=torch.float32)
    return drv.compare(cfg, params["law"], path, [(k, low[k]) for k in ks], limits, ref)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import core

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload, ROOT)
    for seed in args.seeds:
        got = readings(cell, seed, "cuda")
        fails = [k for k, c in got.items() if not c["value"] <= c["limit"]]
        print(json.dumps({"workload": cell.name, "seed": seed, "control": got, "not_correct": bool(fails)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
