"""Find a cell's files by name, run it once, and print its result line.

A run: set-up (the program built and warmed on the cell's own shapes), the
measured window, with ``--trace 1`` an instrumented window and a profiled
one, then the peak memory read, the program's state freed, the kept outputs
judged against the plain reference, and the metrics read by their readers.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "dolfinx_materials_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


# ----------------------------------------------------------------- discovery
def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file of this folder, whatever its name holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files: the
    cell's ``workloads/<name>.json`` (traffic kind, parameters, limits) and
    its configuration's ``configs/<config>.json``."""

    def __init__(self, name, root=ROOT):
        self.root = Path(root)
        self.here = self.root / "portbench"
        self.bench = load_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
        self.entry = entries[name]
        self.name = name
        self.spec = load_json(self.here / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if self.spec[key] != self.entry[key]:
                raise ValueError(f"{name}: {key} is {self.spec[key]!r} in its file, {self.entry[key]!r} in BENCHMARK.json")
        self.config_name = self.entry["config"]
        self.config = load_json(self.here / "configs" / f"{self.config_name}.json")
        self.chips = int(self.entry["chips"])

    def metrics(self, kind):
        """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"):
        those with no ``workloads`` key and those that list the cell."""
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]

    def reader(self, metric_name):
        return load_module(self.here / "metrics" / f"{metric_name}.py", f"portbench_metric_{metric_name}")

    def builder(self):
        return load_module(self.here / "configs" / f"{self.config_name}.py", f"portbench_config_{self.config_name}")

    def reference(self):
        return load_module(self.here / "reference" / f"{self.config_name}.py", f"portbench_reference_{self.config_name}")

    def driver(self):
        kind = self.spec["kind"]
        return load_module(self.here / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


# ------------------------------------------------------------------ records
class Window:
    """What one window of traffic leaves: its wall seconds, host-clock spans
    (name -> durations in seconds) and counts."""

    def __init__(self):
        self.seconds = 0.0
        self.spans = defaultdict(list)
        self.counts = defaultdict(int)
        self.trace = None  # a trace.Summary where the window was profiled


class Record:
    """A run's record, handed to every metric reader: ``setup_s``, the
    measured (or, under ``--trace 1``, instrumented) window ``timed``, the
    profiled window ``traced`` (``--trace 1`` only) and the problem's
    ``shapes`` for the byte counts."""

    def __init__(self):
        self.setup_s = None
        self.timed = None
        self.traced = None
        self.shapes = {}


# -------------------------------------------------------------------- a run
def log(msg):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def device_info(torch, chips):
    """The card's name and its power limit (the data sheet's peaks assume
    700 W)."""
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip().splitlines()
    except FileNotFoundError:
        limit = []
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": limit[0] if limit else "not read"}


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device="cuda"):
    """Run ``cell`` once; returns ``(result dict, comparison lines)``.
    ``t_start`` is the process's start on the host clock."""
    log(f"imports and CUDA {time.perf_counter() - t_start:.3f} s")
    drv = cell.driver().Driver(cell, seed, device, cell.config)
    return execute(cell, drv, seconds, trace, t_start, device)


def execute(cell, drv, seconds, trace, t_start, device="cuda"):
    """The rest of a run once the driver ``drv`` is set up: the window(s),
    the peak memory, the program's state freed, the comparison and the
    metrics."""
    import torch

    rec = Record()
    rec.shapes = drv.shapes
    rec.setup_s = time.perf_counter() - t_start
    log(f"set-up {rec.setup_s:.3f} s")
    t = time.perf_counter()
    if trace:
        rec.timed = drv.window(seconds, instrument=True)
        rec.traced = drv.window(seconds, instrument=True, profile=True)
    else:
        rec.timed = drv.window(seconds)
    log(f"window(s) and trace reading {time.perf_counter() - t:.3f} s")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kept = drv.release()
    t = time.perf_counter()
    compared = drv.compare(kept)
    log(f"reference and comparison {time.perf_counter() - t:.3f} s")

    windows = [w for w in (rec.timed, rec.traced) if w is not None]
    attempted = sum(w.counts["attempted"] for w in windows)
    failed = sum(w.counts["failed"] for w in windows)
    correct = attempted > 0 and all(c["value"] <= c["limit"] for c in compared.values())
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = cell.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(torch, cell.chips) if device == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = peak
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec.traced.trace is not None:
        t = rec.traced.trace
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.top(t.ops), "idle_gaps": t.top(t.gaps)}
    result["compared"] = compared
    lines = [f"compared {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}"
             for k, c in compared.items()]
    return result, lines
