"""Cells, configurations and metrics are found by name: a new one is new
files (and its entry in BENCHMARK.json), no file edited."""

import json
import shutil
import time

import pytest
from conftest import ROOT, SMALL

from portbench import core

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_files(cell):
    c = core.Cell(cell)
    assert c.driver().Driver and c.builder().build and c.reference()
    for kind in ("end_to_end", "per_layer"):
        for m in c.metrics(kind):
            assert callable(c.reader(m["name"]).read)
    names = {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in names and len(names) >= 2 and c.metrics("per_layer")


def test_every_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", cells)


def copy_of_benchmark(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_a_new_configuration_cell_and_metric_are_new_files_only(tmp_path):
    bench = copy_of_benchmark(tmp_path)
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    # a configuration: its sizes, builder and reference under a name of its own
    pb = tmp_path / "portbench"
    cfg = dict(json.loads((pb / "configs/points_j2_2m.json").read_text()), n_points=SMALL["points_j2_2m"]["n_points"])
    (pb / "configs/points_j2_small.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "configs/points_j2_2m.py", pb / "configs/points_j2_small.py")
    shutil.copy(pb / "reference/points_j2_2m.py", pb / "reference/points_j2_small.py")
    bench["configs"].append(dict(bench["configs"][1], name="points_j2_small", file="portbench/configs/points_j2_small.json"))
    # a cell: another law on it
    spec = json.loads((pb / "workloads/points.user-law.json").read_text())
    spec.update(config="points_j2_small", traffic="voce-linear",
                params=dict(spec["params"], law="300.0 + 200.0 * (1.0 - exp(-500.0 * p)) + 1e3 * p"))
    (pb / "workloads/points.voce-linear.json").write_text(json.dumps(spec))
    bench["workloads"].append({"name": "points.voce-linear", "config": "points_j2_small", "traffic": "voce-linear",
                               "chips": 1, "why": "Voce and linear hardening as text"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "points.user-law" in m.get("workloads", []):
            m["workloads"].append("points.voce-linear")
    # a per-layer metric: a reader of its own
    (tmp_path / "portbench/metrics/increments.points.py").write_text(
        "def read(rec):\n    return rec.timed.counts['attempted'] or None\n")
    bench["per_layer"].append({"name": "increments.points", "unit": "increments", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "gp_updates_per_s",
                               "workloads": ["points.voce-linear"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = core.Cell("points.voce-linear", tmp_path)
    result, lines = core.run(cell, 2**33 + 5, 0.3, False, time.perf_counter(), device="cpu")
    assert result["correct"] and set(result["metrics"]) == {"setup_s", "gp_updates_per_s", "update_p95_ms"}
    assert [m["name"] for m in cell.metrics("per_layer")][-1] == "increments.points"
    rec = core.Record()
    rec.timed = core.Window()
    rec.timed.counts["attempted"] = 7
    assert cell.reader("increments.points").read(rec) == 7
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_a_cell_file_must_agree_with_its_entry(tmp_path):
    bench = copy_of_benchmark(tmp_path)
    bench["workloads"][0]["traffic"] = "something-else"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):
        core.Cell(bench["workloads"][0]["name"], tmp_path)
