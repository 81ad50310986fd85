"""``correct`` has to come out false for the control (the reference one
precision below, float32, in the program's place) and for each fault a cell
can have, planted underneath the timed path of a run that skips only the
look for a card; and true for the sound program. Small sizes, the CPU."""

import json
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT, SMALL

from portbench import control, core

CELLS = ["plate.fused-plastic", "points.voce", "points.user-law"]
SEED = 2**32 + 17


def driver(name):
    cell = core.Cell(name)
    cfg = dict(cell.config, **SMALL[cell.config_name])
    return cell, cell.driver().Driver(cell, SEED, "cpu", cfg)


def correct(cell, drv, seconds=0.5):
    result, _ = core.execute(cell, drv, seconds, False, time.perf_counter(), device="cpu")
    return result["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name):
    assert correct(*driver(name))


def test_a_plate_window_holds_whole_cycles():
    """Each seed orders a cycle's programs its own way: a window that is not
    profiled runs on to the end of its cycle, so that every seed's window
    holds the same programs."""
    cell, drv = driver("plate.fused-plastic")
    steps = len(cell.spec["params"]["factors"])
    for seconds in (0.01, 0.2):
        w = drv.window(seconds)
        assert w.counts["attempted"] % (drv.cycle * steps) == 0 and w.counts["attempted"] > 0
        assert drv.program is None


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = core.Cell(name)
    got = control.readings(cell, SEED, "cpu", SMALL[cell.config_name])
    assert any(not c["value"] <= c["limit"] for c in got.values()), got


def material_of(drv):
    return drv.plate.qmap.material if hasattr(drv, "plate") else drv.material


def state_unchanged(drv):
    """A step that hands its state back unchanged: the load step returns
    its start, the update its entering state."""
    if hasattr(drv, "plate"):
        def step(u, states, mask, vals, dt):
            one = torch.ones((), dtype=torch.float64)
            return torch.where(torch.as_tensor(mask), torch.as_tensor(vals), u), states, one, one, (0, 0)
        step.cg = drv.plate.step.cg
        drv.plate.step = step
    else:
        m = material_of(drv)
        fast = m._fast_update
        m._fast_update = lambda x, state, dt: (*fast(x, state, dt)[:2], dict(state))


def half_left_out(drv):
    """Half of the points' updates left out: stress, tangent and new state
    of the second half zero."""
    m = material_of(drv)
    fast = m._fast_update

    def update(x, state, dt):
        sig, Ct, st = fast(x, state, dt)
        h = x.shape[0] // 2
        keep = (torch.arange(x.shape[0]) < h).to(x.dtype)
        return sig * keep[:, None], Ct * keep[:, None], {k: v * keep.reshape(-1, *[1] * (v.dim() - 1)) for k, v in st.items()}

    m._fast_update = update


def answer_altered(drv):
    """One answer altered where it is produced: one point's stress (points)
    or one displacement (plate) off by 1e-6 of its scale."""
    if hasattr(drv, "plate"):
        step = drv.plate.step

        def altered(*a):
            u, *rest = step(*a)
            u = u.clone()
            u[u.shape[0] // 2] += 1e-6 * float(u.abs().max())
            return (u, *rest)
        altered.cg = step.cg
        drv.plate.step = altered
    else:
        m = material_of(drv)
        fast = m._fast_update

        def update(x, state, dt):
            sig, Ct, st = fast(x, state, dt)
            sig = sig.clone()
            sig[x.shape[0] // 2] *= 1 + 1e-6
            return sig, Ct, st
        m._fast_update = update


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_underneath_is_not_correct(name, fault):
    cell, drv = driver(name)
    fault(drv)
    assert not correct(cell, drv)


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "points.voce", "--seed", str(SEED),
                          "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
