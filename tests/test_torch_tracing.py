"""The port's one tracer, ``utils/timers.py``: spans, counters and the cost
of tracing off, on the CPU (no JAX).

A fused load step of a 5x5 P1 J2/Voce plate (``test_torch_fused_step.py``'s
``plate5``) and a ``Material.integrate`` call: with tracing off they enter
no ``record_function`` and record no CUDA event; with tracing on, under
``torch.profiler``, their spans nest as the timer taxonomy states; the
counters add up what the step already reads; tracing changes no bit of
what they return.
"""

import numpy as np
import pytest
import torch

import dolfinx_materials_tpu_torch as tdm
from dolfinx_materials_tpu_torch import fem, models, parallel
from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d
from dolfinx_materials_tpu_torch.utils import timers

torch.set_num_threads(1)

E, NU, SIG0 = 70e3, 0.3, 350.0
STEP_SPANS = ("fused: step", "fused: line search", "cg: solve", "cg: replay")
MATERIAL_SPANS = ("material: integrate", "material: store")


@pytest.fixture(autouse=True)
def fresh_registry():
    timers.reset_timings()
    yield
    timers.set_tracing(None)
    timers.reset_timings()


def j2():
    return tdm.Material(models.vonMisesIsotropicHardening(models.LinearElasticIsotropic(E, NU),
                                                          models.VoceHardening(SIG0, 500.0, 1e3)), device="cpu")


def plate(**opts):
    """``run() -> (u, states, res, res0, (newton, cg))`` of one fused load
    step of the 5x5 plate pulled to 3 sig0/E, from the virgin state."""
    V = fem.FunctionSpace(fem.create_unit_square(5, 5, "quad"), 1, (2,))
    bcs = [fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0), 0), 0.0),
           fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0), 1), 0.0),
           fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1), 0), 3 * SIG0 / E)]
    m = j2()
    q = tdm.QuadratureMap(V, 2, m)
    q.register_gradient("Strain", mandel_strain_2d())
    prob = tdm.NonlinearMaterialProblem([q], fem.Function(V), bcs=bcs)
    step, pad = parallel.make_sharded_newton_step_general(prob, parallel.device_mesh(1, devices=["cpu"]),
                                                          return_info="stats", **opts)
    mask, vals = combine_bcs(bcs, V.num_dofs)
    virgin = pad([m.data_manager.s0.internal])

    def run():
        return step(np.zeros(V.num_dofs), virgin, mask, vals, 0.0)

    return run


def strains(n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return 4 * SIG0 / E * torch.randn(n, 6, generator=g, dtype=torch.float64)


def integrate_twice(m, eps):
    """Two increments along ``eps``, the first committed."""
    out1 = m.integrate(0.5 * eps)
    m.data_manager.update()
    return out1 + m.integrate(eps)


def forbid_tracing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("tracing off entered a span or recorded an event")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


@pytest.mark.parametrize("switch", [False, None], ids=["off", "default-without-profiler"])
def test_tracing_off_enters_no_span(monkeypatch, switch):
    run = plate()
    m = j2()
    timers.set_tracing(switch)
    forbid_tracing(monkeypatch)
    newton = run()[4][0]
    integrate_twice(m, strains())
    assert timers.timing("fused: step")[0] == 1
    assert timers.timing("cg: solve")[0] == timers.timing("fused: line search")[0] == newton > 0
    assert timers.timing("material: integrate")[0] == timers.timing("material: store")[0] == 2
    assert all(timers.device_timing(n)[0] == 0 for n in STEP_SPANS + MATERIAL_SPANS)


def spans(prof, names):
    """``name -> [(start, end)]`` of the host events named ``names``, none
    of them a user annotation (which would take the device range of what
    it launches from a ``record_function`` around it)."""
    out = {n: [] for n in names}
    for e in prof.events():
        if e.name in out:
            assert not e.is_user_annotation
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def inside(inner, outer):
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


@pytest.mark.parametrize("switch", [True, None], ids=["on", "default-under-profiler"])
def test_spans_nest_under_the_profiler(switch):
    from torch.profiler import ProfilerActivity, profile

    run = plate()
    m = j2()
    timers.set_tracing(switch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        newton = run()[4][0]
        with torch.profiler.record_function("caller"):
            integrate_twice(m, strains())
    s = spans(prof, STEP_SPANS + MATERIAL_SPANS + (f"{m.name}: constitutive update",))
    assert len(s["fused: step"]) == 1 and newton > 0
    assert len(s["cg: solve"]) == len(s["fused: line search"]) == newton
    assert not s["cg: replay"]  # the CPU runs its CG blocks eagerly: no graph
    assert inside(s["cg: solve"], s["fused: step"]) and inside(s["fused: line search"], s["fused: step"])
    assert not inside(s["cg: solve"][:1], s["fused: line search"])
    assert len(s["material: integrate"]) == len(s["material: store"]) == 2
    assert inside(s["material: store"], s["material: integrate"])
    caller = [e for e in prof.events() if e.name == "caller"]
    assert len(caller) == 1 and caller[0].is_user_annotation
    assert inside(s[f"{m.name}: constitutive update"], s["material: integrate"])
    assert timers.device_timing("cg: solve")[0] == newton


def test_cg_counters_add_up_the_steps_own_counts():
    _, _, _, _, (newton, cg) = plate()()
    c = timers.counters()
    assert c["cg: iterations"] == cg > 0 and c.get("cg: budget iterations", 0) < cg
    timers.reset_timings()
    _, _, _, _, (newton, cg) = plate(n_cg=3)()
    c = timers.counters()
    assert c["cg: iterations"] == c["cg: budget iterations"] == cg == 3 * newton


def test_host_reads_count_every_read_of_a_tensor_the_step_makes(monkeypatch):
    """Each ``float``, ``bool``, ``int`` or ``item`` of a tensor inside the
    step is one ``host reads``, and nothing else is."""
    run = plate()
    seen = []
    for name in ("__float__", "__bool__", "__int__", "item"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, **k):
            seen.append(1)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    _, _, _, _, (newton, cg) = run()
    monkeypatch.undo()
    reads = timers.counters()["host reads"]
    # a correction reads its CG's flag a block and its count, a line-search
    # trial or more, and the new residual; the step its entering residual
    assert reads == len(seen) >= 1 + newton * 4


def test_tracing_changes_no_bit():
    out = {}
    for on in (False, True):
        timers.reset_timings()
        timers.set_tracing(on)
        u, states, res, res0, counts = plate()()
        m = j2()
        mat = integrate_twice(m, strains(seed=3))
        out[on] = (u, states, res, res0, counts, mat, timers.counters())
    (u0, st0, r0, q0, c0, m0, k0), (u1, st1, r1, q1, c1, m1, k1) = out[False], out[True]
    assert torch.equal(u0, u1) and torch.equal(r0, r1) and torch.equal(q0, q1) and c0 == c1 and k0 == k1
    for a, b in zip(st0, st1):
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))


def test_list_timings_prints_counters_and_marks_enqueue_totals(capsys):
    with timers.timer("a card scope", device="cuda"):
        pass
    with timers.timer("a host scope"):
        pass
    timers.count("host reads", 3)
    timers.count("host reads")
    timers.list_timings()
    lines = {line.split("  ")[0].strip(): line for line in capsys.readouterr().out.splitlines()}
    assert lines["a card scope"].endswith("(enqueue)") and "count=1" in lines["a card scope"]
    assert "enqueue" not in lines["a host scope"]
    assert lines["host reads"].endswith("counter=4")
    assert timers.counters() == {"host reads": 4}
    timers.reset_timings()
    assert timers.counters() == {} and timers.timing("a card scope") == (0, 0.0)


def test_traced_scopes_keep_their_host_seconds_apart():
    timers.set_tracing(True)
    with timers.timer("x"):
        pass
    timers.set_tracing(False)
    with timers.timer("x"):
        pass
    count, total = timers.timing("x")
    traced, host, device = timers.device_timing("x")
    assert (count, traced, device) == (2, 1, 0.0) and 0 < host <= total


def test_under_a_profiler_a_card_scope_records_no_event(monkeypatch):
    """The profiler records the device's work itself: no event pair."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(torch.cuda, "Event", None)
    timers.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.timer("a card scope", device="cuda"):
            pass
    assert [e.name for e in prof.events()] == ["a card scope"]
    assert timers.device_timing("a card scope") == (1, pytest.approx(timers.timing("a card scope")[1]), 0.0)


def test_what_a_profiler_recorded_is_kept_apart():
    """Scopes and counts under a profiler, whatever the tracing switch, are
    the ``profiled`` part; the rest is the part with none recording."""
    from torch.profiler import ProfilerActivity, profile

    timers.set_tracing(False)
    with timers.timer("x"):
        timers.count("n", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        with timers.timer("x"):
            timers.count("n", 5)
        timers.count("m")
    (n_all, s_all), (n_in, s_in), (n_out, s_out) = (timers.timing("x", p) for p in (None, True, False))
    assert (n_all, n_in, n_out) == (2, 1, 1) and s_in + s_out == pytest.approx(s_all)
    assert timers.device_timing("x")[0] == 0  # tracing was off throughout
    assert timers.counters() == {"n": 7, "m": 1}
    assert timers.counters(profiled=True) == {"n": 5, "m": 1}
    assert timers.counters(profiled=False) == {"n": 2, "m": 0}


@pytest.mark.cuda
def test_event_pairs_go_back_to_the_pool():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    a = torch.randn(256, 256, device="cuda")
    pool = timers._EVENTS[a.device.index]
    del pool[:]
    timers.set_tracing(True)
    for _ in range(2):
        with timers.timer("mm", device=a.device):
            a @ a
    assert not pool and timers.device_timing("mm")[2] > 0 and len(pool) == 4
    with timers.timer("mm", device=a.device):
        a @ a
    assert len(pool) == 2 and timers.device_timing("mm")[0] == 3 and len(pool) == 4


@pytest.mark.cuda
def test_a_traced_card_scope_resolves_its_device_seconds():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    a = torch.randn(2048, 2048, device="cuda", dtype=torch.float64)
    timers.set_tracing(True)
    for _ in range(3):
        with timers.timer("matmul", device=a.device):
            a @ a
    timers.set_tracing(False)
    with timers.timer("matmul", device=a.device):
        a @ a
    traced, host, device = timers.device_timing("matmul")
    assert traced == 3 and device > 0 and timers.timing("matmul")[0] == 4
