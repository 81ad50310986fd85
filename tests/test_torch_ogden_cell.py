"""The benchmark's Ogden cell (``portbench`` ``ogden.tet-protocol``) on the
CPU, float64, no JAX: the port's whole-batch Ogden update against the plain
reference's spectral law, the reference's own checks (its mesh, quadrature,
law and patch test), the protocol at N = 4 through the cell's driver and
comparison, the float32 control, the ``hyperelastic:`` spans and counters
of ``utils/timers.py`` and the cell's seven metric readers."""

import itertools
import math
import time

import numpy as np
import pytest
import torch

import dolfinx_materials_tpu_torch as tdm
from dolfinx_materials_tpu_torch import fem, models, parallel
from dolfinx_materials_tpu_torch.demos import ogden_block
from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d
from dolfinx_materials_tpu_torch.ops.matfun_fm import NONSYM_IJ
from dolfinx_materials_tpu_torch.utils import timers
from portbench import core, trace
from portbench.drivers import ogden_protocol
from portbench.reference import ogden_block_p2tet_n10_mixed as ref

torch.set_num_threads(1)

CELL = "ogden.tet-protocol"
#: the cell's configuration at a size a test run holds: N = 4 is the smallest
#: block with banded plans; 3 of the protocol's 2 % steps
SMALL = dict(N=4, steps=3, strain=0.06)
SEED = 2**33 + 7
LAW = dict(mu=list(ogden_block.OGDEN_PARAMS["mu"]), alpha=list(ogden_block.OGDEN_PARAMS["alpha"]),
           K=ogden_block.OGDEN_PARAMS["K"])
NS = [3 * i + j for i, j in NONSYM_IJ]  # the port's nonsymmetric 9-vector order
SCOPES = ("hyperelastic: constitutive update", "hyperelastic: flux")


@pytest.fixture(autouse=True)
def fresh_registry():
    timers.reset_timings()
    yield
    timers.set_tracing(None)
    timers.reset_timings()


def rotations(rng, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    return q * np.sign(np.linalg.det(q))[:, None, None]


def deformations(case, n=64, seed=0):
    """Seeded deformation gradients ``(n, 3, 3)``: near I, exactly I, two
    repeated principal stretches in random frames, or entries of I + U(-0.25,
    0.25)."""
    rng = np.random.default_rng([seed, ["near_identity", "identity", "repeated", "stretched"].index(case)])
    if case == "near_identity":
        return np.eye(3) + 1e-6 * rng.standard_normal((n, 3, 3))
    if case == "identity":
        return np.tile(np.eye(3), (n, 1, 1))
    if case == "repeated":
        lam = np.stack([np.full(n, 1.1), np.full(n, 1.1), rng.uniform(0.8, 0.95, n)], axis=1)
        return rotations(rng, n) @ (lam[:, :, None] * np.eye(3)) @ rotations(rng, n).transpose(0, 2, 1)
    return np.eye(3) + rng.uniform(-0.25, 0.25, (n, 3, 3))


def scales(P, A):
    """PK1's scale (its largest entry, at least the shear modulus) and the
    tangent's (its largest entry)."""
    return max(float(P.abs().max()), LAW["mu"][0]), float(A.abs().max())


@pytest.mark.parametrize("case", ["near_identity", "identity", "repeated", "stretched"])
def test_port_update_and_flux_match_the_reference_law(case):
    F = torch.tensor(deformations(case), dtype=torch.float64)
    n = F.shape[0]
    P, A = ref.Ogden(LAW)(F)
    P9, A9 = P.reshape(n, 9)[:, NS], A[:, NS][:, :, NS]
    sP, sA = scales(P, A)
    port = models.Ogden(**ogden_block.OGDEN_PARAMS)
    Fv = F.reshape(n, 9)[:, NS]
    pk1, Ct, _ = port.batched_update(Fv, {}, 0.0)
    flux, _ = port.batched_flux(Fv, {}, 0.0)
    assert float((pk1 - P9).abs().max()) <= 1e-10 * sP
    assert float((flux - P9).abs().max()) <= 1e-10 * sP
    assert float((Ct.reshape(n, 9, 9) - A9).abs().max()) <= 1e-10 * sA


@pytest.mark.parametrize("lam3", [0.95, 0.8, 0.6])
def test_port_update_matches_the_reference_law_across_the_pair_switch(lam3):
    """Two stretches 10^-12 to 10^-1 apart (relative), in random frames:
    1 - |cos 3 theta| from ~1e-15 to ~1, either side of the coincident-pair
    series' switch. PK1 and the tangent of the update to 1e-10 of scale."""
    rng = np.random.default_rng([5, int(100 * lam3)])
    gaps = np.repeat(np.concatenate([[0.0], 10.0 ** np.arange(-12, 0)]), 4)
    lam = np.stack([np.full(gaps.size, 1.1), 1.1 * (1 + gaps), np.full(gaps.size, lam3)], axis=1)
    n = gaps.size
    F = torch.tensor(rotations(rng, n) @ (lam[:, :, None] * np.eye(3)) @ rotations(rng, n).transpose(0, 2, 1))
    P, A = ref.Ogden(LAW)(F)
    sP, sA = scales(P, A)
    pk1, Ct, _ = models.Ogden(**ogden_block.OGDEN_PARAMS).batched_update(F.reshape(n, 9)[:, NS], {}, 0.0)
    assert float((pk1 - P.reshape(n, 9)[:, NS]).abs().max()) <= 1e-10 * sP
    assert float((Ct.reshape(n, 9, 9) - A[:, NS][:, :, NS]).abs().max()) <= 1e-10 * sA


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["near_identity", "identity", "repeated", "stretched"])
def test_port_update_on_the_card_matches_the_cpu_and_the_reference_law(case):
    """The whole-batch update and flux in float64 on the card: PK1 and the
    tangent to 1e-12 of scale of the CPU's, and to the reference law as on
    the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    F = torch.tensor(deformations(case, n=4096, seed=3), dtype=torch.float64)
    n = F.shape[0]
    P, A = ref.Ogden(LAW)(F)
    sP, sA = scales(P, A)
    port = models.Ogden(**ogden_block.OGDEN_PARAMS, tangent_chunk=1024)
    Fv = F.reshape(n, 9)[:, NS]
    pk1, Ct, _ = port.batched_update(Fv.cuda(), {}, 0.0)
    flux, _ = port.batched_flux(Fv.cuda(), {}, 0.0)
    pk1_h, Ct_h, _ = port.batched_update(Fv, {}, 0.0)
    pk1, Ct, flux = pk1.cpu(), Ct.cpu(), flux.cpu()
    assert float((pk1 - pk1_h).abs().max()) <= 1e-12 * sP and float((flux - pk1_h).abs().max()) <= 1e-12 * sP
    assert float((Ct - Ct_h).abs().max()) <= 1e-12 * sA
    assert float((pk1 - P.reshape(n, 9)[:, NS]).abs().max()) <= 1e-10 * sP
    assert float((Ct.reshape(n, 9, 9) - A[:, NS][:, :, NS]).abs().max()) <= 1e-10 * sA


@pytest.mark.parametrize("case", ["near_identity", "repeated", "stretched"])
def test_reference_pk1_is_the_energys_derivative(case):
    F = torch.tensor(deformations(case, n=16, seed=1), dtype=torch.float64)
    law = ref.Ogden(LAW)
    P, A = law(F)
    h = 1e-6
    fd = torch.zeros_like(P)
    for k, l in itertools.product(range(3), range(3)):
        E = torch.zeros(3, 3, dtype=torch.float64)
        E[k, l] = h
        fd[:, k, l] = (law.energy(F + E) - law.energy(F - E)) / (2 * h)
    assert float((P - fd).abs().max()) <= 1e-8 * scales(P, A)[0]


@pytest.mark.parametrize("case", ["near_identity", "identity", "repeated", "stretched"])
def test_reference_tangent_is_symmetric_and_pk1s_derivative(case):
    F = torch.tensor(deformations(case, n=16, seed=2), dtype=torch.float64)
    law = ref.Ogden(LAW)
    P, A = law(F)
    sA = scales(P, A)[1]
    assert float((A - A.transpose(1, 2)).abs().max()) <= 1e-13 * sA
    h = 1e-6
    fd = torch.zeros_like(A)
    for b in range(9):
        E = torch.zeros(9, dtype=torch.float64)
        E[b] = h
        dP = law(F + E.reshape(3, 3), False)[0] - law(F - E.reshape(3, 3), False)[0]
        fd[:, :, b] = (dP / (2 * h)).reshape(-1, 9)
    assert float((A - fd).abs().max()) <= 1e-8 * sA


def test_reference_small_strain_limit_is_linear_elasticity():
    """At F = I the tangent is the isotropic elasticity tensor of shear
    modulus mu and bulk modulus K: lambda d_ij d_kl + mu (d_ik d_jl + d_il
    d_jk), lambda = K - 2 mu / 3."""
    mu, K = LAW["mu"][0], LAW["K"]
    P, A = ref.Ogden(LAW)(torch.eye(3, dtype=torch.float64)[None])
    d = np.eye(3)
    C = (K - 2 * mu / 3) * np.einsum("ij,kl->ijkl", d, d) + mu * (np.einsum("ik,jl->ijkl", d, d)
                                                                 + np.einsum("il,jk->ijkl", d, d))
    assert float(P.abs().max()) <= 1e-12 * mu
    np.testing.assert_allclose(A[0].numpy(), C.reshape(9, 9), rtol=0, atol=1e-12 * K)


def uniaxial_stress(lz, law):
    """The lateral stretch at which F = diag(l, l, lz) has P_xx = 0."""
    lo, hi = 1.0, 1.0 / lz
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        F = torch.diag(torch.tensor([mid, mid, lz], dtype=torch.float64))[None]
        if float(law(F, False)[0][0, 0, 0]) > 0:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def test_reference_patch_test():
    """An affine displacement of uniaxial stress leaves no residual on the
    free dofs: the interior, the traction-free sides and the top face's x
    and y."""
    cfg = dict(LAW, N=3)
    b = ref.Block(cfg, "cpu", torch.float64)
    lx = uniaxial_stress(0.9, b.law)
    M = b.M
    ijk = np.stack(np.meshgrid(np.arange(M), np.arange(M), np.arange(M), indexing="ij"), -1).reshape(-1, 3)
    node = (ijk[:, 2] * M + ijk[:, 1]) * M + ijk[:, 0]
    x = np.zeros((M**3, 3))
    x[node] = ijk / (M - 1)
    u = torch.tensor((x * (np.array([lx, lx, 0.9]) - 1.0)).reshape(-1), dtype=torch.float64)
    P, _ = b.law(b.F(u), False)
    R = b.residual(P)
    assert float(R[b.free].norm()) <= 1e-10 * float(R.norm()) and float(R.norm()) > 0


def test_reference_mesh_is_the_programs_kuhn_split():
    N = 3
    mesh = fem.create_unit_cube(N, N, N, "tetrahedron")
    prog = {frozenset(map(tuple, np.rint(mesh.points[c] * 2 * N).astype(int))) for c in mesh.cells}
    mine = {frozenset(map(tuple, t)) for t in ref.kuhn_tetrahedra(N)}
    assert len(prog) == len(mine) == 6 * N**3 and prog == mine


def test_reference_quadrature_is_exact_and_the_programs():
    L, w = ref.quadrature()
    assert len(w) == 14 and abs(w.sum() - 1.0) < 1e-15
    for a, b_, c in itertools.product(range(5), repeat=3):
        if a + b_ + c <= 4:
            exact = math.factorial(a) * math.factorial(b_) * math.factorial(c) / math.factorial(a + b_ + c + 3)
            got = (w / 6 * L[:, 1] ** a * L[:, 2] ** b_ * L[:, 3] ** c).sum()
            assert abs(got - exact) <= 1e-14 * exact
    cfg = dict(LAW, N=2)
    proto = ogden_block.make_protocol(2, "tetrahedron", 2, "mixed", device="cpu")
    x_q = proto["qmap"].domain.x_q.reshape(-1, 3).numpy()
    order = ref.point_order(cfg, x_q)  # raises where the points differ by more than 1e-12
    assert sorted(order) == list(range(len(x_q)))
    V = proto["V"]
    dofs = ref.dof_order(cfg, np.asarray(V.node_coords))
    M = 5
    lat = np.rint(np.asarray(V.node_coords) * 4).astype(int)
    assert sorted(dofs) == list(range(V.num_dofs))
    rid = (lat[:, 2] * M + lat[:, 1]) * M + lat[:, 0]
    assert (dofs[3 * rid] == 3 * np.arange(len(rid))).all()


def driver(cfg=None):
    cell = core.Cell(CELL)
    return cell, cell.driver().Driver(cell, SEED, "cpu", dict(cell.config, **(cfg or SMALL)))


def test_the_protocol_at_n4_is_correct():
    """Three mixed steps of the N = 4 block through the cell's driver,
    judged by the cell's comparison: the f64 residual of each step at most
    1e-4 of its entering guess's, u against the tightly solved reference."""
    cell, drv = driver()
    result, lines = core.execute(cell, drv, 0.01, False, time.perf_counter(), device="cpu")
    assert result["attempted"] == 3 and result["failed"] == 0
    assert result["correct"], lines
    assert set(result["metrics"]) == {"setup_s", "load_step_s"}


def test_a_step_that_hands_back_its_guess_is_not_correct():
    cell, drv = driver(dict(SMALL, steps=2, strain=0.04))
    one = torch.ones((), dtype=torch.float64)

    def unchanged(u, states, mask, vals, dt):
        return torch.where(mask, vals, u), states, 0 * one, one

    unchanged.info = dict(newton=0, cg=0)
    drv.block.step = unchanged
    result, _ = core.execute(cell, drv, 0.01, False, time.perf_counter(), device="cpu")
    got = result["compared"]
    assert not result["correct"] and got["res"]["value"] > 0.1
    assert all(got[k]["value"] > got[k]["limit"] for k in ("u", "u_later")), got


def test_the_float32_control_is_not_correct():
    """The control, the reference solved in float32 over six steps of the
    N = 4 block and judged by the cell's comparison: its later steps end at
    its floor, above the protocol's promise (which float64 residuals keep),
    and their u is farther from the float64 solve than ``u_later`` allows."""
    cell = core.Cell(CELL)
    got = ogden_protocol.control_readings(cell, SEED, "cpu", dict(N=4, steps=6, strain=0.12))
    assert all(got[k]["value"] > got[k]["limit"] for k in ("res", "u_later")), got


# ------------------------------------------------------------------ tracing
def test_hyperelastic_scopes_are_spans_and_count_points_padding_and_chunks():
    from torch.profiler import ProfilerActivity, profile

    port = models.Ogden(**ogden_block.OGDEN_PARAMS, tangent_chunk=64)
    Fv = torch.tensor(deformations("stretched", n=100).reshape(100, 9)[:, NS])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port.batched_update(Fv, {}, 0.0)
        port.batched_flux(Fv, {}, 0.0)
    names = [e.name for e in prof.events()]
    assert names.count(SCOPES[0]) == 1 and names.count(SCOPES[1]) == 1
    assert all(timers.device_timing(s)[0] == 1 for s in SCOPES)
    port.batched_update(Fv[:64], {}, 0.0)  # one chunk, no padding
    assert timers.counters() == {"hyperelastic: points": 264, "hyperelastic: padded points": 28,
                                 "hyperelastic: chunks": 3}
    assert timers.counters(profiled=False) == {"hyperelastic: points": 64, "hyperelastic: padded points": 0,
                                               "hyperelastic: chunks": 1}


def test_the_plate_and_points_paths_open_no_hyperelastic_scope():
    V = fem.FunctionSpace(fem.create_unit_square(5, 5, "quad"), 1, (2,))
    bcs = [fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0)), 0.0),
           fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 1), 1), 0.005)]
    m = tdm.Material(models.vonMisesIsotropicHardening(models.LinearElasticIsotropic(70e3, 0.3),
                                                       models.VoceHardening(350.0, 500.0, 1e3)), device="cpu")
    q = tdm.QuadratureMap(V, 2, m)
    q.register_gradient("Strain", mandel_strain_2d())
    prob = tdm.NonlinearMaterialProblem([q], fem.Function(V), bcs=bcs)
    step, pad = parallel.make_sharded_newton_step_general(prob, parallel.device_mesh(1, devices=["cpu"]))
    mask, vals = combine_bcs(bcs, V.num_dofs)
    timers.set_tracing(True)
    step(np.zeros(V.num_dofs), pad([m.data_manager.s0.internal]), mask, vals, 0.0)
    points = tdm.Material(m.behavior, device="cpu")
    points.integrate(1e-3 * torch.randn(64, 6, dtype=torch.float64, generator=torch.Generator().manual_seed(0)))
    assert timers.timing("fused: step")[0] == 1 and timers.timing("material: integrate")[0] == 1
    assert all(timers.timing(s)[0] == 0 for s in SCOPES)
    assert not any(k.startswith("hyperelastic:") for k in timers.counters())


# ------------------------------------------------------------------ readers
def reader(name):
    return core.Cell(CELL).reader(name)


def record():
    rec = core.Record()
    rec.timed, rec.traced = core.Window(), core.Window()
    rec.shapes = dict(n_points=100, dtype="float64")
    return rec


class Event:
    def __init__(self, name, a, b, device, annotation=False):
        self._e = (name, a, b, device, annotation)

    def name(self):
        return self._e[0]

    def start_ns(self):
        return self._e[1]

    def end_ns(self):
        return self._e[2]

    def device_type(self):
        return self._e[3]

    def is_user_annotation(self):
        return self._e[4]

    def start_thread_id(self):
        return 1


def protocol_window():
    """A 1,000 ns profiled window and its profiler session: device busy 600
    ns; the update's span (95, 405) holds 150 ns of idle (100 ns of it
    between operators, 50 ns in a synchronisation), the flux's (600, 700)
    50 ns."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [Event("portbench.window", 0, 1000, cpu, True), Event("portbench.load_step", 2, 998, cpu, True),
              Event("fused: step", 5, 995, cpu), Event("portbench.constitutive", 90, 410, cpu, True),
              Event(SCOPES[0], 95, 405, cpu), Event("cudaDeviceSynchronize", 350, 405, cpu),
              Event(SCOPES[1], 600, 700, cpu)]
    for a, b in ((0, 100), (200, 350), (400, 600), (650, 800), (1000, 1000)):
        events.append(Event("kernel", a, b, cuda))
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    rec = record()
    rec.traced.trace = trace.summarize(prof, 1e-6, ogden_protocol.SPANS)
    return rec, prof


def test_the_cells_readers_read_their_values():
    rec = record()
    rec.timed.counts.update(attempted=4, newton=22, cg=1500)
    assert reader("newton_per_step.ogden").read(rec) == 5.5
    assert reader("cg_per_step.ogden").read(rec) == 375.0
    timers.set_tracing(False)
    for _ in range(2):
        with timers.timer("fused: step"):
            with timers.timer(SCOPES[0]):
                timers.count("hyperelastic: points", 100)
            with timers.timer(SCOPES[1]):
                timers.count("hyperelastic: points", 100)
    seconds = sum(timers.timing(s)[1] for s in SCOPES)
    assert reader("constitutive_s_per_step.ogden").read(rec) == pytest.approx(seconds / 2)
    assert reader("ogden_evals_per_step.ogden").read(rec) == 2.0

    rec, prof = protocol_window()
    assert reader("idle_constitutive_pct.ogden").read(rec) is None  # no scope measured
    n, idle = ogden_protocol.idle_in_scopes(prof)
    assert n == 5 and idle == pytest.approx(200e-9)
    rec.traced.idle_in_scopes = idle
    assert reader("idle_constitutive_pct.ogden").read(rec) == pytest.approx(20.0)
    assert reader("device_idle_pct.ogden").read(rec) == pytest.approx(40.0)
    rec.traced.counts.update({"update.float64": 1, "flux.float32": 1})
    least = 100 * (99 * 8 + 18 * 4) / 3.35e12  # 100 points' F, PK1 and tangent at the HBM rate
    busy = rec.traced.trace.host_clipped["constitutive"]
    assert busy == pytest.approx(170e-9)  # (90, 410) of the busy (0, 100), (200, 350), (400, 600)
    assert reader("ogden_update_roofline_pct.ogden").read(rec) == pytest.approx(100 * least / busy)


def test_a_session_without_the_scopes_measures_no_idle_in_them():
    _, prof = protocol_window()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() not in SCOPES]
    prof.profiler.kineto_results.events = lambda: events
    assert ogden_protocol.idle_in_scopes(prof) == (5, None)


@pytest.mark.parametrize("name", ["newton_per_step.ogden", "cg_per_step.ogden", "constitutive_s_per_step.ogden",
                                  "ogden_evals_per_step.ogden", "idle_constitutive_pct.ogden",
                                  "ogden_update_roofline_pct.ogden", "device_idle_pct.ogden"])
def test_a_reader_with_nothing_to_read_gives_none(name, monkeypatch):
    """As on a program without the ``hyperelastic:`` scopes: no span, no
    counter, no profiled window."""
    rec = record()
    rec.traced = None
    assert reader(name).read(rec) is None
    timers.set_tracing(True)
    with timers.timer("fused: step"):
        pass
    monkeypatch.delattr(timers, "counters")
    assert reader(name).read(record()) is None
