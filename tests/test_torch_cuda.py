"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card; the file imports
neither JAX nor the JAX package, so it runs where the card is:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the two J2 kernels (full and factored tangent) to 1e-10 of each
field's scale in f64, and to the Pallas kernel's own test tolerances in f32
(tests/test_pallas_j2.py), at 1 to 4,099 points in both layouts, on arrays
that start at their storage's first element and at its second; their two
layouts, and their stress and state, bitwise to each other (one return map
in one template); the take kernels to 1e-13 (f64) / 1e-6 (f32) of
the plain version, and bitwise to each other and to
``compact_take_reference`` (all three add each output's entries in one order).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dolfinx_materials_tpu_torch as tdm
from dolfinx_materials_tpu_torch import fem, models
from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d
from dolfinx_materials_tpu_torch.ops import banded_gather as bg
from dolfinx_materials_tpu_torch.ops import j2_cuda
from dolfinx_materials_tpu_torch.ops.j2_fast import make_j2_batched_update

pytestmark = pytest.mark.cuda
E = 70e3
LAWS = {
    "linear": models.LinearHardening(350.0, 2e3),
    "voce": models.VoceHardening(350.0, 500.0, 1e3),
    "swift": models.SwiftHardening(350.0, 2e-3, 0.2),
    "ramberg_osgood": models.RambergOsgoodHardening(350.0, E, 2e-3, 5.0),
}


def user_law(p):
    """A hardening callable with no closed form in the kernel."""
    return 350.0 + 2e3 * p + 50.0 * torch.tanh(100.0 * p)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def j2_inputs(n, seed=3):
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(n, 6)) * np.geomspace(1e-4, 4e-2, n)[:, None]
    eps_p = 1e-3 * rng.normal(size=(n, 6))
    eps_p[:, :3] -= eps_p[:, :3].mean(axis=1, keepdims=True)
    return eps, eps_p, 5e-3 * rng.random(n)


def j2_args(n, feature_major, dtype, card, offset=0, seed=3):
    """:func:`j2_inputs` in the kernel layout, on the card, each array
    starting ``offset`` elements into its storage (1: a data pointer off the
    16-byte grid, the kernel's element-wise route)."""
    eps, eps_p, p = j2_inputs(n, seed)
    arrays = [eps.T, eps_p.T, p[None, :]] if feature_major else [eps, eps_p, p]
    out = []
    for a in arrays:
        a = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
        t = torch.empty(a.numel() + offset, dtype=dtype, device=card)[offset:].view(a.shape)
        assert t.is_contiguous() and t.storage_offset() == offset
        out.append(t.copy_(a))
    return out


# point counts: one point, a part of one tile, a tile and a bit, and a
# ragged many-tile batch (the kernels take 128 points a block)
J2_SIZES = [1, 31, 129, 4099]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("contract", ["pallas", "j2_fast"])
@pytest.mark.parametrize("feature_major", [True, False])
@pytest.mark.parametrize("n", J2_SIZES)
@pytest.mark.parametrize("offset", [0, 1])
def test_j2_kernel_matches_plain(card, dtype, law, contract, feature_major, n, offset):
    c = j2_cuda.PALLAS_CONTRACT if contract == "pallas" else j2_cuda.J2_FAST_CONTRACT
    el = models.LinearElasticIsotropic(E, 0.3)
    args = j2_args(n, feature_major, dtype, card, offset)
    before = j2_cuda.j2_radial_return.launches
    got = j2_cuda.j2_radial_return(*args, el, LAWS[law], feature_major=feature_major, **c)
    assert j2_cuda.j2_radial_return.launches == before + 1
    want = j2_cuda.j2_radial_return_reference(*args, el, LAWS[law], feature_major=feature_major, **c)
    torch.cuda.synchronize()
    f64 = dtype == torch.float64
    tol = dict(sig=1e-10, Ct=1e-10, st=1e-10) if f64 else dict(sig=2e-4, Ct=5e-4, st=1e-6)
    assert float((got[0] - want[0]).abs().max()) <= tol["sig"] * float(want[0].abs().max())
    assert float((got[1] - want[1]).abs().max()) <= tol["Ct"] * E
    for g, w in zip(got[2:], want[2:]):
        assert float((g - w).abs().max()) <= tol["st"] * (float(w.abs().max()) if f64 else 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("contract", ["pallas", "j2_fast"])
@pytest.mark.parametrize("feature_major", [True, False])
@pytest.mark.parametrize("n", J2_SIZES)
@pytest.mark.parametrize("offset", [0, 1])
def test_j2_factored_kernel_matches_plain(card, dtype, law, contract, feature_major, n, offset):
    """The factored-tangent kernel against its plain version, and its
    expansion against the full-tangent kernel's Ct on the same inputs."""
    c = j2_cuda.PALLAS_CONTRACT if contract == "pallas" else j2_cuda.J2_FAST_CONTRACT
    el = models.LinearElasticIsotropic(E, 0.3)
    args = j2_args(n, feature_major, dtype, card, offset)
    kw = dict(c, feature_major=feature_major)
    before = j2_cuda.j2_radial_return_factored.launches
    got = j2_cuda.j2_radial_return_factored(*args, el, LAWS[law], **kw)
    assert j2_cuda.j2_radial_return_factored.launches == before + 1
    want = j2_cuda.j2_radial_return_factored_reference(*args, el, LAWS[law], **kw)
    full = j2_cuda.j2_radial_return(*args, el, LAWS[law], **kw)
    torch.cuda.synchronize()
    assert tuple(got[1].shape) == ((2, n) if feature_major else (n, 2))
    f64 = dtype == torch.float64
    tol = dict(sig=1e-10, Ct=1e-10, st=1e-10) if f64 else dict(sig=2e-4, Ct=5e-4, st=1e-6)
    assert float((got[0] - want[0]).abs().max()) <= tol["sig"] * float(want[0].abs().max())
    assert float((got[1] - want[1]).abs().max()) <= tol["Ct"] * E
    for g, w in zip(got[2:], want[2:]):
        assert float((g - w).abs().max()) <= tol["st"] * (float(w.abs().max()) if f64 else 1.0)
    Ct = j2_cuda.expand_factored_tangent(el, got[0], got[1], feature_major=feature_major)
    assert float((Ct - full[1]).abs().max()) <= (1e-12 if f64 else 1e-5) * E


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("factored", [False, True])
def test_j2_layouts_are_bitwise_equal(card, dtype, law, factored):
    """The point-major instantiation (tiles staged through shared memory)
    and the feature-major one give the same bits for the same points, on
    aligned and misaligned arrays."""
    el = models.LinearElasticIsotropic(E, 0.3)
    launch = j2_cuda.J2Launch(el, LAWS[law], factored=factored, **j2_cuda.J2_FAST_CONTRACT)
    for offset in (0, 1):
        fm = launch(*j2_args(4099, True, dtype, card, offset), feature_major=True)
        pm = launch(*j2_args(4099, False, dtype, card, offset), feature_major=False)
        torch.cuda.synchronize()
        for a, b in zip(pm, (fm[0].T, fm[1].T, fm[2].T, fm[3][0])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("feature_major", [True, False])
def test_j2_full_and_factored_state_bitwise_equal(card, dtype, law, feature_major):
    """K1 and K2 run one return map: their sig, eps_p_new and p_new are the
    same bits."""
    el = models.LinearElasticIsotropic(E, 0.3)
    args = j2_args(4099, feature_major, dtype, card)
    kw = dict(j2_cuda.J2_FAST_CONTRACT, feature_major=feature_major)
    full = j2_cuda.j2_radial_return(*args, el, LAWS[law], **kw)
    fac = j2_cuda.j2_radial_return_factored(*args, el, LAWS[law], **kw)
    torch.cuda.synchronize()
    for i in (0, 2, 3):
        assert torch.equal(full[i], fac[i])


def test_j2_launch_is_one_kernel_and_its_outputs(card):
    """A call of a held launch (the fast path's) adds one to its wrapper's
    count and calls no PyTorch operator besides the four outputs'
    allocations: no copy, no layout change, no host-to-device transfer."""
    el = models.LinearElasticIsotropic(E, 0.3)
    upd = make_j2_batched_update(el, LAWS["voce"])
    args = j2_args(4099, False, torch.float64, card)
    upd.launch(*args, feature_major=False)  # loads the library and types the entry point
    before = j2_cuda.j2_radial_return.launches
    with _Ops() as log:
        upd.launch(*args, feature_major=False)
    assert j2_cuda.j2_radial_return.launches == before + 1
    assert log.ops == ["aten.new_empty.default"] * 4


def test_j2_wrapper_raises_instead_of_falling_back(card):
    el = models.LinearElasticIsotropic(E, 0.3)
    args = [torch.zeros(s, dtype=torch.float64, device=card) for s in ((6, 256), (6, 256), (1, 256))]
    for wrapper in (j2_cuda.j2_radial_return, j2_cuda.j2_radial_return_factored):
        with pytest.raises(TypeError, match="no in-kernel form"):
            wrapper(*args, el, user_law, **j2_cuda.J2_FAST_CONTRACT)
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(args[0].T.contiguous().T, *args[1:], el, LAWS["voce"], **j2_cuda.J2_FAST_CONTRACT)
        with pytest.raises(ValueError, match="expected"):
            wrapper(args[0][:, :128].contiguous(), *args[1:], el, LAWS["voce"], **j2_cuda.J2_FAST_CONTRACT)
        with pytest.raises(TypeError, match="unsupported dtype"):
            wrapper(*(a.half() for a in args), el, LAWS["voce"], **j2_cuda.J2_FAST_CONTRACT)


def test_law_without_kernel_form_raises_on_the_card(card):
    """A user callable with no closed form raises on the card, through the
    fast path of Material.integrate too, launches nothing and still runs on
    the CPU (the Ramberg-Osgood law itself runs inside the kernel, see
    test_j2_kernel_matches_plain)."""
    el = models.LinearElasticIsotropic(E, 0.3)
    upd = make_j2_batched_update(el, user_law)
    eps, eps_p, p = (torch.as_tensor(a, device=card) for a in j2_inputs(512))
    before = j2_cuda.j2_radial_return.launches
    with pytest.raises(TypeError, match="no in-kernel form"):
        upd(eps, {"eps_p": eps_p, "p": p}, 0.0)
    mat = tdm.Material(models.vonMisesIsotropicHardening(el, user_law), device="cuda")
    with pytest.raises(TypeError, match="no in-kernel form"):
        mat.integrate(eps.cpu().numpy(), 0.0)
    assert j2_cuda.j2_radial_return.launches == before
    sig, _, _ = upd(eps.cpu(), {"eps_p": eps_p.cpu(), "p": p.cpu()}, 0.0)
    assert bool(torch.isfinite(sig).all())


GENERIC = {
    "general_von_mises": (lambda el: models.GeneralIsotropicHardening(el, LAWS["voce"]), 0.0),
    "norton": (lambda el: models.NortonViscoplasticity(el, LAWS["linear"], K=150.0, n=3.0), 0.05),
    "maxwell": (lambda el: models.GeneralizedMaxwell(50e3, 10e3, [(20e3, 0.5), (3e3, 50.0)]), 0.3),
    "plane_stress_j2": (lambda el: models.PlaneStress(models.vonMisesIsotropicHardening(el, LAWS["linear"])), 0.0),
}


@pytest.mark.parametrize("name", sorted(GENERIC))
def test_generic_update_card_matches_cpu(card, name):
    """The generic vmap(jacfwd) update (masked Newton on the active points,
    IFT tangents) on the card against the CPU: the same code, other sums;
    1e-10 of each array's scale."""
    make, dt = GENERIC[name]
    eps, _, _ = j2_inputs(2048)
    if name.startswith("plane"):
        eps[:, [2, 4, 5]] = 0.0
    out = {}
    for dev in ("cuda", "cpu"):
        mat = tdm.Material(make(models.LinearElasticIsotropic(E, 0.3)), device=dev)
        out[dev] = [t.cpu() for t in mat.integrate(eps, dt)] + [t.cpu() for t in mat.integrate_flux_only(eps, dt)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())


def plate_space():
    return fem.FunctionSpace(fem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "quad"), 2, (2,))


def plate_plans(card):
    V = plate_space()
    dm, n = V.dofmap, V.num_dofs
    Vt = fem.FunctionSpace(fem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "triangle"), 2, (2,))
    return {
        "cell": bg.plan_banded_take(dm.ravel(), n, chunk=2048, max_R=256, device=card),
        "fm": bg.plan_banded_take(dm.T.ravel(), n, chunk=512, max_R=256, device=card),
        "asm": bg.plan_slotwise_assembly(dm, n, chunk=1024, max_R=256, device=card),
        # repeated patch positions (overflow of max-valence dofs)
        "asm_overflow": bg.plan_slotwise_assembly(Vt.dofmap, Vt.num_dofs, chunk=1024, max_R=256,
                                                  k_quantile=0.01, device=card),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["cell", "fm", "asm", "asm_overflow"])
def test_take_kernels_match_plain_and_each_other(card, dtype, kind):
    plan = plate_plans(card)[kind]
    table = torch.as_tensor(np.random.default_rng(3).standard_normal(plan.n_src), dtype=dtype, device=card)
    e0, c0 = bg.banded_take_ell.launches, bg.banded_take_csr.launches
    a = bg.banded_take_ell(table, plan)
    b = bg.banded_take_csr(table, plan)
    assert (bg.banded_take_ell.launches, bg.banded_take_csr.launches) == (e0 + 1, c0 + 1)
    plain = [bg.compact_take_reference(table, plan, layout) for layout in ("ell", "csr")]
    ref = bg.banded_take_reference(table, plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, x) for x in [b, *plain])
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    assert float((a - ref).abs().max()) <= tol * float(ref.abs().max())


class _Ops(TorchDispatchMode):
    """Records every PyTorch operator called inside the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("wrapper", ["banded_take_ell", "banded_take_csr"])
@pytest.mark.parametrize("kind", ["cell", "asm_overflow"])
def test_take_is_one_launch_with_no_patch_step(card, wrapper, kind):
    """A take on a plan with patches (repeated positions for asm_overflow)
    adds one to its wrapper's launch count and calls no PyTorch operator
    besides the output's allocation: no patch step follows the kernel."""
    plan = plate_plans(card)[kind]
    assert len(plan.patch_pos) > 0
    take = getattr(bg, wrapper)
    table = torch.as_tensor(np.random.default_rng(4).standard_normal(plan.n_src), device=card)
    take(table, plan)  # first call: loads the library and caches the entry point
    before = take.launches
    with _Ops() as log:
        out = take(table, plan)
    assert take.launches == before + 1
    assert log.ops == ["aten.empty.memory_format"]
    want = bg.banded_take_reference(table, plan)
    assert float((out - want).abs().max()) <= 1e-13 * float(want.abs().max())


@pytest.mark.parametrize("wrapper", ["banded_take_ell", "banded_take_csr"])
def test_take_wrappers_raise_instead_of_falling_back(card, wrapper):
    take = getattr(bg, wrapper)
    plan = plate_plans(card)["asm"]
    table = torch.zeros(plan.n_src, dtype=torch.float64, device=card)
    before = take.launches
    with pytest.raises(TypeError, match="unsupported dtype"):
        take(table.half(), plan)
    with pytest.raises(ValueError, match="contiguous"):
        take(torch.zeros(2 * plan.n_src, dtype=torch.float64, device=card)[::2], plan)
    with pytest.raises(ValueError, match="expected"):
        take(table[:-1], plan)
    V = plate_space()
    cpu_plan = bg.plan_slotwise_assembly(V.dofmap, V.num_dofs, chunk=1024, max_R=256)
    with pytest.raises(ValueError, match="plan on cpu"):
        take(table, cpu_plan)
    assert take.launches == before


def test_plan_off_the_current_device_raises_when_planned(card):
    """The takes launch on the current device and enter no device context:
    a plan for another CUDA device is refused when it is made, not at its
    first take."""
    V = plate_space()
    other = f"cuda:{torch.cuda.current_device() + 1}"
    with pytest.raises(ValueError, match="not the current CUDA device"):
        bg.plan_slotwise_assembly(V.dofmap, V.num_dofs, chunk=1024, max_R=256, device=other)
    with pytest.raises(ValueError, match="not the current CUDA device"):
        bg.plan_banded_take(V.dofmap.ravel(), V.num_dofs, chunk=2048, max_R=256, device=other)


def test_plate_steps_card_match_cpu(card):
    """Three load steps of the 16x32 J2 plate (banded route) on the card and
    on the CPU: u and p to 1e-8 relative, equal Newton counts."""
    out = {}
    for dev in ("cuda", "cpu"):
        V = fem.FunctionSpace(fem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "quad"), 2, (2,))
        mat = tdm.Material(models.vonMisesIsotropicHardening(
            models.LinearElasticIsotropic(E, 0.3), LAWS["voce"]), device=dev)
        qmap = tdm.QuadratureMap(V, 4, mat)
        qmap.register_gradient("Strain", mandel_strain_2d())
        assert qmap.domain.banded_active
        bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0))
        top = fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 2.0), 1), 0.0)
        prob = tdm.NonlinearMaterialProblem(qmap, fem.Function(V), bcs=[fem.DirichletBC(bottom, 0.0), top])
        its = []
        for uy in (0.0025, 0.005, 0.0075):
            top.set(uy)
            converged, n = prob.solve()
            assert converged
            its.append(n)
        out[dev] = (prob.u.x.copy(), qmap.field_array("p").cpu().numpy().ravel(), its)
    (uc, pc, ic), (uh, ph, ih) = out["cuda"], out["cpu"]
    assert ic == ih and ph.max() > 0
    np.testing.assert_allclose(uc, uh, rtol=0, atol=1e-8 * np.abs(uh).max())
    np.testing.assert_allclose(pc, ph, rtol=0, atol=1e-8 * np.abs(ph).max())


# ------------------------------------------------- fused step and its pieces
def test_fixed_sum_is_one_launch_and_bitwise(card):
    """The fixed-order sum (the CSR take kernel over a SumPlan): one launch,
    bitwise equal to the CSR take's plain version, to the CPU's plain
    version, and to itself on a second call."""
    rng = np.random.default_rng(6)
    target = rng.integers(0, 500, 50_000)
    vals = rng.standard_normal(50_000) * 10.0 ** rng.uniform(-8, 8, 50_000)
    plan = bg.plan_fixed_sum(target, 500, device=card)
    v = torch.as_tensor(vals, device=card)
    before = bg.banded_take_csr.launches
    out = bg.fixed_sum(v, plan)
    assert bg.banded_take_csr.launches == before + 1
    assert torch.equal(out, bg.compact_take_reference(v, plan, "csr"))
    assert torch.equal(out, bg.fixed_sum(v, plan))
    cpu = bg.fixed_sum(torch.as_tensor(vals), bg.plan_fixed_sum(target, 500))
    assert torch.equal(out.cpu(), cpu)


@pytest.mark.parametrize("n_cg", [21, 500])
def test_masked_cg_graph_matches_eager(card, n_cg):
    """The CG block replayed as a CUDA graph against the same block run
    eagerly: bitwise equal x and counts, on two solves through one graph."""
    from dolfinx_materials_tpu_torch.parallel.sharding import MaskedCG

    rng = np.random.default_rng(7)
    A = rng.standard_normal((300, 300))
    A = torch.as_tensor(A @ A.T + 300 * np.eye(300), device=card)
    ops = {"A": A, "d": torch.diagonal(A).clone()}

    def Av(o, v):
        return o["A"] @ v

    def M(o, r):
        return r / o["d"]

    graph, eager = MaskedCG(Av, M, n_cg, 1e-12, graph=True), MaskedCG(Av, M, n_cg, 1e-12, graph=False)
    for seed in (0, 1):
        b = torch.as_tensor(np.random.default_rng(seed).standard_normal(300), device=card)
        (xg, kg), (xe, ke) = graph.solve(ops, b), eager.solve(ops, b)
        assert kg == ke and torch.equal(xg, xe)
    assert len(graph._graphs) == 1 and not eager._graphs


def test_fused_step_card_matches_cpu(card):
    """The fused step of the 5x5 J2 plate (tests/test_sharding.py) on the
    card, through its CUDA graph, and on the CPU: u and p to 1e-10 of their
    scale, equal counts."""
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step_general

    assert device_mesh().device.type == "cuda"
    out = {}
    for dev in ("cuda", "cpu"):
        V = fem.FunctionSpace(fem.create_unit_square(5, 5, "quad"), 1, (2,))
        mat = tdm.Material(models.vonMisesIsotropicHardening(
            models.LinearElasticIsotropic(E, 0.3), LAWS["voce"]), device=dev)
        qmap = tdm.QuadratureMap(V, 2, mat)
        qmap.register_gradient("Strain", mandel_strain_2d())
        left = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0), 0)
        bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0), 1)
        right = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1), 0)
        bcs = [fem.DirichletBC(left, 0.0), fem.DirichletBC(bottom, 0.0), fem.DirichletBC(right, 3 * 350.0 / E)]
        prob = tdm.NonlinearMaterialProblem(qmap, fem.Function(V), bcs=bcs)
        step, pad = make_sharded_newton_step_general(
            prob, device_mesh(1, devices=[dev]), n_newton=12, n_cg=200, return_info="stats")
        mask, vals = combine_bcs(bcs, V.num_dofs)
        u, st, rn, rn0, counts = step(np.zeros(V.num_dofs), pad([mat.data_manager.s0.internal]), mask, vals)
        assert float(rn) < 1e-10 * float(rn0)
        assert (dev == "cuda") == bool(step.cg._graphs)
        out[dev] = u.cpu().numpy(), st[0]["p"].cpu().numpy(), counts
    (uc, pc, cc), (uh, ph, ch) = out["cuda"], out["cpu"]
    assert cc == ch and ph.max() > 0
    np.testing.assert_allclose(uc, uh, rtol=0, atol=1e-10 * np.abs(uh).max())
    np.testing.assert_allclose(pc, ph, rtol=0, atol=1e-10 * np.abs(ph).max())


def test_fused_step_graph_counts_replayed_launches(card):
    """One Newton update of the 16x32 P2 plate (banded route) with the CG
    blocks replayed as a CUDA graph and run eagerly: u bitwise equal. The
    take wrappers count every call, the capture's included; a replay calls
    no wrapper, so the graph run's launches are its wrapper counts less the
    capture's calls plus replays x recorded, which is the eager run's
    launches plus one block's, the warm-up the capture runs on copies."""
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step_general

    names = ("banded_take_ell", "banded_take_csr")
    out = {}
    for graph in (True, False):
        V = fem.FunctionSpace(fem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "quad"), 2, (2,))
        mat = tdm.Material(models.vonMisesIsotropicHardening(
            models.LinearElasticIsotropic(E, 0.3), LAWS["voce"]), device=card)
        qmap = tdm.QuadratureMap(V, 4, mat)
        qmap.register_gradient("Strain", mandel_strain_2d())
        bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0))
        top = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 2.0), 1)
        bcs = [fem.DirichletBC(bottom, 0.0), fem.DirichletBC(top, 0.0075)]
        prob = tdm.NonlinearMaterialProblem(qmap, fem.Function(V), bcs=bcs)
        step, pad = make_sharded_newton_step_general(prob, device_mesh(1), n_newton=1, n_cg=400,
                                                     return_info="stats")
        step.cg.graph = graph
        mask, vals = combine_bcs(bcs, V.num_dofs)
        u0 = np.stack([np.zeros(V.num_nodes), 0.0075 * V.node_coords[:, 1] / 2.0], axis=1).reshape(-1)
        counts = [bg.banded_take_ell.launches, bg.banded_take_csr.launches]
        u, _, _, _, (_, ncg) = step(u0, pad([mat.data_manager.s0.internal]), mask, vals)
        torch.cuda.synchronize()
        out[graph] = u, ncg, [bg.banded_take_ell.launches - counts[0], bg.banded_take_csr.launches - counts[1]]
        if graph:
            (g,) = step.cg._graphs.values()
            block = [g["recorded"][n][0] for n in names]
            replays = g["replays"]
        else:
            blocks = step.cg.blocks
    assert out[True][1] == out[False][1] > 16
    assert torch.equal(out[True][0], out[False][0])
    assert min(block) > 0 and replays == blocks
    launched = [calls - b + replays * b for calls, b in zip(out[True][2], block)]
    assert launched == [e + b for e, b in zip(out[False][2], block)]
