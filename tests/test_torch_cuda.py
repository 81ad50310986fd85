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
``compact_take_reference`` (all three add each output's entries in one order);
the two coarse-correction kernels to 1e-13 (f64) / 1e-5 (f32) of the plain
version's largest value: both sum a few hundred dofs an aggregate and a row
of ~1,000 coarse values, in another order (the kernels: strided partial sums
and a shuffle tree; the plain version: node values, a row sum, a matrix
product), and bitwise to themselves from run to run.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dolfinx_materials_tpu_torch as tdm
from dolfinx_materials_tpu_torch import fem, models
from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d
from dolfinx_materials_tpu_torch.ops import banded_gather as bg
from dolfinx_materials_tpu_torch.ops import coarse_correction as cc
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
    """A hardening callable with no closed form in the kernel: it runs there
    as a law program (ops/law_program.py)."""
    return 350.0 + 2e3 * p + 50.0 * torch.tanh(100.0 * p)


def branching_law(p):
    """A hardening callable that is not a program (a branch on the value)."""
    return 350.0 + 2e3 * p if p > 0.01 else 370.0 + 0.0 * p


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
            wrapper(*args, el, branching_law, **j2_cuda.J2_FAST_CONTRACT)
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(args[0].T.contiguous().T, *args[1:], el, LAWS["voce"], **j2_cuda.J2_FAST_CONTRACT)
        with pytest.raises(ValueError, match="expected"):
            wrapper(args[0][:, :128].contiguous(), *args[1:], el, LAWS["voce"], **j2_cuda.J2_FAST_CONTRACT)
        with pytest.raises(TypeError, match="unsupported dtype"):
            wrapper(*(a.half() for a in args), el, LAWS["voce"], **j2_cuda.J2_FAST_CONTRACT)


def test_traced_law_runs_inside_the_kernel(card):
    """A user callable with no closed form runs inside the kernel as a law
    program, through the fast path of Material.integrate too: each call
    launches the kernel once and matches the plain version on the CPU (the
    callable differentiated by torch.func) to 1e-12 of each field's scale."""
    el = models.LinearElasticIsotropic(E, 0.3)
    upd = make_j2_batched_update(el, user_law)
    eps, eps_p, p = (torch.as_tensor(a, device=card) for a in j2_inputs(4099))
    before = j2_cuda.j2_radial_return.launches
    got = upd(eps, {"eps_p": eps_p, "p": p}, 0.0)
    assert j2_cuda.j2_radial_return.launches == before + 1
    want = upd(eps.cpu(), {"eps_p": eps_p.cpu(), "p": p.cpu()}, 0.0)
    got = [got[0], got[1], got[2]["eps_p"], got[2]["p"]]
    want = [want[0], want[1], want[2]["eps_p"], want[2]["p"]]
    assert float((want[3] - p.cpu()).max()) > 1e-3, "must exercise the plastic branch"
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-12 * float(w.abs().max())
    out = {}
    for dev in ("cuda", "cpu"):
        mat = tdm.Material(models.vonMisesIsotropicHardening(el, user_law), device=dev)
        before = j2_cuda.j2_radial_return.launches
        out[dev] = [t.cpu() for t in mat.integrate(eps.cpu().numpy(), 0.0)]
        assert j2_cuda.j2_radial_return.launches == before + (dev == "cuda")
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_untraceable_law_raises_on_the_card(card):
    """A law that is not a program raises on the card, through the fast path
    of Material.integrate too, launches nothing and still runs on the CPU."""
    el = models.LinearElasticIsotropic(E, 0.3)
    law = lambda p: 350.0 + 100.0 * torch.sin(p)  # noqa: E731 — no sin instruction
    upd = make_j2_batched_update(el, law)
    eps, eps_p, p = (torch.as_tensor(a, device=card) for a in j2_inputs(512))
    before = j2_cuda.j2_radial_return.launches
    with pytest.raises(TypeError, match="unsupported operation sin"):
        upd(eps, {"eps_p": eps_p, "p": p}, 0.0)
    mat = tdm.Material(models.vonMisesIsotropicHardening(el, law), device="cuda")
    with pytest.raises(TypeError, match="unsupported operation sin"):
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
    cpu_plan = bg.plan_slotwise_assembly(V.dofmap, V.num_dofs, chunk=1024, max_R=256, device="cpu")
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
def coarse_space(name):
    if name == "plate":  # the plate cell's 128x256 P2 space
        return fem.FunctionSpace(fem.create_rectangle((0.0, 0.0), (1.0, 2.0), (128, 256), "quad"), 2, (2,))
    return fem.FunctionSpace(fem.create_unit_cube(8, 8, 8, "tetrahedron"), 2, (3,))  # a P2 tet block


def coarse_case(card, dtype, modes, pc_boxes, space="plate", seed=5):
    """``space`` cut into ``pc_boxes`` boxes a side, its aggregate plan on
    the card, the mode weights and seeded operands: r, z, s_inv, a mask on a
    fifth of the dofs, an SPD Ac_inv."""
    from dolfinx_materials_tpu_torch.parallel.coarse import _coord_agg_modes

    V = coarse_space(space)
    ncoarse, agg_np, W_np = _coord_agg_modes(V, pc_boxes, modes=modes)
    rng = np.random.default_rng(seed)
    n = V.num_dofs
    G = rng.standard_normal((ncoarse, ncoarse))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=card)  # noqa: E731
    ops = dict(r=t(rng.standard_normal(n)), z=t(rng.standard_normal(n)), s_inv=t(rng.uniform(0.5, 2.0, n)),
               mask=torch.as_tensor(rng.random(n) < 0.2, device=card),
               Ac_inv=t(G @ G.T / ncoarse + np.eye(ncoarse)), W=t(W_np))
    return cc.plan_aggregates(agg_np, V.ncomp, W_np.shape[2], device=card), ops


# the plate's coarse space (22 boxes: 2 or 3 modes, 968 or 1,452 coarse dofs,
# 16-byte rows of Ac_inv), one of 147 coarse dofs (rows of odd length: 8-byte
# loads), and a 3D block's (3 or 6 modes, 375 or 1,296 coarse dofs)
COARSE = [("trans", 22, "plate"), ("rbm", 22, "plate"), ("rbm", 7, "plate"), ("trans", 5, "tets"),
          ("rbm", 6, "tets")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("modes,pc_boxes,space", COARSE)
def test_coarse_kernels_match_plain(card, dtype, modes, pc_boxes, space):
    """Restriction and prolongation with the mask, the scaling and the add
    to z (the fused step's call), and without them (the split-dof route's):
    one launch each, within the summation-order tolerance of the plain
    version, bitwise equal on a second call."""
    plan, o = coarse_case(card, dtype, modes, pc_boxes, space)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    for mask, s_inv, z in ((o["mask"], o["s_inv"], o["z"]), (None, None, None)):
        before = (cc.coarse_restrict.launches, cc.coarse_prolong.launches, cc.coarse_restrict.f32_launches)
        rc = cc.coarse_restrict(o["r"], plan, o["W"], mask, s_inv)
        out = cc.coarse_prolong(rc, o["Ac_inv"], plan, o["W"], z, mask, s_inv)
        f32 = dtype == torch.float32
        assert (cc.coarse_restrict.launches, cc.coarse_prolong.launches,
                cc.coarse_restrict.f32_launches) == (before[0] + 1, before[1] + 1, before[2] + f32)
        rc_ref = cc.coarse_restrict_reference(o["r"], plan, o["W"], mask, s_inv)
        # the same rc into both prolongations: each kernel is held alone
        out_ref = cc.coarse_prolong_reference(rc, o["Ac_inv"], plan, o["W"], z, mask, s_inv)
        torch.cuda.synchronize()
        assert float((rc - rc_ref).abs().max()) <= tol * float(rc_ref.abs().max())
        assert float((out - out_ref).abs().max()) <= tol * float(out_ref.abs().max())
        if mask is not None:
            assert torch.equal(out[o["mask"]], o["z"][o["mask"]])
        assert torch.equal(rc, cc.coarse_restrict(o["r"], plan, o["W"], mask, s_inv))
        assert torch.equal(out, cc.coarse_prolong(rc, o["Ac_inv"], plan, o["W"], z, mask, s_inv))


def test_coarse_wrappers_raise_instead_of_falling_back(card):
    plan, o = coarse_case(card, torch.float64, "trans", 22)
    r, W, A = o["r"], o["W"], o["Ac_inv"]
    rc = cc.coarse_restrict(r, plan, W)
    before = (cc.coarse_restrict.launches, cc.coarse_prolong.launches)
    with pytest.raises(TypeError, match="unsupported dtype"):
        cc.coarse_restrict(r.half(), plan, W.half())
    with pytest.raises(ValueError, match="expected W"):
        cc.coarse_restrict(r, plan, W.float())
    with pytest.raises(ValueError, match="contiguous"):
        cc.coarse_restrict(torch.stack([r, r], dim=1)[:, 0], plan, W)
    with pytest.raises(ValueError, match="expected r"):
        cc.coarse_restrict(r[:-1], plan, W)
    with pytest.raises(ValueError, match="expected mask"):
        cc.coarse_restrict(r, plan, W, mask=o["mask"].double())
    with pytest.raises(ValueError, match="expected Ac_inv"):
        cc.coarse_prolong(rc, A[:-1], plan, W)
    with pytest.raises(ValueError, match="contiguous"):
        cc.coarse_prolong(rc, A.T, plan, W)
    with pytest.raises(ValueError, match="z on cpu"):
        cc.coarse_prolong(rc, A, plan, W, z=o["z"].cpu())
    cpu_plan = cc.plan_aggregates(np.zeros(4, np.int64), 2, 2, device="cpu")
    with pytest.raises(ValueError, match="plan on cpu"):
        cc.coarse_restrict(torch.zeros(8, dtype=torch.float64, device=card), cpu_plan,
                           torch.zeros((4, 2, 2), dtype=torch.float64, device=card))
    assert (cc.coarse_restrict.launches, cc.coarse_prolong.launches) == before


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
    cpu = bg.fixed_sum(torch.as_tensor(vals), bg.plan_fixed_sum(target, 500, device="cpu"))
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

    wrappers = (bg.banded_take_ell, bg.banded_take_csr, cc.coarse_restrict, cc.coarse_prolong)
    names = tuple(w.__name__ for w in wrappers)
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
        counts = [w.launches for w in wrappers]
        u, _, _, _, (_, ncg) = step(u0, pad([mat.data_manager.s0.internal]), mask, vals)
        torch.cuda.synchronize()
        out[graph] = u, ncg, [w.launches - c for w, c in zip(wrappers, counts)]
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


def fefp_inputs(n, seed=1, dtype=torch.float64):
    """bench.py's FeFp batch: F = I + 2e-2 N(0, 1), committed identity state."""
    rng = np.random.default_rng(seed)
    Fv = np.tile([1.0, 1, 1, 0, 0, 0, 0, 0, 0], (n, 1)) + 2e-2 * rng.standard_normal((n, 9))
    state = {"be": np.tile([1.0, 1, 1, 0, 0, 0], (n, 1)), "p": np.zeros(n),
             "F_prev": np.tile([1.0, 1, 1, 0, 0, 0, 0, 0, 0], (n, 1))}
    return torch.tensor(Fv, dtype=dtype), {k: torch.tensor(v, dtype=dtype) for k, v in state.items()}


def to(tree, device):
    if isinstance(tree, dict):
        return {k: to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to(v, device) for v in tree)
    return tree.to(device)


def assert_fields(got, want, tol):
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert_fields([g[k] for k in w], [w[k] for k in w], tol)
            continue
        g = g.cpu()
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= tol * max(float(w.abs().max()), 1.0)


@pytest.mark.parametrize("mode", ["analytic", "jvp"])
@pytest.mark.parametrize("law", ["voce", "user"])
def test_fefp_batched_update_card_vs_cpu(card, mode, law):
    """FeFp's whole-batch update on the card against the same update on the
    CPU (f64, 1e-10 of each field's scale), with a built-in law and a user
    hardening callable (differentiated with torch.func on both)."""
    ys = LAWS["voce"] if law == "voce" else user_law
    beh = models.FeFpJ2Plasticity(models.LinearElasticIsotropic(70e3, 0.3), ys, tangent_mode=mode)
    Fv, st = fefp_inputs(4096)
    want = beh.batched_update(Fv, st, 0.0)
    got = beh.batched_update(*to((Fv, st), card), 0.0)
    torch.cuda.synchronize()
    assert float(want[2]["p"].max()) > 0
    assert_fields(got, want, 1e-10)
    assert_fields(beh.batched_flux(*to((Fv, st), card), 0.0), beh.batched_flux(Fv, st, 0.0), 1e-10)


def test_crystal_batched_update_card_vs_cpu(card):
    """Three chained crystal updates (bench.py's batch shape, dt = 1e-2):
    stress and state to 1e-9 of scale, tangent to 1e-8, the same Newton
    counts on both."""
    beh = models.MericCailletaudCrystalPlasticity()
    rng = np.random.default_rng(2)
    eps = torch.tensor(2e-3 * rng.standard_normal((2048, 6)))
    st = {k: torch.zeros((2048,) + np.shape(v), dtype=torch.float64) for k, v in beh.init_state().items()}
    stc = to(st, card)
    for _ in range(3):
        want = beh.batched_update(eps, st, 1e-2)
        its = beh.last_newton_iters
        got = beh.batched_update(eps.to(card), stc, 1e-2)
        assert beh.last_newton_iters == its
        assert_fields(got[:1] + got[2:], want[:1] + want[2:], 1e-9)
        assert_fields(got[1:2], want[1:2], 1e-8)
        st, stc = want[2], got[2]
        eps = eps + 1e-3 * torch.tensor(rng.standard_normal((2048, 6)))
    assert float(st["p"].max()) > 1e-4


def test_root_backward_on_card(card):
    """Reverse mode through a vmapped Voce path on CUDA tensors against the
    same gradient on the CPU."""
    from torch.func import grad

    from dolfinx_materials_tpu_torch.calibration import make_path_simulator

    def factory(th):
        return models.vonMisesIsotropicHardening(models.LinearElasticIsotropic(70e3, 0.3),
                                                 models.VoceHardening(350.0 * torch.exp(th["a"]), 500.0, 1e3))

    path = np.zeros((10, 3, 6))
    path[:, :, 0] = np.linspace(0, 0.02, 11)[1:, None] * np.array([1.0, 0.5, 1.2])
    grads = []
    for dev in ("cpu", card):
        th = {"a": torch.tensor(0.0, dtype=torch.float64, device=dev)}
        sim = make_path_simulator(factory, th)
        g = grad(lambda t: torch.sum(sim(t, torch.tensor(path, device=dev)) ** 2))(th)
        grads.append(float(g["a"]))
    assert grads[0] != 0.0
    assert abs(grads[1] / grads[0] - 1.0) <= 1e-10


def counted(fn):
    """``fn()``'s result and the launches of K1, K3 and K4 during it."""
    wrappers = (j2_cuda.j2_radial_return, bg.banded_take_csr, bg.banded_take_ell)
    before = [w.launches for w in wrappers]
    out = fn()
    torch.cuda.synchronize()
    return out, {w.__name__: w.launches - b for w, b in zip(wrappers, before)}


def test_blocked_interface_host_solve_card_vs_cpu(card):
    """The multimaterial demo twin's blocked LU solve (20 x 10 P1, J2 on both
    sides): the same Newton count on card and CPU, both fields to 1e-8;
    K1 runs both materials, K3 the interface's fixed-order sums."""
    from dolfinx_materials_tpu_torch.demos import multimaterial_interface as mmi

    out = {}
    for dev in ("cpu", card):
        b = mmi.build(device=dev)
        (ok, its), launches = counted(b["blocked"].solve)
        assert ok
        out[str(dev)] = (its, np.concatenate([p.u.x for p in b["problems"]]))
    assert out["cuda"][0] == out["cpu"][0]
    assert float(np.abs(out["cuda"][1] - out["cpu"][1]).max()) <= 1e-8 * np.abs(out["cpu"][1]).max()
    assert launches["j2_radial_return"] > 0 and launches["banded_take_csr"] > 0


def test_blocked_fused_step_card_vs_cpu(card):
    """The fused blocked step on a 48 x 24 P2 interface plate (both fields on
    the banded route): card against CPU, z and p to 1e-8 of scale with equal
    Newton counts; K1, K3 and K4 all launch on the card. The BiCGStab counts
    (~1,400) may differ by a few iterations: the card's dots and batched
    products round in another order than the CPU's, and the stopping test
    at 1e-8 of |b| meets that rounding (1,429 against 1,415 on an H100)."""
    from dolfinx_materials_tpu_torch.demos import multimaterial_interface as mmi
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_blocked_step

    out = {}
    for dev in ("cpu", card):
        # the demo's plate on a 48 x 24 P2 parent, the inclusion's right edge
        # pulled from the uniform stretch
        b = mmi.build(48, 24, 2, device=dev, pull=1.5e-2)
        assert all(q.domain.banded_active for q in b["qmaps"])
        blocked = b["blocked"]
        step, pad = make_sharded_blocked_step(blocked, device_mesh(1, devices=[dev]), n_newton=12, n_cg=4000)
        mask, vals = blocked._masks()
        states = pad([q.material.data_manager.s0.internal for q in b["qmaps"]])
        z0 = torch.where(mask, vals, torch.as_tensor(b["start"], device=dev))
        (z, st, rn), launches = counted(lambda: step(z0, states, mask, vals, 0.0))
        assert float(rn) <= 1e-7 * E
        out[str(dev)] = (z.cpu(), [s["p"].cpu() for s in st], step.info["newton"], step.info["bicgstab"])
    (zc, pc, nc, kc), (zh, ph, nh, kh) = out["cuda"], out["cpu"]
    assert nc == nh and abs(kc - kh) <= 0.05 * kh
    assert float((zc - zh).abs().max()) <= 1e-8 * float(zh.abs().max())
    for a, b_ in zip(pc, ph):
        assert float(b_.max()) > 0 and float((a - b_).abs().max()) <= 1e-8 * float(b_.abs().max())
    assert all(n > 0 for n in launches.values()), launches


def test_blocked_thermo_step_and_host_solve_card_vs_cpu(card):
    """The stiff thermo-mechanical coupling (cross-field blocks both ways,
    generic path) at N = 6: the host LU solve and the fused step on card and
    CPU, z to 1e-8 with equal counts."""
    from dolfinx_materials_tpu_torch.demos.blocked_thermomechanics import build
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_blocked_step

    out = {}
    for dev in ("cpu", card):
        heat, mech, qT, qu, coups = build(6, dev)
        ok, its = tdm.BlockedNonlinearProblem([heat, mech], coups, options={"ksp_type": "lu"}).solve()
        assert ok
        z_lu = np.concatenate([heat.u.x, mech.u.x])
        heat, mech, qT, qu, coups = build(6, dev)
        blocked = tdm.BlockedNonlinearProblem([heat, mech], coups)
        step, pad = make_sharded_blocked_step(blocked, device_mesh(1, devices=[dev]), n_newton=16, n_cg=400)
        mask, vals = blocked._masks()
        z0 = torch.where(mask, vals, torch.as_tensor(np.concatenate([heat.u.x, mech.u.x]), device=dev))
        z, _, rn = step(z0, pad([q.material.data_manager.s0.internal for q in (qT, qu)]), mask, vals, 0.0)
        assert float(rn) <= 1e-7 * E
        out[str(dev)] = (its, z_lu, step.info["newton"], step.info["bicgstab"], z.cpu().numpy())
    c, h = out["cuda"], out["cpu"]
    assert (c[0], c[2], c[3]) == (h[0], h[2], h[3])
    for a, b in ((c[1], h[1]), (c[4], h[4])):
        assert float(np.abs(a - b).max()) <= 1e-8 * np.abs(b).max()


#: two NCCL ranks, one a card: a summed vector, the same sum captured in a
#: CUDA graph and replayed, then the end of the worker
TWO_RANKS = """
import sys
import torch
import torch.distributed as dist
from dolfinx_materials_tpu_torch.parallel import multiprocess as mp
pid, n, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dev = mp.initialize(pid, n, coord)
x = torch.full((1024,), float(pid + 1), device=dev, dtype=torch.float64)
dist.all_reduce(x)
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    y = x.clone()
    dist.all_reduce(y)
torch.cuda.current_stream().wait_stream(side)
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph, stream=side):
    y = x.clone()
    dist.all_reduce(y)
graph.replay()
torch.cuda.synchronize()
print(f"rank {pid}: {x[0].item()} {y[0].item()}", flush=True)
mp.exit_worker()
"""


def test_two_nccl_ranks_sum_and_end(card):
    """Two NCCL ranks on two cards sum a vector, eagerly and in a replayed
    CUDA graph, and their processes end: ``exit_worker`` skips NCCL's
    teardown, which hung between two H100s after the last collective."""
    import os
    import sys

    from dolfinx_materials_tpu_torch.parallel import multiprocess as mp

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = mp.launch([sys.executable, "-c", TWO_RANKS], 2, timeout=120, cwd=repo)
    for pid, out in enumerate(outs):
        assert f"rank {pid}: 3.0 6.0" in out, out[-2000:]
