"""The port's Krylov pieces against the JAX package, in float64 on the CPU:

- ``parallel/krylov.py`` (``_pbicgstab``, ``_sym_block_inv``, ``_norm2``) on
  seeded systems;
- ``NonlinearMaterialProblem`` with ``ksp_type`` "bicgstab" and "gmres" and
  with ``ksp_precision="f32"`` on the 16x32 J2 plate;
- ``parallel/coarse.py``: the three coarse-space builders, bitwise;
- the fixed-order sum that assembles the two-level coarse operators.
"""

import numpy as np
import pytest
import torch
from test_torch_solve_plate import plate

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu.parallel import coarse as jcoarse  # noqa: E402
from dolfinx_materials_tpu.parallel import krylov as jkrylov  # noqa: E402

from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch.ops import banded_gather as bg  # noqa: E402
from dolfinx_materials_tpu_torch.parallel import coarse as tcoarse  # noqa: E402
from dolfinx_materials_tpu_torch.parallel import krylov as tkrylov  # noqa: E402

torch.set_num_threads(1)


def systems(n=80, seed=0):
    """A seeded SPD and a non-symmetric (diagonally dominant) system."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    spd = G @ G.T + n * np.eye(n)
    nonsym = rng.standard_normal((n, n)) + 2 * np.sqrt(n) * np.eye(n)
    return {"spd": spd, "nonsym": nonsym}, rng.standard_normal(n)


@pytest.mark.parametrize("kind", ["spd", "nonsym"])
@pytest.mark.parametrize("maxiter", [3, 200])
def test_pbicgstab_matches_jax(kind, maxiter):
    """Jacobi-preconditioned, with a budget that ends the loop early and one
    the tolerance ends: x to 1e-10 of its scale (the same iteration; the
    dots differ only in summation order)."""
    mats, b = systems()
    A = mats[kind]
    d = np.diag(A).copy()
    At, bt, dt = (torch.as_tensor(a) for a in (A, b, d))
    x_t = tkrylov._pbicgstab(lambda v: At @ v, bt, lambda v: v / dt, maxiter, 1e-10)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    x_j = np.asarray(jkrylov._pbicgstab(lambda v: Aj @ v, jnp.asarray(b), lambda v: v / dj, maxiter, 1e-10))
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=1e-10 * np.abs(x_j).max())
    if maxiter == 200:
        np.testing.assert_allclose(A @ x_t.numpy(), b, rtol=0, atol=1e-8 * np.abs(b).max())


def test_sym_block_inv_and_norm2_match_jax():
    """Node blocks with a 1e6 spread of scales and an asymmetric rounding
    perturbation: the SPD-preserving inverse to 1e-12 of its scale."""
    rng = np.random.default_rng(1)
    G = rng.standard_normal((50, 3, 3))
    B = G @ np.swapaxes(G, 1, 2) + 3 * np.eye(3)
    B = B * (10.0 ** rng.uniform(0, 6, 50))[:, None, None] + 1e-9 * rng.standard_normal((50, 3, 3))
    got = tkrylov._sym_block_inv(torch.as_tensor(B), torch.eye(3, dtype=torch.float64)).numpy()
    want = np.asarray(jkrylov._sym_block_inv(jnp.asarray(B), jnp.eye(3)))
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) <= 1e-12 * scale).all()
    assert (np.abs(got - np.swapaxes(got, 1, 2)) <= 1e-15 * scale).all()  # symmetric to rounding
    v = rng.standard_normal(97)
    np.testing.assert_allclose(float(tkrylov._norm2(torch.as_tensor(v))), float(jkrylov._norm2(jnp.asarray(v))),
                               rtol=1e-15)


# ------------------------------------------------------ Krylov options
LOADS = (0.005, 0.0075)


def plate_run(which, options):
    """Two load steps, each started from the uniform stretch u_y = load y /
    2 (from the last displacement the whole increment sits in the top row of
    cells and Newton takes 15-20 iterations)."""
    prob, qmap, top = plate(which)
    for k, v in options.items():
        setattr(prob, k, v)
    y = prob.u.space.node_coords[:, 1]
    its = []
    for load in LOADS:
        top.set(load)
        lifted = np.asarray(prob.u.x).reshape(-1, 2).copy()
        lifted[:, 1] = load * y / 2.0
        prob.u.x = lifted.reshape(-1)
        converged, n = prob.solve()
        assert converged, load
        its.append(n)
    return np.asarray(prob.u.x), np.asarray(qmap.field_array("p")).ravel(), its


@pytest.mark.parametrize("options", [
    dict(ksp_type="bicgstab"),
    dict(ksp_type="gmres"),
    dict(ksp_precision="f32"),
], ids=["bicgstab", "gmres", "f32"])
def test_krylov_options_on_the_plate_match_jax(options):
    """The 16x32 P2 J2 plate (banded route in the port), two load steps:
    u and p to 1e-8 of their scale with equal Newton counts. Both packages
    run the same Krylov iteration; under ksp_precision="f32" each Krylov
    solve is f32-accurate (1e-6) in both, and Newton's f64 residual takes
    both to the same f64 solution."""
    ut, pt, it = plate_run("torch", options)
    uj, pj, ij = plate_run("jax", options)
    assert it == ij
    assert pj.max() > 0
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8 * np.abs(uj).max())
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-8 * np.abs(pj).max())


def test_krylov_options_are_checked():
    prob, _, _ = plate("torch")
    with pytest.raises(ValueError, match="ksp_type"):
        type(prob)(prob.qmaps, prob.u, options={"ksp_type": "minres"})
    with pytest.raises(ValueError, match="ksp_precision"):
        type(prob)(prob.qmaps, prob.u, options={"ksp_precision": "bf16"})


# ------------------------------------------------------ coarse spaces
def spaces(degree, cell, n=(6, 9)):
    return [fem.FunctionSpace(fem.create_rectangle((0, 0), (1.0, 1.5), n, cell), degree, (2,))
            for fem in (tfem, jfem)]


@pytest.mark.parametrize("modes", ["trans", "rbm"])
@pytest.mark.parametrize("labelled", [False, True])
def test_coord_agg_modes_bitwise(modes, labelled):
    Vt, Vj = spaces(1, "quad")
    labels = (np.arange(Vt.num_nodes) % 3 == 0).astype(np.int64) if labelled else None
    for pc_boxes in (2, 8):
        got = tcoarse._coord_agg_modes(Vt, pc_boxes, modes=modes, labels=labels)
        want = jcoarse._coord_agg_modes(Vj, pc_boxes, modes=modes, labels=labels)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_coord_agg_cdofs_bitwise():
    Vt, Vj = spaces(1, "quad")
    for pc_boxes in (3, 8):
        got, want = tcoarse._coord_agg_cdofs(Vt, pc_boxes), jcoarse._coord_agg_cdofs(Vj, pc_boxes)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_p1_coarse_bitwise_on_p2_triangles():
    Vt, Vj = spaces(2, "triangle")
    got, want = tcoarse._p1_coarse(Vt), jcoarse._p1_coarse(Vj)
    assert got[0] == want[0] == 2 * Vt.mesh.num_vertices
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="P2 simplex"):
        tcoarse._p1_coarse(spaces(1, "quad")[0])


# ------------------------------------------------------ fixed-order sums
def test_fixed_sum_adds_in_the_kernel_order():
    """The plain version (``index_add_`` on the CPU) against the CSR take's
    own plain version, which adds in the kernel's order: bitwise equal, on
    values spread over 16 decades where any other order rounds otherwise;
    and against an f64 sum to rounding."""
    rng = np.random.default_rng(2)
    target = rng.integers(0, 300, 20_000)
    vals = torch.as_tensor(rng.standard_normal(20_000) * 10.0 ** rng.uniform(-8, 8, 20_000))
    plan = bg.plan_fixed_sum(target.reshape(100, 200), 300)
    got = bg.fixed_sum(vals, plan)
    assert torch.equal(got, bg.compact_take_reference(vals, plan, "csr"))
    want = np.zeros(300)
    np.add.at(want, target, vals.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert plan.csr_idx.dtype == torch.int32 and int(plan.csr_ptr[-1]) == 20_000
