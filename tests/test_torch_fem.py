"""The port's FEM layer against the JAX package, in float64.

Shape-function tables and quadrature rules, meshes and P2 spaces (exact or to
1e-12), and on the 16x32 P2 plate (banded route on in the port, gather-map
route in the JAX package on the CPU) the QuadratureDomain's gather, residual,
element matrices, SpMV, diagonal, DG-0 projection and the two-level
preconditioner's apply, to 1e-12 relative: the two sides differ in summation
order only.
"""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.fem import assembly as jasm  # noqa: E402
from dolfinx_materials_tpu.fem import element as jel  # noqa: E402
from dolfinx_materials_tpu.fem import forms as jforms  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.fem import assembly as tasm  # noqa: E402
from dolfinx_materials_tpu_torch.fem import element as tel  # noqa: E402
from dolfinx_materials_tpu_torch.fem import forms as tforms  # noqa: E402

# one intra-op thread: the suite runs several pytest workers on one machine,
# and spinning thread pools in each of them starve one another
torch.set_num_threads(1)

RTOL = 1e-12


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("cell", ["triangle", "quad", "tetrahedron", "hexahedron"])
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("qdeg", [2, 4])
def test_reference_element_tables_match_jax(cell, degree, qdeg):
    t, j = tel.ReferenceElement(cell, degree, qdeg), jel.ReferenceElement(cell, degree, qdeg)
    for f in ("nodes", "qpoints", "qweights", "N", "dN"):
        close(getattr(t, f), getattr(j, f))
    pts = np.random.default_rng(0).random((5, t.dim)) / t.dim
    close(t.tabulate(pts), j.tabulate(pts))


@pytest.mark.parametrize("cell", ["triangle", "tetrahedron"])
def test_simplex_quadrature_rules_match_jax(cell):
    for deg in range(1, 9):  # symmetric rules, then the Duffy collapse
        for a, b in zip(tel.quadrature_rule(cell, deg), jel.quadrature_rule(cell, deg)):
            close(a, b)


@pytest.mark.parametrize("cell", ["quad", "triangle"])
def test_mesh_and_p2_space_match_jax(cell):
    tm = tfem.create_rectangle((0.0, 0.0), (1.0, 2.0), (6, 9), cell)
    jm = jfem.create_rectangle((0.0, 0.0), (1.0, 2.0), (6, 9), cell)
    np.testing.assert_array_equal(tm.points, jm.points)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    for a, b in zip(tm.edges(), jm.edges()):
        np.testing.assert_array_equal(a, b)
    tV = tfem.FunctionSpace(tm, degree=2, shape=(2,))
    jV = jfem.FunctionSpace(jm, degree=2, shape=(2,))
    np.testing.assert_array_equal(tV.node_coords, jV.node_coords)
    np.testing.assert_array_equal(tV.dofmap, jV.dofmap)
    np.testing.assert_array_equal(tV.node_renum, jV.node_renum)


@pytest.fixture(scope="module")
def plate():
    """Both packages' 16x32 P2 plates with random fields and tangents."""
    tV = tfem.FunctionSpace(tfem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "quad"), 2, (2,))
    jV = jfem.FunctionSpace(jfem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "quad"), 2, (2,))
    tdom, jdom = tasm.QuadratureDomain(tV, 4, device="cpu"), jasm.QuadratureDomain(jV, 4)
    assert tdom.banded_active
    rng = np.random.default_rng(0)
    n = tdom.num_points
    A = rng.standard_normal((n, 6, 6))
    data = dict(
        u=rng.standard_normal(tV.num_dofs) * 1e-3,
        v=rng.standard_normal(tV.num_dofs),
        field=rng.standard_normal((n, 6)),
        C=np.einsum("nij,nkj->nik", A, A) + 6 * np.eye(6),
    )
    return tV, jV, tdom, jdom, data


def both(data, key):
    return torch.as_tensor(data[key]), jnp.asarray(data[key])


def test_domain_gather_residual_matrices_spmv(plate):
    tV, jV, tdom, jdom, d = plate
    tu, ju = both(d, "u")
    close(tdom.gather(tu), jdom.gather(ju))
    te, je = tforms.mandel_strain_2d(), jforms.mandel_strain_2d()
    close(tdom.make_eval(te)(tu), jdom.make_eval(je)(ju))
    tf, jf = both(d, "field")
    close(tdom.make_residual([te])(tu, [tf]), jdom.make_residual([je])(ju, [jf]))
    tC, jC = both(d, "C")
    tK = tdom.make_element_matrices([te], [(0, te, None)])(tu, [tf], [tC])
    jK = jdom.make_element_matrices([je], [(0, je, None)])(ju, [jf], [jC])
    close(tK, jK)
    tv, jv = both(d, "v")
    close(tdom.spmv(tdom.spmv_prepare(tK), tv), jdom.spmv(jdom.spmv_prepare(jK), jv))
    close(tdom.spmv(tK, tv), jdom.spmv(jK, jv))
    close(tdom.matrix_diagonal(tK, tV.num_dofs), jdom.matrix_diagonal(jK, jV.num_dofs))
    close(tdom.matrix_node_blocks(tK, tV.num_nodes), jdom.matrix_node_blocks(jK, jV.num_nodes))
    close(tasm.project_dg0(tdom, tf), jasm.project_dg0(jdom, jf))


def problems(tV, jV):
    """The J2 plate problem (bottom clamped, top pulled) in both packages."""
    out = []
    for pkg, fem, models, forms, V, kw in (
        (tdm, tfem, tmodels, tforms, tV, dict(device="cpu")),
        (jdm, jfem, jmodels, jforms, jV, {}),
    ):
        mat = pkg.Material(models.vonMisesIsotropicHardening(
            models.LinearElasticIsotropic(70e3, 0.3), models.VoceHardening(350.0, 500.0, 1e3)), **kw)
        qmap = pkg.QuadratureMap(V, 4, mat)
        qmap.register_gradient("Strain", forms.mandel_strain_2d())
        bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0))
        top = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 2.0), 1)
        bcs = [fem.DirichletBC(bottom, 0.0), fem.DirichletBC(top, 1e-3)]
        out.append(pkg.NonlinearMaterialProblem(qmap, fem.Function(V), bcs=bcs))
    return out


def test_two_level_preconditioner_apply_matches_jax(plate):
    """M(v) = v0 / diag + P Ac^-1 P^T v0 (bc rows identity), with the JAX
    package's aggregates, diagonal and element tangents, against the port's
    apply; and one preconditioned CG step of each package's linear solve."""
    tV, jV, tdom, jdom, d = plate
    tp, jp = problems(tV, jV)
    mask_np, vals = jfem.bc.combine_bcs(jp.bcs, jV.num_dofs)
    u0 = np.where(mask_np, vals, 0.0)
    tp._constitutive_update(torch.as_tensor(u0))
    jp._constitutive_update(jnp.asarray(u0))
    tK, jK = tp._element_matrices(torch.as_tensor(u0)), jp._element_matrices(jnp.asarray(u0))
    close(tK[0], jK[0])
    mask = torch.as_tensor(mask_np)
    v = d["v"]
    got = tp._preconditioner(tK, mask)(torch.as_tensor(v)).numpy()

    # the JAX package's two-level formula (solvers.py, pc_type="two_level")
    agg, nagg = (np.asarray(a) for a in jp._node_aggregates())
    nagg = int(nagg)
    K = np.asarray(jK[0])
    dm = np.asarray(jdom.dofmap)
    diag = np.asarray(jdom.matrix_diagonal(jK[0], jV.num_dofs))
    diag = np.where(mask_np | (np.abs(diag) < 1e-30), 1.0, diag)
    nc = 2
    w = (~mask_np).astype(float)[dm]
    cd = agg[dm // nc] * nc + dm % nc
    Ac = np.zeros((nagg * nc, nagg * nc))
    np.add.at(Ac, (cd[:, :, None], cd[:, None, :]), K * w[:, :, None] * w[:, None, :])
    dAc = np.diag(Ac).copy()
    ridge = 1e-10 * np.abs(dAc).max() + 1e-30
    Ac += ridge * np.eye(len(Ac)) + np.diag((np.abs(dAc) < ridge).astype(float))
    v0 = np.where(mask_np, 0.0, v)
    rc = np.zeros((nagg, nc))
    np.add.at(rc, agg, v0.reshape(-1, nc))
    wc = np.linalg.solve(Ac, rc.ravel()).reshape(nagg, nc)
    want = np.where(mask_np, v, v0 / diag + wc[agg].ravel())
    close(got, want)

    # one CG step through each package's own linear solve
    tp.ksp_rtol = jp.ksp_rtol = 1e-12
    tp.ksp_maxiter = jp.ksp_maxiter = 1
    rhs = d["field"][: jV.num_dofs, 0]
    du_t, its = tp._linear_solve(tK, torch.as_tensor(rhs), mask)
    du_j = jp._linear_solve(jK, jnp.asarray(rhs), mask_np)
    assert its == 1
    close(du_t, du_j)
