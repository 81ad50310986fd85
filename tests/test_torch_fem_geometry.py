"""Curved (isoparametric) geometry, cell centers, the space API and the flat
internal-state setter of dolfinx_materials_tpu_torch against the JAX package,
on the CPU in float64: curved meshes node for node, curved quadrature
domains (x_q, dN/dx, w detJ) to 1e-13, the rest exactly."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.fem.assembly import QuadratureDomain as JDomain  # noqa: E402
from dolfinx_materials_tpu.state import MaterialStateManager as JState  # noqa: E402

from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.fem.assembly import QuadratureDomain as TDomain  # noqa: E402
from dolfinx_materials_tpu_torch.state import MaterialStateManager as TState  # noqa: E402

torch.set_num_threads(1)


def polar(x):
    r, th = x[:, 0], x[:, 1]
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=1)


def bulge(x):
    """A smooth 3D map that curves every face of the unit box."""
    return x + 0.1 * x**2 + 0.05 * np.sin(np.pi * x[:, [1, 2, 0]])


# name -> (mesh builder taking the fem module, transform)
CURVED = {
    "annulus_quad": (lambda f: f.create_rectangle((1.0, 0.0), (2.0, np.pi / 2), (3, 4), "quad"), polar),
    "annulus_triangle": (lambda f: f.create_rectangle((1.0, 0.0), (2.0, np.pi / 2), (3, 2), "triangle"), polar),
    "hexahedron": (lambda f: f.create_box((0, 0, 0), (1, 1, 1), (2, 2, 1), "hexahedron"), bulge),
    "tetrahedron": (lambda f: f.create_box((0, 0, 0), (1, 1, 1), (2, 1, 1), "tetrahedron"), bulge),
}


@pytest.mark.parametrize("name", sorted(CURVED))
def test_curve_mesh_matches_jax(name):
    build, transform = CURVED[name]
    jm, tm = jfem.curve_mesh(build(jfem), transform), tfem.curve_mesh(build(tfem), transform)
    assert tm.geom_degree == jm.geom_degree == 2
    np.testing.assert_array_equal(tm.geom_cells, jm.geom_cells)
    np.testing.assert_allclose(tm.geom_points, jm.geom_points, rtol=0, atol=1e-15)
    np.testing.assert_allclose(tm.points, jm.points, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(tm.cell_centers(), jm.cell_centers())
    assert tm.grid == jm.grid


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("name", sorted(CURVED))
def test_curved_domain_matches_jax(name, degree):
    """The isoparametric map: Gauss points, shape-function gradients and the
    weighted Jacobian determinant to 1e-13; degree-2 nodes sit on the curved
    geometry nodes."""
    build, transform = CURVED[name]
    jm, tm = jfem.curve_mesh(build(jfem), transform), tfem.curve_mesh(build(tfem), transform)
    jV, tV = jfem.FunctionSpace(jm, degree, (jm.dim,)), tfem.FunctionSpace(tm, degree, (tm.dim,))
    np.testing.assert_allclose(tV.node_coords, jV.node_coords, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(tV.dofmap, jV.dofmap)
    jd, td = JDomain(jV, 2 * degree), TDomain(tV, 2 * degree, device="cpu")
    for attr in ("x_q", "dNdx", "wdetJ", "cell_volumes"):
        want = np.asarray(getattr(jd, attr))
        got = getattr(td, attr).numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-13, f"{attr}: {err:.2e}"
    # the curved area/volume differs from the straight one
    straight = TDomain(tfem.FunctionSpace(build(tfem), degree, ()), 2 * degree, device="cpu")
    assert abs(float(td.cell_volumes.sum() - straight.cell_volumes.sum())) > 1e-3


def test_curved_annulus_area_is_exact_to_quadrature():
    """The quarter annulus of radii 1 and 2 has area 3 pi / 4; the straight
    chords miss it by O(h^2), the degree-2 geometry by far less."""
    build, transform = CURVED["annulus_quad"]
    curved = TDomain(tfem.FunctionSpace(tfem.curve_mesh(build(tfem), transform), 1, ()), 4, device="cpu")
    chords = build(tfem)
    chords.points = transform(chords.points)
    straight = TDomain(tfem.FunctionSpace(chords, 1, ()), 4, device="cpu")
    exact = 3 * np.pi / 4
    err_c = abs(float(curved.cell_volumes.sum()) - exact)
    err_s = abs(float(straight.cell_volumes.sum()) - exact)
    assert err_c < 1e-2 * err_s


@pytest.mark.parametrize("cell,degree,shape", [("quad", 2, (2,)), ("triangle", 1, ()), ("hexahedron", 2, (3,)),
                                               ("tetrahedron", 2, (3,))])
def test_space_api_matches_jax(cell, degree, shape):
    def build(f):
        if cell in ("quad", "triangle"):
            return f.create_rectangle((0, 0), (1, 2), (3, 2), cell)
        return f.create_box((0, 0, 0), (1, 1, 2), (2, 1, 2), cell)

    jV, tV = jfem.FunctionSpace(build(jfem), degree, shape), tfem.FunctionSpace(build(tfem), degree, shape)
    np.testing.assert_array_equal(tV.dof_coords(), jV.dof_coords())
    for comp in range(tV.ncomp):
        np.testing.assert_array_equal(tV.component_dofs(comp), jV.component_dofs(comp))
    np.testing.assert_array_equal(tV.mesh.cell_centers(), jV.mesh.cell_centers())

    def field(x):
        vals = np.stack([x[:, 0] ** 2 - x[:, 1], 3 * x[:, 1] * x[:, -1], np.sin(x[:, 0])], axis=1)
        return vals[:, : tV.ncomp] if shape else vals[:, 0]

    jf, tf = jfem.Function(jV).interpolate(field), tfem.Function(tV).interpolate(field)
    np.testing.assert_array_equal(tf.x, jf.x)
    g = tf.copy()
    assert g.space is tV and g.name == tf.name and g.dtype == tf.dtype
    np.testing.assert_array_equal(g.x, tf.x)
    g.x[0] += 1.0
    assert tf.x[0] != g.x[0]  # a copy, not a view
    assert tfem.Function(tV, dtype=torch.float32).interpolate(field).x.dtype == np.float32


def test_set_internal_from_flat_matches_jax():
    """The flat internal-state view (columns by sorted name) written back
    through set_internal_from_flat, in both packages."""
    n = 7
    el = (70e3, 0.3)
    jbeh = jmodels.vonMisesIsotropicHardening(jmodels.LinearElasticIsotropic(*el), jmodels.LinearHardening(350.0, 2e3))
    tbeh = tmodels.vonMisesIsotropicHardening(tmodels.LinearElasticIsotropic(*el), tmodels.LinearHardening(350.0, 2e3))
    js, ts = JState(jbeh, n, jnp.float64), TState(tbeh, n, device="cpu")
    flat = np.random.default_rng(0).normal(size=(n, ts.internal_size))
    assert ts.internal_size == js.internal_size == 7
    js.set_internal_from_flat(jnp.asarray(flat))
    ts.set_internal_from_flat(flat)
    np.testing.assert_array_equal(ts.internal_state_variables.numpy(), np.asarray(js.internal_state_variables))
    np.testing.assert_array_equal(ts.internal_state_variables.numpy(), flat)
    for k in ("eps_p", "p"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
        assert ts.internal[k].shape == tuple(js.internal[k].shape)
