"""Boundary facets, traction and body-force vectors of
dolfinx_materials_tpu_torch/fem/facets.py against the JAX package's, on the
CPU in float64: straight P1/P2 meshes, curved degree-2 meshes (the facet
loads on the degree-2 trace of the geometry), P2 tets and Q2 hexes, constant
and coordinate-dependent loads, to 1e-12 of the vector's scale."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from dolfinx_materials_tpu import fem as jfem  # noqa: E402

from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402

torch.set_num_threads(1)


def polar(x):
    r, th = x[:, 0], x[:, 1]
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=1)


def bulge(x):
    return x + 0.1 * x**2 + 0.05 * np.sin(np.pi * x[:, [1, 2, 0]])


# name -> (mesh builder on a fem module, degree, traction selector)
MESHES = {
    "quad_p1": (lambda f: f.create_rectangle((0, 0), (1, 2), (3, 4), "quad"), 1,
                lambda x: np.isclose(x[:, 1], 2.0)),
    "triangle_p2": (lambda f: f.create_rectangle((0, 0), (1, 2), (3, 4), "triangle"), 2,
                    lambda x: np.isclose(x[:, 0], 1.0)),
    "quad_p2_curved": (lambda f: f.curve_mesh(f.create_rectangle((1.0, 0.0), (2.0, np.pi / 2), (3, 3), "quad"),
                                              polar), 2,
                       lambda x: np.linalg.norm(x, axis=1) < 1.0 + 0.5 / 3),
    "tet_p2": (lambda f: f.create_box((0, 0, 0), (1, 1, 1), (2, 2, 2), "tetrahedron"), 2,
               lambda x: np.isclose(x[:, 2], 1.0)),
    "hex_q2": (lambda f: f.create_box((0, 0, 0), (1, 1, 2), (2, 2, 2), "hexahedron"), 2,
               lambda x: np.isclose(x[:, 0], 0.0) | np.isclose(x[:, 2], 2.0)),
    "hex_q2_curved": (lambda f: f.curve_mesh(f.create_box((0, 0, 0), (1, 1, 1), (2, 2, 2), "hexahedron"), bulge),
                      2, lambda x: x[:, 2] > 1.0),
}


def close(got, want, tol=1e-12):
    err = np.abs(np.asarray(got) - np.asarray(want)).max() / max(np.abs(np.asarray(want)).max(), 1e-300)
    assert err <= tol, f"{err:.2e}"


@pytest.mark.parametrize("cell", ["triangle", "quad", "tetrahedron", "hexahedron"])
def test_boundary_facets_match_jax(cell):
    if cell in ("triangle", "quad"):
        build = lambda f: f.create_rectangle((0, 0), (1, 1), (3, 2), cell)  # noqa: E731
    else:
        build = lambda f: f.create_box((0, 0, 0), (1, 1, 1), (2, 2, 1), cell)  # noqa: E731
    jv, jc = jfem.boundary_facets(build(jfem))
    tv, tc = tfem.boundary_facets(build(tfem))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("load", ["constant", "field"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_traction_matches_jax(name, load):
    build, degree, where = MESHES[name]
    jm, tm = build(jfem), build(tfem)
    dim = tm.dim
    value = ([1.5, -2.0, 0.5][:dim] if load == "constant"
             else (lambda x: np.stack([np.sin(x[:, 0]) + x[:, -1] ** 2, x[:, 1] * x[:, 0], x[:, -1] - 1.0][:dim],
                                      axis=1)))
    jV, tV = jfem.FunctionSpace(jm, degree, (dim,)), tfem.FunctionSpace(tm, degree, (dim,))
    want = jfem.assemble_traction(jV, where, value)
    got = tfem.assemble_traction(tV, where, value)
    assert got.shape == (tV.num_dofs,) and np.abs(got).max() > 0
    close(got, want)


@pytest.mark.parametrize("load", ["constant", "field"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_body_force_matches_jax(name, load):
    build, degree, _ = MESHES[name]
    jm, tm = build(jfem), build(tfem)
    dim = tm.dim
    value = ([0.0, -9.81, 1.0][:dim] if load == "constant"
             else (lambda x: np.stack([x[:, 0] * x[:, 1], np.cos(x[:, -1]), x[:, 0] ** 2][:dim], axis=1)))
    jV, tV = jfem.FunctionSpace(jm, degree, (dim,)), tfem.FunctionSpace(tm, degree, (dim,))
    close(tfem.assemble_body_force(tV, value), jfem.assemble_body_force(jV, value))
    cells = np.arange(0, tm.num_cells, 2)
    close(tfem.assemble_body_force(tV, value, cells=cells), jfem.assemble_body_force(jV, value, cells=cells))


def test_traction_integrates_the_load():
    """A unit radial traction on the curved inner arc (R_i = 1) of the
    quarter annulus sums to the resultant (1, 1) R_i: the degree-2 trace
    integrates it to the accuracy of its geometry."""
    build, _, _ = MESHES["quad_p2_curved"]
    chords = tfem.create_rectangle((1.0, 0.0), (2.0, np.pi / 2), (3, 3), "quad")
    chords.points = polar(chords.points)
    arc = lambda x: np.linalg.norm(x, axis=1) < 1.05  # noqa: E731 — facet midpoints on r = 1 only
    errors = []
    for mesh in (build(tfem), chords):
        V = tfem.FunctionSpace(mesh, 2, (2,))
        F = tfem.assemble_traction(V, arc, lambda x: x / np.linalg.norm(x, axis=1, keepdims=True))
        errors.append(np.abs(F.reshape(-1, 2).sum(axis=0) - 1.0).max())
    assert errors[0] < 1e-4 and errors[0] < 1e-2 * errors[1], errors


def test_no_facet_selected_raises():
    V = tfem.FunctionSpace(tfem.create_rectangle((0, 0), (1, 1), (2, 2), "quad"), 1, (2,))
    with pytest.raises(ValueError, match="no boundary facets"):
        tfem.assemble_traction(V, lambda x: x[:, 0] > 5.0, [1.0, 0.0])
