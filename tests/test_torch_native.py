"""The port's host mesh engine (dolfinx_materials_tpu_torch/native,
fastmesh.cpp built with g++ into build/native/) against the port's numpy
route and the JAX package's generators: the same points, cells, edges and
faces, in the same numbering."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

from dolfinx_materials_tpu import fem as jfem  # noqa: E402

from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch import native  # noqa: E402
from dolfinx_materials_tpu_torch.fem import mesh as tmesh  # noqa: E402
from dolfinx_materials_tpu_torch.fem.element import EDGES, FACETS  # noqa: E402


def test_engine_builds_outside_the_jax_package():
    """g++ is present here: the library is built from the port's own source
    into build/native/ (never into the JAX package)."""
    assert native._load() is not None
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert "dolfinx_materials_tpu/" not in str(path) and native.SOURCE.parent.name == "native"


@pytest.mark.parametrize("n,p0,p1", [((7, 5), (0.0, 0.0), (2.0, 1.0)), ((3, 9), (-1.0, 0.5), (1.0, 1.7))])
def test_quad_generator_matches_numpy_and_jax(n, p0, p1):
    pts, cells = native.structured_quad_mesh(*n, p0, p1)
    npts, ncells = tmesh._structured_quad_numpy(*n, p0, p1)
    np.testing.assert_array_equal(pts, npts)
    np.testing.assert_array_equal(cells, ncells)
    for cell in ("quad", "triangle"):
        t, j = tfem.create_rectangle(p0, p1, n, cell), jfem.create_rectangle(p0, p1, n, cell)
        np.testing.assert_array_equal(t.points, j.points)
        np.testing.assert_array_equal(t.cells, j.cells)
        assert t.grid == j.grid


@pytest.mark.parametrize("n", [(3, 2, 2), (1, 4, 3)])
def test_hex_generator_matches_numpy_and_jax(n):
    p0, p1 = (0.0, -1.0, 0.5), (1.0, 1.0, 2.0)
    pts, cells = native.structured_hex_mesh(*n, p0, p1)
    npts, ncells = tmesh._structured_hex_numpy(*n, p0, p1)
    np.testing.assert_array_equal(pts, npts)
    np.testing.assert_array_equal(cells, ncells)
    for cell in ("hexahedron", "tetrahedron"):
        t, j = tfem.create_box(p0, p1, n, cell), jfem.create_box(p0, p1, n, cell)
        np.testing.assert_array_equal(t.points, j.points)
        np.testing.assert_array_equal(t.cells, j.cells)


@pytest.mark.parametrize("cell", ["triangle", "quad", "tetrahedron", "hexahedron"])
def test_edges_and_faces_match_numpy_and_jax(cell):
    if cell in ("triangle", "quad"):
        t, j = (f.create_rectangle((0, 0), (1, 1), (4, 3), cell) for f in (tfem, jfem))
    else:
        t, j = (f.create_box((0, 0, 0), (1, 1, 1), (3, 2, 2), cell) for f in (tfem, jfem))
        t = tfem.reorder_mesh(tfem.Mesh(t.points, t.cells[::-1].copy(), cell))  # not lattice-ordered
        j = jfem.Mesh(t.points, t.cells, cell)
    ev = t.cells[:, np.array(EDGES[cell])]
    for got, want in zip(native.unique_edges(ev), tmesh._unique_entities(ev)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t.edges(), j.edges()):
        np.testing.assert_array_equal(got, want)
    if t.dim == 3:
        fv = t.cells[:, np.array(FACETS[cell])]
        for got, want in zip(native.unique_faces(fv), tmesh._unique_entities(fv)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(t.faces(), j.faces()):
            np.testing.assert_array_equal(got, want)
    # the degree-2 dofmaps built on them agree
    tV, jV = tfem.FunctionSpace(t, 2, (t.dim,)), jfem.FunctionSpace(j, 2, (j.dim,))
    np.testing.assert_array_equal(tV.dofmap, jV.dofmap)
    np.testing.assert_array_equal(tV.node_coords, jV.node_coords)
