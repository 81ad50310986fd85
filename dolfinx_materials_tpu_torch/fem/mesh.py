"""Meshes: a static-shape mesh container and structured rectangle and box
generators.

Host-side numpy (meshes are built once); the vertex and cell numbering is the
lattice order, identical to the JAX package's: node ``i*(ny+1)+j`` and cell
``i*ny+j`` in 2D, node ``(i*(ny+1)+j)*(nz+1)+k`` and cell ``(i*ny+j)*nz+k``
in 3D.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .element import CELL_DIM, CELL_VERTS, EDGES, FACETS


@dataclass
class Mesh:
    points: np.ndarray  # (npoints, dim) float64 vertex coordinates
    cells: np.ndarray  # (ncells, nverts) int32 vertex indices
    cell_type: str
    #: structured-grid metadata (nx, ny[, nz]) of the generators; enables
    #: the stencil (shifted-slice) gathers of QuadratureDomain on P1 spaces
    grid: tuple | None = None

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64)
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int32)
        assert self.cells.shape[1] == CELL_VERTS[self.cell_type]

    @property
    def dim(self):
        return CELL_DIM[self.cell_type]

    @property
    def num_cells(self):
        return len(self.cells)

    @property
    def num_vertices(self):
        return len(self.points)

    def edges(self):
        """Unique edges as sorted vertex pairs + per-cell edge indices:
        ``(edge_verts (nedges, 2), cell_edges (ncells, nle))``, numbered in
        first-seen order (the JAX package's native engine's numbering)."""
        return _unique_entities(self.cells, EDGES[self.cell_type])

    def faces(self):
        """Unique faces of 3D cells as sorted vertex tuples + per-cell face
        indices in ``element.FACETS`` order, first-seen numbering."""
        return _unique_entities(self.cells, FACETS[self.cell_type])

    def cell_centers(self):
        return self.points[self.cells].mean(axis=1)


def _unique_entities(cells, local):
    """Unique sub-entities (edges/faces given by local vertex tuples) as
    sorted vertex tuples in first-seen order, and per-cell entity ids."""
    loc = np.array(local)
    ev = np.sort(cells[:, loc], axis=2).reshape(-1, loc.shape[1])
    uniq, first, inverse = np.unique(ev, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    ids = rank[inverse.ravel()].reshape(len(cells), len(loc)).astype(np.int32)
    return uniq[order].astype(np.int32), ids


def create_rectangle(p0, p1, n, cell_type="quad"):
    """Structured rectangle mesh of ``n=(nx, ny)`` cells ('quad' or 'triangle')."""
    nx, ny = n
    x = np.linspace(p0[0], p1[0], nx + 1)
    y = np.linspace(p0[1], p1[1], ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)
    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = (I * (ny + 1) + J).ravel()
    v10 = v00 + (ny + 1)
    quads = np.stack([v00, v10, v10 + 1, v00 + 1], axis=1).astype(np.int32)
    if cell_type == "quad":
        return Mesh(points, quads, "quad", grid=(nx, ny))
    if cell_type == "triangle":
        tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=0)
        return Mesh(points, tris, "triangle")
    raise ValueError(cell_type)


def create_unit_square(nx, ny, cell_type="quad"):
    return create_rectangle((0.0, 0.0), (1.0, 1.0), (nx, ny), cell_type)


def create_box(p0, p1, n, cell_type="hexahedron"):
    """Structured box mesh of ``n=(nx, ny, nz)`` cells ('hexahedron' or
    'tetrahedron': the Kuhn split, 6 tets a hex, conforming across faces)."""
    nx, ny, nz = n
    axes = [np.linspace(p0[d], p1[d], n[d] + 1) for d in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    I, J, K = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    hexes = np.stack([
        vid(I, J, K), vid(I + 1, J, K), vid(I + 1, J + 1, K), vid(I, J + 1, K),
        vid(I, J, K + 1), vid(I + 1, J, K + 1), vid(I + 1, J + 1, K + 1), vid(I, J + 1, K + 1),
    ], axis=1).astype(np.int32)
    if cell_type == "hexahedron":
        return Mesh(points, hexes, "hexahedron", grid=(nx, ny, nz))
    if cell_type == "tetrahedron":
        h = hexes
        tets = np.concatenate([
            h[:, [0, 1, 2, 6]], h[:, [0, 2, 3, 6]], h[:, [0, 3, 7, 6]],
            h[:, [0, 7, 4, 6]], h[:, [0, 4, 5, 6]], h[:, [0, 5, 1, 6]],
        ])
        return Mesh(points, tets, "tetrahedron")
    raise ValueError(cell_type)


def create_unit_cube(nx, ny, nz, cell_type="hexahedron"):
    return create_box((0, 0, 0), (1, 1, 1), (nx, ny, nz), cell_type)
