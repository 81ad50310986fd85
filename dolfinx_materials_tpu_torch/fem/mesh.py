"""Meshes: a static-shape mesh container, structured rectangle and box
generators, and degree-2 (curved) geometry.

Host-side (meshes are built once): the generators and the edge/face
extraction run in the host engine of ``native/`` (g++), or in numpy where no
compiler is found, with the same results. The vertex and cell numbering is
the lattice order, identical to the JAX package's: node ``i*(ny+1)+j`` and
cell ``i*ny+j`` in 2D, node ``(i*(ny+1)+j)*(nz+1)+k`` and cell
``(i*ny+j)*nz+k`` in 3D; edges and faces are numbered in first-seen order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from .element import CELL_DIM, CELL_VERTS, EDGES, FACETS


@dataclass
class Mesh:
    points: np.ndarray  # (npoints, dim) float64 vertex coordinates
    cells: np.ndarray  # (ncells, nverts) int32 vertex indices
    cell_type: str
    #: isoparametric geometry: 1 = multilinear from ``points``; 2 = curved,
    #: with per-cell degree-2 geometry nodes in geom_points/geom_cells (set by
    #: :func:`curve_mesh`, read by assembly.QuadratureDomain and facets.py)
    geom_degree: int = 1
    geom_points: np.ndarray | None = None
    geom_cells: np.ndarray | None = None
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
        first-seen order."""
        ev = self.cells[:, np.array(EDGES[self.cell_type])]
        out = native.unique_edges(ev)
        return out if out is not None else _unique_entities(ev)

    def faces(self):
        """Unique faces of 3D cells as sorted vertex tuples + per-cell face
        indices in ``element.FACETS`` order, first-seen numbering."""
        fv = self.cells[:, np.array(FACETS[self.cell_type])]
        out = native.unique_faces(fv)
        return out if out is not None else _unique_entities(fv)

    def cell_centers(self):
        return self.points[self.cells].mean(axis=1)


def curve_mesh(mesh: Mesh, transform):
    """``mesh`` with degree-2 (isoparametric) geometry attached.

    ``transform``: callable ``(n, dim) -> (n, dim)`` mapping the straight
    node positions (vertices and the P2/Q2 edge, face and center nodes of
    the multilinear cell) to their curved positions, e.g. a polar map that
    turns a structured rectangle into an exactly curved annulus. The
    geometry nodes keep the canonical layout of the degree-2 space (vertices,
    then ``nv`` + edge id, then faces and centers), which facets.py's id
    arithmetic and the degree-2 spaces rely on. The vertices are moved
    through ``transform`` too, so topology and boundary queries see the
    curved shape."""
    from .space import FunctionSpace

    V2 = FunctionSpace(mesh, degree=2, shape=(), renumber=False)
    return Mesh(
        points=np.asarray(transform(mesh.points)),
        cells=mesh.cells,
        cell_type=mesh.cell_type,
        geom_degree=2,
        geom_points=np.asarray(transform(V2.node_coords)),
        geom_cells=V2.cell_nodes,
        grid=mesh.grid,  # the topology is unchanged: stencil gathers stay valid
    )


def _unique_entities(ev):
    """numpy route of the native engine: unique sub-entities ``ev (ncells,
    nlocal, nverts)`` as sorted vertex tuples in first-seen order, and
    per-cell entity ids."""
    ncells, nloc, nv = ev.shape
    flat = np.sort(ev, axis=2).reshape(-1, nv)
    uniq, first, inverse = np.unique(flat, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    ids = rank[inverse.ravel()].reshape(ncells, nloc).astype(np.int32)
    return uniq[order].astype(np.int32), ids


def _structured_quad_numpy(nx, ny, p0, p1):
    """numpy route of ``native.structured_quad_mesh``, the same arithmetic
    (``p0 + h i``)."""
    hx, hy = (p1[0] - p0[0]) / nx, (p1[1] - p0[1]) / ny
    X, Y = np.meshgrid(p0[0] + hx * np.arange(nx + 1), p0[1] + hy * np.arange(ny + 1), indexing="ij")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)
    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = (I * (ny + 1) + J).ravel()
    v10 = v00 + (ny + 1)
    return points, np.stack([v00, v10, v10 + 1, v00 + 1], axis=1).astype(np.int32)


def _structured_hex_numpy(nx, ny, nz, p0, p1):
    """numpy route of ``native.structured_hex_mesh`` (z fastest)."""
    n = (nx, ny, nz)
    axes = [p0[d] + (p1[d] - p0[d]) / n[d] * np.arange(n[d] + 1) for d in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    I, J, K = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    hexes = np.stack([
        vid(I, J, K), vid(I + 1, J, K), vid(I + 1, J + 1, K), vid(I, J + 1, K),
        vid(I, J, K + 1), vid(I + 1, J, K + 1), vid(I + 1, J + 1, K + 1), vid(I, J + 1, K + 1),
    ], axis=1).astype(np.int32)
    return points, hexes


def create_rectangle(p0, p1, n, cell_type="quad"):
    """Structured rectangle mesh of ``n=(nx, ny)`` cells ('quad' or 'triangle')."""
    nx, ny = n
    p0, p1 = [float(v) for v in p0], [float(v) for v in p1]
    out = native.structured_quad_mesh(nx, ny, p0, p1)
    points, quads = out if out is not None else _structured_quad_numpy(nx, ny, p0, p1)
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
    p0, p1 = [float(v) for v in p0], [float(v) for v in p1]
    out = native.structured_hex_mesh(nx, ny, nz, p0, p1)
    points, hexes = out if out is not None else _structured_hex_numpy(nx, ny, nz, p0, p1)
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
