"""Bandwidth-reducing mesh reordering for the banded gathers.

The banded plans' cost per output grows with the element dof span
(ops/banded_gather.py), so the vertex numbering sets the gathers' cost on
unstructured meshes. ``reorder_mesh`` tries the natural order, reverse
Cuthill-McKee and a coordinate snake sort and keeps the one with the smallest
99th-percentile element vertex span (RCM is not always best: on grid-like
meshes the natural order can beat it). Cells are then sorted by their
minimum vertex and their local vertex order permuted to balance slot
occupancy (``balance_cell_slots``).
"""

from __future__ import annotations

import numpy as np

from ..ops.banded_gather import balance_cell_slots
from .mesh import Mesh


def _elem_span_p99(cells):
    return float(np.percentile(cells.max(axis=1) - cells.min(axis=1), 99))


def _rcm_order(cells, nv):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    k = cells.shape[1]
    i = np.repeat(cells, k, axis=1).ravel()
    j = np.tile(cells, (1, k)).ravel()
    A = sp.coo_matrix((np.ones(len(i), np.int8), (i, j)), shape=(nv, nv)).tocsr()
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))


def _snake_order(points):
    """Vertices in strips along the longest axis, the sweep direction
    alternating from strip to strip so strip boundaries stay contiguous."""
    pts = np.asarray(points)
    nv, dim = pts.shape
    main = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
    others = [d for d in range(dim) if d != main]
    nstrips = max(1, int(np.sqrt(nv)))
    lo, hi = pts[:, main].min(), pts[:, main].max()
    strip = np.minimum(((pts[:, main] - lo) / max(hi - lo, 1e-300) * nstrips).astype(np.int64), nstrips - 1)
    key2 = pts[:, others[0]] if others else np.zeros(nv)
    key2 = np.where(strip % 2 == 0, key2, -key2)
    key3 = pts[:, others[1]] if len(others) > 1 else np.zeros(nv)
    return np.lexsort((key3, key2, strip))


def reorder_mesh(mesh: Mesh, balance_slots=True, verbose=False):
    """A bandwidth-reduced copy of ``mesh``. Structured meshes (``mesh.grid``
    set) are returned unchanged: the stencil route needs no reordering; so
    are curved ones.

    The copy carries ``vertex_perm`` and ``vertex_inverse`` (new vertex id =
    ``vertex_inverse[old id]``) and ``cell_order`` (new cell c was old cell
    ``cell_order[c]``), for callers with per-vertex or per-cell data."""
    if mesh.grid is not None or mesh.geom_degree != 1:
        return mesh  # curved meshes keep their geometry-node numbering
    nv = mesh.num_vertices
    candidates = {"natural": np.arange(nv), "rcm": _rcm_order(mesh.cells, nv),
                  "snake": _snake_order(mesh.points)}
    best_name, best_perm, best_span = None, None, np.inf
    for name, perm in candidates.items():
        inv = np.empty(nv, np.int64)
        inv[perm] = np.arange(nv)
        span = _elem_span_p99(inv[mesh.cells])
        if span < best_span:
            best_name, best_perm, best_span = name, perm, span
    if verbose:
        print(f"reorder_mesh: '{best_name}' wins, p99 element span {best_span:.0f}")

    inv = np.empty(nv, np.int64)
    inv[best_perm] = np.arange(nv)
    cells = inv[mesh.cells].astype(np.int32)
    order = np.argsort(cells.min(axis=1), kind="stable")
    cells = cells[order]
    if balance_slots:
        cells = balance_cell_slots(cells, mesh.cell_type)
    out = Mesh(mesh.points[best_perm], cells.astype(np.int32), mesh.cell_type)
    out.reordered = True
    out.vertex_perm = np.asarray(best_perm)
    out.vertex_inverse = inv
    out.cell_order = order
    return out
