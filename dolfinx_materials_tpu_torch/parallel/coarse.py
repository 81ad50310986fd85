"""Coarse spaces for the frozen two-level preconditioner of the fused step.

Host-side numpy, built once per problem; counterparts of
dolfinx_materials_tpu/parallel/coarse.py (same arithmetic, same outputs):

- coordinate-box piecewise-constant aggregates (``_coord_agg_cdofs``), the
  host solver's ``_node_aggregates`` scheme;
- per-aggregate mode weights (``_coord_agg_modes``): piecewise-constant
  translations or rigid-body modes (the elasticity near-nullspace);
- the geometric P2->P1 vertex coarse space (``_p1_coarse``).
"""

from __future__ import annotations

import numpy as np

from ..fem.element import EDGES


def _coord_agg_cdofs(space, pc_boxes, budget=2048):
    """Coordinate-box node aggregates over a space: ``(ncoarse,
    cdof_of_dof (ndofs,))`` with ``nagg * ncomp <= ~budget`` coarse dofs, so
    the frozen dense coarse inverse stays one small product."""
    coords = np.asarray(space.node_coords, dtype=np.float64)
    ncomp = space.ncomp
    nnodes, dim = coords.shape
    lo = coords.min(axis=0)
    span = np.maximum(coords.max(axis=0) - lo, 1e-30)
    target = max(1, min(budget // ncomp, nnodes))
    b = max(1, min(int(pc_boxes), int(np.floor(target ** (1.0 / dim)))))
    qz = np.minimum((coords - lo) / span * b, b - 1).astype(np.int64)
    keys = qz[:, 0]
    for d in range(1, dim):
        keys = keys * b + qz[:, d]
    _, agg = np.unique(keys, return_inverse=True)
    nagg = int(agg.max()) + 1
    cdof_of_dof = (agg[:, None] * ncomp + np.arange(ncomp)[None, :]).reshape(-1)
    return nagg * ncomp, cdof_of_dof


def _coord_agg_modes(space, pc_boxes, budget=3072, modes="trans", labels=None):
    """Coordinate-box node aggregates with per-aggregate coarse mode weights.

    - ``modes="trans"``: ``ncomp`` piecewise-constant modes per aggregate;
    - ``modes="rbm"``: on vector spaces the ``ncomp`` translations plus the
      rotations (1 in 2D, 3 in 3D) about the aggregate centroid, so a stiff
      inclusion's rigid motion is representable per aggregate.

    ``labels``: optional ``(nnodes,)`` integer node labels; aggregates never
    mix labels. Returns ``(ncoarse, agg_of_node (nnodes,) int32, W_node
    (nnodes, ncomp, nmodes) float32)`` with ``ncoarse = nagg * nmodes``.
    """
    coords = np.asarray(space.node_coords, dtype=np.float64)
    ncomp = space.ncomp
    nnodes, dim = coords.shape
    if modes == "rbm" and ncomp != dim:
        raise ValueError(f"rbm coarse modes need a {dim}-component space, got ncomp={ncomp}")
    nrot = 0 if modes == "trans" else (1 if dim == 2 else 3)
    nmodes = ncomp + nrot
    lo = coords.min(axis=0)
    span = np.maximum(coords.max(axis=0) - lo, 1e-30)
    target = max(1, min(budget // nmodes, nnodes))
    b = max(1, min(int(pc_boxes), int(np.floor(target ** (1.0 / dim)))))
    qz = np.minimum((coords - lo) / span * b, b - 1).astype(np.int64)
    keys = qz[:, 0]
    for d in range(1, dim):
        keys = keys * b + qz[:, d]
    if labels is not None:
        labels = np.asarray(labels, np.int64)
        keys = keys * (labels.max() + 1) + labels
    _, agg = np.unique(keys, return_inverse=True)
    agg = agg.astype(np.int32)
    nagg = int(agg.max()) + 1

    W = np.zeros((nnodes, ncomp, nmodes), np.float64)
    for c in range(ncomp):
        W[:, c, c] = 1.0
    if nrot:
        # centroid-centred, span-normalised rotations (conditioning of Ac)
        cnt = np.bincount(agg, minlength=nagg).astype(np.float64)
        cen = np.stack([np.bincount(agg, coords[:, d], nagg) / cnt for d in range(dim)], axis=1)
        r = (coords - cen[agg]) / float(np.max(span))
        if dim == 2:
            W[:, 0, ncomp] = -r[:, 1]
            W[:, 1, ncomp] = r[:, 0]
        else:
            # mode ncomp+a = rotation about axis a: w = e_a x r
            W[:, 1, ncomp + 0] = -r[:, 2]
            W[:, 2, ncomp + 0] = r[:, 1]
            W[:, 0, ncomp + 1] = r[:, 2]
            W[:, 2, ncomp + 1] = -r[:, 0]
            W[:, 0, ncomp + 2] = -r[:, 1]
            W[:, 1, ncomp + 2] = r[:, 0]
    return nagg * nmodes, agg, W.astype(np.float32)


def _p1_coarse(space):
    """Geometric P2->P1 coarse space on simplex meshes: the coarse dofs are
    the mesh vertex dofs, and coarse vertex v weighs P2 node n by its P1 hat
    function there (vertex nodes map to themselves, edge nodes take half of
    each endpoint): a continuous coarse basis.

    Uses the canonical node layout (vertices first, then edge nodes) mapped
    through ``space.node_renum``. Returns ``(ncoarse, parents (nnodes, 2)
    int32 vertex ids, pw (nnodes, 2) float32, vid_of_node (nnodes,) int32 —
    vertex id of vertex nodes, -1 elsewhere, Wp1 (nloc, nvloc) float32 — P1
    value of each local vertex at each local node)``.
    """
    mesh = space.mesh
    if space.degree != 2 or mesh.cell_type not in ("triangle", "tetrahedron"):
        raise NotImplementedError(
            f"coarse_modes='p1' needs a P2 simplex space (got P{space.degree} {mesh.cell_type})"
        )
    nv = mesh.num_vertices
    edge_verts, _ = mesh.edges()
    nnodes = space.num_nodes
    parents = np.empty((nnodes, 2), np.int64)
    parents[:nv, 0] = np.arange(nv)
    parents[:nv, 1] = np.arange(nv)
    parents[nv:] = edge_verts
    pw = np.zeros((nnodes, 2), np.float32)
    pw[:nv, 0] = 1.0
    pw[nv:] = 0.5
    vid = np.full(nnodes, -1, np.int64)
    vid[:nv] = np.arange(nv)
    renum = space.node_renum
    if renum is not None:
        p2, w2, v2 = np.empty_like(parents), np.empty_like(pw), np.empty_like(vid)
        p2[renum], w2[renum], v2[renum] = parents, pw, vid
        parents, pw, vid = p2, w2, v2
    nvloc = mesh.cells.shape[1]
    Wp1 = np.zeros((space.nloc, nvloc), np.float32)
    for a in range(nvloc):
        Wp1[a, a] = 1.0
    for i, (a, b) in enumerate(EDGES[mesh.cell_type]):
        Wp1[nvloc + i, a] = 0.5
        Wp1[nvloc + i, b] = 0.5
    return nv * space.ncomp, parents.astype(np.int32), pw, vid.astype(np.int32), Wp1
