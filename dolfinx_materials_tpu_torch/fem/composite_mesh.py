"""Analytic conforming tet mesh of the composite benchmark: a unit cube of
matrix with eight eighth-sphere inclusions of radius R = 0.4 at its corners
(matrix tag 1, inclusion tag 2).

Built as a structured multi-block O-grid ("cubed sphere"), numpy only:

- each cube octant holds one corner eighth-sphere: an inner cube ``[0, b]^3``
  plus three shell blocks blending the inner cube's far faces radially onto
  the exact sphere; the matrix is three more blocks blending the sphere
  radially onto the octant's outer faces. All blends run along rays from the
  sphere's centre, so the blocks tile the octant and interface nodes lie
  exactly on the sphere;
- the template octant is reflected to the 8 corners; reflected copies give
  bitwise equal coordinates on shared faces, so gluing is an exact
  coordinate dedup;
- hexes are split into tets by coning from each hex's minimum-id vertex over
  the face triangulations whose diagonals pass through each face's smallest
  vertex id, so neighbouring hexes agree on every shared face's diagonal.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

#: hex faces in the create_box local numbering (bottom 0123, top 4567)
_HEX_FACES = ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7))


def _octant_blocks(R, h, n0, n1, n2, b_frac=0.5, grade=1.0):
    """Hex blocks of one octant ``[0, h]^3`` with an eighth-sphere of radius R
    at the origin: ``(points (np, 3), hexes (ne, 8), tags (ne,))``. ``n0``
    inner-cube cells an axis, ``n1`` shell layers (inner cube -> sphere),
    ``n2`` matrix layers (sphere -> box); ``grade`` > 1 grades the matrix
    layers geometrically toward the interface."""
    if not (0.0 < R < h):
        raise ValueError(f"need 0 < R < {h}, got R={R}")
    b = b_frac * R  # inner cube half side; its corner radius b sqrt(3) < R
    pts_blocks, hex_blocks, tag_blocks = [], [], []

    def add_block(P, tag):
        """A (m0, m1, m2, 3) lattice -> hexes."""
        m0, m1, m2 = P.shape[:3]
        base = sum(p.shape[0] for p in pts_blocks)
        pts_blocks.append(P.reshape(-1, 3))

        def vid(i, j, k):
            return base + (i * m1 + j) * m2 + k

        I, J, K = (a.ravel() for a in np.meshgrid(np.arange(m0 - 1), np.arange(m1 - 1), np.arange(m2 - 1),
                                                  indexing="ij"))
        hx = np.stack([
            vid(I, J, K), vid(I + 1, J, K), vid(I + 1, J + 1, K), vid(I, J + 1, K),
            vid(I, J, K + 1), vid(I + 1, J, K + 1), vid(I + 1, J + 1, K + 1), vid(I, J + 1, K + 1),
        ], axis=1)
        hex_blocks.append(hx)
        tag_blocks.append(np.full(len(hx), tag, np.int32))

    s = np.linspace(0.0, b, n0 + 1)
    X, Y, Z = np.meshgrid(s, s, s, indexing="ij")
    add_block(np.stack([X, Y, Z], axis=-1), 2)

    uu, vv = np.meshgrid(s, s, indexing="ij")
    for axd in range(3):
        q = np.empty(uu.shape + (3,))  # the inner cube's far face normal to axd
        q[..., axd] = b
        q[..., (axd + 1) % 3] = uu
        q[..., (axd + 2) % 3] = vv
        d = q / np.linalg.norm(q, axis=-1, keepdims=True)
        sph = R * d
        w = np.linspace(0.0, 1.0, n1 + 1)[:, None, None, None]
        add_block(np.moveaxis((1.0 - w) * q[None] + w * sph[None], 0, 2), 2)
        box = h / np.max(d, axis=-1, keepdims=True) * d
        w2 = np.linspace(0.0, 1.0, n2 + 1)
        if grade != 1.0:
            g = grade ** np.arange(n2)
            w2 = np.concatenate([[0.0], np.cumsum(g)]) / g.sum()
        w2 = w2[:, None, None, None]
        add_block(np.moveaxis((1.0 - w2) * sph[None] + w2 * box[None], 0, 2), 1)

    return np.concatenate(pts_blocks), np.concatenate(hex_blocks).astype(np.int64), np.concatenate(tag_blocks)


def _dedup(points, cells, decimals=9):
    """Merge coincident nodes (rounding only guards float noise)."""
    _, first, inv = np.unique(np.round(points, decimals), axis=0, return_index=True, return_inverse=True)
    return points[first], inv.reshape(-1)[cells]


def hexes_to_tets_minvertex(points, hexes):
    """Consistent hex -> tet split: cone from each hex's minimum-id vertex
    over the min-vertex-diagonal face triangulations; 6 tets a hex in hex
    order, each turned to a positive volume."""
    ne = len(hexes)
    m_glob = hexes[np.arange(ne), np.argmin(hexes, axis=1)]
    tets = []
    for f in _HEX_FACES:
        g = hexes[:, f]
        k = np.argmin(g, axis=1)
        gr = np.take_along_axis(g, (k[:, None] + np.arange(4)[None, :]) % 4, axis=1)  # face min first
        for tri in ((0, 1, 2), (0, 2, 3)):
            t = np.column_stack([m_glob, gr[:, tri[0]], gr[:, tri[1]], gr[:, tri[2]]])
            keep = (t[:, 1] != m_glob) & (t[:, 2] != m_glob) & (t[:, 3] != m_glob)
            tets.append((t[keep], keep))
    out = np.empty((ne, 6, 4), np.int64)
    fill = np.zeros(ne, np.int64)
    for t, keep in tets:
        rows = np.nonzero(keep)[0]
        out[rows, fill[rows]] = t
        fill[rows] += 1
    if not (fill == 6).all():
        raise RuntimeError("min-vertex coning did not yield 6 tets per hex")
    tets = out.reshape(-1, 4)
    p = points[tets]
    vol6 = np.einsum("ij,ij->i", np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), p[:, 3] - p[:, 0])
    neg = vol6 < 0
    tets[neg, 2], tets[neg, 3] = tets[neg, 3].copy(), tets[neg, 2].copy()
    if np.any(vol6 == 0):
        raise RuntimeError("degenerate tet produced by coning")
    return tets


def create_inclusion_cube(n0=2, n1=1, n2=3, R=0.4, L=1.0, b_frac=0.5, grade=1.0):
    """Conforming tagged tet mesh of the cube with eight corner eighth-sphere
    inclusions: ``(mesh, cell_tags)``, tag 1 matrix, 2 inclusion. (2, 1, 3)
    gives ~2,700 tets (the benchmark's "coarse" mesh), (3, 1, 3) ~6,500
    ("fine")."""
    pts_t, hex_t, tag_t = _octant_blocks(R, L / 2.0, n0, n1, n2, b_frac, grade)
    all_pts, all_hex = [], []
    for k, (cx, cy, cz) in enumerate((x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)):
        corner = np.array([cx, cy, cz], float)
        all_pts.append(corner * L + (1.0 - 2.0 * corner) * pts_t)
        all_hex.append(hex_t + k * len(pts_t))
    points, hexes = _dedup(np.concatenate(all_pts), np.concatenate(all_hex))
    tets = hexes_to_tets_minvertex(points, hexes)
    return Mesh(points, tets.astype(np.int32), "tetrahedron"), np.repeat(np.tile(tag_t, 8), 6)
