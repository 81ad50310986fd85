"""Reference elements and quadrature rules, tabulated with ``torch.func``.

Shape functions are written once as torch expressions on the reference cell;
values and gradients at quadrature points come from ``torch.func.vmap`` /
``jacfwd`` in float64 on the host (no hand-derived derivative tables).

Reference cells: triangle (0,0),(1,0),(0,1); quad (0,0),(1,0),(1,1),(0,1);
tetrahedron (0,0,0),(1,0,0),(0,1,0),(0,0,1); hexahedron the unit cube with
z-major vertex order. P2 adds edge-midpoint nodes after the vertices (edge
lists below); quads add a center node, hexes face centers and a body center.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

EDGES = {
    "triangle": [(0, 1), (1, 2), (2, 0)],
    "quad": [(0, 1), (1, 2), (2, 3), (3, 0)],
    "tetrahedron": [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)],
    "hexahedron": [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ],
}

CELL_DIM = {"interval": 1, "triangle": 2, "quad": 2, "tetrahedron": 3, "hexahedron": 3}
CELL_VERTS = {"interval": 2, "triangle": 3, "quad": 4, "tetrahedron": 4, "hexahedron": 8}

FACETS = {
    "triangle": [(0, 1), (1, 2), (2, 0)],
    "quad": [(0, 1), (1, 2), (2, 3), (3, 0)],
    "tetrahedron": [(0, 1, 2), (0, 1, 3), (1, 2, 3), (0, 2, 3)],
    "hexahedron": [
        (0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
        (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7),
    ],
}


def _lag2(t):
    """1D quadratic Lagrange basis at nodes (0, 1/2, 1)."""
    return torch.stack([(2 * t - 1) * (t - 1), 4 * t * (1 - t), t * (2 * t - 1)])


def _shape_functions(cell: str, degree: int):
    """Return ``N(xi) -> (nnodes,)`` and the node coordinates on the ref cell."""
    if cell == "interval":
        if degree == 1:
            nodes = np.array([[0.0], [1.0]])

            def N(xi):
                return torch.stack([1 - xi[0], xi[0]])

        elif degree == 2:
            nodes = np.array([[0.0], [1.0], [0.5]])

            def N(xi):
                t = xi[0]
                return torch.stack([(2 * t - 1) * (t - 1), t * (2 * t - 1), 4 * t * (1 - t)])

        else:
            raise NotImplementedError(f"P{degree} on {cell}")
    elif cell in ("triangle", "tetrahedron"):
        dim = CELL_DIM[cell]
        v = np.vstack([np.zeros(dim), np.eye(dim)])

        def bary(xi):
            return torch.stack([1 - xi.sum()] + [xi[d] for d in range(dim)])

        if degree == 1:
            nodes = v

            def N(xi):
                return bary(xi)

        elif degree == 2:
            mids = np.array([(v[a] + v[b]) / 2 for a, b in EDGES[cell]])
            nodes = np.vstack([v, mids])

            def N(xi):
                L = bary(xi)
                edges = torch.stack([4 * L[a] * L[b] for a, b in EDGES[cell]])
                return torch.cat([L * (2 * L - 1), edges])

        else:
            raise NotImplementedError(f"P{degree} on {cell}")
    elif cell == "quad":
        v = np.array([[0.0, 0], [1, 0], [1, 1], [0, 1]])
        if degree == 1:
            nodes = v

            def N(xi):
                x, y = xi[0], xi[1]
                return torch.stack([(1 - x) * (1 - y), x * (1 - y), x * y, (1 - x) * y])

        elif degree == 2:
            mids = np.array([(v[a] + v[b]) / 2 for a, b in EDGES["quad"]])
            nodes = np.vstack([v, mids, [[0.5, 0.5]]])
            # (i, j) 1D-node indices per node, matching the order above
            ij = [(0, 0), (2, 0), (2, 2), (0, 2), (1, 0), (2, 1), (1, 2), (0, 1), (1, 1)]

            def N(xi):
                lx, ly = _lag2(xi[0]), _lag2(xi[1])
                return torch.stack([lx[i] * ly[j] for i, j in ij])

        else:
            raise NotImplementedError(f"Q{degree} on {cell}")
    elif cell == "hexahedron":
        verts = np.array(
            [[0.0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
             [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]]
        )
        if degree == 1:
            nodes = verts
            ijk = [tuple(int(c) for c in nd) for nd in verts]

            def N(xi):
                l1 = [torch.stack([1 - xi[d], xi[d]]) for d in range(3)]
                return torch.stack([l1[0][i] * l1[1][j] * l1[2][k] for i, j, k in ijk])

        elif degree == 2:
            mids = np.array([(verts[a] + verts[b]) / 2 for a, b in EDGES["hexahedron"]])
            faces = np.array(
                [[0.5, 0.5, 0], [0.5, 0.5, 1], [0.5, 0, 0.5],
                 [0.5, 1, 0.5], [0, 0.5, 0.5], [1, 0.5, 0.5]]
            )
            nodes = np.vstack([verts, mids, faces, [[0.5, 0.5, 0.5]]])
            idx1d = {0.0: 0, 0.5: 1, 1.0: 2}
            ijk = [tuple(idx1d[c] for c in nd) for nd in nodes]

            def N(xi):
                l2 = [_lag2(xi[d]) for d in range(3)]
                return torch.stack([l2[0][i] * l2[1][j] * l2[2][k] for i, j, k in ijk])

        else:
            raise NotImplementedError(f"Q{degree} on {cell}")
    else:
        raise NotImplementedError(cell)
    return N, nodes


# ------------------------------------------------------------ quadrature
def _gauss01(n):
    """n-point Gauss-Legendre on [0,1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1) / 2, w / 2


def _tri_orbit3(a):
    return [(a, a), (1 - 2 * a, a), (a, 1 - 2 * a)]


def _tet_orbit4(a):
    b = (1.0 - a) / 3.0
    return [(b, b, b), (a, b, b), (b, a, b), (b, b, a)]


def _tet_orbit6(a):
    b = 0.5 - a
    return [(a, b, b), (b, a, b), (b, b, a), (b, a, a), (a, b, a), (a, a, b)]


def _symmetric_simplex_rule(cell: str, degree: int):
    """Minimal-point symmetric rules on simplices (Dunavant triangle, Keast
    tetrahedron, positive weights); None beyond their range."""
    if cell == "triangle":  # weights sum to 1, scaled by area 1/2
        if degree <= 1:
            pts, wts = [(1 / 3, 1 / 3)], [1.0]
        elif degree == 2:
            pts, wts = _tri_orbit3(1 / 6), [1 / 3] * 3
        elif degree <= 4:
            pts = _tri_orbit3(0.091576213509771) + _tri_orbit3(0.445948490915965)
            wts = [0.109951743655322] * 3 + [0.223381589678011] * 3
        elif degree == 5:
            pts = [(1 / 3, 1 / 3)] + _tri_orbit3(0.101286507323456) + _tri_orbit3(0.470142064105115)
            wts = [0.225] + [0.125939180544827] * 3 + [0.132394152788506] * 3
        else:
            return None
        return np.array(pts), 0.5 * np.array(wts)
    if cell == "tetrahedron":  # weights sum to 1, scaled by volume 1/6
        if degree <= 1:
            pts, wts = [(0.25, 0.25, 0.25)], [1.0]
        elif degree == 2:
            pts = _tet_orbit4((5.0 + 3.0 * np.sqrt(5.0)) / 20.0)
            wts = [0.25] * 4
        elif degree <= 5:
            pts = (
                _tet_orbit4(0.0673422422100983)
                + _tet_orbit4(0.7217942490673264)
                + _tet_orbit6(0.4544962958743506)
            )
            wts = [0.1126879257180162] * 4 + [0.0734930431163619] * 4 + [0.0425460207770812] * 6
        else:
            return None
        return np.array(pts), np.array(wts) / 6.0
    return None


def quadrature_rule(cell: str, degree: int):
    """Points (nq, dim) and weights (nq,) integrating polynomials of ``degree``
    exactly on the reference cell (Gauss tensor rules on quads/hexes,
    symmetric rules on simplices, Duffy collapse beyond their range)."""
    if cell in ("triangle", "tetrahedron"):
        rule = _symmetric_simplex_rule(cell, degree)
        if rule is not None:
            return rule
    n1 = max(degree // 2 + 1, 1)
    x, w = _gauss01(n1)
    if cell == "interval":
        pts, wts = x[:, None], w
    elif cell == "quad":
        X, Y = np.meshgrid(x, x, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)
        wts = np.outer(w, w).ravel()
    elif cell == "hexahedron":
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
        wts = np.einsum("i,j,k->ijk", w, w, w).ravel()
    elif cell == "triangle":
        # Duffy: (u, v) in square -> (u, v(1-u)), |J| = 1-u
        xu, wu = _gauss01(n1 + 1)
        U, V = np.meshgrid(xu, x, indexing="ij")
        WU, WV = np.meshgrid(wu, w, indexing="ij")
        pts = np.stack([U.ravel(), (V * (1 - U)).ravel()], axis=1)
        wts = (WU * WV * (1 - U)).ravel()
    elif cell == "tetrahedron":
        xu, wu = _gauss01(n1 + 1)
        U, V, T = np.meshgrid(xu, xu, x, indexing="ij")
        WU, WV, WT = np.meshgrid(wu, wu, w, indexing="ij")
        pts = np.stack(
            [U.ravel(), (V * (1 - U)).ravel(), (T * (1 - U) * (1 - V)).ravel()], axis=1
        )
        wts = (WU * WV * WT * (1 - U) ** 2 * (1 - V)).ravel()
    else:
        raise NotImplementedError(cell)
    return pts, wts


@dataclass
class ReferenceElement:
    """Tabulated Lagrange element: values and reference gradients at the
    quadrature points (numpy float64)."""

    cell: str
    degree: int
    quad_degree: int

    def __post_init__(self):
        Nfun, nodes = _shape_functions(self.cell, self.degree)
        self.nodes = nodes
        self.nnodes = len(nodes)
        self.dim = CELL_DIM[self.cell]
        pts, wts = quadrature_rule(self.cell, self.quad_degree)
        self.qpoints = pts
        self.qweights = wts
        self.nq = len(wts)
        X = torch.as_tensor(pts, dtype=torch.float64)
        self.N = torch.func.vmap(Nfun)(X).numpy()  # (nq, nnodes)
        self.dN = torch.func.vmap(torch.func.jacfwd(Nfun))(X).numpy()  # (nq, nnodes, dim)
        self._Nfun = Nfun

    def tabulate(self, points):
        """Values at arbitrary reference points."""
        X = torch.as_tensor(np.asarray(points), dtype=torch.float64)
        return torch.func.vmap(self._Nfun)(X).numpy()
