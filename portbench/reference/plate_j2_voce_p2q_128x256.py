"""The plain reference of the plate: plane strain, Q2 Lagrange elements on
the structured ``nx`` x ``ny`` grid of the ``lx`` x ``ly`` rectangle, 3 x 3
Gauss points a cell, the bottom clamped and the top pulled in y, J2
plasticity with Voce hardening (``j2.py``), each load step solved by Newton
with a backtracking line search and a direct solve.

The direct solve: with the nodes numbered row by row, two rows of nodes to a
block, the stiffness matrix is block tridiagonal (a Q2 cell spans three rows
of nodes), so a block Cholesky factorisation solves it exactly in ``ny/2``
dense steps of ``4 (2 nx + 1)`` unknowns: dense tensors and
``torch.linalg``, nothing of the program.

Numbering: node ``(i, j)`` at ``(i hx/2, j hy/2)`` is ``j (2 nx + 1) + i``,
its dofs ``2 node + c``; cell ``(ci, cj)`` is ``cj nx + ci``, its Gauss point
``(qi, qj)`` (in x, in y) is ``9 cell + 3 qj + qi``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import j2

GAUSS = np.array([(1 - 0.6 ** 0.5) / 2, 0.5, (1 + 0.6 ** 0.5) / 2])
WEIGHTS = np.array([5.0, 8.0, 5.0]) / 18.0


def _lagrange(x):
    """Quadratic Lagrange polynomials on the nodes 0, 1/2, 1 and their
    derivatives at ``x``."""
    return (np.array([2 * x * x - 3 * x + 1, 4 * x - 4 * x * x, 2 * x * x - x]),
            np.array([4 * x - 3, 4 - 8 * x, 4 * x - 1]))


class Grid:
    """The mesh's numbering, the strain-displacement matrices and the
    block layout of the stiffness matrix."""

    def __init__(self, cfg, device, dtype):
        nx, ny = int(cfg["nx"]), int(cfg["ny"])
        self.nx, self.ny, self.lx, self.ly = nx, ny, float(cfg["lx"]), float(cfg["ly"])
        self.hx, self.hy = self.lx / nx, self.ly / ny
        self.NX, self.NY = 2 * nx + 1, 2 * ny + 1
        self.ndofs = 2 * self.NX * self.NY
        self.device, self.dtype = device, dtype
        ci, cj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
        ci, cj = ci.ravel(), cj.ravel()  # cell cj * nx + ci
        ai, aj = np.meshgrid(np.arange(3), np.arange(3), indexing="xy")
        ai, aj = ai.ravel(), aj.ravel()  # local node 3 aj + ai
        nodes = (2 * cj[:, None] + aj[None]) * self.NX + 2 * ci[:, None] + ai[None]
        edofs = np.stack([2 * nodes, 2 * nodes + 1], axis=2).reshape(len(ci), 18)
        self.edofs = torch.as_tensor(edofs, device=device)

        B = np.zeros((9, 6, 18))
        wdet = np.zeros(9)
        for qj in range(3):
            for qi in range(3):
                q = 3 * qj + qi
                Lx, dLx = _lagrange(GAUSS[qi])
                Ly, dLy = _lagrange(GAUSS[qj])
                dx = dLx[ai] * Ly[aj] / self.hx
                dy = Lx[ai] * dLy[aj] / self.hy
                B[q, 0, 0::2] = dx
                B[q, 1, 1::2] = dy
                B[q, 3, 0::2] = dy / 2 ** 0.5
                B[q, 3, 1::2] = dx / 2 ** 0.5
                wdet[q] = WEIGHTS[qi] * WEIGHTS[qj] * self.hx * self.hy
        self.B = torch.as_tensor(B, dtype=dtype, device=device)
        self.Bw = self.B * torch.as_tensor(wdet, dtype=dtype, device=device)[:, None, None]

        y = np.repeat(np.arange(self.NY), self.NX)
        fixed = np.zeros((self.NX * self.NY, 2), bool)
        fixed[y == 0] = True
        fixed[y == self.NY - 1, 1] = True
        self.fixed = torch.as_tensor(fixed.reshape(-1), device=device)
        self.top_y = torch.as_tensor(((y == self.NY - 1)[:, None] & (np.arange(2) == 1)[None]).reshape(-1),
                                     device=device)
        self.node_y = torch.as_tensor(np.repeat(y * self.hy / 2, 2), dtype=dtype, device=device)
        self.is_uy = torch.as_tensor(np.tile([False, True], self.NX * self.NY), device=device)

        # block tridiagonal layout: two rows of nodes a block
        self.m = m = 4 * self.NX
        self.nb = nb = (self.NY + 1) // 2
        self.size = nb * m
        rows = edofs[:, :, None].repeat(18, axis=2).reshape(-1)
        cols = edofs[:, None, :].repeat(18, axis=1).reshape(-1)
        br, bc = rows // m, cols // m
        flat = (rows % m) * m + cols % m
        diag, lower = br == bc, br == bc + 1
        self.d_sel = torch.as_tensor(np.nonzero(diag)[0], device=device)
        self.d_at = torch.as_tensor(br[diag] * m * m + flat[diag], device=device)
        self.s_sel = torch.as_tensor(np.nonzero(lower)[0], device=device)
        self.s_at = torch.as_tensor(bc[lower] * m * m + flat[lower], device=device)
        free = np.zeros(self.size)
        free[: self.ndofs] = ~fixed.reshape(-1)
        self.free = torch.as_tensor(free.reshape(nb, m), dtype=dtype, device=device)

    def strain(self, u):
        return torch.einsum("qkd,cd->cqk", self.B, u[self.edofs]).reshape(-1, 6)

    def residual(self, sig):
        Re = torch.einsum("qkd,cqk->cd", self.Bw, sig.reshape(-1, 9, 6))
        R = torch.zeros(self.ndofs, dtype=self.dtype, device=self.device).index_add_(
            0, self.edofs.reshape(-1), Re.reshape(-1))
        return torch.where(self.fixed, torch.zeros_like(R), R)

    def factor(self, Ct):
        """The Cholesky factor of the tangent stiffness, Dirichlet rows and
        columns replaced by the identity, symmetrically scaled by its
        diagonal: ``(L diagonal blocks, L sub-diagonal blocks, scale)``."""
        Ke = torch.einsum("qkd,cqkl,qle->cde", self.Bw, Ct.reshape(-1, 9, 6, 6), self.B).reshape(-1)
        nb, m = self.nb, self.m
        D = torch.zeros(nb * m * m, dtype=self.dtype, device=self.device).index_add_(0, self.d_at, Ke[self.d_sel])
        S = torch.zeros((nb - 1) * m * m, dtype=self.dtype, device=self.device).index_add_(0, self.s_at, Ke[self.s_sel])
        D, S, f = D.view(nb, m, m), S.view(nb - 1, m, m), self.free
        scale = torch.empty_like(f)
        for k in range(nb):
            D[k] *= torch.outer(f[k], f[k])
            torch.diagonal(D[k]).add_(1.0 - f[k])
            scale[k] = torch.rsqrt(torch.diagonal(D[k]))
            D[k] *= torch.outer(scale[k], scale[k])
        for k in range(nb - 1):
            S[k] *= torch.outer(f[k + 1] * scale[k + 1], f[k] * scale[k])
        for k in range(nb):
            A = D[k] - S[k - 1] @ S[k - 1].T if k > 0 else D[k]
            L, info = torch.linalg.cholesky_ex(A)
            if int(info) != 0:
                raise ArithmeticError(f"reference stiffness not positive definite at block {k}")
            D[k] = L
            if k < nb - 1:
                S[k] = torch.linalg.solve_triangular(L, S[k].T, upper=False).T
        return D, S, scale

    def solve(self, factors, b):
        D, S, scale = factors
        nb, m = self.nb, self.m
        x = torch.zeros(self.size, dtype=self.dtype, device=self.device)
        x[: self.ndofs] = b
        x = (x.view(nb, m) * scale).unsqueeze(2)
        for k in range(nb):
            r = x[k] - S[k - 1] @ x[k - 1] if k > 0 else x[k]
            x[k] = torch.linalg.solve_triangular(D[k], r, upper=False)
        for k in reversed(range(nb)):
            r = x[k] - S[k].T @ x[k + 1] if k < nb - 1 else x[k]
            x[k] = torch.linalg.solve_triangular(D[k].T, r, upper=True)
        return (x.squeeze(2) * scale).reshape(-1)[: self.ndofs]


def solve(cfg, increments, device, dtype=torch.float64, max_newton=30):
    """The plate's load program from the virgin state: after each increment
    of the top displacement, ``(u, p)`` as numpy float64 arrays in this
    module's numbering."""
    g = Grid(cfg, device, dtype)
    E, nu = float(cfg["E"]), float(cfg["nu"])
    hardening = j2.Hardening(cfg)
    npts = 9 * g.nx * g.ny
    eps_p = torch.zeros(npts, 6, dtype=dtype, device=device)
    p = torch.zeros(npts, dtype=dtype, device=device)
    u = torch.zeros(g.ndofs, dtype=dtype, device=device)
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    out, uy = [], 0.0

    def evaluate(v):
        sig, Ct, ep, pn = j2.return_map(g.strain(v), eps_p, p, E, nu, hardening)
        R = g.residual(sig)
        return R, float(torch.linalg.vector_norm(R)), Ct, ep, pn

    for d in increments:
        uy += d
        u = torch.where(g.is_uy, uy * g.node_y / g.ly, u)  # the lifted predictor
        u = torch.where(g.fixed, torch.zeros_like(u), u)
        u = torch.where(g.top_y, torch.full_like(u, uy), u)
        R, res, Ct, ep, pn = evaluate(u)
        res0 = max(res, 1e-300)
        for _ in range(max_newton):
            if res <= tol * res0:
                break
            du = -g.solve(g.factor(Ct), R)
            alpha, best = 1.0, None
            for _ in range(11):
                trial = evaluate(u + alpha * du)
                if trial[1] < (1 - 1e-4 * alpha) * res:
                    best = trial
                    break
                alpha *= 0.5
            if best is None:  # no decrease left: the floor of the dtype
                break
            u = u + alpha * du
            R, res, Ct, ep, pn = best
        eps_p, p = ep, pn
        out.append((u.double().cpu().numpy(), p.double().cpu().numpy()))
    return out


def _lattice(values, step, what):
    k = np.rint(values / step)
    if np.abs(values - k * step).max() > 1e-6 * step:
        raise ValueError(f"{what} off the reference grid")
    return k.astype(np.int64)


def dof_order(cfg, node_coords):
    """Indices that put a dof vector numbered by ``node_coords`` (the
    program's nodes, two components each) in this module's numbering."""
    nx, ny = int(cfg["nx"]), int(cfg["ny"])
    NX = 2 * nx + 1
    i = _lattice(node_coords[:, 0], cfg["lx"] / nx / 2, "node")
    j = _lattice(node_coords[:, 1], cfg["ly"] / ny / 2, "node")
    rid = j * NX + i
    node_of = np.full(NX * (2 * ny + 1), -1)
    node_of[rid] = np.arange(len(rid))
    if (node_of < 0).any() or len(rid) != len(node_of):
        raise ValueError("the program's nodes are not the reference's")
    return (2 * node_of[:, None] + np.arange(2)[None]).reshape(-1)


def point_order(cfg, x_q):
    """Indices that put a Gauss-point field at the points ``x_q`` (the
    program's) in this module's numbering."""
    nx, ny = int(cfg["nx"]), int(cfg["ny"])
    hx, hy = cfg["lx"] / nx, cfg["ly"] / ny
    fx, fy = x_q[:, 0] / hx, x_q[:, 1] / hy
    ci, cj = np.floor(fx).astype(np.int64), np.floor(fy).astype(np.int64)
    qi = np.abs((fx - ci)[:, None] - GAUSS[None]).argmin(axis=1)
    qj = np.abs((fy - cj)[:, None] - GAUSS[None]).argmin(axis=1)
    rid = 9 * (cj * nx + ci) + 3 * qj + qi
    point_of = np.full(9 * nx * ny, -1)
    point_of[rid] = np.arange(len(rid))
    if (point_of < 0).any() or len(rid) != len(point_of):
        raise ValueError("the program's Gauss points are not the reference's")
    return point_of
