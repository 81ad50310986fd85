"""The plain reference of the Ogden block: the unit cube in ``N``^3 cubes of
six tetrahedra each, P2 Lagrange displacements, the 14-point rule of degree 5
(so every degree-4 integrand exactly), the compressible Ogden law in its
spectral form, the bottom face clamped and the top face pushed down in z,
each load step solved by Newton with a backtracking line search and a dense
Cholesky factorisation of the free dofs' exact tangent.

Mesh: cube ``(a, b, c)`` (``a`` in x) is split along its diagonal from
``(a, b, c)`` to ``(a+1, b+1, c+1)`` into the six tetrahedra that follow the
cube's edges in the six orders of the axes (the Kuhn split). Nodes lie on
the half-step lattice: node ``(i, j, k)`` at ``(i, j, k) / (2 N)`` is ``(k M
+ j) M + i`` with ``M = 2 N + 1``, its dofs ``3 node + c``. A tetrahedron's
P2 nodes: its four vertices, then the midpoints of its edges (0,1), (0,2),
(0,3), (1,2), (1,3), (2,3).

Ogden law, one or more terms ``p``:

    W = sum_p 2 mu_p / alpha_p^2 (sum_i lbar_i^alpha_p - 3) + K/2 (J - 1)^2,

``lbar_i = J^(-1/3) lambda_i``. With ``c_i`` the eigenvalues of ``C = F^T
F`` and ``n_i`` its eigenvectors, ``S = 2 dW/dC = sum_i s_i n_i n_i``, and
the tangent ``dS`` takes ``ds_i / dc_j`` on the eigenbasis' diagonal and the
divided differences ``(s_i - s_j) / (c_i - c_j)`` off it (Daleckii-Krein),
written in closed form so that coincident eigenvalues (``C = I``) take
their limit, with no derivative through ``eigh``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

#: The 14-point rule of degree 5 on the tetrahedron (Walkington, "Quadrature
#: on simplices of arbitrary dimension", 2000; Keast, 1986): barycentric
#: orbits and their weights, the weights summing to 1 (times the volume)
RULE = (
    ((0.31088591926330060980, 0.31088591926330060980, 0.31088591926330060980, 0.06734224221009817060),
     0.11268792571801585080),
    ((0.09273525031089122640, 0.09273525031089122640, 0.09273525031089122640, 0.72179424906732632079),
     0.07349304311636194954),
    ((0.45449629587435035051, 0.45449629587435035051, 0.04550370412564964949, 0.04550370412564964949),
     0.04254602077708146644),
)

#: a tetrahedron's edges, in the order of its P2 edge nodes
EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def quadrature():
    """The rule's barycentric points ``(14, 4)`` and weights ``(14,)``,
    summing to 1."""
    pts, wts = [], []
    for orbit, w in RULE:
        for p in sorted(set(itertools.permutations(orbit))):
            pts.append(p)
            wts.append(w)
    return np.array(pts), np.array(wts)


def kuhn_tetrahedra(N):
    """Vertices of every tetrahedron as lattice points of the half-step
    lattice, ``(6 N^3, 4, 3)`` integers: cube by cube (x fastest), in each
    the six axis orders."""
    a, b, c = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
    corner = np.stack([a.ravel(order="F"), b.ravel(order="F"), c.ravel(order="F")], axis=1)
    paths = []
    for order in itertools.permutations(range(3)):
        steps = np.zeros((4, 3), np.int64)
        for s, axis in enumerate(order):
            steps[s + 1:, axis] += 1
        paths.append(steps)
    paths = np.array(paths)  # (6, 4, 3)
    return 2 * (corner[:, None, None, :] + paths[None]).reshape(-1, 4, 3)


class Block:
    """The mesh, its P2 gradients at the quadrature points, the Dirichlet
    dofs and the dense layout of the free dofs' stiffness."""

    def __init__(self, cfg, device, dtype):
        N = int(cfg["N"])
        self.M = 2 * N + 1
        self.device, self.dtype = device, dtype
        self.nnodes = self.M ** 3
        self.ndofs = 3 * self.nnodes
        verts = kuhn_tetrahedra(N)  # lattice points
        mids = np.stack([(verts[:, a] + verts[:, b]) // 2 for a, b in EDGES], axis=1)
        lat = np.concatenate([verts, mids], axis=1)  # (ne, 10, 3)
        nodes = (lat[..., 2] * self.M + lat[..., 1]) * self.M + lat[..., 0]
        self.ne = len(nodes)
        self.edofs = torch.as_tensor((3 * nodes[:, :, None] + np.arange(3)).reshape(self.ne, 30), device=device)

        h = 1.0 / (2 * N)
        X = verts * h  # (ne, 4, 3)
        Jm = np.transpose(X[:, 1:] - X[:, :1], (0, 2, 1))  # columns X_d - X_0
        dL = np.linalg.inv(Jm)  # rows: gradients of L_1..L_3
        dL = np.concatenate([-dL.sum(axis=1, keepdims=True), dL], axis=1)  # (ne, 4, 3)
        vol = np.abs(np.linalg.det(Jm)) / 6.0
        L, w = quadrature()
        G = np.zeros((self.ne, len(w), 10, 3))
        for q, Lq in enumerate(L):
            for v in range(4):
                G[:, q, v] = (4 * Lq[v] - 1) * dL[:, v]
            for e, (a, b) in enumerate(EDGES):
                G[:, q, 4 + e] = 4 * (Lq[a] * dL[:, b] + Lq[b] * dL[:, a])
        self.nq = len(w)
        self.G = torch.as_tensor(G, dtype=dtype, device=device)
        self.w = torch.as_tensor(vol[:, None] * w[None], dtype=dtype, device=device)

        z = np.arange(self.nnodes) // (self.M * self.M)
        fixed = np.zeros((self.nnodes, 3), bool)
        fixed[z == 0] = True
        fixed[z == self.M - 1, 2] = True
        self.fixed = torch.as_tensor(fixed.reshape(-1), device=device)
        self.top_z = torch.as_tensor(((z == self.M - 1)[:, None] & (np.arange(3) == 2)[None]).reshape(-1),
                                     device=device)
        free = np.nonzero(~fixed.reshape(-1))[0]
        self.free = torch.as_tensor(free, device=device)
        self.nf = len(free)
        slot = np.full(self.ndofs, -1)
        slot[free] = np.arange(self.nf)
        ed = slot[(3 * nodes[:, :, None] + np.arange(3)).reshape(self.ne, 30)]
        r = np.repeat(ed[:, :, None], 30, axis=2).reshape(-1)
        c = np.repeat(ed[:, None, :], 30, axis=1).reshape(-1)
        keep = (r >= 0) & (c >= 0)
        self.k_sel = torch.as_tensor(np.nonzero(keep)[0], device=device)
        self.k_at = torch.as_tensor(r[keep] * self.nf + c[keep], device=device)
        self.law = Ogden(cfg)

    def F(self, u):
        """Deformation gradients at every point, ``(ne nq, 3, 3)``."""
        ue = u[self.edofs].reshape(self.ne, 10, 3)
        grad = torch.einsum("eni,eqnj->eqij", ue, self.G).reshape(-1, 3, 3)
        return grad + torch.eye(3, dtype=self.dtype, device=self.device)

    def residual(self, P):
        """The internal forces of the PK1 stresses ``P (ne nq, 3, 3)``, every
        dof."""
        Re = torch.einsum("eq,eqij,eqnj->eni", self.w, P.reshape(self.ne, self.nq, 3, 3), self.G)
        return torch.zeros(self.ndofs, dtype=self.dtype, device=self.device).index_add_(
            0, self.edofs.reshape(-1), Re.reshape(-1))

    def stiffness(self, A):
        """The free dofs' dense stiffness of the tangents ``A (ne nq, 9,
        9)``."""
        A = A.reshape(self.ne, self.nq, 3, 3, 3, 3)
        Ke = torch.einsum("eq,eqnj,eqijkl,eqml->enimk", self.w, self.G, A, self.G).reshape(-1)
        return torch.zeros(self.nf * self.nf, dtype=self.dtype, device=self.device).index_add_(
            0, self.k_at, Ke[self.k_sel]).view(self.nf, self.nf)

    def free_residual(self, u, tangent=False):
        """``(R on the free dofs, its norm, the points' tangents or None)``."""
        P, A = self.law(self.F(u), tangent)
        R = self.residual(P)[self.free]
        return R, float(torch.linalg.vector_norm(R)), A

    def with_bcs(self, u, uz):
        """``u`` with the clamped dofs at 0 and the top face's z at ``uz``."""
        u = torch.where(self.fixed, torch.zeros_like(u), u)
        return torch.where(self.top_z, torch.full_like(u, uz), u)


def _power_divided(x, y, r):
    """``(x^r - y^r) / (x - y)``, and ``r y^(r-1)`` at ``x = y``, without
    cancellation: ``y^(r-1) expm1(r log1p(d)) / d``, ``d = (x - y) / y``."""
    d = (x - y) / y
    safe = torch.where(d == 0, torch.ones_like(d), d)
    ratio = torch.where(d == 0, torch.full_like(d, r), torch.expm1(r * torch.log1p(safe)) / safe)
    return y ** (r - 1) * ratio


def _det(F):
    """Determinants of ``(n, 3, 3)`` by cofactors."""
    return (F[:, 0, 0] * (F[:, 1, 1] * F[:, 2, 2] - F[:, 1, 2] * F[:, 2, 1])
            - F[:, 0, 1] * (F[:, 1, 0] * F[:, 2, 2] - F[:, 1, 2] * F[:, 2, 0])
            + F[:, 0, 2] * (F[:, 1, 0] * F[:, 2, 1] - F[:, 1, 1] * F[:, 2, 0]))


def _eigh(C):
    """Eigenvalues and eigenvectors of the symmetric ``(n, 3, 3)``, on the
    host: the card's batched solver refuses a batch of 84,000."""
    c, Q = torch.linalg.eigh(C.cpu())
    return c.to(C.device), Q.to(C.device)


class Ogden:
    """The law's energy, PK1 and tangent ``dP/dF`` on a batch of
    deformation gradients ``(n, 3, 3)``."""

    def __init__(self, cfg):
        self.mu = [float(m) for m in cfg["mu"]]
        self.alpha = [float(a) for a in cfg["alpha"]]
        self.K = float(cfg["K"])

    def energy(self, F):
        c = _eigh(F.transpose(1, 2) @ F)[0]
        J = _det(F)
        W = 0.5 * self.K * (J - 1.0) ** 2
        for mu, a in zip(self.mu, self.alpha):
            W = W + 2.0 * mu / a**2 * (J ** (-a / 3.0) * (c ** (a / 2.0)).sum(1) - 3.0)
        return W

    def __call__(self, F, tangent=True):
        """``(P (n, 3, 3), A (n, 9, 9) or None)``, ``A[:, 3 i + j, 3 k + l]
        = dP_ij / dF_kl``."""
        c, Q = _eigh(F.transpose(1, 2) @ F)  # c (n, 3), eigenvectors in Q's columns
        J = _det(F)
        K = self.K
        s = K * (J * J - J)[:, None] / c
        D = K * (J * J - 0.5 * J)[:, None, None] / (c[:, :, None] * c[:, None, :]) \
            - torch.diag_embed(K * (J * J - J)[:, None] / c**2)
        theta = -K * (J * J - J)[:, None, None] / (c[:, :, None] * c[:, None, :])
        for mu, a in zip(self.mu, self.alpha):
            m = a / 2.0
            A = 2.0 * mu / a**2 * J ** (-a / 3.0)
            T = (c**m).sum(1)
            g = a * c ** (m - 1) - (a / 3.0) * T[:, None] / c
            s = s + A[:, None] * g
            if tangent:
                dg = torch.diag_embed(a * (m - 1) * c ** (m - 2) + (a / 3.0) * T[:, None] / c**2) \
                    - (a / 3.0) * m * c[:, None, :] ** (m - 1) / c[:, :, None]
                D = D + A[:, None, None] * (-(a / 6.0) * g[:, :, None] / c[:, None, :] + dg)
                dd = _power_divided(c[:, :, None], c[:, None, :], m - 1)
                theta = theta + A[:, None, None] * (a * dd + (a / 3.0) * T[:, None, None]
                                                    / (c[:, :, None] * c[:, None, :]))
        S = Q @ torch.diag_embed(s) @ Q.transpose(1, 2)
        P = F @ S
        if not tangent:
            return P, None
        # the nine unit dF: dC = dF^T F + F^T dF on the eigenbasis
        E = torch.eye(9, dtype=F.dtype, device=F.device).reshape(9, 3, 3)
        FE = torch.einsum("kab,nbc->nkac", E.transpose(1, 2), F)  # dF^T F
        dC = Q.transpose(1, 2)[:, None] @ (FE + FE.transpose(2, 3)) @ Q[:, None]
        eye = torch.eye(3, dtype=F.dtype, device=F.device)
        diag = torch.diagonal(dC, dim1=2, dim2=3)  # (n, 9, 3)
        dS = theta[:, None] * dC * (1 - eye) + torch.diag_embed(torch.einsum("nij,nkj->nki", D, diag))
        dS = Q[:, None] @ dS @ Q.transpose(1, 2)[:, None]
        dP = E[None] @ S[:, None] + F[:, None] @ dS  # (n, 9 seeds, 3, 3)
        return P, dP.reshape(-1, 9, 9).transpose(1, 2)


def _no_tf32():
    """Float32 products in float32, not TF32 (the control's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def solve(cfg, device, dtype=torch.float64, max_newton=30):
    """The protocol from u = 0: ``cfg["steps"]`` uniform steps of the top
    face to ``-cfg["strain"]``, each from the secant predictor of the
    steps before, solved to ``1e-11`` of its entering residual or to its
    floor. Returns u after each step, numpy float64 in this module's
    numbering."""
    _no_tf32()
    b = Block(cfg, device, dtype)
    tol = 1e-11
    u = u_prev = torch.zeros(b.ndofs, dtype=dtype, device=device)
    out = []
    for k in range(int(cfg["steps"])):
        uz = -float(cfg["strain"]) * (k + 1) / int(cfg["steps"])
        u, u_prev = b.with_bcs(u + (u - u_prev), uz), u
        R, res, A = b.free_residual(u, True)
        res0 = max(res, 1e-300)
        for _ in range(max_newton):
            if res <= tol * res0:
                break
            Kd = b.stiffness(A)
            L, info = torch.linalg.cholesky_ex(Kd)
            if int(info) == 0:
                du_f = -torch.cholesky_solve(R[:, None], L)[:, 0]
            else:
                du_f = -torch.linalg.solve(Kd, R)
            du = torch.zeros_like(u).index_copy_(0, b.free, du_f)
            del L, Kd
            alpha, best = 1.0, None
            for k in range(11):  # the full step's tangent with its residual, the next once taken
                trial = b.free_residual(u + alpha * du, k == 0)
                if np.isfinite(trial[1]) and trial[1] < (1 - 1e-4 * alpha) * res:
                    best = trial
                    break
                alpha *= 0.5
            if best is None:  # no decrease left: the floor of the dtype
                break
            u = u + alpha * du
            R, res, A = best if best[2] is not None else b.free_residual(u, True)
        out.append(u.double().cpu().numpy())
    return out


def residual_ratios(cfg, outputs, device):
    """For each step k of ``outputs`` (u after each step, this module's
    numbering): the float64 residual norm on the free dofs at ``u_k`` over
    the same norm at the step's entering guess ``g_k = u_(k-1) + (u_(k-1) -
    u_(k-2))`` (``u_0 = u_(-1) = 0``), both with step k's boundary values
    (which a sound ``u_k`` holds already). Returns ``[(res(u_k),
    res(g_k))]``."""
    _no_tf32()
    b = Block(cfg, device, torch.float64)
    zero = torch.zeros(b.ndofs, dtype=torch.float64, device=device)
    prev2 = prev = zero
    out = []
    for k, u in enumerate(outputs):
        uz = -float(cfg["strain"]) * (k + 1) / int(cfg["steps"])
        g = b.with_bcs(prev + (prev - prev2), uz)
        u = torch.as_tensor(u, dtype=torch.float64, device=device)
        out.append((b.free_residual(b.with_bcs(u, uz))[1], b.free_residual(g)[1]))
        prev2, prev = prev, u
    return out


def _lattice(values, step, what):
    k = np.rint(values / step)
    if np.abs(values - k * step).max() > 1e-6 * step:
        raise ValueError(f"{what} off the reference lattice")
    return k.astype(np.int64)


def dof_order(cfg, node_coords):
    """Indices that put a dof vector numbered by ``node_coords`` (the
    program's nodes, three components each) in this module's numbering."""
    N = int(cfg["N"])
    M = 2 * N + 1
    i, j, k = (_lattice(node_coords[:, d], 1.0 / (2 * N), "node") for d in range(3))
    rid = (k * M + j) * M + i
    node_of = np.full(M**3, -1)
    node_of[rid] = np.arange(len(rid))
    if (node_of < 0).any() or len(rid) != len(node_of):
        raise ValueError("the program's nodes are not the reference's")
    return (3 * node_of[:, None] + np.arange(3)[None]).reshape(-1)


def point_order(cfg, x_q):
    """Indices that put a field at the points ``x_q (n, 3)`` (the
    program's) in this module's order of points; raises where the two sets
    of points differ by more than 1e-12."""
    mine = points(cfg)
    keys = [np.lexsort(np.round(x * 1e9).T[::-1]) for x in (mine, np.asarray(x_q))]
    if len(mine) != len(x_q):
        raise ValueError("the program's points are not the reference's")
    order = np.empty(len(mine), np.int64)
    order[keys[0]] = keys[1]
    if np.abs(np.asarray(x_q)[order] - mine).max() > 1e-12:
        raise ValueError("the program's points are not the reference's")
    return order


def points(cfg):
    """The physical quadrature points, ``(6 N^3 14, 3)``, in this module's
    order (tetrahedron by tetrahedron)."""
    N = int(cfg["N"])
    X = kuhn_tetrahedra(N) / (2.0 * N)
    L, _ = quadrature()
    return np.einsum("qv,evd->eqd", L, X).reshape(-1, 3)
