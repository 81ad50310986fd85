"""Exact plane-stress return mappings on non-smooth and smooth conic yield
surfaces: Rankine, L1-Rankine, Hosford and von Mises.

Counterpart of dolfinx_materials_tpu/models/conic_exact.py. The reference
solves one conic program per Gauss point (cvxpy); here the plane-stress
elastic metric is isotropic, so the projection keeps the trial principal
axes and reduces to projecting the two trial principal stresses:

- Rankine and L1-Rankine: onto a convex polygon, by enumerating the
  interior point, the metric projection onto each edge line and each
  vertex, masking the infeasible candidates and keeping the one of least
  metric distance (``argmin``: the first on a tie, as in the JAX package);
- Hosford: the 3x3 KKT system solved by ``ops.newton.newton_solve`` (its
  residual holds the gradient of the yield function, so the root's Jacobian
  is forward over reverse);
- plane-stress von Mises: one scalar secular equation in the basis of a
  generalized eigenproblem solved once on the host.

``tangent="consistent"`` (default) differentiates the projection;
``tangent="elastic"`` returns the projected value with the elastic C as its
derivative (the reference's choice), the split written with ``.detach()``.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch
from torch.func import grad

from ..ops.newton import newton_solve, scalar_newton_solve
from .base import Behavior

_BIG = 1e30
_SQ2 = 2.0**0.5


def _principal_2x2(sig3):
    """Mandel (s0, s1, sqrt2 s01) -> (lam1 >= lam2, cos 2t, sin 2t); the
    radius is floored at a scale-relative tiny so forward-mode tangents stay
    finite at coincident principal stresses."""
    T = sig3[0] + sig3[1]
    dx = 0.5 * (sig3[0] - sig3[1])
    dy = sig3[2] / _SQ2
    scale = torch.abs(T) + torch.abs(dx) + torch.abs(dy)
    tiny = 1e-12 * scale + 1e-290
    R = torch.sqrt(dx * dx + dy * dy + tiny * tiny)
    return 0.5 * T + R, 0.5 * T - R, dx / R, dy / R


def _recompose_2x2(lam1, lam2, c2t, s2t):
    """Principal values and trial axes -> Mandel (3,)."""
    m = 0.5 * (lam1 + lam2)
    d = 0.5 * (lam1 - lam2)
    return torch.stack([m + d * c2t, m - d * c2t, _SQ2 * d * s2t])


def _project_polygon(t, A, edges, vertices, tol_scale):
    """Exact metric projection of ``t`` (2,) onto the convex polygon {lam :
    g . lam <= b for (g, b) in edges} under the metric ``A``; ``vertices``
    (numpy (nv, 2)) are candidate corners, infeasible ones masked out."""
    Ainv = torch.linalg.inv(A)
    G = edges[:, :2]
    b = edges[:, 2]
    tol = 1e-9 * tol_scale
    cands = [t]
    for e in range(edges.shape[0]):
        g, be = G[e], b[e]
        Ag = Ainv @ g
        cands.append(t - Ag * ((g @ t - be) / (g @ Ag)))
    for vtx in vertices:
        cands.append(torch.as_tensor(vtx, dtype=t.dtype, device=t.device))
    P = torch.stack(cands)  # (nc, 2)
    feas = torch.all(P @ G.T <= b + tol, dim=1)
    finite = torch.all(torch.isfinite(P), dim=1)
    d = P - t
    obj = torch.sum(d * (d @ A.T), dim=1)
    obj = torch.where(feas & finite, obj, torch.full_like(obj, _BIG))
    # P[argmin] as a masked sum (a data-dependent index has no vmap rule)
    pick = torch.arange(P.shape[0], device=P.device) == torch.argmin(obj)
    return torch.sum(torch.where(pick[:, None], P, torch.zeros_like(P)), dim=0)


class _ExactConicPlaneStress(Behavior):
    """Plane-stress elasticity and an exact principal-space projection, in
    the reference's CvxPyMaterial protocol: gradient Strain (3,), flux
    Stress (3,), incremental driving from the stored (Strain, Stress)
    state, perfect plasticity."""

    gradients = {"Strain": 3}
    fluxes = {"Stress": 3}

    def __init__(self, E, nu, ft, fc, tangent="consistent"):
        self.E, self.nu = float(E), float(nu)
        self.ft, self.fc = float(ft), float(fc)
        if tangent not in ("consistent", "elastic"):
            raise ValueError(f"tangent must be 'consistent' or 'elastic', got {tangent!r}")
        self.tangent = tangent
        E_, nu_ = self.E, self.nu
        # plane-stress stiffness on the Mandel 3-vector (shear entry 2G)
        self.C = np.array([
            [E_ / (1 - nu_**2), E_ * nu_ / (1 - nu_**2), 0.0],
            [E_ * nu_ / (1 - nu_**2), E_ / (1 - nu_**2), 0.0],
            [0.0, 0.0, E_ / (1 + nu_)],
        ])
        # principal-space metric A = C_p^{-1}
        self.A = np.linalg.inv(E_ / (1 - nu_**2) * np.array([[1.0, nu_], [nu_, 1.0]]))

    def init_state(self):
        return {"Strain": np.zeros(3), "Stress": np.zeros(3)}

    def _edges_vertices(self):
        raise NotImplementedError

    def project(self, sig_trial3):
        """Exact return map of one trial Mandel stress (3,)."""
        like = dict(dtype=sig_trial3.dtype, device=sig_trial3.device)
        lam1, lam2, c2t, s2t = _principal_2x2(sig_trial3)
        edges, vertices = self._edges_vertices()
        edges_t = torch.as_tensor(edges, **like)
        t = torch.stack([lam1, lam2])
        p = _project_polygon(t, torch.as_tensor(self.A, **like), edges_t, vertices, tol_scale=max(self.ft, self.fc))
        projected = _recompose_2x2(torch.maximum(p[0], p[1]), torch.minimum(p[0], p[1]), c2t, s2t)
        # a feasible trial is returned verbatim: the elastic tangent stays exact
        feasible = torch.all(edges_t[:, :2] @ t <= edges_t[:, 2])
        return torch.where(feasible, sig_trial3, projected)

    def constitutive_update(self, inputs, state, dt):
        eps = inputs["Strain"]
        C = torch.as_tensor(self.C, dtype=eps.dtype, device=eps.device)
        sig_tr = state["Stress"] + C @ (eps - state["Strain"])
        if self.tangent == "elastic":
            # the exact projection's value with the elastic C as its derivative
            sig = self.project(sig_tr).detach() + C @ eps - (C @ eps).detach()
        else:
            sig = self.project(sig_tr)
        return {"Stress": sig}, {"Strain": eps, "Stress": sig}


class RankineExact(_ExactConicPlaneStress):
    """Exact Rankine: -fc <= lambda_i <= ft."""

    def _edges_vertices(self):
        ft, fc = self.ft, self.fc
        edges = np.array([[1.0, 0.0, ft], [0.0, 1.0, ft], [-1.0, 0.0, fc], [0.0, -1.0, fc]])
        vertices = np.array([[ft, ft], [ft, -fc], [-fc, ft], [-fc, -fc]])
        return edges, vertices


class L1RankineExact(_ExactConicPlaneStress):
    """Exact L1-Rankine: T <= ft, T >= -fc, lam_i/ft - lam_j/fc <= 1."""

    def _edges_vertices(self):
        ft, fc = self.ft, self.fc
        edges = np.array([
            [1.0, 1.0, ft],
            [-1.0, -1.0, fc],
            [1.0 / ft, -1.0 / fc, 1.0],
            [-1.0 / fc, 1.0 / ft, 1.0],
        ])

        def isect(e1, e2):
            M = np.array([e1[:2], e2[:2]])
            if abs(np.linalg.det(M)) < 1e-14:
                return np.array([np.inf, np.inf])
            return np.linalg.solve(M, np.array([e1[2], e2[2]]))

        vertices = np.array([isect(edges[0], edges[2]), isect(edges[0], edges[3]), isect(edges[1], edges[2]),
                             isect(edges[1], edges[3]), isect(edges[2], edges[3])])
        return edges, vertices


class HosfordExact(_ExactConicPlaneStress):
    """Exact plane-stress Hosford projection: on in-plane principal stresses,
    g(lam) = |lam1 - lam2|^a + |lam1|^a + |lam2|^a - 2 sig0^a <= 0, a C^1
    surface for a > 2. The projection solves the KKT system A (lam - t) + mu
    grad g(lam) = 0, g(lam) = 0 in sig0-normalized variables by the damped
    Newton of ops/newton.py, warm-started from the radial return; the
    tangent comes from the implicit function theorem."""

    def __init__(self, E, nu, sig0, a=10.0, tangent="consistent"):
        super().__init__(E, nu, ft=sig0, fc=sig0, tangent=tangent)
        self.sig0 = float(sig0)
        self.a = float(a)
        self.A_hat = np.asarray(self.A) * self.E  # sig0-normalized metric, O(1) entries

    def _g_hat(self, lam_hat):
        """Normalized yield sum |x_i|^a - 2 on x = (l1 - l2, l1, l2) / sig0;
        (x^2 + tiny)^(a/2) keeps |x|^a differentiable at x = 0."""
        x = torch.stack([lam_hat[0] - lam_hat[1], lam_hat[0], lam_hat[1]])
        return torch.sum((x * x + 1e-60) ** (self.a / 2)) - 2.0

    def project(self, sig_trial3):
        dtype = sig_trial3.dtype
        lam1, lam2, c2t, s2t = _principal_2x2(sig_trial3)
        t_hat = torch.stack([lam1, lam2]) / self.sig0
        A_hat = torch.as_tensor(self.A_hat, dtype=dtype, device=sig_trial3.device)
        grad_g = grad(self._g_hat)

        def kkt(z, t_):
            lam, mu = z[:2], z[2]
            return torch.cat([A_hat @ (lam - t_) + mu * grad_g(lam), self._g_hat(lam).reshape(1)])

        # warm start: radial p-norm scaling onto the surface, least-squares mu
        g_t = self._g_hat(t_hat)
        scale = (2.0 / torch.clamp(g_t + 2.0, min=1e-30)) ** (1.0 / self.a)
        lam0 = t_hat * torch.clamp(scale, max=1.0)
        g0 = grad_g(lam0)
        mu0 = torch.clamp((g0 @ (A_hat @ (t_hat - lam0))) / torch.clamp(g0 @ g0, min=1e-30), min=0.0)
        eps_d = float(torch.finfo(dtype).eps)
        z, _ = newton_solve(kkt, torch.cat([lam0, mu0.reshape(1)]).detach(), args=(t_hat,),
                            tol=max(1e-13, 30.0 * eps_d), max_iter=60)
        p1 = torch.maximum(z[0], z[1]) * self.sig0
        p2 = torch.minimum(z[0], z[1]) * self.sig0
        projected = _recompose_2x2(p1, p2, c2t, s2t)
        return torch.where(g_t <= 0.0, sig_trial3, projected)


class PlaneStressVonMisesExact(_ExactConicPlaneStress):
    """Exact plane-stress von Mises projection, quad_form(sig, Q) <= sig0^2
    with the reference's Q = [[1, -1/2, 0], [-1/2, 1, 0], [0, 0, 1]] on the
    Mandel 3-vector. The generalized eigenproblem Q v = mu C^{-1} v, solved
    once on the host, diagonalizes the metric and the yield quadric
    together, so the projection is one scalar secular equation
    sum_i mu_i t_i^2 / (1 + lam mu_i)^2 = sig0^2 per point (scalar Newton,
    IFT tangent)."""

    def __init__(self, E, nu, sig0, Q=None, tangent="consistent"):
        super().__init__(E, nu, ft=sig0, fc=sig0, tangent=tangent)
        self.sig0 = float(sig0)
        self.Q = (np.array([[1.0, -0.5, 0.0], [-0.5, 1.0, 0.0], [0.0, 0.0, 1.0]]) if Q is None
                  else np.asarray(Q, float))
        A = np.linalg.inv(self.C)
        # an A-orthonormal eigenbasis, also for degenerate eigenvalues
        mus, V = scipy.linalg.eigh(self.Q, A)
        self._V = V  # sig = V @ sig_tilde
        self._W = V.T @ A  # sig_tilde = W @ sig
        self._mus = mus

    def project(self, sig_trial3):
        like = dict(dtype=sig_trial3.dtype, device=sig_trial3.device)
        t = torch.as_tensor(self._W, **like) @ sig_trial3
        mus = torch.as_tensor(self._mus, **like)
        sig0_2 = self.sig0**2

        def secular(lam, t_):
            s = t_ / (1.0 + lam * mus)
            return torch.sum(mus * s * s) - sig0_2

        inside = torch.sum(mus * t * t) - sig0_2 <= 0.0
        # dtype-aware tolerance (1e-12 sig0^2 is below float32 resolution)
        eps_d = float(torch.finfo(sig_trial3.dtype).eps)
        lam, _ = scalar_newton_solve(secular, torch.zeros((), **like), args=(t,),
                                     tol=max(1e-12, 10.0 * eps_d) * sig0_2, max_iter=60, lower=0.0)
        lam = torch.where(inside, torch.zeros_like(lam), lam)
        return torch.as_tensor(self._V, **like) @ (t / (1.0 + lam * mus))
