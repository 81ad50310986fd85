"""Crystal (visco)plasticity: Meric-Cailletaud single crystal, FCC
octahedral slip.

Counterpart of dolfinx_materials_tpu/models/crystal.py (MFront's
MericCailletaudSingleCrystalViscoPlasticity: 12 slip systems, Norton flow
per system, per-system isotropic hardening through an interaction matrix and
an Armstrong-Frederick back-strain; the finite-strain variant is
``HenckyFiniteStrain(MericCailletaudCrystalPlasticity())``).

- The per-point update solves the 12 slip increments with one IFT Newton
  (``ops.newton.newton_solve``); ``Material`` differentiates through it.
- The whole-batch path (``batched_update``) works on (12, n) / (6, n)
  tensors: a damped Newton with an early exit (one host read of the step
  size per iteration), Jacobians from 12 forward-mode seeds, a pivot-free
  LU over the (12, 12, n) Jacobian, and the consistent tangent from 6 more
  solves against the converged Jacobian (implicit function theorem).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from ..ops import tensors
from ..ops.newton import newton_solve
from .base import SmallStrainBehavior


def fcc_slip_systems():
    """The 12 FCC octahedral systems {111}<110> as (normals, directions), unit
    vectors, deduplicated up to direction sign. Deterministic order: planes
    (1,1,1), (-1,1,1), (1,-1,1), (1,1,-1), three <110> directions each."""
    planes = [(1, 1, 1), (-1, 1, 1), (1, -1, 1), (1, 1, -1)]
    dirs_all = []
    for a in range(3):
        for b in range(a + 1, 3):
            for s in (1, -1):
                d = np.zeros(3)
                d[a], d[b] = 1, s
                dirs_all.append(d)
    normals, dirs = [], []
    for n in planes:
        n = np.asarray(n, float)
        for d in dirs_all:
            if abs(np.dot(n, d)) < 1e-12:
                if any(np.allclose(d, -dd) and np.allclose(n, nn) for nn, dd in zip(normals, dirs)):
                    continue
                normals.append(n)
                dirs.append(np.asarray(d, float))
    normals = np.array(normals) / np.sqrt(3.0)
    dirs = np.array(dirs) / np.sqrt(2.0)
    assert len(normals) == 12
    return normals, dirs


def schmid_tensors_mandel(normals, dirs):
    """Symmetrized Schmid tensors mu_s = sym(d (x) n) as Mandel 6-vectors,
    (nss, 6): the resolved shears are one (nss, 6) x (6,) product."""
    mus = 0.5 * (dirs[:, :, None] * normals[:, None, :] + normals[:, :, None] * dirs[:, None, :])
    return np.asarray(tensors.mat_to_sym(torch.as_tensor(mus)))


def fcc_interaction_matrix(h_self=1.0, h_coplanar=1.0, h_hirth=0.6, h_lomer=1.8, h_glissile=1.6,
                           h_collinear=12.3):
    """12x12 FCC interaction matrix from the 6 interaction classes (self,
    coplanar, Hirth lock, Lomer lock, glissile junction, collinear), the
    class of each pair found from the slip geometry."""
    normals, dirs = fcc_slip_systems()
    nss = len(normals)
    H = np.zeros((nss, nss))
    for i in range(nss):
        for j in range(nss):
            ni, di = normals[i], dirs[i]
            nj, dj = normals[j], dirs[j]
            if i == j:
                H[i, j] = h_self
            elif abs(abs(np.dot(ni, nj)) - 1.0) < 1e-9:
                H[i, j] = h_coplanar
            elif abs(abs(np.dot(di, dj)) - 1.0) < 1e-9:
                H[i, j] = h_collinear
            elif abs(np.dot(di, dj)) < 1e-9:
                H[i, j] = h_hirth
            else:
                # junction direction: the +-combination that is a <110> direction
                for s in (1.0, -1.0):
                    b = di + s * dj
                    nb = np.linalg.norm(b)
                    if abs(nb - 1.0) < 1e-9:
                        glissile = abs(np.dot(b, ni)) < 1e-9 or abs(np.dot(b, nj)) < 1e-9
                        H[i, j] = h_glissile if glissile else h_lomer
                        break
                else:
                    H[i, j] = h_glissile
    return H


def cubic_elasticity_C(E, nu, G):
    """Mandel 6x6 stiffness of a cubic crystal (E, nu, G on the cube axes)."""
    S = np.zeros((6, 6))
    S[:3, :3] = -nu / E
    np.fill_diagonal(S[:3, :3], 1.0 / E)
    S[3, 3] = S[4, 4] = S[5, 5] = 1.0 / (2.0 * G)
    return np.linalg.inv(S)


class MericCailletaudCrystalPlasticity(SmallStrainBehavior):
    """Meric-Cailletaud single-crystal viscoplasticity (small strain, theta = 1).

    Per slip system s: Norton flow dg_s = dt ((|tau_s - x_s| - r_s)_+ / K)^n
    sgn(tau_s - x_s), isotropic hardening r_s = tau0 + Q sum_j H_sj (1 -
    e^{-b p_j}), back-stress x_s = C_kin (a_s + da_s), da_s = (dg_s - d a_s
    |dg_s|) / (1 + d |dg_s|). Internal state: eps_p (6), g, p, a (nss each).

    Whole-batch Newton: ``fm_newton_iters`` at most, the first
    ``fm_damped_iters`` with a ``fm_backtracks``-trial line search, exit when
    max |step| / (1 + max |dg|) <= ``fm_tol`` (1e-12 in float64, 3e-6 in
    float32 when None). ``last_newton_iters`` holds the iteration count of
    the last whole-batch solve; each iteration reads its exit test on the
    host once.
    """

    def __init__(self, E=208000.0, nu=0.3, G=80000.0, n=10.0, K=25.0, tau0=66.62, Q=11.43, b=2.1, d=494.0,
                 C_kin=14363.0, interaction_matrix=None, tol=1e-12, max_iter=60, fm_newton_iters=48,
                 fm_backtracks=6, fm_ridge=1e-12, fm_damped_iters=10, fm_tol=None, use_batched_fast=True):
        self.C6 = cubic_elasticity_C(E, nu, G)
        normals, dirs = fcc_slip_systems()
        self.mus = schmid_tensors_mandel(normals, dirs)  # (nss, 6)
        self.nss = self.mus.shape[0]
        self.H = np.asarray(interaction_matrix if interaction_matrix is not None else fcc_interaction_matrix())
        self.n = n
        self.K = K
        self.tau0 = tau0
        self.Q = Q
        self.b = b
        self.d = d
        self.C_kin = C_kin
        self.tol = tol
        self.max_iter = max_iter
        self.fm_newton_iters = fm_newton_iters
        self.fm_backtracks = fm_backtracks
        self.fm_ridge = fm_ridge
        self.fm_damped_iters = fm_damped_iters
        self.fm_tol = fm_tol
        self.last_newton_iters = None
        self._tensors = {}
        if not use_batched_fast:
            self.batched_update = None
            self.batched_flux = None

    def init_state(self):
        z = np.zeros(self.nss)
        return {"eps_p": np.zeros(6), "g": z, "p": z, "a": z}

    def _consts(self, like):
        """``(C6, mus, H)`` as tensors of ``like``'s dtype and device."""
        key = (like.dtype, like.device)
        if key not in self._tensors:
            self._tensors[key] = tuple(torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)
                                       for a in (self.C6, self.mus, self.H))
        return self._tensors[key]

    def _dt_safe(self, dt, like):
        return torch.clamp(torch.as_tensor(dt, dtype=like.dtype, device=like.device), min=1e-14)

    def small_strain_update(self, eps, state, dt):
        C6, mus, H = self._consts(eps)
        eps_p, g, p, a = state["eps_p"], state["g"], state["p"], state["a"]
        dt_safe = self._dt_safe(dt, eps)

        def residual(dg, eps, eps_p, p, a, dt_safe):
            abs_dg = torch.abs(dg)
            eps_el = eps - eps_p - dg @ mus
            sig = C6 @ eps_el
            tau = mus @ sig
            r = self.tau0 + self.Q * H @ (1.0 - torch.exp(-self.b * (p + abs_dg)))
            da = (dg - self.d * a * abs_dg) / (1.0 + self.d * abs_dg)
            x = self.C_kin * (a + da)
            f = tensors.pos(torch.abs(tau - x) - r)
            return dg - dt_safe * (f / self.K) ** self.n * torch.sign(tau - x)

        dg, _ = newton_solve(residual, eps.new_zeros(self.nss), args=(eps, eps_p, p, a, dt_safe),
                             tol=self.tol * self.nss, max_iter=self.max_iter)
        abs_dg = torch.abs(dg)
        deps_p = dg @ mus
        sig = C6 @ (eps - eps_p - deps_p)
        da = (dg - self.d * a * abs_dg) / (1.0 + self.d * abs_dg)
        return sig, {"eps_p": eps_p + deps_p, "g": g + dg, "p": p + abs_dg, "a": a + da}

    # ---------------------------------------------------- whole-batch path
    def _fm_residual(self, dg, eps_T, eps_p_T, p_T, a_T, dt_safe):
        """The residual on (nss | 6, n) tensors: resolved shears and hardening
        are (12, 6) x (6, n) and (12, 12) x (12, n) products."""
        C6, mus, H = self._consts(dg)
        abs_dg = torch.abs(dg)
        eps_el = eps_T - eps_p_T - mus.T @ dg
        tau = mus @ (C6 @ eps_el)
        r_iso = self.tau0 + self.Q * (H @ (1.0 - torch.exp(-self.b * (p_T + abs_dg))))
        da = (dg - self.d * a_T * abs_dg) / (1.0 + self.d * abs_dg)
        x_back = self.C_kin * (a_T + da)
        f = tensors.pos(torch.abs(tau - x_back) - r_iso)
        return dg - dt_safe * (f / self.K) ** self.n * torch.sign(tau - x_back)

    @staticmethod
    def _fm_lu_solve(J, rhs, ridge):
        """Pivot-free LU of ``J (nss, nss, n)`` with a relative ridge on the
        diagonal, then solves for ``rhs (m, nss, n)``; returns (m, nss, n).

        Doolittle by pivots: one division and one outer-product update of the
        trailing block per pivot, so each factor entry gets the arithmetic of
        the entry-by-entry elimination. The substitutions run by columns
        (the sums of the back substitution in the reverse order of a row
        loop). No pivoting: the plasticity Jacobians here are identity plus
        rate terms with dominant diagonals."""
        nss = J.shape[0]
        dscale = sum(torch.abs(J[i, i]) for i in range(nss)) / nss
        A = J.clone()
        diag = torch.arange(nss, device=J.device)
        A[diag, diag] = A[diag, diag] + ridge * dscale
        for k in range(nss - 1):
            lk = A[k + 1:, k] * (1.0 / A[k, k])
            A[k + 1:, k] = lk
            A[k + 1:, k + 1:] -= lk[:, None] * A[k, k + 1:][None]
        y = rhs.clone()
        for j in range(nss - 1):
            y[:, j + 1:] -= A[j + 1:, j] * y[:, j:j + 1]
        for j in reversed(range(nss)):
            y[:, j] = y[:, j] / A[j, j]
            if j:
                y[:, :j] -= A[:j, j] * y[:, j:j + 1]
        return y

    def _fm_jacobian(self, dg, eps_T, eps_p_T, p_T, a_T, dt_safe):
        """J[i, j, n] = d res_i / d dg_j by 12 forward-mode seeds (one vmap of
        jvp with a shared primal)."""
        nss, n = dg.shape
        seeds = torch.eye(nss, dtype=dg.dtype, device=dg.device)[:, :, None].expand(nss, nss, n)
        res = lambda x: self._fm_residual(x, eps_T, eps_p_T, p_T, a_T, dt_safe)  # noqa: E731
        tang = vmap(lambda s: jvp(res, (dg,), (s,))[1])(seeds)
        return tang.permute(1, 0, 2)

    def _fm_solve(self, eps_T, eps_p_T, p_T, a_T, dt_safe):
        """The slip increments (nss, n): backtracking steps for the first
        ``fm_damped_iters`` iterations (the virgin state's rate power
        overflows on full steps), full steps after, until the step size
        test passes (read on the host once an iteration)."""
        res = lambda x: self._fm_residual(x, eps_T, eps_p_T, p_T, a_T, dt_safe)  # noqa: E731
        n = eps_T.shape[1]
        dtype = eps_T.dtype
        tol = self.fm_tol
        if tol is None:
            tol = 1e-12 if torch.finfo(dtype).eps < 1e-9 else 3e-6
        dg = eps_T.new_zeros((self.nss, n))
        it = 0
        while it < self.fm_newton_iters:
            r = res(dg)
            J = self._fm_jacobian(dg, eps_T, eps_p_T, p_T, a_T, dt_safe)
            dx = self._fm_lu_solve(J, r[None], self.fm_ridge)[0]
            if it < self.fm_damped_iters:
                rn0 = torch.sum(r * r, dim=0)
                alpha = torch.ones_like(rn0)
                best = torch.full_like(rn0, float("inf"))
                chosen = torch.ones_like(rn0)
                for _ in range(self.fm_backtracks):
                    rt = res(dg - alpha * dx)
                    rn = torch.sum(rt * rt, dim=0)
                    rn = torch.where(torch.isfinite(rn), rn, torch.full_like(rn, float("inf")))
                    better = rn < best
                    chosen = torch.where(better, alpha, chosen)
                    best = torch.where(better, rn, best)
                    alpha = 0.5 * alpha
                # the best trial if it improves, else a hard damping
                chosen = torch.where(best < rn0, chosen, alpha)
            else:
                chosen = torch.ones((n,), dtype=dtype, device=dg.device)
            dg = dg - chosen * dx
            err = torch.max(torch.abs(chosen * dx)) / (1.0 + torch.max(torch.abs(dg)))
            it += 1
            if not bool(err > tol):  # NaN exits too, as in the JAX loop's test
                break
        self.last_newton_iters = it
        return dg

    def _fm_state(self, eps, state, dt):
        """``(dg, sig (6, n), new_state, transposed inputs)`` of one batch."""
        dtype = eps.dtype
        eps_T = eps.T
        eps_p_T = state["eps_p"].to(dtype).T
        p_T = state["p"].to(dtype).T
        a_T = state["a"].to(dtype).T
        dt_safe = self._dt_safe(dt, eps)
        C6, mus, _ = self._consts(eps)
        dg = self._fm_solve(eps_T, eps_p_T, p_T, a_T, dt_safe)
        abs_dg = torch.abs(dg)
        deps_p = mus.T @ dg
        sig = C6 @ (eps_T - eps_p_T - deps_p)
        da = (dg - self.d * a_T * abs_dg) / (1.0 + self.d * abs_dg)
        new_state = {"eps_p": (eps_p_T + deps_p).T, "g": state["g"].to(dtype) + dg.T, "p": (p_T + abs_dg).T,
                     "a": (a_T + da).T}
        return dg, sig, new_state, (eps_T, eps_p_T, p_T, a_T, dt_safe)

    def batched_update(self, eps, state, dt):
        """Whole-batch stress, consistent 6x6 tangent (n, 36) and new state:
        the tangent from the implicit function theorem at the converged
        root, J ddg_k = -d res/d eps . e_k, dsig/deps_k = C6 (e_k - mus^T
        ddg_k), never differentiating the Newton loop."""
        n = eps.shape[0]
        dg, sig, new_state, (eps_T, eps_p_T, p_T, a_T, dt_safe) = self._fm_state(eps, state, dt)
        C6, mus, _ = self._consts(eps)
        J = self._fm_jacobian(dg, eps_T, eps_p_T, p_T, a_T, dt_safe)
        res_eps = lambda e: self._fm_residual(dg, e, eps_p_T, p_T, a_T, dt_safe)  # noqa: E731
        eye6 = torch.eye(6, dtype=eps.dtype, device=eps.device)
        rhs = vmap(lambda s: jvp(res_eps, (eps_T,), (s,))[1])(eye6[:, :, None].expand(6, 6, n))
        ddg = self._fm_lu_solve(J, -rhs, self.fm_ridge)  # (6, nss, n)
        cols = C6 @ (eye6[:, :, None] - mus.T @ ddg)  # (6_in, 6_out, n)
        return sig.T, cols.permute(2, 1, 0).reshape(n, 36), new_state

    def batched_flux(self, eps, state, dt):
        """Tangent-free whole-batch update (line-search trials)."""
        _, sig, new_state, _ = self._fm_state(eps, state, dt)
        return sig.T, new_state
