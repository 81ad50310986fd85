"""Hyperelastic behaviors: a strain energy in, PK1 and its consistent tangent
out by automatic differentiation.

A model is a scalar energy ``W(F)``: ``PK1 = dW/dF`` by reverse mode and the
tangent ``dPK1/dF`` by forward over reverse, with no hand-derived
fourth-order tensor. Per point, stretch powers use the eigh-free matrix
functions of ``ops/matfun.py`` (differentiable at F = I); the whole-batch
Ogden path works on the tuple algebra of ``ops/matfun_fm.py``.

The whole-batch Ogden calls are scopes of the port's tracer
(``utils/timers.py``): ``hyperelastic: constitutive update`` (PK1 and the
tangent) and ``hyperelastic: flux`` (PK1 alone, the line-search trials),
with the counters ``hyperelastic: points`` (the batch's points, each call),
``hyperelastic: padded points`` (the identity points that pad the tangent's
last chunk) and ``hyperelastic: chunks`` (the tangent chunks
differentiated).
"""

from __future__ import annotations

import torch
from torch.func import grad

from ..ops import matfun, tensors
from ..ops import matfun_fm as fm
from ..utils.timers import count, timer
from .base import FiniteStrainBehavior


def _trace(A):
    return A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]


class HyperelasticBehavior(FiniteStrainBehavior):
    """Base: subclasses implement ``strain_energy(F)`` on 3x3 deformation
    gradients."""

    def strain_energy(self, F):
        raise NotImplementedError

    def finite_strain_update(self, F, state, dt):
        return grad(lambda Fv: self.strain_energy(tensors.nonsym_to_mat(Fv)))(F), state


class SaintVenantKirchhoff(HyperelasticBehavior):
    """W = lambda/2 tr(E)^2 + mu tr(E^2), E = (C - I)/2."""

    def __init__(self, E, nu):
        self.E = E
        self.nu = nu

    def strain_energy(self, F):
        lmbda = self.E * self.nu / (1 + self.nu) / (1 - 2 * self.nu)
        mu = self.E / 2.0 / (1 + self.nu)
        C = F.T @ F
        Egl = 0.5 * (C - torch.eye(3, dtype=F.dtype, device=F.device))
        return 0.5 * lmbda * _trace(Egl) ** 2 + mu * _trace(Egl @ Egl)


class NeoHooke(HyperelasticBehavior):
    """Compressible neo-Hookean: W = mu/2 (I1_bar - 3) + K/2 (J - 1)^2."""

    def __init__(self, mu, K):
        self.mu = mu
        self.K = K

    def strain_energy(self, F):
        C = F.T @ F
        J = tensors.det33(F)
        I1b = _trace(C) * J ** (-2.0 / 3.0)
        return 0.5 * self.mu * (I1b - 3.0) + 0.5 * self.K * (J - 1.0) ** 2


def _gradient(energy, x, hessian):
    """The gradient of the summed per-point ``energy`` at ``x (n, m)`` and,
    with ``hessian``, its Hessian columns ``(m, n, m)``: ``H[q, :, p] =
    d2W / dx_q dx_p``, reverse over reverse with the m unit seeds batched
    into one backward pass (per-point energies do not couple). Fewer host
    operations than ``jvp`` under ``vmap``, the same values to rounding."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(energy(x).sum(), x, create_graph=hessian)
        if not hessian:
            return g, None
        m = x.shape[1]
        seeds = torch.eye(m, dtype=x.dtype, device=x.device)[:, None, :].expand(m, *x.shape)
        (H,) = torch.autograd.grad(g, x, seeds, is_grads_batched=True)
    return g.detach(), H


def _chunked(fn, Fv, chunk):
    """``fn`` over chunks of ``chunk`` points, in order, the batch padded with
    identity F (a regular point) to a chunk multiple: peak memory O(chunk).
    ``fn(F (m, 9)) -> tuple of (m, k) tensors``."""
    n = Fv.shape[0]
    if n <= chunk:
        count("hyperelastic: chunks")
        return fn(Fv)
    pad = (-n) % chunk
    count("hyperelastic: chunks", (n + pad) // chunk)
    count("hyperelastic: padded points", pad)
    if pad:
        eye = torch.eye(3, dtype=Fv.dtype, device=Fv.device).reshape(1, 9).expand(pad, 9)
        Fv = torch.cat([Fv, eye])
    parts = [fn(Fc) for Fc in Fv.split(chunk)]
    return tuple(torch.cat(p)[:n] for p in zip(*parts))


class Ogden(HyperelasticBehavior):
    """Multi-term compressible Ogden model on isochoric principal stretches:

    W = sum_p 2 mu_p / alpha_p^2 (lbar_1^alpha_p + lbar_2^alpha_p + lbar_3^alpha_p - 3)
        + K/2 (J - 1)^2

    with lbar_i = J^(-1/3) lambda_i, i.e. sum lbar^alpha = tr(Cbar^(alpha/2)).
    The default is the MFront Ogden behavior of the composite benchmark
    (alpha = 28.8, mu_mfront = 27778, K = 69444444) in this convention: mu =
    mu_mfront alpha / 2, K verbatim.

    ``tangent_mode``: "c6" (default), six Hessian seeds of S(C6) = 2 dW/dC in
    Mandel coordinates and the closed-form wrap dP = dF S + F (H : dC); "f9",
    nine seeds of dPK1/dF. ``tangent_chunk`` points are differentiated at a
    time: 2^17 takes a mesh of up to 131,072 points (the 84,000 of the P2-tet
    block at N = 10) in one chunk, unpadded; each chunk costs the same host
    launches whatever its size.
    """

    #: ||X||_F below which (X = C/c - I, c = tr(C)/3) the near-spherical
    #: series replaces the Cardano branch per point
    _spherical_switch = 0.15
    #: 1 - |r| (r = det X / (2 (||X||^2 / 6)^(3/2)) = cos 3 theta) below which
    #: the coincident-pair series replaces the Cardano branch per point: two
    #: eigenvalues of C within ~1e-2 of their spread
    _pair_switch = 1e-3

    def __init__(self, mu=(27778.0 * 28.8 / 2,), alpha=(28.8,), K=69444444.0, tangent_chunk=131072,
                 tangent_mode="c6"):
        self.mu = tuple(mu)
        self.alpha = tuple(alpha)
        self.K = K
        self.tangent_chunk = int(tangent_chunk)
        self.tangent_mode = tangent_mode

    def strain_energy(self, F):
        C = F.T @ F
        J = torch.sqrt(tensors.det33(C))
        W = 0.5 * self.K * (J - 1.0) ** 2
        logC = matfun.logm(C)
        for mu_p, a_p in zip(self.mu, self.alpha):
            trCa = _trace(matfun.expm(0.5 * a_p * logC))  # tr(Cbar^(a/2)) = J^(-a/3) tr(C^(a/2))
            W = W + 2.0 * mu_p / a_p**2 * (J ** (-a_p / 3.0) * trCa - 3.0)
        return W

    # ---------------------------------------------------- whole-batch path
    def strain_energy_batched(self, Fv):
        """Energy of a batch ``Fv (n, 9) -> W (n,)``. Stretch powers tr(C^(a/2))
        come per point from one of two branches:

        - Cardano eigenvalues (``matfun_fm.t_eigvals_sym``) for spread
          spectra: the energy is an isotropic invariant, so no eigenvectors;
        - a near-spherical series where ||C/c - I||_F < 0.15: tr(C^s) = c^s
          sum_k binom(s, k) p_k(X), the power sums p_k of the traceless X
          from Newton's recurrence. Smooth and ~1e-13 exact at coincident
          eigenvalues (F = I), where AD through Cardano's arccos clamp loses
          ~5 digits of tangent."""
        F = fm.t_from_nonsym_rows(Fv)
        return self._energy_from_Ct(fm.t_bmm(fm.t_transpose(F), F))

    def _energy_from_C6(self, C6):
        """Energy from the Mandel right Cauchy-Green rows ``C6 (n, 6)``."""
        sq2 = 2.0**0.5
        v = C6.T
        d01, d02, d12 = v[3] / sq2, v[4] / sq2, v[5] / sq2
        return self._energy_from_Ct(((v[0], d01, d02), (d01, v[1], d12), (d02, d12, v[2])))

    def _energy_from_Ct(self, C):
        """The invariant energy on a tuple-form batched C."""
        J = torch.sqrt(fm.t_det(C))
        W = 0.5 * self.K * (J - 1.0) ** 2

        # X = C/c - I is traceless: its invariants are e2 = -||X||^2 / 2 and
        # e3 = det X, no matrix products
        c = fm.t_trace(C) / 3.0
        X = tuple(tuple(C[i][j] / c - (1.0 if i == j else 0.0) for j in range(3)) for i in range(3))
        p2 = sum(X[i][j] * X[i][j] for i in range(3) for j in range(3))
        e2 = -0.5 * p2
        e3 = fm.t_det(X)
        near = p2 < self._spherical_switch**2

        # power sums of X's eigenvalues by Newton's recurrence (e1 = 0)
        n_terms = 24
        psums = [3.0 * torch.ones_like(p2), torch.zeros_like(p2), p2, 3.0 * e3]
        for k in range(4, n_terms + 1):
            psums.append(-e2 * psums[k - 2] + e3 * psums[k - 3])

        # the Cardano branch sees a well-separated dummy spectrum on the
        # near-spherical points: reverse mode multiplies the unselected
        # branch's local derivative (NaN at an exact degeneracy in f32) by a
        # zero cotangent, which would give NaN
        dummy = (1.0, 2.0, 3.0)
        C_safe = tuple(
            tuple(torch.where(near, c * dummy[i] if i == j else 0.0 * C[i][j], C[i][j]) for j in range(3))
            for i in range(3)
        )
        lams = fm.t_eigvals_sym(C_safe)  # squared stretches

        # two coincident eigenvalues: Cardano's r = cos 3 theta reaches +-1,
        # where its clamped arccos keeps the energy and its gradient but not
        # the Hessian. With X's eigenvalues 2 rho cos(theta + 2 pi k / 3), the
        # simple one is x_s = 2 sgn(r) rho u (u = cos(theta / 3), the root
        # near 1 of 4u^3 - 3u = |r|, by Newton from 1) and the pair's are m -
        # 1 +- d with m = 1 - x_s / 2, d^2 = 3 rho^2 (1 - u^2): its stretch
        # powers (m + d)^s + (m - d)^s = 2 m^s sum_k binom(s, 2k) (d/m)^2k
        # are smooth in C. Points off the branch see a dummy pair.
        rho2 = torch.where(near, torch.ones_like(p2), p2 / 6.0)
        r = torch.where(near, torch.zeros_like(e3), e3) / (2.0 * rho2 * torch.sqrt(rho2))
        pair = ~near & (r.abs() > 1.0 - self._pair_switch)
        ra = torch.where(pair, r.abs(), torch.ones_like(r))
        rho = torch.where(pair, torch.sqrt(rho2), torch.full_like(r, 0.1))
        u = torch.ones_like(ra)
        for _ in range(4):
            u = u - (4.0 * u**3 - 3.0 * u - ra) / (12.0 * u * u - 3.0)
        x_s = 2.0 * torch.where(r < 0, -rho, rho) * u
        m = 1.0 - 0.5 * x_s
        q = 3.0 * rho * rho * (1.0 - u * u) / (m * m)
        pair = pair & (q < 0.01)

        for mu_p, a_p in zip(self.mu, self.alpha):
            s_exp = 0.5 * a_p
            tr_a_cardano = sum(torch.clamp(lam, min=1e-12) ** s_exp for lam in lams)
            # tr((I+X)^s) = sum_k binom(s, k) p_k: 24 terms are ~1e-15 exact at
            # the 0.15 radius for |alpha| <= ~30
            tr_exp = psums[0]
            coef = 1.0
            for k in range(1, n_terms + 1):
                coef = coef * (s_exp - (k - 1)) / k
                tr_exp = tr_exp + coef * psums[k]
            tr_pair, coef, qk = 2.0 * torch.ones_like(q), 1.0, torch.ones_like(q)
            for k in range(1, 9):  # ~1e-16 at q = 0.01 for |alpha| <= ~30
                coef = coef * (s_exp - (2 * k - 2)) * (s_exp - (2 * k - 1)) / ((2 * k - 1) * 2 * k)
                qk = qk * q
                tr_pair = tr_pair + 2.0 * coef * qk
            tr_pair = (1.0 + x_s) ** s_exp + m**s_exp * tr_pair
            tr_a = torch.where(near, c**s_exp * tr_exp, torch.where(pair, c**s_exp * tr_pair, tr_a_cardano))
            W = W + 2.0 * mu_p / a_p**2 * (J ** (-a_p / 3.0) * tr_a - 3.0)
        return W

    def batched_update(self, Fv, state, dt):
        """Whole-batch ``(PK1 (n, 9), Ct (n, 81), state)``: PK1 from one
        reverse-mode pass over the batch energy (per-point energies are
        independent, so the gradient of the sum is the per-point gradient),
        the tangent from its Hessian columns, chunk by chunk.

        "c6" (default): P = F S(C) with S = 2 dW/dC, so dP = dF S + F (H :
        dC), dC = dF^T F + F^T dF, with H = dS/dC the 6x6 Mandel Hessian.
        Only H needs AD (6 seeds of the 6-dim map S(C6)); dC per F-seed and
        the wraps are closed-form elementwise products. "f9": 9 seeds of
        dPK1/dF."""
        with timer("hyperelastic: constitutive update", device=Fv.device):
            count("hyperelastic: points", Fv.shape[0])
            return self._update(Fv, state)

    def _update(self, Fv, state):
        if self.tangent_mode == "c6":
            pk1, Ct = _chunked(lambda Fc: self._c6_chunk(Fc, True), Fv, self.tangent_chunk)
            return pk1, Ct, state

        def tangent(Fc):
            pk1, cols = _gradient(self.strain_energy_batched, Fc, True)  # cols (9_in, nc, 9_out)
            return pk1, cols.permute(1, 2, 0).reshape(Fc.shape[0], 81)

        pk1, Ct = _chunked(tangent, Fv, self.tangent_chunk)
        return pk1, Ct, state

    def batched_flux(self, Fv, state, dt):
        """PK1 alone, ``(PK1 (n, 9), state)``: the same arithmetic as
        :meth:`batched_update`'s PK1 without the tangent (line-search
        trials)."""
        with timer("hyperelastic: flux", device=Fv.device):
            count("hyperelastic: points", Fv.shape[0])
            if self.tangent_mode == "c6":
                return self._c6_chunk(Fv, False)[0], state
            return _gradient(self.strain_energy_batched, Fv, False)[0], state

    def _c6_chunk(self, Fc, tangent):
        """PK1 and, with ``tangent``, the factored-through-C tangent of one
        chunk (else None)."""
        sq2 = 2.0**0.5
        nc = Fc.shape[0]
        F3 = fm.from_nonsym_rows(Fc)
        C6 = fm.to_sym_cols(fm.bmm(fm.transpose(F3), F3)).T  # (nc, 6)
        # Mandel is an orthonormal basis of symmetric tensors: the gradient in
        # the 6 coordinates is the tensor gradient's Mandel form, S = 2 dW/dC
        g, H = _gradient(self._energy_from_C6, C6, tangent)
        S3 = fm.from_sym_cols(2.0 * g.T)
        P3 = fm.bmm(F3, S3)
        if not tangent:
            return fm.to_nonsym_rows(P3), None
        Hcols = 2.0 * H  # Hcols[q, :, p] = dS_p / dC_q

        zero = Fc.new_zeros(nc)
        cols = []
        for i, j in fm.NONSYM_IJ:
            # dC = e_j (x) h + h (x) e_j with h = F[i, :], as a Mandel 6-vector
            h = F3[i]
            diag = [zero, zero, zero]
            diag[j] = 2.0 * h[j]
            off = [  # [12, 13, 23] Mandel slots
                sq2 * ((h[1] if j == 0 else zero) + (h[0] if j == 1 else zero)),
                sq2 * ((h[2] if j == 0 else zero) + (h[0] if j == 2 else zero)),
                sq2 * ((h[2] if j == 1 else zero) + (h[1] if j == 2 else zero)),
            ]
            dS6 = torch.einsum("qnp,qn->pn", Hcols, torch.stack(diag + off))
            # dP = e_i (x) S3[j, :] + F dS
            dP = fm.bmm(F3, fm.from_sym_cols(dS6))
            ES = torch.stack([S3[j] if a == i else torch.zeros_like(S3[j]) for a in range(3)])
            cols.append(fm.to_nonsym_rows(dP + ES))
        return fm.to_nonsym_rows(P3), torch.stack(cols, dim=-1).reshape(nc, 81)
