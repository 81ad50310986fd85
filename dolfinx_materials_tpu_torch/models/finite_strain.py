"""Finite-strain plasticity: multiplicative FeFp J2 and the Hencky
log-strain wrapper.

Counterpart of dolfinx_materials_tpu/models/finite_strain.py:

- ``FeFpJ2Plasticity``: gradient F (9), flux PK1 (9), internal state ``be``
  (elastic left Cauchy-Green, Mandel, init identity), ``p`` and ``F_prev``.
  The per-point update (the generic ``vmap(jacfwd)`` path) uses the
  product-only ``ops.matfun`` log/exp and the scalar IFT radial return; the
  whole-batch fast path (``batched_update``) works on (3, 3, n) / (6, n)
  tensors with the Gregory-series log, an unrolled radial-return Newton and
  either the factored consistent tangent ("analytic", 6 forward-mode seeds
  through the log series) or 9 seeds through the whole core ("jvp");
- ``HenckyFiniteStrain``: any small-strain behavior driven by the total
  Hencky strain 1/2 log(F^T F), PK1 from one reverse-mode pullback.

``torch.maximum`` stands wherever the JAX code has ``jnp.maximum``: both give
the slope 0.5 at a tie, which the ``jvp`` tangent mode differentiates
through.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vjp, vmap

from ..ops import matfun, tensors
from ..ops import matfun_fm as fm
from ..ops.newton import scalar_newton_solve
from .base import FiniteStrainBehavior


def _slope(f, x):
    """df/dx at ``x`` for an elementwise ``f`` (a hardening law or any
    traceable callable), by one forward-mode pass."""
    return jvp(f, (x,), (torch.ones_like(x),))[1]


class FeFpJ2Plasticity(FiniteStrainBehavior):
    """Multiplicative J2 elastoplasticity, Simo exponential return mapping.

    Hencky hyperelasticity in eps_e = 1/2 log(be): Kirchhoff stress tau =
    lambda tr(eps_e) I + 2 mu eps_e; von Mises yield on tau with isotropic
    hardening sigma_Y(p); trial be_tr = f be_old f^T, f = F F_prev^{-1}.

    ``fm_stretch_guard``: points whose ||S||_F (S = (be_tr - I)(be_tr +
    I)^{-1}) exceeds it leave the Gregory series' envelope and are poisoned
    with NaN on the fast path, so the solver's line search backtracks
    (None disables the guard). ``use_batched_fast=False`` shadows the fast
    path with instance attributes set to None, so ``Material`` runs the
    per-point path.
    """

    def __init__(self, elasticity, yield_stress, tol=1e-10, max_iter=50,
                 fm_gregory_terms=5, fm_newton_iters=16, fm_stretch_guard=0.33,
                 use_batched_fast=True, tangent_mode="analytic"):
        self.elasticity = elasticity
        self.yield_stress = yield_stress
        self.tol = tol
        self.max_iter = max_iter
        self.fm_gregory_terms = fm_gregory_terms
        self.fm_newton_iters = fm_newton_iters
        self.fm_stretch_guard = fm_stretch_guard
        #: "analytic" (default): factored tangent; "jvp": 9 seeds through the core
        self.tangent_mode = tangent_mode
        if not use_batched_fast:
            self.batched_update = None
            self.batched_flux = None

    def init_state(self):
        return {"be": tensors.I2.copy(), "p": np.zeros(()), "F_prev": tensors.I9.copy()}

    def finite_strain_update(self, Fvec, state, dt):
        el = self.elasticity
        mu = el.mu
        F = tensors.nonsym_to_mat(Fvec)
        F_prev = tensors.nonsym_to_mat(state["F_prev"])
        be_old = tensors.sym_to_mat(state["be"])
        p = state["p"]

        f_rel = F @ tensors.inv33(F_prev)
        be_tr = f_rel @ be_old @ f_rel.T
        eps_e_tr = tensors.mat_to_sym(0.5 * matfun.logm(be_tr))

        tau_tr = el.stress(eps_e_tr)
        s_tr = tensors.dev(tau_tr)
        sigY0 = self.yield_stress(p)
        q_tr = tensors.eq_vm_safe(tau_tr, 1.0 + sigY0)

        def residual(dp, f_act, p0):
            return f_act - 3.0 * mu * dp - (self.yield_stress(p0 + dp) - self.yield_stress(p0))

        f_act = tensors.pos(q_tr - sigY0)
        dp, _ = scalar_newton_solve(
            residual, torch.zeros_like(q_tr), args=(f_act, p),
            tol=self.tol * (1.0 + sigY0), max_iter=self.max_iter, lower=0.0,
        )

        n = 1.5 * s_tr / q_tr
        eps_e = eps_e_tr - dp * n
        tau = tau_tr - 2.0 * mu * dp * n

        be_new = matfun.expm(2.0 * tensors.sym_to_mat(eps_e))
        P = tensors.sym_to_mat(tau) @ tensors.inv33(F).T
        new_state = {"be": tensors.mat_to_sym(be_new), "p": p + dp, "F_prev": Fvec}
        return tensors.mat_to_nonsym(P), new_state

    # ---------------------------------------------------- whole-batch path
    def _fm_eps_tr(self, be_tr):
        """Trial logarithmic elastic strain 1/2 log(be_tr), Mandel (6, n),
        by the Gregory series with the envelope NaN guard. Shared by the
        primal core and the analytic tangent's 6-seed jvp."""
        I = fm.eye_like(be_tr)
        S = fm.bmm(be_tr - I, fm.inv33(be_tr + I))
        S2 = fm.bmm(S, S)
        term = S
        acc = S
        for k in range(1, self.fm_gregory_terms):
            term = fm.bmm(term, S2)
            acc = acc + term / (2 * k + 1)
        logbe = 2.0 * acc
        if self.fm_stretch_guard is not None:
            bad = fm.trace(S2) > self.fm_stretch_guard**2  # ||S||_F^2, S symmetric
            logbe = torch.where(bad[None, None, :], torch.full_like(logbe, float("nan")), logbe)
        return fm.to_sym_cols(0.5 * logbe)

    def _fm_trial(self, Fv, state):
        """``(F, F_prev^{-1}, f_rel, be_old, be_tr, p)`` as (3, 3, n) / (n,)."""
        dtype = Fv.dtype
        F = fm.from_nonsym_rows(Fv)
        F_prev = fm.from_nonsym_rows(state["F_prev"].to(dtype))
        be_old = fm.from_sym_cols(state["be"].to(dtype).T)
        p = state["p"].to(dtype)
        Fp_inv = fm.inv33(F_prev)
        f_rel = fm.bmm(F, Fp_inv)
        be_tr = fm.bmm(fm.bmm(f_rel, be_old), fm.transpose(f_rel))
        return F, Fp_inv, f_rel, be_old, be_tr, p

    def _fm_return(self, eps_tr, p):
        """The radial return on the trial strain (6, n): ``(tau_tr, s_tr,
        q_tr, f_act, dp)``, with an unrolled Newton of ``fm_newton_iters``."""
        el = self.elasticity
        mu, lmbda = el.mu, el.lmbda
        tr_e = eps_tr[0] + eps_tr[1] + eps_tr[2]
        iso = torch.cat([(tr_e / 3.0).expand(3, -1), torch.zeros_like(eps_tr[:3])])
        tau_tr = 2.0 * mu * eps_tr + lmbda * 3.0 * iso
        s_tr = 2.0 * mu * (eps_tr - iso)

        sigY = self.yield_stress
        Y0 = sigY(p)
        tiny = (1e-14 * (1.0 + Y0)) ** 2
        q_tr = torch.sqrt(1.5 * torch.sum(s_tr * s_tr, dim=0) + tiny)
        f_act = tensors.pos(q_tr - Y0)

        dp = torch.zeros_like(p)
        for _ in range(self.fm_newton_iters):
            r = f_act - 3.0 * mu * dp - (sigY(p + dp) - Y0)
            dY = _slope(sigY, p + dp)
            dp = tensors.pos(dp - r / (-3.0 * mu - dY))
        return tau_tr, s_tr, q_tr, f_act, dp

    def _fm_core(self, Fv, state):
        """``Fv (n, 9) -> (PK1 (n, 9), eps_e (6, n), p_new (n,))``: all but
        the be = exp(2 eps_e) commit, which PK1 does not depend on."""
        mu = self.elasticity.mu
        F, _, _, _, be_tr, p = self._fm_trial(Fv, state)
        eps_tr = self._fm_eps_tr(be_tr)
        tau_tr, s_tr, q_tr, _, dp = self._fm_return(eps_tr, p)
        n_dir = 1.5 * s_tr / q_tr
        eps_e = eps_tr - dp * n_dir
        tau = tau_tr - 2.0 * mu * dp * n_dir
        P = fm.bmm(fm.from_sym_cols(tau), fm.transpose(fm.inv33(F)))
        return fm.to_nonsym_rows(P), eps_e, p + dp

    def _fm_state(self, Fv, eps_e, p_new):
        be_new = fm.expm_unrolled(2.0 * fm.from_sym_cols(eps_e))
        return {"be": fm.to_sym_cols(be_new).T, "p": p_new, "F_prev": Fv}

    def batched_update(self, Fv, state, dt):
        """Whole-batch ``(PK1 (n, 9), Ct (n, 81), state)``, by
        ``tangent_mode``."""
        if self.tangent_mode == "analytic":
            return self._batched_update_analytic(Fv, state, dt)
        return self._batched_update_jvp(Fv, state, dt)

    def _batched_update_jvp(self, Fv, state, dt):
        """9 basis seeds through the whole core, one vmap of jvp with a shared
        primal; the be commit stays outside the differentiated core."""
        n = Fv.shape[0]
        seeds = torch.eye(9, dtype=Fv.dtype, device=Fv.device)[:, None, :].expand(9, n, 9)

        def one(seed):
            prim, tang = jvp(lambda x: self._fm_core(x, state), (Fv,), (seed,))
            return prim, tang[0]

        (pk1, eps_e, p_new), cols = vmap(one, out_dims=(None, 0))(seeds)
        Ct = cols.permute(1, 2, 0).reshape(n, 81)
        return pk1, Ct, self._fm_state(Fv, eps_e, p_new)

    def _batched_update_analytic(self, Fv, state, dt):
        """Factored consistent tangent: tau depends on F only through be_tr,
        and after eps_tr = 1/2 log(be_tr) the algorithm is the small-strain
        radial return with the Simo-Hughes tangent A = C - 2 mu beta K4 -
        gamma nbar (x) nbar, so

            dP = M(A : L : dbe_tr) F^{-T} - P dF^T F^{-T},
            dbe_tr = dF H + (dF H)^T,   H = F_prev^{-1} be_old f^T,

        where only L = d(1/2 log)/d(be) needs AD: 6 Mandel seeds through the
        Gregory series (one vmap of jvp with a shared primal)."""
        el = self.elasticity
        mu, lmbda = el.mu, el.lmbda
        dtype = Fv.dtype
        n = Fv.shape[0]

        F, Fp_inv, f_rel, be_old, be_tr, p = self._fm_trial(Fv, state)
        be6_tr = fm.to_sym_cols(be_tr)

        seeds6 = torch.eye(6, dtype=dtype, device=Fv.device)[:, :, None].expand(6, 6, n)

        def one(seed):
            return jvp(lambda b6: self._fm_eps_tr(fm.from_sym_cols(b6)), (be6_tr,), (seed,))

        eps_tr, Lcols = vmap(one, out_dims=(None, 0))(seeds6)
        # Lcols[q, p, :] = d eps_p / d be_q

        tau_tr, s_tr, q_tr, f_act, dp = self._fm_return(eps_tr, p)
        n_dir = 1.5 * s_tr / q_tr
        eps_e = eps_tr - dp * n_dir
        tau = tau_tr - 2.0 * mu * dp * n_dir

        Finv = fm.inv33(F)
        FinvT = fm.transpose(Finv)
        P3 = fm.bmm(fm.from_sym_cols(tau), FinvT)

        Hp = _slope(self.yield_stress, p + dp)
        nbar = s_tr / q_tr
        beta = 3.0 * mu * dp / q_tr
        gamma = 9.0 * mu**2 * (1.0 / (3.0 * mu + Hp) - dp / q_tr)
        plastic = (f_act > 0.0).to(dtype)
        two_mu_beta = plastic * 2.0 * mu * beta
        gamma_m = plastic * gamma
        H = fm.bmm(Fp_inv, fm.bmm(be_old, fm.transpose(f_rel)))
        sq2 = 2.0**0.5
        zero = torch.zeros_like(p)

        cols = []
        for i, j in fm.NONSYM_IJ:
            # dbe_tr = e_i (x) h + h (x) e_i, h = H[j, :], as a Mandel 6-vector
            h = H[j]
            diag = [zero, zero, zero]
            diag[i] = 2.0 * h[i]
            off = [  # [12, 13, 23] Mandel slots
                sq2 * ((h[1] if i == 0 else zero) + (h[0] if i == 1 else zero)),
                sq2 * ((h[2] if i == 0 else zero) + (h[0] if i == 2 else zero)),
                sq2 * ((h[2] if i == 1 else zero) + (h[1] if i == 2 else zero)),
            ]
            w = torch.einsum("qpn,qn->pn", Lcols, torch.stack(diag + off))

            # dtau = A w, matrix-free: C w = lam tr(w) I + 2 mu w, K4 w = w - tr(w)/3 I
            trw = w[0] + w[1] + w[2]
            trw_iso = torch.cat([trw.expand(3, -1), torch.zeros_like(w[:3])])
            ndot = torch.sum(nbar * w, dim=0)
            dtau = (2.0 * mu * w + lmbda * trw_iso - two_mu_beta * (w - trw_iso / 3.0)
                    - (gamma_m * ndot) * nbar)

            # dP = M(dtau) F^{-T} - P3 (e_j (x) e_i) F^{-T}
            dP = fm.bmm(fm.from_sym_cols(dtau), FinvT)
            geo = torch.stack([torch.stack([-P3[a][j] * Finv[b][i] for b in range(3)]) for a in range(3)])
            cols.append(fm.to_nonsym_rows(dP + geo))

        Ct = torch.stack(cols, dim=-1).reshape(n, 81)
        return fm.to_nonsym_rows(P3), Ct, self._fm_state(Fv, eps_e, p + dp)

    def batched_flux(self, Fv, state, dt):
        """Tangent-free whole-batch update (line-search trials)."""
        pk1, eps_e, p_new = self._fm_core(Fv, state)
        return pk1, self._fm_state(Fv, eps_e, p_new)


class HenckyFiniteStrain(FiniteStrainBehavior):
    """Lagrangian logarithmic-strain wrapper around any small-strain behavior
    (MFront's ``@StrainMeasure Hencky``): E_log = 1/2 log(F^T F) drives the
    wrapped update, whose stress T is the work conjugate of E_log, and PK1 =
    (dE_log/dF)^T : T is one reverse-mode pullback through the product-only
    matrix log. Under ``Material``'s ``jacfwd`` that is forward over reverse.
    """

    def __init__(self, small_strain_behavior):
        self.inner = small_strain_behavior

    def init_state(self):
        return self.inner.init_state()

    def finite_strain_update(self, Fvec, state, dt):
        def E_log(Fv):
            F = tensors.nonsym_to_mat(Fv)
            return tensors.mat_to_sym(0.5 * matfun.logm(F.T @ F))

        eps, pullback = vjp(E_log, Fvec)
        T, new_state = self.inner.small_strain_update(eps, state, dt)
        (pk1,) = pullback(T)
        return pk1, new_state
