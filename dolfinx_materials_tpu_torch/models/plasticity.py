"""Rate-independent elastoplasticity with isotropic hardening.

- ``vonMisesIsotropicHardening(elasticity=..., yield_stress=...)``: the radial
  return of von Mises plasticity, a scalar root per Gauss point through
  :func:`~..ops.newton.scalar_newton_solve`. The elastic/plastic branch is
  encoded in the residual itself via ``max(f_trial, 0)``, so the elastic root
  is exactly 0 and the tangent degenerates exactly to C. Its whole-batch fast
  path (:meth:`batched_update`, analytic Simo-Hughes tangent, ops/j2_fast.py)
  is what :class:`~..material.Material` runs; on the card it launches the CUDA
  return-map kernel.
- ``GeneralIsotropicHardening(stress_norm=...)``: any smooth equivalent-stress
  norm, via a full 7-unknown (eps_el, dp) return mapping; the flow direction
  is ``d(stress_norm)/d(sigma)`` by AD.

Internal state of both: plastic strain ``eps_p`` (Mandel 6) and cumulated
plastic strain ``p``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad

from ..ops import tensors
from ..ops.newton import newton_solve, scalar_newton_solve
from .base import SmallStrainBehavior


class vonMisesIsotropicHardening(SmallStrainBehavior):
    """J2 plasticity, radial return, general isotropic hardening."""

    def __init__(self, elasticity, yield_stress, tol=1e-10, max_iter=50):
        self.elasticity = elasticity
        self.yield_stress = yield_stress
        self.tol = tol
        self.max_iter = max_iter

    def init_state(self):
        return {"eps_p": np.zeros(6), "p": np.zeros(())}

    def batched_update(self, eps, state, dt):
        """Whole-batch fast path (ops/j2_fast.py). The cached update closes
        over elasticity/yield_stress, so the cache is keyed on those objects:
        swapping parameters rebuilds instead of using stale moduli."""
        key = (id(self.elasticity), id(self.yield_stress))
        if getattr(self, "_fast_key", None) != key:
            from ..ops.j2_fast import make_j2_batched_update

            self._fast = make_j2_batched_update(self.elasticity, self.yield_stress)
            self._fast_key = key
        return self._fast(eps, state, dt)

    def small_strain_update(self, eps, state, dt):
        el = self.elasticity
        mu = el.mu
        eps_p, p = state["eps_p"], state["p"]

        sig_tr = el.stress(eps - eps_p)
        s_tr = tensors.dev(sig_tr)
        sigY0 = self.yield_stress(p)
        q_tr = tensors.eq_vm_safe(sig_tr, 1.0 + sigY0)
        f_tr = q_tr - sigY0

        def residual(dp, f_act, p0):
            # elastic root is exactly dp = 0 because f_act = max(f_trial, 0)
            return f_act - 3.0 * mu * dp - (self.yield_stress(p0 + dp) - self.yield_stress(p0))

        f_act = torch.clamp(f_tr, min=0.0)
        dp, _ = scalar_newton_solve(
            residual,
            torch.zeros_like(q_tr),
            args=(f_act, p),
            tol=self.tol * (1.0 + sigY0),
            max_iter=self.max_iter,
            lower=0.0,
        )

        # flow direction n = 3/2 s/q (Mandel vector); q_tr is smooth-guarded at 0
        n = 1.5 * s_tr / q_tr
        sig = sig_tr - 2.0 * mu * dp * n
        return sig, {"eps_p": eps_p + dp * n, "p": p + dp}


class GeneralIsotropicHardening(SmallStrainBehavior):
    """Plasticity with a general smooth equivalent-stress norm and isotropic
    hardening, via a full 7-unknown (eps_el, dp) return mapping.

    ``stress_norm``: callable mapping a Mandel stress 6-vector to the
    equivalent stress (positively homogeneous of degree 1); defaults to von
    Mises. The associated flow direction is its gradient by AD.
    """

    def __init__(self, elasticity, yield_stress, stress_norm=None, tol=1e-10, max_iter=50):
        self.elasticity = elasticity
        self.yield_stress = yield_stress
        self.stress_norm = stress_norm if stress_norm is not None else tensors.eq_vm
        self.tol = tol
        self.max_iter = max_iter

    def init_state(self):
        return {"eps_p": np.zeros(6), "p": np.zeros(())}

    def small_strain_update(self, eps, state, dt):
        el = self.elasticity
        eps_p, p = state["eps_p"], state["p"]
        eps_el_tr = eps - eps_p
        sig_tr = el.stress(eps_el_tr)
        f_tr = self.stress_norm(sig_tr) - self.yield_stress(p)

        normal = grad(self.stress_norm)

        def residual(x, eps_el_tr, p0, plastic):
            eps_el, dp = x[:6], x[6]
            sig = el.stress(eps_el)
            # safe evaluation point for the (irrelevant) normal on the elastic
            # branch: stress norms are non-smooth at sig = 0 and would put NaN
            # into the implicit-function pass there
            safe_dir = torch.tensor([1.0, -0.5, -0.5, 0.0, 0.0, 0.0], dtype=x.dtype, device=x.device)
            sig_n = torch.where(plastic, sig, sig + (1.0 + self.yield_stress(p0)) * safe_dir)
            r1 = eps_el - eps_el_tr + dp * normal(sig_n)
            # when elastic, force the root to (eps_el_tr, 0) smoothly
            r2 = torch.where(plastic, self.stress_norm(sig) - self.yield_stress(p0 + dp), dp)
            return torch.cat([r1, r2.reshape(1)])

        plastic = f_tr > 0.0
        x0 = torch.cat([eps_el_tr, eps_el_tr.new_zeros(1)])
        x, _ = newton_solve(
            residual,
            x0,
            args=(eps_el_tr, p, plastic),
            tol=self.tol * (1.0 + self.yield_stress(p)),
            max_iter=self.max_iter,
        )
        eps_el, dp = x[:6], x[6]
        sig = el.stress(eps_el)
        return sig, {"eps_p": eps_p + (eps_el_tr - eps_el), "p": p + dp}


def hosford_norm(a, eps_reg=1e-12):
    """Regularized Hosford equivalent stress of exponent ``a`` on Mandel
    6-vectors: (1/2 (|s1-s2|^a + |s2-s3|^a + |s1-s3|^a))^(1/a) with principal
    stresses s_i; AD-safe through the smoothing term and the smooth
    closed-form eigenvalues."""

    def norm(sig):
        lam = tensors.eigvals33_smooth(tensors.sym_to_mat(sig))
        d01 = lam[..., 0] - lam[..., 1]
        d12 = lam[..., 1] - lam[..., 2]
        d02 = lam[..., 0] - lam[..., 2]
        pw = lambda x: (x * x + eps_reg) ** (a / 2.0)  # noqa: E731
        return (0.5 * (pw(d01) + pw(d12) + pw(d02))) ** (1.0 / a)

    return norm
