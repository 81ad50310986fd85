"""Rate-dependent (visco)plasticity: Norton/Perzyna overstress flow and the
generalized-standard-material (GSM) incremental variational integrator. Both
are backward-Euler implicit solves through ``ops.newton`` (consistent tangents
by the implicit function theorem).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad

from ..ops import tensors
from ..ops.newton import newton_solve, scalar_newton_solve
from .base import SmallStrainBehavior


class NortonViscoplasticity(SmallStrainBehavior):
    """Perzyna/Norton overstress viscoplasticity with optional isotropic hardening.

    Flow rule: dp/dt = ((q - sigma_Y(p)) / K)_+^n; backward-Euler update solved
    implicitly for dp: r(dp) = dp - dt ((q_tr - 3 mu dp - sigma_Y(p+dp))/K)_+^n.
    The residual is written in the fixed-point form (dp on the outside) so the
    Newton iteration is well-conditioned at dp = 0 for any n >= 1.

    ``yield_stress``: callable p -> sigma_Y(p); a constant function gives pure
    Norton creep with a threshold.
    """

    def __init__(self, elasticity, yield_stress, K, n, tol=1e-12, max_iter=80):
        self.elasticity = elasticity
        self.yield_stress = yield_stress
        self.K = K
        self.n = n
        self.tol = tol
        self.max_iter = max_iter

    def init_state(self):
        return {"eps_p": np.zeros(6), "p": np.zeros(())}

    def small_strain_update(self, eps, state, dt):
        el = self.elasticity
        mu = el.mu
        eps_p, p = state["eps_p"], state["p"]
        sig_tr = el.stress(eps - eps_p)
        s_tr = tensors.dev(sig_tr)
        sigY0 = self.yield_stress(p)
        q_tr = tensors.eq_vm_safe(sig_tr, 1.0 + sigY0)
        dt = torch.as_tensor(dt, dtype=q_tr.dtype, device=q_tr.device)

        def residual(dp, q_tr, p0, dt):
            over = (q_tr - 3.0 * mu * dp - self.yield_stress(p0 + dp)) / self.K
            return dp - dt * torch.clamp(over, min=0.0) ** self.n

        dp, _ = scalar_newton_solve(
            residual,
            torch.zeros_like(q_tr),
            args=(q_tr, p, dt),
            tol=self.tol * (1.0 + dt),
            max_iter=self.max_iter,
            lower=0.0,
        )
        n_dir = 1.5 * s_tr / q_tr
        sig = sig_tr - 2.0 * mu * dp * n_dir
        return sig, {"eps_p": eps_p + dp * n_dir, "p": p + dp}


class GeneralizedStandardMaterial(SmallStrainBehavior):
    """Generalized standard material: free energy psi(eps, alpha) + dissipation
    potential phi(alpha_rate); backward-Euler incremental minimization

        alpha_{n+1} = argmin_a  psi(eps, a) + dt phi((a - alpha_n)/dt)

    solved by its stationarity condition with the IFT Newton solver, so
    sigma = d psi/d eps at the solution carries exact consistent tangents.
    ``psi(eps, alpha)`` and ``phi(alpha_dot)`` act on a flat internal-variable
    vector ``alpha`` of size ``n_internal``.
    """

    def __init__(self, psi, phi, n_internal, isv_name="alpha", tol=1e-10, max_iter=60):
        self.psi = psi
        self.phi = phi
        self.n_internal = n_internal
        self.isv_name = isv_name
        self.tol = tol
        self.max_iter = max_iter

    def init_state(self):
        return {self.isv_name: np.zeros(self.n_internal)}

    def small_strain_update(self, eps, state, dt):
        a0 = state[self.isv_name]
        dt = torch.as_tensor(dt, dtype=eps.dtype, device=eps.device)
        # guard dt = 0 (the rate-independent limit is not defined for a pure potential)
        dt_safe = torch.clamp(dt, min=1e-14)

        def stationarity(a, eps, a0, dt_safe):
            def incr(a_):
                return self.psi(eps, a_) + dt_safe * self.phi((a_ - a0) / dt_safe)

            return grad(incr)(a)

        a, _ = newton_solve(
            stationarity, a0, args=(eps, a0, dt_safe), tol=self.tol, max_iter=self.max_iter
        )
        sig = grad(self.psi, argnums=0)(eps, a)
        return sig, {self.isv_name: a}
