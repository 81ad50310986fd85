"""Linear viscoelasticity: generalized Maxwell (Prony series) with the exact
exponential integrator per branch.

Volumetric response elastic (bulk ``kappa``); deviatoric response a long-term
spring ``mu_inf`` in parallel with N Maxwell branches ``(mu_i, tau_i)``. Each
branch's viscous deviatoric strain follows ``d(epsv_i)/dt = (dev(eps) -
epsv_i)/tau_i``, integrated with the exact exponential update for strain held
constant over the step (so the discrete model is the analytic relaxation for
step-strain histories, and ``dt = 0`` is a fixed point).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tensors import I2, dev, tr
from .base import SmallStrainBehavior


class GeneralizedMaxwell(SmallStrainBehavior):
    """Prony-series viscoelasticity with ``len(branches)`` Maxwell branches.

    ``branches``: sequence of ``(mu_i, tau_i)`` pairs. The instantaneous shear
    modulus is ``mu_inf + sum(mu_i)``; the relaxed modulus is ``mu_inf``.
    Internal state: ``epsv`` of shape (branches, 6).
    """

    def __init__(self, kappa, mu_inf, branches):
        self.kappa = kappa
        self.mu_inf = mu_inf
        self.branches = tuple((float(m), float(t)) for (m, t) in branches)
        if not self.branches:
            raise ValueError("GeneralizedMaxwell needs at least one branch")

    def init_state(self):
        return {"epsv": np.zeros((len(self.branches), 6))}

    def relaxation_shear_modulus(self, t):
        """Closed-form mu(t) = mu_inf + sum mu_i exp(-t/tau_i)."""
        mu = self.mu_inf
        for m, tau in self.branches:
            mu = mu + m * np.exp(-t / tau)
        return mu

    def small_strain_update(self, eps, state, dt):
        e = dev(eps)
        I2t = torch.as_tensor(I2, dtype=eps.dtype, device=eps.device)
        dt = torch.as_tensor(dt, dtype=eps.dtype, device=eps.device)
        sig = self.kappa * tr(eps) * I2t + 2.0 * self.mu_inf * e
        new_rows = []
        for i, (m, tau) in enumerate(self.branches):
            a = torch.exp(-dt / tau)  # dt = 0 -> a = 1 -> no flow
            epsv = e + (state["epsv"][i] - e) * a
            new_rows.append(epsv)
            sig = sig + 2.0 * m * (e - epsv)
        return sig, {"epsv": torch.stack(new_rows)}


class ZenerViscoelasticity(GeneralizedMaxwell):
    """Standard linear solid: one Maxwell branch (mu1, tau) in parallel with
    (kappa, mu_inf)."""

    def __init__(self, kappa, mu_inf, mu1, tau):
        super().__init__(kappa, mu_inf, [(mu1, tau)])
