"""Ramberg-Osgood nonlinear (deformation-theory) elasticity:

    eps = S : sig + beta (sig_eq/sig0)^n N,   N = 3/2 s / sig_eq,
    beta = alpha sig0 / E,

inverted strain-driven: with eps_eq = sqrt(2/3 e:e), solve the scalar relation
sig_eq/(3 mu) + beta (sig_eq/sig0)^n = eps_eq (IFT Newton), then
sig = K tr(eps) I + sig_eq (2/3) e / eps_eq. Stateless (path-independent).
"""

from __future__ import annotations

import torch

from ..ops import tensors
from ..ops.newton import scalar_newton_solve
from .base import SmallStrainBehavior


class RambergOsgoodNonLinearElasticity(SmallStrainBehavior):
    def __init__(self, E, nu, sig0, alpha, n, eps_tol=1e-12, max_iter=50):
        self.E = E
        self.nu = nu
        self.sig0 = sig0
        self.alpha = alpha
        self.n = n
        self.eps_tol = eps_tol
        self.max_iter = max_iter

    @property
    def mu(self):
        return self.E / 2.0 / (1 + self.nu)

    @property
    def kappa(self):
        return self.E / 3.0 / (1 - 2 * self.nu)

    def small_strain_update(self, eps, state, dt):
        mu, K = self.mu, self.kappa
        beta = self.alpha * self.sig0 / self.E
        e = tensors.dev(eps)
        eps_eq = torch.sqrt(2.0 / 3.0 * tensors.ddot(e, e) + (self.eps_tol) ** 2)

        def residual(sig_eq, eps_eq):
            # guard the power at sig_eq <= 0 (iterates stay positive anyway)
            s = torch.clamp(sig_eq, min=1e-9 * self.sig0)
            return sig_eq / (3.0 * mu) + beta * (s / self.sig0) ** self.n - eps_eq

        # start from the lower of the elastic and the power-law branch
        x0 = torch.minimum(3.0 * mu * eps_eq, self.sig0 * (eps_eq / beta) ** (1.0 / self.n))
        sig_eq, _ = scalar_newton_solve(
            residual,
            x0,
            args=(eps_eq,),
            tol=self.eps_tol * (1.0 + eps_eq),
            max_iter=self.max_iter,
            lower=0.0,
        )
        ne = (2.0 / 3.0) * e / eps_eq
        I2 = torch.as_tensor(tensors.I2, dtype=eps.dtype, device=eps.device)
        return K * tensors.tr(eps) * I2 + sig_eq * ne, state
