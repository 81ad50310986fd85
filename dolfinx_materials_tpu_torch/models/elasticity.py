"""Isotropic linear elasticity, the elastic backbone of the J2 models."""

from __future__ import annotations

import torch

from ..ops import tensors
from .base import SmallStrainBehavior


class LinearElasticIsotropic(SmallStrainBehavior):
    """Isotropic linear elasticity, Mandel convention; exposes ``mu``,
    ``lmbda``, ``kappa`` and the 6x6 stiffness ``C`` (numpy float64)."""

    def __init__(self, E, nu):
        self.E = E
        self.nu = nu

    @property
    def lmbda(self):
        return self.E * self.nu / (1 + self.nu) / (1 - 2 * self.nu)

    @property
    def mu(self):
        return self.E / 2.0 / (1 + self.nu)

    @property
    def kappa(self):
        return self.E / 3.0 / (1 - 2 * self.nu)

    @property
    def C(self):
        return tensors.isotropic_C(self.E, self.nu)

    def stress(self, eps_el):
        """sigma = lambda tr(eps) I + 2 mu eps (elementwise)."""
        I2 = torch.as_tensor(tensors.I2, dtype=eps_el.dtype, device=eps_el.device)
        return self.lmbda * tensors.tr(eps_el)[..., None] * I2 + 2.0 * self.mu * eps_el

    def small_strain_update(self, eps, state, dt):
        return self.stress(eps), state
