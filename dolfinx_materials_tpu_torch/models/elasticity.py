"""Linear elasticity: isotropic (the elastic backbone of the (visco)plastic
models) and orthotropic in the material frame."""

from __future__ import annotations

import numpy as np
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


class LinearElasticOrthotropic(SmallStrainBehavior):
    """Orthotropic linear elasticity in the material frame (Mandel 6x6
    stiffness ``C``, numpy float64). Combine with a
    :class:`~..material.Material` ``rotation_matrix`` to orient the material
    frame per Gauss point."""

    def __init__(self, E1, E2, E3, nu12, nu13, nu23, G12, G13, G23):
        S = np.zeros((6, 6))
        S[0, 0], S[1, 1], S[2, 2] = 1 / E1, 1 / E2, 1 / E3
        S[0, 1] = S[1, 0] = -nu12 / E1
        S[0, 2] = S[2, 0] = -nu13 / E1
        S[1, 2] = S[2, 1] = -nu23 / E2
        # Mandel shear entries: gamma = sqrt(2) eps_m, tau = sig_m / sqrt(2)
        S[3, 3], S[4, 4], S[5, 5] = 1 / (2 * G12), 1 / (2 * G13), 1 / (2 * G23)
        self.C_mat = np.linalg.inv(S)

    @property
    def C(self):
        return self.C_mat

    def small_strain_update(self, eps, state, dt):
        C = torch.as_tensor(self.C_mat, dtype=eps.dtype, device=eps.device)
        return C @ eps, state
