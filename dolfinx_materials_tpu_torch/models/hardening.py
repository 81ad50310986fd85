"""Isotropic hardening laws: callables ``p -> sigma_Y(p)`` on tensors.

The four laws shipped here also report ``kernel_law() -> (law_id, params)``
(up to four parameters): the CUDA return maps evaluate their value and slope
in closed form, and the ids match ``csrc/j2_radial_return.cu``. Any other
callable (a user function) is traced once into a law program
(ops/law_program.py) that the same kernels interpret on the card; the plain
PyTorch return map on the CPU differentiates the callable with
``torch.func``. A callable that is not a program (a branch on the value, an
operation the program has no instruction for) raises on the card.
"""

from __future__ import annotations

import torch

LAW_LINEAR, LAW_VOCE, LAW_SWIFT, LAW_RAMBERG_OSGOOD = 0, 1, 2, 3


class LinearHardening:
    """sigma_Y(p) = sigma_0 + H p."""

    def __init__(self, sig0, H):
        self.sig0 = sig0
        self.H = H

    def __call__(self, p):
        return self.sig0 + self.H * p

    def kernel_law(self):
        return LAW_LINEAR, (float(self.sig0), float(self.H), 0.0)


class VoceHardening:
    """Saturating exponential hardening
    sigma_Y(p) = sigma_0 + (sigma_u - sigma_0) (1 - exp(-b p))."""

    def __init__(self, sig0, sigu, b):
        self.sig0 = sig0
        self.sigu = sigu
        self.b = b

    def __call__(self, p):
        return self.sig0 + (self.sigu - self.sig0) * (1.0 - torch.exp(-self.b * p))

    def kernel_law(self):
        return LAW_VOCE, (float(self.sig0), float(self.sigu), float(self.b))


class SwiftHardening:
    """Power-law hardening sigma_Y(p) = sigma_0 (1 + p/eps_0)^n."""

    def __init__(self, sig0, eps0, n):
        self.sig0 = sig0
        self.eps0 = eps0
        self.n = n

    def __call__(self, p):
        return self.sig0 * (1.0 + p / self.eps0) ** self.n

    def kernel_law(self):
        return LAW_SWIFT, (float(self.sig0), float(self.eps0), float(self.n))


class RambergOsgoodHardening:
    """Hardening of a Ramberg-Osgood uniaxial curve,
    sigma_Y(p) = sig0 * (max(p, p_eps) E / (alpha sig0))^(1/n): clamped at
    ``p_eps`` (slope 0 below it) so the power stays differentiable at p = 0."""

    def __init__(self, sig0, E, alpha, n, p_eps=1e-12):
        self.sig0 = sig0
        self.E = E
        self.alpha = alpha
        self.n = n
        self.p_eps = p_eps

    def __call__(self, p):
        x = torch.clamp(p, min=self.p_eps) * self.E / (self.alpha * self.sig0)
        return self.sig0 * x ** (1.0 / self.n)

    def kernel_law(self):
        k = float(self.E) / (float(self.alpha) * float(self.sig0))
        return LAW_RAMBERG_OSGOOD, (float(self.sig0), k, 1.0 / float(self.n), float(self.p_eps))
