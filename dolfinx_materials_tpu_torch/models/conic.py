"""Non-smooth yield surfaces (Rankine / L1-Rankine / Hosford) as smoothed
principal-stress norms fed to the general return mapping
(:class:`~.plasticity.GeneralIsotropicHardening`; AD gives the flow direction).

The smoothing parameter trades sharpness of the vertex/edge against
conditioning; with ``smooth = 1e-3`` the stress error against the exact
non-smooth surface is O(smooth * scale), and only at vertices.
"""

from __future__ import annotations

import torch

from ..ops import tensors
from .plasticity import GeneralIsotropicHardening, hosford_norm


def _principal(sig):
    """AD-safe principal stresses (ascending) via the closed-form eigenvalues:
    finite derivatives at coincident eigenvalues."""
    return tensors.eigvals33_smooth(tensors.sym_to_mat(sig))


def _initial_yield(yield_stress):
    return float(yield_stress(torch.zeros((), dtype=torch.float64)))


def rankine_norm(smooth=1e-3, scale=1.0):
    """(Smoothed) maximum principal stress lambda_max(sig), as a softmax over
    the closed-form principal stresses. Overshoot <= log(3)*smooth*scale."""
    beta = 1.0 / (smooth * scale)

    def norm(sig):
        lam = _principal(sig)
        m = lam[-1].detach()
        return m + torch.log(torch.sum(torch.exp(beta * (lam - m)))) / beta

    return norm


def l1_rankine_norm(smooth=1e-3, scale=1.0):
    """L1-Rankine sum_i |lambda_i| with smooth-abs regularization
    sqrt(x^2 + (smooth*scale)^2)."""
    eps = smooth * scale

    def norm(sig):
        lam = _principal(sig)
        return torch.sum(torch.sqrt(lam * lam + eps * eps))

    return norm


class RankinePlasticity(GeneralIsotropicHardening):
    """Associated plasticity with the (smoothed) Rankine yield surface."""

    def __init__(self, elasticity, yield_stress, smooth=1e-3, scale=None, **kw):
        scale = scale if scale is not None else _initial_yield(yield_stress)
        super().__init__(elasticity, yield_stress, stress_norm=rankine_norm(smooth, scale), **kw)


class L1RankinePlasticity(GeneralIsotropicHardening):
    """Associated plasticity with the (smoothed) L1-Rankine yield surface."""

    def __init__(self, elasticity, yield_stress, smooth=1e-3, scale=None, **kw):
        scale = scale if scale is not None else _initial_yield(yield_stress)
        super().__init__(elasticity, yield_stress, stress_norm=l1_rankine_norm(smooth, scale), **kw)


class HosfordPlasticity(GeneralIsotropicHardening):
    """Hosford yield surface of exponent ``a``."""

    def __init__(self, elasticity, yield_stress, a=10.0, eps_reg=1e-10, **kw):
        super().__init__(elasticity, yield_stress, stress_norm=hosford_norm(a, eps_reg), **kw)
