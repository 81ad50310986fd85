"""Mandel-convention tensor algebra (MFront ordering) on torch tensors.

Symmetric 2nd-order tensor -> 6-vector ``[T11, T22, T33, s2*T12, s2*T13,
s2*T23]`` with ``s2 = sqrt(2)``, so double contraction is a plain dot product
and 4th-order tensors on symmetric space are 6x6 matrices. The constants are
numpy arrays; functions take tensors with any leading batch axes.
"""

import numpy as np
import torch

SQ2 = np.sqrt(2.0)

#: Second-order identity in Mandel 6-vector form.
I2 = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
#: Fourth-order symmetric identity in Mandel form (just the 6x6 identity).
I4 = np.eye(6)
#: Spherical projector J = (1/3) I2 (x) I2.
J4 = np.outer(I2, I2) / 3.0
#: Deviatoric projector K = I4 - J4.
K4 = I4 - J4


def tr(v):
    """Trace of a Mandel 6-vector ``(..., 6)``."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def dev(v):
    """Deviatoric part of a Mandel 6-vector ``(..., 6)``."""
    m = tr(v)[..., None] / 3.0
    return v - m * torch.as_tensor(I2, dtype=v.dtype, device=v.device)


def ddot(a, b):
    """Double contraction a:b of two Mandel 6-vectors — a plain dot product."""
    return torch.sum(a * b, dim=-1)


def eq_vm_safe(sig, scale):
    """Von Mises stress sqrt(3/2 s:s) with a smooth guard at s = 0: adds
    ``(1e-14 * scale)^2`` under the root so the derivative stays finite at
    stress-free points (relative error < 1e-28)."""
    s = dev(sig)
    return torch.sqrt(1.5 * ddot(s, s) + (1e-14 * scale) ** 2)


def isotropic_C(E, nu):
    """6x6 Mandel stiffness of isotropic linear elasticity (numpy float64):
    2*mu*I + lambda on the upper-left 3x3 block."""
    lmbda = E * nu / (1 + nu) / (1 - 2 * nu)
    mu = E / 2.0 / (1 + nu)
    C = 2 * mu * np.eye(6)
    C[:3, :3] += lmbda
    return C
