"""Plain J2 plasticity with isotropic hardening: the radial return and its
consistent tangent, in Mandel notation ``[xx, yy, zz, s2 xy, s2 xz, s2 yz]``.

Written from the textbook (Simo & Hughes, Computational Inelasticity, Box
3.2 and 3.3), in plain PyTorch, with no code of the program: the plastic
increment is solved by Newton to a tolerance, and the tangent is

    C_ep = C - 2 mu (1 - theta) I_dev - 2 mu theta_bar N (x) N,
    1 - theta = 3 mu dp / q_tr,   theta_bar = 3 mu / (3 mu + H) - (1 - theta),

with N = s_tr / |s_tr|, q_tr = sqrt(3/2) |s_tr| and H = dsigma_Y/dp at the
new p.
"""

from __future__ import annotations

import torch

from portbench.laws import compile_law

ONE = (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)


class Hardening:
    """``sigma_Y(p)`` and its slope: Voce in closed form from the
    configuration, or a law given as text (slope by autograd)."""

    def __init__(self, cfg, law_text=None):
        self.text = law_text
        if law_text is None:
            self.s0, self.su, self.b = float(cfg["sig0"]), float(cfg["sigu"]), float(cfg["b"])
        else:
            self.fn = compile_law(law_text)

    def __call__(self, p):
        """``(sigma_Y, H)`` at ``p``."""
        if self.text is None:
            e = torch.exp(-self.b * p)
            return self.s0 + (self.su - self.s0) * (1.0 - e), self.b * (self.su - self.s0) * e
        with torch.enable_grad():
            x = p.detach().requires_grad_(True)
            y = self.fn(x)
            (h,) = torch.autograd.grad(y.sum(), x)
        return y.detach(), h


def moduli(E, nu):
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    return lam, mu


def return_map(eps, eps_p, p, E, nu, hardening, max_iter=60):
    """``(sig, Ct (n, 6, 6), eps_p_new, p_new)`` for strains ``eps (n, 6)``
    from the state ``(eps_p (n, 6), p (n,))``, in the tensors' dtype."""
    dtype, device = eps.dtype, eps.device
    lam, mu = moduli(E, nu)
    one = torch.tensor(ONE, dtype=dtype, device=device)
    eye = torch.eye(6, dtype=dtype, device=device)
    i_dev = eye - torch.outer(one, one) / 3.0
    C = lam * torch.outer(one, one) + 2.0 * mu * eye

    e = eps - eps_p
    sig_tr = e @ C
    s = sig_tr @ i_dev
    norm_s = torch.sqrt((s * s).sum(dim=1))
    q = (1.5 ** 0.5) * norm_s
    y0, h0 = hardening(p)
    f = q - y0
    plastic = f > 0
    f_act = torch.clamp(f, min=0.0)

    tol = 64 * torch.finfo(dtype).eps
    dp = f_act / (3.0 * mu + h0)  # below the root: the residual is convex in dp
    for _ in range(max_iter):
        y, h = hardening(p + dp)
        r = f_act - 3.0 * mu * dp - (y - y0)
        dp = torch.clamp(dp + r / (3.0 * mu + h), min=0.0)
        if not bool((r.abs() > tol * y0).any()):
            break
    _, h = hardening(p + dp)

    safe = torch.where(plastic, norm_s, torch.ones_like(norm_s))
    N = s / safe[:, None]
    q_safe = torch.where(plastic, q, torch.ones_like(q))
    sig = sig_tr - (2.0 * mu * (1.5 ** 0.5) * dp)[:, None] * N
    eps_p_new = eps_p + ((1.5 ** 0.5) * dp)[:, None] * N
    one_m_theta = torch.where(plastic, 3.0 * mu * dp / q_safe, torch.zeros_like(q))
    theta_bar = torch.where(plastic, 3.0 * mu / (3.0 * mu + h) - one_m_theta, torch.zeros_like(q))
    Ct = (C[None] - (2.0 * mu * one_m_theta)[:, None, None] * i_dev[None]
          - (2.0 * mu * theta_bar)[:, None, None] * N[:, :, None] * N[:, None, :])
    return sig, Ct, eps_p_new, p + dp
