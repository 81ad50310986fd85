"""The plain reference of the material points: each point's strain path from
the virgin state through ``j2.return_map`` (plain PyTorch, the plastic
increment solved to a tolerance, the textbook tangent)."""

from __future__ import annotations

import torch

from portbench.reference import j2


def run(cfg, law_text, path, ks, dtype=torch.float64):
    """``{k: (sig, Ct (n, 36), eps_p, p)}`` after each increment ``k`` of
    ``ks`` (0-based) of ``path`` (``path(k)`` is the strain of increment k),
    from the virgin state, in ``dtype``."""
    hardening = j2.Hardening(cfg, law_text)
    eps0 = path(0)
    n, device = eps0.shape[0], eps0.device
    eps_p = torch.zeros(n, 6, dtype=dtype, device=device)
    p = torch.zeros(n, dtype=dtype, device=device)
    out = {}
    for k in range(max(ks) + 1):
        sig, Ct, eps_p, p = j2.return_map(path(k).to(dtype), eps_p, p, float(cfg["E"]), float(cfg["nu"]), hardening)
        if k in ks:
            out[k] = (sig, Ct.reshape(n, 36), eps_p, p)
    return out
