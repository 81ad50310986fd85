"""Checkpoint and resume of material state and solution fields.

Counterpart of dolfinx_materials_tpu/checkpoint.py, with the same file
format: one host ``.npz`` holding a QuadratureMap's converged (s0) state as
its name-keyed columns (``__gradients__``, ``__fluxes__``, ``isv::<name>``
per internal variable, ``__cells__``) and any extra arrays
(``extra::<name>``), so a file written by either package restores into the
other.
"""

from __future__ import annotations

import numpy as np
import torch


def save_state(path, qmap, extra: dict | None = None):
    """Write a QuadratureMap's converged (s0) state and optional extra
    arrays to ``path``."""
    s0 = qmap.material.data_manager.s0
    payload = {
        "__gradients__": s0.gradients.cpu().numpy(),
        "__fluxes__": s0.fluxes.cpu().numpy(),
        **{f"isv::{k}": v.cpu().numpy() for k, v in s0.internal.items()},
        "__cells__": np.asarray(qmap.cells),
    }
    for k, v in (extra or {}).items():
        payload[f"extra::{k}"] = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    np.savez(path, **payload)


def load_state(path, qmap):
    """Restore a QuadratureMap's state (s0 and s1 alike) from a
    :func:`save_state` file, on the map's device and in its dtype. Raises
    ``ValueError`` for a file of another point count or ISV shape. Returns
    the dict of extra arrays (numpy)."""
    data = np.load(path)
    dm = qmap.material.data_manager
    n_ckpt = data["__gradients__"].shape[0]
    n_here = dm.s0.gradients.shape[0]
    if n_ckpt != n_here:
        raise ValueError(
            f"checkpoint holds {n_ckpt} Gauss points but this QuadratureMap has {n_here} (different mesh or "
            "quadrature degree?): refusing to load a mismatched state"
        )

    def tensor(a, like):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    for s in (dm.s0, dm.s1):
        s.gradients = tensor(data["__gradients__"], s.gradients)
        s.fluxes = tensor(data["__fluxes__"], s.fluxes)
        for k in list(s.internal):
            want, got = tuple(s.internal[k].shape), data[f"isv::{k}"].shape
            if want != got:
                raise ValueError(f"checkpoint ISV '{k}' has shape {got}, expected {want}")
            s.internal[k] = tensor(data[f"isv::{k}"], s.internal[k])
    return {k.split("::", 1)[1]: data[k] for k in data.files if k.startswith("extra::")}
