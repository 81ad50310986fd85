"""Device-resident structure-of-arrays material state with s0/s1 buffers.

- per-Gauss-point internal state is a ``dict[str, tensor]`` built from
  ``behavior.init_state()`` with a leading point axis on every leaf;
- ``s0`` (converged) / ``s1`` (trial) double buffer with ``update()``
  (commit) and ``revert()`` (load-step cutback);
- name-indexed flat views for I/O and the quadrature map.

Tensors are never modified in place by the update path (every update builds
new tensors), so a buffer copy shares its leaves safely.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def _leaf_width(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _slices(sizes: dict) -> dict:
    out, pos = {}, 0
    for name, size in sizes.items():
        out[name] = slice(pos, pos + size)
        pos += size
    return out


class MaterialStateManager:
    """One buffer of batched state: gradients, fluxes and internal variables.

    ``gradients``/``fluxes`` are flat ``(n, total)`` tensors; ``internal`` is
    the batched behavior state dict. ``device=None`` is the card
    (:func:`~dolfinx_materials_tpu_torch.resolve_device`); the CPU needs
    ``device="cpu"``.
    """

    def __init__(self, behavior, ngauss: int, dtype=torch.float64, device=None):
        self.behavior = behavior
        self.n = ngauss
        self.dtype = dtype
        self.device = resolve_device(device)
        self.gradients_size = sum(behavior.gradients.values())
        self.fluxes_size = sum(behavior.fluxes.values())
        self.gradients = torch.zeros((ngauss, self.gradients_size), dtype=dtype, device=self.device)
        self.fluxes = torch.zeros((ngauss, self.fluxes_size), dtype=dtype, device=self.device)
        point_state = {k: np.asarray(v) for k, v in behavior.init_state().items()}
        self.internal = {
            k: torch.as_tensor(v, dtype=dtype, device=self.device)
            .expand((ngauss,) + v.shape)
            .clone()
            for k, v in point_state.items()
        }
        self._grad_slices = _slices(behavior.gradients)
        self._flux_slices = _slices(behavior.fluxes)
        self.internal_state_sizes = {
            k: _leaf_width(v.shape) for k, v in point_state.items()
        }
        # flat-view columns go by sorted name, whatever order an update hands
        # its state dict back in (the JAX package's pytree flattening sorts
        # dict keys, so this is also its column order)
        self._isv_slices = _slices({k: self.internal_state_sizes[k] for k in sorted(point_state)})
        self.internal_size = sum(self.internal_state_sizes.values())

    @property
    def internal_state_variables(self) -> torch.Tensor:
        """Flat ``(n, total_isv)`` view of the internal state, columns by
        sorted variable name."""
        if not self.internal:
            return torch.zeros((self.n, 0), dtype=self.dtype, device=self.device)
        return torch.cat([self.internal[k].reshape(self.n, -1) for k in self._isv_slices], dim=1)

    def set_internal_from_flat(self, arr) -> None:
        """Set the internal state from a flat ``(n, total_isv)`` array in the
        column order of :attr:`internal_state_variables` (sorted by name)."""
        arr = torch.as_tensor(arr, dtype=self.dtype, device=self.device)
        for k, sl in self._isv_slices.items():
            leaf = self.internal[k]
            self.internal[k] = arr[:, sl].reshape(leaf.shape).to(leaf.dtype).clone()

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self._grad_slices:
            return self.gradients[:, self._grad_slices[name]]
        if name in self._flux_slices:
            return self.fluxes[:, self._flux_slices[name]]
        if name in self.internal:
            return self.internal[name].reshape(self.n, -1)
        raise KeyError(f"Unknown state field '{name}'")

    def __setitem__(self, name: str, value) -> None:
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        size = self._field_size(name)
        if value.ndim == 0:
            value = value.expand(self.n, size)
        elif value.ndim == 1:
            value = value[:, None] if value.shape[0] == self.n else value[None, :]
            value = value.expand(self.n, size)
        if name in self._grad_slices:
            g = self.gradients.clone()
            g[:, self._grad_slices[name]] = value
            self.gradients = g
        elif name in self._flux_slices:
            f = self.fluxes.clone()
            f[:, self._flux_slices[name]] = value
            self.fluxes = f
        elif name in self.internal:
            leaf = self.internal[name]
            self.internal[name] = value.reshape(leaf.shape).clone()
        else:
            raise KeyError(f"Unknown state field '{name}'")

    def _field_size(self, name: str) -> int:
        for slices in (self._grad_slices, self._flux_slices):
            if name in slices:
                return slices[name].stop - slices[name].start
        if name in self.internal_state_sizes:
            return self.internal_state_sizes[name]
        raise KeyError(f"Unknown state field '{name}'")

    def keys(self):
        return list(self._grad_slices) + list(self._flux_slices) + list(self.internal)

    def as_dict(self) -> dict:
        return {k: self[k].cpu().numpy() for k in self.keys()}

    def copy(self) -> "MaterialStateManager":
        new = object.__new__(MaterialStateManager)
        new.__dict__.update(self.__dict__)
        new.internal = dict(self.internal)
        return new


class DataManager:
    """s0/s1 double buffer with commit/revert, on ``device`` (``None``: the
    card)."""

    def __init__(self, behavior, ngauss: int, dtype=torch.float64, device=None):
        self.s0 = MaterialStateManager(behavior, ngauss, dtype, device)
        self.s1 = MaterialStateManager(behavior, ngauss, dtype, device)
        self.n = ngauss

    def update(self) -> None:
        """Commit the trial state: s0 <- s1 (after global convergence)."""
        self.s0 = self.s1.copy()

    def revert(self) -> None:
        """Load-step cutback: s1 <- s0."""
        self.s1 = self.s0.copy()


def from_reference_array(values, dtype=torch.float64, device=None) -> torch.Tensor:
    """One array of the JAX package (a state field, an external state
    variable, a material-property field) as a tensor of this package, on
    ``device`` (``None``: the card)."""
    return torch.as_tensor(np.array(values), dtype=dtype, device=resolve_device(device))


def from_reference_state(state_dict_of_numpy: dict, dtype=torch.float64, device=None) -> dict:
    """State arrays of the JAX package (``Material.get_initial_state_dict()``
    there: name -> numpy array, every field flattened to ``(n, width)``) as a
    dict of tensors, ready for this package's
    ``Material.set_initial_state_dict``, which gives an array-valued field
    (Maxwell branches ``epsv (n, branches, 6)``, a GSM's ``alpha``) back its
    shape."""
    return {k: from_reference_array(v, dtype, device) for k, v in state_dict_of_numpy.items()}


def from_reference_params(params) -> dict:
    """An MLP parameter list of the JAX package (``[{"W": (in, out), "b":
    (out,)}, ...]``, numpy) as the module state of this package's
    ``models.nn.MLP`` (``state_dict`` names): W transposed into
    ``nn.Linear``'s (out, in) weight, float64 on the CPU."""
    state = {}
    for k, layer in enumerate(params):
        state[f"linears.{k}.weight"] = torch.as_tensor(np.asarray(layer["W"]).T.copy(), dtype=torch.float64)
        state[f"linears.{k}.bias"] = torch.as_tensor(np.asarray(layer["b"]).copy(), dtype=torch.float64)
    return state
