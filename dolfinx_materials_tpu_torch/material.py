"""Material adapter: batches a Behavior over Gauss points with its tangent.

The counterpart of dolfinx_materials_tpu/material.py for the behaviors that
supply a whole-batch fast path (``behavior.batched_update``, e.g. the J2
return map of ops/j2_fast.py, which launches the CUDA kernel on the card):
``integrate`` runs it on the s0 state and stores the trial state in s1.
The generic ``vmap(jacfwd)`` path over per-point updates and material-frame
rotations are not ported yet (ROADMAP.md Queue 1); such behaviors raise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .state import DataManager
from .utils.timers import timer


class Material:
    """Wraps a :class:`~.models.base.Behavior` into the batched, stateful
    protocol the QuadratureMap and solvers consume."""

    def __init__(self, behavior, dtype=torch.float64, name=None, device=None):
        self.behavior = behavior
        self._name = name or behavior.name
        self.dtype = dtype
        self.device = resolve_device(device)
        self.data_manager: DataManager | None = None
        self.rotation_matrix = None

        self.gradients = dict(behavior.gradients)
        self.fluxes = dict(behavior.fluxes)
        self.external_state_variables = dict(behavior.external_state_variables)
        self.internal_state_variables = {
            k: int(np.prod(np.shape(v))) if np.ndim(v) else 1
            for k, v in behavior.init_state().items()
        }
        self.tangent_blocks = {
            (y, x): (self._field_size(y), self._input_size(x))
            for (y, x) in behavior.tangent_blocks
        }
        self._build_batched()

    @property
    def name(self):
        return self._name

    @property
    def gradient_names(self):
        return list(self.gradients.keys())

    @property
    def flux_names(self):
        return list(self.fluxes.keys())

    @property
    def internal_state_variable_names(self):
        return list(self.internal_state_variables.keys())

    def _field_size(self, name):
        if name in self.fluxes:
            return self.fluxes[name]
        if name in self.internal_state_variables:
            return self.internal_state_variables[name]
        raise KeyError(f"tangent block output '{name}' is not a flux or ISV")

    def _input_size(self, name):
        if name in self.gradients:
            return self.gradients[name]
        if name in self.external_state_variables:
            return self.external_state_variables[name]
        raise KeyError(f"tangent block input '{name}' is not a gradient or ESV")

    def _build_batched(self):
        """Pick the whole-batch fast path the behavior supplies; only the
        single-gradient / no-ESV / no-property signature can use it."""
        behavior = self.behavior
        fast = getattr(behavior, "batched_update", None)
        self._fast_update = None
        if (
            fast is not None
            and not self.external_state_variables
            and not getattr(behavior, "material_properties", {})
            and len(self.tangent_blocks) == 1
        ):
            self._fast_update = fast

    def _require_fast(self):
        if self._fast_update is None:
            raise NotImplementedError(
                f"{self.name}: only behaviors with a whole-batch batched_update "
                "are ported; the generic vmap(jacfwd) path is ROADMAP.md Queue 1, "
                "'Generic IFT path'"
            )
        if self.rotation_matrix is not None:
            raise NotImplementedError(
                "material-frame rotations are not ported yet (ROADMAP.md Queue 1)"
            )

    # ------------------------------------------------------------- lifecycle
    def set_data_manager(self, ngauss: int):
        self.data_manager = DataManager(self.behavior, ngauss, self.dtype, self.device)

    # ------------------------------------------------------------- integrate
    def _inputs(self, gradients):
        dm = self.data_manager
        if dm is None:
            self.set_data_manager(gradients.shape[0])
            dm = self.data_manager
        return dm, torch.as_tensor(gradients, dtype=self.dtype, device=self.device)

    def integrate(self, gradients, dt=0.0):
        """Batched constitutive update on ``gradients (n, sum(grad sizes))``.

        Returns ``(flux (n, nflux), isv_flat (n, nisv), Ct_flat (n, block
        sizes))`` and stores the trial state in ``data_manager.s1``."""
        self._require_fast()
        dm, x = self._inputs(gradients)
        with timer(f"{self.name}: constitutive update"):
            flux, Ct, new_state = self._fast_update(x, dm.s0.internal, dt)
        Ct = Ct.reshape(dm.n, -1)
        s1 = dm.s1
        s1.gradients = x
        s1.fluxes = flux
        s1.internal = dict(new_state)
        return flux, s1.internal_state_variables, Ct

    def integrate_flux_only(self, gradients, dt=0.0):
        """Tangent-free update for line-search trials: ``(flux, isv_flat)``.
        The J2 fast path's analytic tangent is nearly free, so it is reused."""
        self._require_fast()
        dm, x = self._inputs(gradients)
        with timer(f"{self.name}: constitutive update (flux-only)"):
            flux, _, new_state = self._fast_update(x, dm.s0.internal, dt)
        s1 = dm.s1
        s1.gradients = x
        s1.fluxes = flux
        s1.internal = dict(new_state)
        return flux, s1.internal_state_variables

    # ----------------------------------------------------- state dict access
    def get_initial_state_dict(self):
        return self.data_manager.s0.as_dict()

    def get_final_state_dict(self):
        return self.data_manager.s1.as_dict()

    def set_initial_state_dict(self, state: dict):
        for k, v in state.items():
            self.data_manager.s0[k] = v

