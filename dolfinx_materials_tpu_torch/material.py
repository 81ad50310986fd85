"""Material adapter: batches a Behavior over Gauss points with consistent tangents.

The counterpart of dolfinx_materials_tpu/material.py:

- ``batched_constitutive_update = vmap(jacfwd(update, has_aux=True))`` over
  the Gauss-point axis, with implicit-function-theorem roots inside the update
  (ops/newton.py) so the Jacobian pass never unrolls a local Newton loop;
- every declared tangent block (flux x gradient, plus ISV x ESV blocks for
  generalized behaviors) is sliced out of that one forward-mode Jacobian and
  packed into the flat layout the QuadratureMap consumes;
- a behavior that supplies a whole-batch fast path (``batched_update``, e.g.
  the J2 return map of ops/j2_fast.py, which launches the CUDA kernel on the
  card) is run through it instead; an optional ``batched_flux`` companion
  serves the tangent-free update;
- ``rotation_matrix`` (global -> material frame, (3,3) or (n,3,3)) rotates
  inputs into the material frame and fluxes and tangents back;
- state lives in the DataManager (state.py): ``integrate`` runs on the s0
  state and stores the trial state in s1.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from . import resolve_device
from .ops import tensors
from .state import DataManager, _slices
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
        self.rotation_matrix = None  # optional (3,3) or (n,3,3) global->material

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

        # differentiable inputs = gradients then ESVs, concatenated flat
        self._input_sizes = {**self.gradients, **self.external_state_variables}
        self._in_slices = _slices(self._input_sizes)
        self.n_inputs = sum(self._input_sizes.values())
        # outputs that need tangents = fluxes then any ISV named as a block "y"
        tangent_isvs = [y for (y, _) in self.tangent_blocks if y in self.internal_state_variables]
        self._out_sizes = dict(self.fluxes)
        for y in tangent_isvs:
            self._out_sizes.setdefault(y, self.internal_state_variables[y])
        self._out_slices = _slices(self._out_sizes)
        self._tangent_isvs = list(dict.fromkeys(tangent_isvs))

        # external state variable values, set by the QuadratureMap before integrate
        self.external_state: dict = {}
        # spatially-varying material properties (behavior.material_properties)
        self.material_property_values: dict = {}

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

    # ---------------------------------------------------------- batched core
    def _build_batched(self):
        behavior = self.behavior
        in_slices = self._in_slices
        out_slices = self._out_slices
        flux_names = self.flux_names
        tangent_isvs = self._tangent_isvs
        blocks = list(self.tangent_blocks.keys())

        def evaluate(x, props, state, dt):
            inputs = {k: x[sl] for k, sl in in_slices.items()}
            inputs.update(props)
            return behavior.constitutive_update(inputs, state, dt)

        def point_update(x_flat, props, state, dt):
            def f(x):
                flux_dict, new_state = evaluate(x, props, state, dt)
                outs = [flux_dict[n].reshape(-1) for n in flux_names]
                outs += [new_state[n].reshape(-1) for n in tangent_isvs]
                return torch.cat(outs), (flux_dict, new_state)

            J, (flux_dict, new_state) = jacfwd(f, has_aux=True)(x_flat)
            J = J.to(x_flat.dtype)  # float32 tangents of 0-d intermediates come back float64
            flux_flat = torch.cat([flux_dict[n].reshape(-1) for n in flux_names])
            Ct_parts = [J[out_slices[y], in_slices[x]].reshape(-1) for (y, x) in blocks]
            Ct_flat = torch.cat(Ct_parts) if Ct_parts else x_flat.new_zeros(0)
            return flux_flat, Ct_flat, new_state

        def point_flux(x_flat, props, state, dt):
            """Tangent-free update: one behavior evaluation, no jacfwd pass;
            a line-search trial costs 1 evaluation instead of 1 + n_inputs."""
            flux_dict, new_state = evaluate(x_flat, props, state, dt)
            return torch.cat([flux_dict[n].reshape(-1) for n in flux_names]), new_state

        self._point_update = point_update
        self._point_flux = point_flux
        #: ``(x (n, n_inputs), props, state, dt) -> (flux, Ct_flat, new_state)``
        self.batched_constitutive_update = vmap(point_update, in_dims=(0, 0, 0, None))
        #: ``(x, props, state, dt) -> (flux, new_state)``
        self.batched_flux_update = vmap(point_flux, in_dims=(0, 0, 0, None))

        # optional whole-batch fast path supplied by the behavior (e.g. the
        # analytic-tangent J2 return map, ops/j2_fast.py). Only usable for the
        # single-gradient / no-ESV / no-property signature.
        fast = getattr(behavior, "batched_update", None)
        self._fast_update = None
        self._fast_flux = None
        if (
            fast is not None
            and not self.external_state_variables
            and not getattr(behavior, "material_properties", {})
            and len(self.tangent_blocks) == 1
        ):
            self._fast_update = fast
            # optional tangent-free whole-batch companion, for behaviors whose
            # tangent costs far more than their flux
            self._fast_flux = getattr(behavior, "batched_flux", None)

    # ------------------------------------------------------------- lifecycle
    def set_data_manager(self, ngauss: int):
        self.data_manager = DataManager(self.behavior, ngauss, self.dtype, self.device)

    def _tensor(self, values):
        return torch.as_tensor(values, dtype=self.dtype, device=self.device)

    def update_external_state_variable(self, name, values):
        if name not in self.external_state_variables:
            raise KeyError(f"behavior does not declare ESV '{name}'")
        self.external_state[name] = self._tensor(values)

    def update_material_property(self, name, values):
        """Update a material property: scalar/array values of a declared
        spatially-varying property, or a plain behavior attribute."""
        if name in getattr(self.behavior, "material_properties", {}):
            self.material_property_values[name] = self._tensor(values)
        else:
            setattr(self.behavior, name, values)
            # drop any behavior-level cached whole-batch update that closed
            # over the old parameters (e.g. vonMisesIsotropicHardening._fast)
            for cached in ("_fast", "_fast_key", "_batched", "_kernel"):
                self.behavior.__dict__.pop(cached, None)
            self._build_batched()

    # ------------------------------------------------------------- rotations
    def _rotation_ops(self, n):
        """Per-size rotation operators from ``self.rotation_matrix`` (global
        -> material frame, (3,3) or (n,3,3)): Mandel 6x6 for size-6 fields,
        9x9 for size-9 fields, R itself for vectors."""
        R = self._tensor(self.rotation_matrix)
        if R.ndim == 2:
            R = R.expand(n, 3, 3)
        ops = {}
        for s in set(self._input_sizes.values()) | set(self._out_sizes.values()):
            if s == 6:
                ops[6] = tensors.rotation_to_mandel6(R)
            elif s == 9:
                ops[9] = tensors.rotation_to_9(R)
            elif s == 3:
                ops[3] = R
        return ops

    @staticmethod
    def _rotate_cols(arr, sizes, ops, transpose):
        """Rotate each named column block of ``arr (n, total)`` whose size has
        an operator; built with ``cat`` of the rotated slices, no in-place
        write."""
        parts = []
        for name, sl in _slices(sizes).items():
            block = arr[:, sl]
            Q = ops.get(sizes[name])
            if Q is not None:
                Qe = Q.transpose(1, 2) if transpose else Q
                block = torch.einsum("nij,nj->ni", Qe, block)
            parts.append(block)
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    def _rotate_tangent(self, Ct, ops):
        """C_glob = Q_y^T C_mat Q_x per packed tangent block."""
        parts = []
        pos = 0
        for (sy, sx) in self.tangent_blocks.values():
            block = Ct[:, pos : pos + sy * sx].reshape(-1, sy, sx)
            Qy, Qx = ops.get(sy), ops.get(sx)
            if Qy is not None:
                block = torch.einsum("nji,njk->nik", Qy, block)
            if Qx is not None:
                block = torch.einsum("nik,nkj->nij", block, Qx)
            parts.append(block.reshape(-1, sy * sx))
            pos += sy * sx
        return torch.cat(parts, dim=1) if parts else Ct

    # ------------------------------------------------------------- integrate
    def _to_batched(self, v, n, size):
        """Broadcast scalar / (size,) / (n,) / (n*size,) values to (n, size)."""
        v = self._tensor(v)
        if v.ndim == 0 or tuple(v.shape) == (size,):
            return v.expand(n, size)
        return v.reshape(n, size)

    def _assemble_inputs(self, gradients, n):
        parts = [gradients]
        for name, size in self.external_state_variables.items():
            if name in self.external_state:
                parts.append(self._to_batched(self.external_state[name], n, size))
            else:
                parts.append(gradients.new_zeros((n, size)))
        return torch.cat(parts, dim=1) if len(parts) > 1 else gradients

    def _assemble_props(self, n):
        props = {}
        for name, size in getattr(self.behavior, "material_properties", {}).items():
            v = self.material_property_values.get(name)
            if v is None:
                raise ValueError(f"material property '{name}' has not been set")
            v = self._to_batched(v, n, size)
            props[name] = v[:, 0] if size == 1 else v
        return props

    def _prepare(self, gradients):
        """Shared front of both integrate forms: ``(dm, gradients, x, props,
        rot)`` with ``x`` the (rotated) gradient + ESV input columns."""
        dm = self.data_manager
        if dm is None:
            self.set_data_manager(gradients.shape[0])
            dm = self.data_manager
        gradients = self._tensor(gradients)
        x = self._assemble_inputs(gradients, dm.n)
        props = self._assemble_props(dm.n)
        rot = None
        if self.rotation_matrix is not None:
            rot = self._rotation_ops(dm.n)
            x = self._rotate_cols(x, self._input_sizes, rot, False)
        return dm, gradients, x, props, rot

    def _store(self, dm, gradients, flux, new_state):
        with timer("material: store", device=self.device):
            s1 = dm.s1
            s1.gradients = gradients
            s1.fluxes = flux
            s1.internal = dict(new_state)
            return s1.internal_state_variables

    def integrate(self, gradients, dt=0.0):
        """Batched constitutive update on ``gradients (n, sum(grad sizes))``.

        Returns ``(flux (n, nflux), isv_flat (n, nisv), Ct_flat (n, sum block
        sizes))`` and stores the trial state in ``data_manager.s1``."""
        with timer("material: integrate", device=self.device):
            dm, gradients, x, props, rot = self._prepare(gradients)
            with timer(f"{self.name}: constitutive update", device=self.device):
                if self._fast_update is not None:
                    flux, Ct, new_state = self._fast_update(x, dm.s0.internal, dt)
                    Ct = Ct.reshape(dm.n, -1)
                else:
                    flux, Ct, new_state = self.batched_constitutive_update(x, props, dm.s0.internal, dt)
            if rot is not None:
                flux = self._rotate_cols(flux, self.fluxes, rot, True)
                Ct = self._rotate_tangent(Ct, rot)
            return flux, self._store(dm, gradients, flux, new_state), Ct

    def integrate_flux_only(self, gradients, dt=0.0):
        """Tangent-free batched update: ``(flux (n, nflux), isv_flat)``.

        Same contract as :meth:`integrate` (rotations included, trial state
        stored in s1) but skips the jacfwd tangent pass: the cheap evaluation
        line-search backtracking needs."""
        dm, gradients, x, props, rot = self._prepare(gradients)
        with timer(f"{self.name}: constitutive update (flux-only)", device=self.device):
            if self._fast_flux is not None:
                flux, new_state = self._fast_flux(x, dm.s0.internal, dt)
            elif self._fast_update is not None:
                # the analytic fast path's tangent is nearly free; reuse it
                flux, _, new_state = self._fast_update(x, dm.s0.internal, dt)
            else:
                flux, new_state = self.batched_flux_update(x, props, dm.s0.internal, dt)
        if rot is not None:
            flux = self._rotate_cols(flux, self.fluxes, rot, True)
        return flux, self._store(dm, gradients, flux, new_state)

    # ----------------------------------------------------- state dict access
    def get_initial_state_dict(self):
        return self.data_manager.s0.as_dict()

    def get_final_state_dict(self):
        return self.data_manager.s1.as_dict()

    def set_initial_state_dict(self, state: dict):
        for k, v in state.items():
            self.data_manager.s0[k] = v

