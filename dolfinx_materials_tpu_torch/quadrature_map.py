"""QuadratureMap: binds a Material to the Gauss points of a (sub)domain.

- ``register_gradient(name, expr)`` registers a kinematic expression of the
  local field context (fem/forms.py); its variation for tangent assembly is
  ``torch.func`` AD;
- ``register_external_state_variable(name, values_or_expr)`` feeds an external
  state variable as a constant/array or as an expression of u;
- ``update(u)`` evaluates the gradients at the Gauss points, runs the batched
  constitutive update on the device and keeps flux/tangent tensors there;
- ``advance()`` commits s1 -> s0 after global convergence, ``revert()`` undoes
  a failed load step.
"""

from __future__ import annotations

import numpy as np
import torch

from .fem.assembly import QuadratureDomain, project_cg, project_dg0
from .fem.space import FunctionSpace
from .material import Material
from .utils.timers import timer


class QuadratureMap:
    def __init__(self, space: FunctionSpace, deg_quad: int, material: Material, cells=None,
                 check_nans: bool = False, weight=None):
        """The Gauss points of ``cells`` (default: all) at quadrature degree
        ``deg_quad``, on the material's device and in its dtype; ``weight``
        multiplies the integration measure (see :class:`QuadratureDomain`)."""
        self.space = space
        self.material = material
        self.dtype = material.dtype
        self.device = material.device
        self.domain = QuadratureDomain(
            space, deg_quad, cells, dtype=self.dtype, device=self.device, weight=weight
        )
        material.set_data_manager(self.domain.num_points)
        self.dt = 0.0
        #: assert flux/state/tangent finiteness after every integration. Off by
        #: default: it costs one blocking host sync per Newton iteration.
        self.check_nans = check_nans
        self.gradient_exprs: dict = {}
        self.esv_exprs: dict = {}
        self._eval_fns: dict = {}
        self._flux = None
        self._Ct = None
        self._block_slices = {}
        pos = 0
        for (y, x), (sy, sx) in material.tangent_blocks.items():
            self._block_slices[(y, x)] = (slice(pos, pos + sy * sx), sy, sx)
            pos += sy * sx

    def register_gradient(self, name: str, expr):
        if name not in self.material.gradients:
            raise KeyError(
                f"behavior declares gradients {list(self.material.gradients)}, not '{name}'"
            )
        self.gradient_exprs[name] = expr
        self._eval_fns[name] = self.domain.make_eval(expr)

    def register_external_state_variable(self, name: str, expr_or_values):
        """Register an ESV as a constant/array or as an expression of u."""
        if callable(expr_or_values):
            self.esv_exprs[name] = expr_or_values
            self._eval_fns[name] = self.domain.make_eval(expr_or_values)
        else:
            self.material.update_external_state_variable(name, expr_or_values)

    def _gradient_values(self, u):
        """ESV expressions evaluated into the material, then the gradient
        columns ``(npoints, sum(grad sizes))``."""
        missing = [g for g in self.material.gradients if g not in self.gradient_exprs]
        if missing:
            raise RuntimeError(f"gradients not registered: {missing}")
        with timer("qmap: external state variable update", device=self.device):
            for name in self.esv_exprs:
                self.material.update_external_state_variable(name, self._eval_fns[name](u))
        with timer("qmap: gradients evaluation", device=self.device):
            grads = [self._eval_fns[g](u) for g in self.material.gradients]
            return torch.cat(grads, dim=1) if len(grads) > 1 else grads[0]

    def update(self, u):
        """Gradients at Gauss points -> batched material integrate ->
        device-resident flux/tangents."""
        u = torch.as_tensor(u, dtype=self.dtype, device=self.device)
        grad_vals = self._gradient_values(u)
        with timer("qmap: material integration", device=self.device):
            flux, isv, Ct = self.material.integrate(grad_vals, self.dt)
        if self.check_nans:
            # one reduced scalar per array, one host sync in all
            sums = torch.stack([flux.sum(), isv.sum(), Ct.sum()])
            finite = torch.isfinite(sums).cpu().numpy()
            if not finite.all():
                names = [n for n, ok in zip(("flux", "isv", "tangent"), finite) if not ok]
                raise FloatingPointError(
                    f"Material integration of {self.material.name} produced "
                    f"non-finite {', '.join(names)} values"
                )
        self._flux = flux
        self._Ct = Ct
        return flux, Ct

    def update_flux_only(self, u):
        """Tangent-free update for line-search trials; the cached tangent is
        left untouched."""
        u = torch.as_tensor(u, dtype=self.dtype, device=self.device)
        grad_vals = self._gradient_values(u)
        with timer("qmap: material integration (flux-only)", device=self.device):
            flux, _ = self.material.integrate_flux_only(grad_vals, self.dt)
        self._flux = flux
        return flux

    def advance(self):
        """Commit the converged state."""
        self.material.data_manager.update()

    def revert(self):
        self.material.data_manager.revert()

    @property
    def num_points(self):
        return self.domain.num_points

    @property
    def cells(self):
        return self.domain.cells

    def flux_array(self, name: str):
        """Current (trial) flux values (npoints, size)."""
        return self.material.data_manager.s1[name]

    def field_array(self, name: str):
        """Any state field by name from the trial state."""
        return self.material.data_manager.s1[name]

    def tangent_block(self, y: str, x: str):
        """(npoints, sy, sx) view of one consistent-tangent block."""
        sl, sy, sx = self._block_slices[(y, x)]
        return self._Ct[:, sl].reshape(-1, sy, sx)

    def update_initial_state(self, field: str, value):
        """Set a converged-state field from a scalar, an array or a callable
        of the Gauss-point coordinates ``(npoints, dim)``."""
        if callable(value):
            xq = self.domain.x_q.reshape(self.num_points, -1).cpu().numpy()
            value = np.asarray(value(xq))
        self.material.data_manager.s0[field] = value
        self.material.data_manager.s1[field] = value

    def project_on(self, name: str, kind=("DG", 0), smooth=None):
        """Project a quadrature state field: ``("DG", 0)`` -> cell averages
        (ne, k) numpy; ``("P"|"CG"|"Lagrange", deg)`` -> continuous L2
        projection, ``(FunctionSpace, dof values (nnodes, k) numpy)``, with
        ``smooth`` the Helmholtz filter length of :func:`project_cg`.

        A ``name`` that is no field collects every field that starts with it,
        sorted by name, into one vector field (array-valued internal
        variables stored under flattened names, ``p0``, ``p1``, ...)."""
        s1 = self.material.data_manager.s1
        try:
            vals = s1[name]
        except KeyError:
            matches = sorted(k for k in s1.keys() if k.startswith(name))
            if not matches:
                raise KeyError(
                    f"no state field named or prefixed '{name}' (fields: {s1.keys()})"
                ) from None
            vals = torch.cat([s1[k].reshape(self.num_points, -1) for k in matches], dim=1)
        if kind[0] in ("DG", "dg") and kind[1] == 0:
            return project_dg0(self.domain, vals).cpu().numpy()
        if kind[0] in ("P", "CG", "Lagrange"):
            return project_cg(self.domain, vals, degree=kind[1], smooth=smooth)
        raise NotImplementedError(kind)
