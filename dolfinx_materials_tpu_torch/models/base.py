"""Behavior protocol: the contract every material model implements.

A behavior maps a dict of differentiable inputs (gradients + external state
variables) to a dict of fluxes plus a new internal-state dict, and declares
its signature (gradient, flux and state sizes). A behavior may also supply a
whole-batch ``batched_update(x, state, dt) -> (flux, Ct, state)`` (J2:
strains (n,6) -> stresses and Ct (n,36); finite strain: F (n,9) -> PK1 and
Ct (n,81)); :class:`~..material.Material` prefers it.

Consistent tangents are not part of the protocol: ``Material`` computes every
declared tangent block in one forward-mode Jacobian pass over the per-point
update, with implicit-function-theorem roots (ops/newton.py) inside it.
"""

from __future__ import annotations


class Behavior:
    """Base class. Subclasses declare I/O signatures and the per-point update."""

    #: name -> number of (flattened) components of each gradient-like input
    gradients: dict = {}
    #: name -> number of components of each flux (thermodynamic force)
    fluxes: dict = {}
    #: name -> number of components of external state variables consumed
    external_state_variables: dict = {}
    #: extra tangent blocks (y_name, x_name) beyond flux x gradient
    extra_tangent_blocks: list = []

    def init_state(self) -> dict:
        """Per-point internal-state template: dict of numpy arrays."""
        return {}

    @property
    def tangent_blocks(self) -> list:
        """All (y, x) consistent-tangent blocks, default flux x gradient."""
        blocks = [(f, g) for f in self.fluxes for g in self.gradients]
        return blocks + list(self.extra_tangent_blocks)

    def constitutive_update(self, inputs: dict, state: dict, dt):
        """Per-point update ``(inputs, state, dt) -> (fluxes, new_state)``.

        ``inputs`` holds every gradient and external state variable (and any
        declared material property) as flat tensors of the declared sizes;
        ``state`` is this behavior's internal-state dict. Must be a pure
        function of tensors, differentiable with respect to ``inputs``."""
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


class SmallStrainBehavior(Behavior):
    """Small-strain mechanics: Mandel strain (6,) -> Mandel stress (6,)."""

    gradients = {"Strain": 6}
    fluxes = {"Stress": 6}

    def constitutive_update(self, inputs, state, dt):
        sig, new_state = self.small_strain_update(inputs["Strain"], state, dt)
        return {"Stress": sig}, new_state

    def small_strain_update(self, eps, state, dt):
        raise NotImplementedError


class FiniteStrainBehavior(Behavior):
    """Finite-strain mechanics: deformation gradient F (9,) -> PK1 stress
    (9,), vector convention [11,22,33,12,21,13,31,23,32]; the consistent
    tangent dPK1/dF is (9, 9), 81 wide flattened row-major (PK1 row, F
    column). Subclasses implement ``finite_strain_update(F, state, dt)``
    (models/hyperelasticity.py: PK1 as the gradient of an energy) and may
    add a whole-batch ``batched_update(F (n,9), state, dt) -> (PK1 (n,9),
    Ct (n,81), state)``."""

    gradients = {"F": 9}
    fluxes = {"PK1": 9}

    def constitutive_update(self, inputs, state, dt):
        pk1, new_state = self.finite_strain_update(inputs["F"], state, dt)
        return {"PK1": pk1}, new_state

    def finite_strain_update(self, F, state, dt):
        raise NotImplementedError
