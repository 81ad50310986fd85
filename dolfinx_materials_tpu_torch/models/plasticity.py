"""Rate-independent J2 elastoplasticity with isotropic hardening.

``vonMisesIsotropicHardening(elasticity=..., yield_stress=...)``: the radial
return of von Mises plasticity. Internal state: plastic strain ``eps_p``
(Mandel 6) and cumulated plastic strain ``p``. The whole-batch fast path
(:meth:`batched_update`, analytic Simo-Hughes tangent, ops/j2_fast.py) is
what :class:`~..material.Material` runs; on the card it launches the CUDA
return-map kernel.
"""

from __future__ import annotations

import numpy as np

from .base import SmallStrainBehavior


class vonMisesIsotropicHardening(SmallStrainBehavior):
    """J2 plasticity, radial return, general isotropic hardening."""

    def __init__(self, elasticity, yield_stress, tol=1e-10, max_iter=50):
        self.elasticity = elasticity
        self.yield_stress = yield_stress
        self.tol = tol
        self.max_iter = max_iter

    def init_state(self):
        return {"eps_p": np.zeros(6), "p": np.zeros(())}

    def batched_update(self, eps, state, dt):
        """Whole-batch fast path (ops/j2_fast.py). The cached update closes
        over elasticity/yield_stress, so the cache is keyed on those objects:
        swapping parameters rebuilds instead of using stale moduli."""
        key = (id(self.elasticity), id(self.yield_stress))
        if getattr(self, "_fast_key", None) != key:
            from ..ops.j2_fast import make_j2_batched_update

            self._fast = make_j2_batched_update(self.elasticity, self.yield_stress)
            self._fast_key = key
        return self._fast(eps, state, dt)

    def small_strain_update(self, eps, state, dt):
        raise NotImplementedError(
            "the generic per-point J2 return map (implicit-function-theorem "
            "roots, ops/newton.py) is not ported yet: see ROADMAP.md Queue 1, "
            "'Generic IFT path'. Material uses batched_update instead."
        )
