"""Modelling hypotheses: plane stress.

Plane strain and 3d are native (the Mandel 6-vector carries ezz). Plane stress
is a wrapper behavior: the out-of-plane strain is solved per Gauss point so
that sig_zz = 0, through the implicit-function-theorem scalar solver, so any
small-strain behavior (elastic, J2, Norton, ...) gets a consistent
plane-stress-condensed tangent. Axisymmetry is a kinematic and measure
concern handled in fem/forms.py (``axisymmetric_strain``) and the
QuadratureDomain ``weight``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.newton import scalar_newton_solve
from .base import SmallStrainBehavior


def _with_ezz(eps, ezz):
    return torch.cat([eps[:2], ezz.reshape(1), eps[3:]])


class PlaneStress(SmallStrainBehavior):
    """Enforce sig_zz = 0 by solving for eps_zz internally.

    The incoming Strain 6-vector's ezz slot must be 0 (2D kinematics produce 0
    there); the solved ezz is exposed as the ISV ``eps_zz``. A nonzero
    incoming ezz means a 3D-strain caller is misusing the wrapper: raising is
    impossible per point under ``vmap``, so such points have their stress
    poisoned with NaN, which the solver's non-finite residual test and the
    QuadratureMap NaN check both surface.
    """

    def __init__(self, inner, tol=1e-10, max_iter=40):
        self.inner = inner
        self.tol = tol
        self.max_iter = max_iter

    def init_state(self):
        st = self.inner.init_state()
        if "eps_zz" in st:
            raise ValueError("the wrapped behavior already has an 'eps_zz' state variable")
        return {**st, "eps_zz": np.zeros(())}

    def small_strain_update(self, eps, state, dt):
        names = [k for k in state if k != "eps_zz"]
        inner_state = {k: state[k] for k in names}

        # the wrapped state varies per point, so it reaches the residual
        # through the solver's arguments, not by closure (ops/newton.py)
        def res(ezz, eps, dt, *leaves):
            st = dict(zip(names, leaves))
            sig, _ = self.inner.small_strain_update(_with_ezz(eps, ezz), st, dt)
            return sig[2]

        # initial guess: the previous converged value
        ezz, _ = scalar_newton_solve(
            res,
            state["eps_zz"],
            args=(eps, dt, *inner_state.values()),
            tol=self.tol,
            max_iter=self.max_iter,
        )
        sig, new_inner = self.inner.small_strain_update(_with_ezz(eps, ezz), inner_state, dt)
        bad = eps[2] != 0.0
        sig = torch.where(bad, torch.full_like(sig, torch.nan), sig)
        return sig, {**new_inner, "eps_zz": ezz}
