"""Generalized (non-mechanical) behaviors: nonlinear heat transfer, phase
change and thermo-mechanical coupling.

Counterpart of dolfinx_materials_tpu/models/thermal.py (MFront's
StationaryHeatTransfer and HeatTransferPhaseChange generic behaviours). The
flux depends on the temperature gradient and on the temperature itself (an
external state variable), and the phase-change enthalpy is an internal
state variable with its own dh/dT block; ``Material`` takes every block
from its one forward-mode pass. None of these has a whole-batch fast path:
a behavior with external state variables always runs the generic path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import tensors
from .base import Behavior
from .elasticity import LinearElasticIsotropic


class NonlinearHeatTransfer(Behavior):
    """Fourier conduction with k(T) = 1 / (A + B T); j = -k(T) grad(T)."""

    def __init__(self, A=0.0375, B=2.165e-4, dim=2):
        self.A = A
        self.B = B
        self.dim = dim
        self.gradients = {"TemperatureGradient": dim}
        self.fluxes = {"HeatFlux": dim}
        self.external_state_variables = {"Temperature": 1}
        self.extra_tangent_blocks = [("HeatFlux", "Temperature")]

    def conductivity(self, T):
        return 1.0 / (self.A + self.B * T)

    def constitutive_update(self, inputs, state, dt):
        T = inputs["Temperature"][0]
        return {"HeatFlux": -self.conductivity(T) * inputs["TemperatureGradient"]}, state


class ThermoElasticIsotropic(Behavior):
    """Thermo-elasticity sig = C : (eps - alpha (T - T0) I), with the
    d Stress / d Temperature block (staggered thermo-mechanics,
    demos/thermomechanics.py)."""

    def __init__(self, E, nu, alpha_th, T0=293.15):
        self.elastic = LinearElasticIsotropic(E, nu)
        self.alpha_th = alpha_th
        self.T0 = T0
        self.gradients = {"Strain": 6}
        self.fluxes = {"Stress": 6}
        self.external_state_variables = {"Temperature": 1}
        self.extra_tangent_blocks = [("Stress", "Temperature")]

    def constitutive_update(self, inputs, state, dt):
        eps = inputs["Strain"]
        T = inputs["Temperature"][0]
        eps_th = self.alpha_th * (T - self.T0) * torch.as_tensor(tensors.I2, dtype=eps.dtype, device=eps.device)
        return {"Stress": self.elastic.stress(eps - eps_th)}, state


class PhaseChangeHeatTransfer(Behavior):
    """Conduction with solid/liquid phase change through a smoothed enthalpy
    internal state variable:

    - solid (T < Ts): k = ks, h = cs T;
    - liquid (T > Tl): k = kl, h = cl (T - Tl) + dh_sl + cs Ts + (cs + cl) Tsm / 2;
    - mushy: k linear in T, h = cs Ts + c_m (T - Ts), c_m = (cs + cl) / 2 + dh_sl / Tsm.
    """

    def __init__(self, Tm=933.15, ks=210.0, cs=3.0e6, kl=95.0, cl=2.58e6, dh_sl=1.08048e9, Tsmooth=0.1, dim=2):
        self.Tm, self.ks, self.cs, self.kl, self.cl = Tm, ks, cs, kl, cl
        self.dh_sl, self.Tsmooth = dh_sl, Tsmooth
        self.dim = dim
        self.gradients = {"TemperatureGradient": dim}
        self.fluxes = {"HeatFlux": dim}
        self.external_state_variables = {"Temperature": 1}
        self.extra_tangent_blocks = [("HeatFlux", "Temperature"), ("Enthalpy", "Temperature")]

    def init_state(self):
        return {"Enthalpy": np.zeros(1)}

    def _k_h(self, T):
        Ts = self.Tm - self.Tsmooth / 2
        Tl = self.Tm + self.Tsmooth / 2
        c_m = (self.cs + self.cl) / 2 + self.dh_sl / self.Tsmooth
        k_solid, h_solid = torch.full_like(T, self.ks), self.cs * T
        k_liquid = torch.full_like(T, self.kl)
        h_liquid = self.cl * (T - Tl) + self.dh_sl + self.cs * Ts + (self.cs + self.cl) * self.Tsmooth / 2
        k_mushy = self.ks + (self.kl - self.ks) * (T - Ts) / self.Tsmooth
        h_mushy = self.cs * Ts + c_m * (T - Ts)
        k = torch.where(T < Ts, k_solid, torch.where(T > Tl, k_liquid, k_mushy))
        h = torch.where(T < Ts, h_solid, torch.where(T > Tl, h_liquid, h_mushy))
        return k, h

    def constitutive_update(self, inputs, state, dt):
        k, h = self._k_h(inputs["Temperature"][0])
        return {"HeatFlux": -k * inputs["TemperatureGradient"]}, {"Enthalpy": h.reshape(1)}


class ThermoMechanicalHeat(Behavior):
    """Conduction with a mechanically coupled heat source, the two-way
    partner of :class:`ThermoElasticIsotropic`:

        j = -k grad(T),   Source = kappa (T - T0) + chi eps_v

    with the volumetric strain ``eps_v`` an external state variable fed from
    the mechanical field."""

    def __init__(self, k=1.0, kappa=0.0, chi=0.0, T0=293.15, dim=2):
        self.k, self.kappa, self.chi, self.T0, self.dim = k, kappa, chi, T0, dim
        self.gradients = {"TemperatureGradient": dim}
        self.fluxes = {"HeatFlux": dim, "Source": 1}
        self.external_state_variables = {"Temperature": 1, "VolStrain": 1}
        self.extra_tangent_blocks = [("Source", "Temperature"), ("Source", "VolStrain")]

    def constitutive_update(self, inputs, state, dt):
        T = inputs["Temperature"][0]
        src = self.kappa * (T - self.T0) + self.chi * inputs["VolStrain"][0]
        return {"HeatFlux": -self.k * inputs["TemperatureGradient"], "Source": src.reshape(1)}, state
