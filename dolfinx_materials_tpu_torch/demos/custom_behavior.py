"""A behavior written by the user: Zener (standard linear solid)
viscoelasticity in torch, on the generic path. The torch twin of the JAX
package's custom-behavior demo.

The user writes one per-point update against the ``SmallStrainBehavior``
protocol; ``Material`` derives the batching and the consistent tangent
(``vmap(jacfwd)``). The experiment is a stress relaxation: a homogeneous
strain ``eps_xx = exx`` imposed by affine Dirichlet conditions on the whole
boundary of a unit square, then held while time advances. The strain field
is exactly constant, so the discrete solution has the closed form

    sigma_xx(t) = kappa exx + (4/3) mu_inf exx + (4/3) mu1 exx exp(-t/tau)

which the demo checks against and writes out as a CSV relaxation curve.

Run: ``python -m dolfinx_materials_tpu_torch.demos.custom_behavior [N] [cpu]``
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, create_unit_square, locate_dofs_geometrical
from ..fem.forms import mandel_strain_2d
from ..models.base import SmallStrainBehavior
from ..ops.tensors import I2, dev, tr


class ZenerViscoelasticity(SmallStrainBehavior):
    """Standard linear solid: a long-term spring (kappa, mu_inf) in parallel
    with a Maxwell branch (mu1, relaxation time tau),

        sigma = kappa tr(eps) I + 2 mu_inf dev(eps) + 2 mu1 (dev(eps) - epsv),

    the viscous deviatoric strain following d(epsv)/dt = (dev(eps) - epsv)/tau,
    integrated exactly for a strain held over the step (dt = 0: no flow)."""

    def __init__(self, kappa, mu_inf, mu1, tau):
        self.kappa, self.mu_inf, self.mu1, self.tau = kappa, mu_inf, mu1, tau

    def init_state(self):
        return {"epsv": np.zeros(6)}

    def small_strain_update(self, eps, state, dt):
        e = dev(eps)
        a = math.exp(-float(dt) / self.tau)
        epsv = e + (state["epsv"] - e) * a
        i2 = torch.as_tensor(I2, dtype=eps.dtype, device=eps.device)
        sig = self.kappa * tr(eps) * i2 + 2 * self.mu_inf * e + 2 * self.mu1 * (e - epsv)
        return sig, {"epsv": epsv}


def relaxation_modulus_xx(t, kappa, mu_inf, mu1, tau):
    """Closed-form sigma_xx / exx of the held uniaxial-strain state."""
    return kappa + (4.0 / 3.0) * (mu_inf + mu1 * np.exp(-t / tau))


def main(N=8, n_hold=40, write_outputs=True, device=None, out_dir="."):
    """Returns ``(times, sigma_xx, closed form, max relative error)``."""
    kappa, mu_inf, mu1, tau = 1.0e3, 300.0, 700.0, 0.5
    exx = 1e-3
    material = Material(ZenerViscoelasticity(kappa, mu_inf, mu1, tau), device=device)
    V = FunctionSpace(create_unit_square(N, N, "quad"), degree=1, shape=(2,))
    qmap = QuadratureMap(V, 2, material)
    qmap.register_gradient("Strain", mandel_strain_2d())

    # affine Dirichlet on the whole boundary: u_x = exx x, u_y = 0, a
    # homogeneous strain [exx, 0, 0, 0, 0, 0] at all times
    def on_boundary(x):
        return np.isclose(x[:, 0], 0.0) | np.isclose(x[:, 0], 1.0) | np.isclose(x[:, 1], 0.0) | np.isclose(x[:, 1], 1.0)

    bx = locate_dofs_geometrical(V, on_boundary, component=0)
    by = locate_dofs_geometrical(V, on_boundary, component=1)
    bcs = [DirichletBC(bx, exx * V.node_coords[bx // V.ncomp, 0]), DirichletBC(by, 0.0)]
    u = Function(V, name="u")
    problem = NonlinearMaterialProblem(qmap, u, bcs=bcs, options={"ksp_type": "lu", "atol": 1e-12, "rtol": 1e-12})

    def sig_xx():
        return float(qmap.material.data_manager.s0["Stress"][0, 0])

    qmap.dt = 0.0  # the instantaneous step: the Maxwell branch is glassy
    converged, _ = problem.solve()
    if not converged:
        raise RuntimeError("instantaneous step failed")
    qmap.advance()
    dt = tau / 8.0
    ts, sig = [0.0], [sig_xx()]
    qmap.dt = dt
    for k in range(n_hold):
        converged, _ = problem.solve()
        if not converged:
            raise RuntimeError(f"hold step {k} failed")
        qmap.advance()
        ts.append((k + 1) * dt)
        sig.append(sig_xx())

    ts, sig = np.asarray(ts), np.asarray(sig)
    analytic = exx * relaxation_modulus_xx(ts, kappa, mu_inf, mu1, tau)
    rel_err = float(np.max(np.abs(sig - analytic) / np.abs(analytic)))
    print(f"relaxation steps: {n_hold}, dt = tau/8, device: {material.device}")
    print(f"sigma_xx(0)   = {sig[0]:.6e}  (analytic {analytic[0]:.6e})")
    print(f"sigma_xx(end) = {sig[-1]:.6e}  (analytic {analytic[-1]:.6e})")
    print(f"max rel error vs closed form: {rel_err:.3e}")
    if write_outputs:
        np.savetxt(os.path.join(out_dir, "zener_relaxation.csv"), np.column_stack([ts, sig, analytic]),
                   delimiter=",", header="t,sigma_xx,analytic", comments="")
    return ts, sig, analytic, rel_err


if __name__ == "__main__":
    args = sys.argv[1:]
    ints = [int(a) for a in args if a.isdigit()]
    main(ints[0] if ints else 8, device="cpu" if "cpu" in args else None)
