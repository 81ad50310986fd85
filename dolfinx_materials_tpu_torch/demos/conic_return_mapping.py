"""Conic return mapping: exact projections onto non-smooth and smooth
plane-stress yield surfaces, the torch twin of the JAX package's
``demos/conic_return_mapping.py``.

A fan of radial plane-stress strain paths is driven through the exact
Rankine, L1-Rankine and plane-stress von Mises materials; every plastic
path must end exactly on its surface. The paths of one material advance
together, one batched update (``torch.func.vmap`` over the directions) per
step. The stress paths are written to ``conic_stress_paths.csv`` (columns
material index, direction, step, s0, s1, s2).

Run: ``python -m dolfinx_materials_tpu_torch.demos.conic_return_mapping [n_dirs] [cpu]``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
from torch.func import vmap

from .. import resolve_device
from ..models import L1RankineExact, PlaneStressVonMisesExact, RankineExact

E, nu = 30e3, 0.2
ft, fc = 3.0, 30.0
sig0 = 5.0


def stress_paths(mat, n_dirs=16, n_steps=24, eps_max=4e-3, device=None):
    """Radial strain paths: the committed stress histories (n_dirs,
    n_steps, 3) as numpy."""
    dev = resolve_device(device)
    thetas = np.linspace(0, 2 * np.pi, n_dirs, endpoint=False)
    dirs = torch.as_tensor(np.stack([np.cos(thetas), np.sin(thetas), 0.3 * np.sin(2 * thetas)], axis=1),
                           dtype=torch.float64, device=dev)
    state = {k: torch.as_tensor(v, dtype=torch.float64, device=dev).expand(n_dirs, *np.shape(v))
             for k, v in mat.init_state().items()}
    update = vmap(lambda e, st: mat.constitutive_update({"Strain": e}, st, 0.0))
    out = []
    for amp in np.linspace(0, eps_max, n_steps + 1)[1:]:
        flux, state = update(float(amp) * dirs, state)
        out.append(flux["Stress"])
    return torch.stack(out, dim=1).cpu().numpy()


def main(n_dirs=16, device=None, out_dir="."):
    """Returns ``{name: final stresses (n_dirs, 3)}``; raises if a plastic
    path ends off its surface."""
    mats = {
        "rankine": RankineExact(E, nu, ft, fc),
        "l1rankine": L1RankineExact(E, nu, ft, fc),
        "vonmises_ps": PlaneStressVonMisesExact(E, nu, sig0),
    }
    rows, finals = [], {}
    for m, (name, mat) in enumerate(mats.items()):
        paths = stress_paths(mat, n_dirs=n_dirs, device=device)
        fin = finals[name] = paths[:, -1]
        T = fin[:, 0] + fin[:, 1]
        R = np.hypot(0.5 * (fin[:, 0] - fin[:, 1]), fin[:, 2] / np.sqrt(2))
        l1, l2 = 0.5 * T + R, 0.5 * T - R
        if name == "rankine":
            on = np.isclose(l1, ft, atol=1e-8) | np.isclose(l2, -fc, atol=1e-8)
        elif name == "l1rankine":
            on = np.isclose(T, ft, atol=1e-8) | np.isclose(T, -fc, atol=1e-8) | np.isclose(l1 / ft - l2 / fc, 1.0,
                                                                                             atol=1e-9)
        else:
            on = np.isclose(np.einsum("ni,ij,nj->n", fin, mat.Q, fin), sig0**2, rtol=1e-9)
        print(f"{name}: {on.sum()}/{len(on)} paths land exactly ON the surface (max |sig| = {np.abs(fin).max():.3f})")
        if not on.all():
            raise AssertionError(f"{name}: every plastic path must end on the surface")
        for k in range(paths.shape[0]):
            for s in range(paths.shape[1]):
                rows.append([m, k, s, *paths[k, s]])
    np.savetxt(os.path.join(out_dir, "conic_stress_paths.csv"), np.array(rows), delimiter=",",
               header="mat,dir,step,s0,s1,s2")
    print("wrote conic_stress_paths.csv")
    return finals


if __name__ == "__main__":
    args = sys.argv[1:]
    ints = [int(a) for a in args if a.isdigit()]
    main(ints[0] if ints else 16, device="cpu" if "cpu" in args else None)
