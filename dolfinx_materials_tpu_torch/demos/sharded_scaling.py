"""The fused Newton load step over several ranks: the torch twin of the JAX
package's ``demos/sharded_scaling.py``.

The J2 plate of the JAX demo (N x N P1 quads, linear hardening, the right
edge pulled to u_x = 2 sig0 / E) through ``parallel.make_sharded_newton_step``
on a mesh of ``nproc`` ranks, one process and one device a rank
(``parallel.multiprocess``): each rank runs the constitutive update and the
element work of its block of cells, the assembled vectors are summed across
ranks. :func:`run` launches the ranks and prints the wall milliseconds per
load step and the residual.

Run: ``python -m dolfinx_materials_tpu_torch.demos.sharded_scaling NPROC [cpu]``
(NCCL, one card a rank; ``cpu``: gloo on the CPU).

Each rank runs this module's worker mode (``--worker OUT ... pid nproc
coordinator``), which also serves other plates and the blocked step:
``--hardening voce --load 3`` is the plate of the JAX package's
``tests/_mp_worker.py``, ``--blocked thermo`` the stiff thermo-mechanical
coupling of :mod:`.blocked_thermomechanics`, ``--blocked interface`` the
interface problem of :mod:`.multimaterial_interface` pulled at its right
edge. Rank 0 writes u (or z), the plastic strain p, |R|, the Newton and
Krylov counts, the step's milliseconds and every rank's kernel launches to
``OUT`` (``.npz``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

E, NU, SIG0 = 70e3, 0.3, 350.0
#: the interface problem's pull of its right edge ([blocked]'s fused step)
PULL = 1.5e-2


def plate(N, hardening="linear", load=2.0, device=None, dtype=torch.float64, banded=False):
    """The J2 plate: ``N`` x ``N`` P1 quads of the unit square, left edge
    u_x = 0, bottom u_y = 0, right edge u_x = ``load`` sig0 / E; linear
    hardening (H = 1000, the JAX demo) or Voce (500, 1e3: tests/_mp_worker.py
    and bench.py). With ``banded`` the map lists its cells, so its gathers
    and assembly take the banded route (the kernels' takes) in place of the
    structured grid's stencil. Returns ``(material, qmap, space, bcs,
    problem)``."""
    from .. import Material, NonlinearMaterialProblem, QuadratureMap
    from ..fem import DirichletBC, Function, FunctionSpace, create_unit_square, locate_dofs_geometrical
    from ..fem.forms import mandel_strain_2d
    from ..models import LinearElasticIsotropic, LinearHardening, VoceHardening, vonMisesIsotropicHardening

    law = LinearHardening(SIG0, 1000.0) if hardening == "linear" else VoceHardening(SIG0, 500.0, 1e3)
    mat = Material(vonMisesIsotropicHardening(LinearElasticIsotropic(E, NU), law), dtype=dtype, device=device)
    V = FunctionSpace(create_unit_square(N, N, "quad"), 1, (2,))
    qmap = QuadratureMap(V, 2, mat, cells=np.arange(N * N) if banded else None)
    qmap.register_gradient("Strain", mandel_strain_2d())
    left = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0), 0)
    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0), 1)
    right = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1), 0)
    bcs = [DirichletBC(left, 0.0), DirichletBC(bottom, 0.0), DirichletBC(right, load * SIG0 / E)]
    return mat, qmap, V, bcs, NonlinearMaterialProblem(qmap, Function(V), bcs=bcs)


def _launches():
    from ..ops import banded_gather as bg
    from ..ops import j2_cuda

    return {w.__name__: w.launches for w in (j2_cuda.j2_radial_return, bg.banded_take_ell, bg.banded_take_csr)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, reps):
    """``fn()``'s result from its first call, and the best wall ms of
    ``reps`` more calls (all when ``reps`` is 0: the first call's)."""
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    best = time.perf_counter() - t
    for _ in range(reps):
        _sync(device)
        t = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t)
    return out, 1e3 * best


def solve_plate(mesh, args, device):
    """One load step of the plate from u = 0 in each dof layout of
    ``args.layouts``; ``{layout_key: array}``."""
    from ..fem.bc import combine_bcs
    from ..parallel import make_sharded_newton_step

    out = {}
    for layout in args.layouts.split(","):
        mat, qmap, V, bcs, prob = plate(args.N, args.hardening, args.load, device, banded=args.banded)
        step, pad = make_sharded_newton_step(qmap, prob, mesh, axis=mesh.axis_names, n_newton=args.n_newton,
                                             n_cg=args.n_cg, shard_dofs=layout == "sharded")
        mask, vals = combine_bcs(bcs, V.num_dofs)
        st0 = pad(mat.data_manager.s0.internal)
        u0 = torch.zeros(V.num_dofs, dtype=torch.float64, device=device)
        before = _launches()
        (u, st, rn), ms = _timed(lambda: step(u0, st0, mask, vals, 0.0), device, args.reps)
        after = _launches()
        out.update({f"u_{layout}": u, f"p_{layout}": st["p"].reshape(-1), f"res_{layout}": rn.reshape(1),
                    f"res0_{layout}": step.info["res0"],
                    f"newton_{layout}": step.info["newton"], f"cg_{layout}": step.info["cg"],
                    f"ms_{layout}": ms, f"replays_{layout}": sum(g["replays"] for g in step.cg._graphs.values())})
        out.update({f"launches_{layout}_{k}": after[k] - before[k] for k in after})
    return out


def solve_blocked(mesh, args, device):
    """One fused blocked step (one call, timed): the thermo-mechanical
    coupling from its built state, or the interface problem from its
    uniform stretch."""
    from ..parallel import make_sharded_blocked_step

    if args.blocked == "thermo":
        from .. import BlockedNonlinearProblem
        from .blocked_thermomechanics import build

        heat, mech, qT, qu, coups = build(args.N, device)
        blocked = BlockedNonlinearProblem([heat, mech], coups)
        z0 = np.concatenate([heat.u.x, mech.u.x])
        opts = dict(n_newton=16, n_cg=400)
    else:
        from .multimaterial_interface import build

        b = build(args.N, args.N // 2, 2, device=device, pull=PULL)
        blocked, z0 = b["blocked"], b["start"]
        opts = dict(n_newton=12, n_cg=8000)
    step, pad = make_sharded_blocked_step(blocked, mesh, axis=mesh.axis_names, **opts)
    mask, vals = blocked._masks()
    z0 = torch.where(mask, vals, torch.as_tensor(z0, dtype=vals.dtype, device=device))
    states = pad([q.material.data_manager.s0.internal for p in blocked.problems for q in p.qmaps])
    before = _launches()
    (z, st, rn), ms = _timed(lambda: step(z0, states, mask, vals, 0.0), device, 0)
    after = _launches()
    out = {"z_blocked": z, "res_blocked": rn.reshape(1), "newton_blocked": step.info["newton"],
           "bicgstab_blocked": step.info["bicgstab"], "ms_blocked": ms}
    for i, s in enumerate(st):
        if "p" in s:
            out[f"p{i}_blocked"] = s["p"].reshape(-1)
    out.update({f"launches_blocked_{k}": after[k] - before[k] for k in after})
    return out


def worker(argv=None):
    """One rank: ``--worker OUT [options] pid nproc coordinator``."""
    import torch.distributed as dist

    from ..parallel import device_mesh
    from ..parallel import multiprocess as mp

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True, help="the .npz rank 0 writes")
    ap.add_argument("--N", type=int, default=24)
    ap.add_argument("--hardening", choices=("linear", "voce"), default="linear")
    ap.add_argument("--load", type=float, default=2.0, help="the right edge's u_x in sig0 / E")
    ap.add_argument("--layouts", default="replicated", help="the plate's dof layouts: replicated,sharded "
                    "(empty: no plate)")
    ap.add_argument("--n-newton", type=int, default=8)
    ap.add_argument("--n-cg", type=int, default=200)
    ap.add_argument("--banded", action="store_true", help="the plate's map on the banded route (plate())")
    ap.add_argument("--blocked", choices=("thermo", "interface"), default=None,
                    help="also run the blocked step on this problem (--N its size)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--reps", type=int, default=0, help="timed calls after the first")
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("coordinator")
    args = ap.parse_args(argv)
    device = mp.initialize(args.pid, args.nproc, args.coordinator, device=args.device, backend=args.backend)
    mesh = device_mesh(args.nproc)
    out = solve_plate(mesh, args, device) if args.layouts else {}
    if args.blocked:
        out.update(solve_blocked(mesh, args, device))
    counts = [None] * args.nproc
    dist.all_gather_object(counts, {k: v for k, v in out.items() if k.startswith("launches_")})
    if args.pid == 0:
        arrays = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in out.items()
                  if not k.startswith("launches_")}
        for r, c in enumerate(counts):
            arrays.update({f"rank{r}_{k}": np.asarray(v) for k, v in c.items()})
        np.savez(args.worker, **arrays)
    print(f"[{args.pid}] done on {device}", flush=True)
    mp.exit_worker()


def launch_worker(nproc, options, timeout=900.0):
    """Run ``nproc`` ranks of the worker with ``options`` (a list of
    command-line words); returns rank 0's results as a dict of arrays."""
    from ..parallel import multiprocess as mp

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.npz")
        mp.launch([sys.executable, "-m", "dolfinx_materials_tpu_torch.demos.sharded_scaling", "--worker", out]
                  + [str(o) for o in options], nproc, timeout=timeout, cwd=root)
        with np.load(out) as f:
            return dict(f)


def run(nproc, N=24, device=None, reps=3):
    """The demo: one load step of the JAX demo's plate over ``nproc`` ranks
    (``device="cpu"``: gloo on the CPU; otherwise NCCL, a card a rank),
    timed as the best of ``reps`` calls after the first. Prints ms per load
    step and |R|; returns ``dict(u, p, res, ms, newton, cg)``."""
    opts = ["--N", N, "--reps", reps, "--n-newton", 8, "--n-cg", 200]
    if device is not None:
        opts += ["--device", device]
    r = launch_worker(nproc, opts)
    res = float(r["res_replicated"][0])
    print(f"{nproc} rank(s): {float(r['ms_replicated']):8.1f} ms/load-step  (res_norm={res:.2e}, "
          f"{r['p_replicated'].size} Gauss pts, newton={int(r['newton_replicated'])} cg={int(r['cg_replicated'])})")
    return dict(u=r["u_replicated"], p=r["p_replicated"], res=res, ms=float(r["ms_replicated"]),
                newton=int(r["newton_replicated"]), cg=int(r["cg_replicated"]))


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker()
    else:
        n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
        run(n, device=sys.argv[2] if len(sys.argv) > 2 else None)
