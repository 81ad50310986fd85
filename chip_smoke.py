#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dolfinx_materials_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels of ``dolfinx_materials_tpu_torch/csrc`` with nvcc
(sm_90a) into ``build/kernels/`` and runs seven phases; any failure exits
non-zero before the result line is printed:

1. build: every kernel, with the compiler's register report;
2. J2: the two return-map kernels (full and factored tangent) against their
   plain PyTorch versions at 2^21 points (Linear, Voce, Swift, Ramberg-Osgood;
   the Pallas and j2_fast contracts; f32 and f64), and the expanded factored
   tangent against the full one;
3. banded take: the streaming and the shared-memory window kernels against the
   plain version, and against each other (bitwise), on the 128x256 P2 plate's
   cell, fm and asm plans, in f32 and f64;
4. the J2 plate slice on a 16x32 mesh, 3 load steps, on the card and on the
   CPU: displacement and plastic strain agree to 1e-8, Newton counts equal;
5. the main path at full width: the 128x256 P2 plate (294,912 Gauss points,
   263,682 dofs) through ``solve_adaptive``, counting kernel launches;
6. the material-point path at that width (the plate's last-step strains and
   state, f64): ``Material.integrate`` (fast path, full-tangent kernel) and
   the factored-tangent kernel against the generic ``vmap(jacfwd)`` update
   with implicit-function-theorem roots; then Norton viscoplasticity and a
   generalized Maxwell solid, card against CPU on a 4,096-point subset;
7. the generic path through the FEM entry points: the same plate with
   ``GeneralIsotropicHardening`` (no fast path, 7-unknown local Newton), 3
   load steps into the plastic range, each started from the uniform stretch
   (a lifted first iterate set through ``problem.u.x``, not the load stepping
   of ``solve_adaptive``), against the fast-path plate at the same steps.

Then it prints the card's name and power limit, one JSON line with every
kernel's launches, error, time and bound, and as the last line the contract
JSON ``{"ok": true, "device": {...}}``. Times are CUDA-event medians on this
card; bounds use the H100 SXM data-sheet rates in :data:`PEAK`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM data-sheet rates: HBM bytes/s, and non-tensor-core FLOP/s per dtype
PEAK = {"bytes": 3.35e12, torch.float32: 67e12, torch.float64: 34e12}

E, NU, SIG0, SIGU, B_VOCE = 70e3, 0.3, 350.0, 500.0, 1e3
LX, LY = 1.0, 2.0
#: phase 4 loads (top displacement): the third step enters the plastic range
SLICE_LOADS = (0.0025, 0.005, 0.0075)
#: phase 7 loads: the third step puts the plate's mean strain above sig0/E
GENERIC_LOADS = (0.0035, 0.007, 0.0105)
POINT_SUBSET = 4096
J2_N = 1 << 21
REPS = 20
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=REPS, warmup=3):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes, ops, dtype):
    """Least time for the work: bytes over HBM rate vs ops over peak rate."""
    t_bytes = nbytes / PEAK["bytes"] * 1e3
    t_ops = ops / PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b, scale):
    return float((a - b).abs().max()) / float(scale)


# ------------------------------------------------------------------ phase 1
def phase_build():
    from dolfinx_materials_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    for src, text in logs.items():
        log(f"[build] {src} -> {cuda_build.library_path(src)}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build]   {line.strip()}")
    log(f"[build] {len(logs)} kernels built in {time.perf_counter() - t0:.2f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[build] card: {smi}")
    return smi


# ------------------------------------------------------------------ phase 2
def j2_ops_per_point(n_iter, factored=False):
    """Floating-point operations of one point of the J2 kernels, counted from
    csrc/j2_radial_return.cu: trial state and norm ~45, each hardening
    evaluation ~10 (one exp or pow counted as one), each Newton step ~8,
    stress/state update ~30, the two tangent factors ~15, and for the full
    tangent 36 x 4 more."""
    return 45 + 10 * (n_iter + 2) + 8 * n_iter + 30 + 15 + (0 if factored else 36 * 4)


def j2_bytes(n, dtype, factored=False):
    """Inputs read once (eps, eps_p: 6 each, p: 1) and outputs written once
    (sig 6, eps_p 6, p 1, and Ct 36 or fac 2): 62 or 28 values a point."""
    return (28 if factored else 62) * n * torch.empty((), dtype=dtype).element_size()


def j2_inputs(n, seed, device):
    """Mixed elastic/plastic batch: strain amplitudes spread over 1e-4..4e-2
    (log-uniform), a prior plastic state so the warm start matters."""
    g = torch.Generator(device=device).manual_seed(seed)
    amp = torch.logspace(-4, np.log10(4e-2), n, dtype=torch.float64, device=device)
    amp = amp[torch.randperm(n, generator=g, device=device)]
    eps = torch.randn(n, 6, generator=g, dtype=torch.float64, device=device) * amp[:, None]
    eps_p = 1e-3 * torch.randn(n, 6, generator=g, dtype=torch.float64, device=device)
    eps_p[:, :3] -= eps_p[:, :3].mean(dim=1, keepdim=True)  # plastic flow is deviatoric
    p = 5e-3 * torch.rand(n, generator=g, dtype=torch.float64, device=device)
    return eps, eps_p, p


def off_yield_surface(eps, eps_p, p, el, law):
    """The tangent jumps at the yield surface (f_tr = 0), and rounding decides
    the side for points within a few ulps of it: stretch the elastic strain of
    points within 1e-4 of sigma_Y by 2 %, so both versions see the same branch."""
    from dolfinx_materials_tpu_torch.ops import tensors

    e = eps - eps_p
    s = tensors.dev(2.0 * el.mu * e)
    q = torch.sqrt(1.5 * tensors.ddot(s, s))
    Y0 = law(p)
    near = ((q - Y0).abs() < 1e-4 * Y0)[:, None]
    return torch.where(near, eps_p + 1.02 * e, eps)


def feature_major(eps, eps_p, p, dtype):
    return tuple(t.to(dtype).contiguous() for t in (eps.T, eps_p.T, p[None, :]))


def phase_j2():
    from dolfinx_materials_tpu_torch.models import (
        LinearElasticIsotropic, LinearHardening, RambergOsgoodHardening, SwiftHardening,
        VoceHardening,
    )
    from dolfinx_materials_tpu_torch.ops import j2_cuda

    el = LinearElasticIsotropic(E, NU)
    laws = {
        "linear": LinearHardening(SIG0, 2e3),
        "voce": VoceHardening(SIG0, SIGU, B_VOCE),
        "swift": SwiftHardening(SIG0, 2e-3, 0.2),
        "ramberg": RambergOsgoodHardening(SIG0, E, 2e-3, 5.0),
    }
    contracts = {"pallas": j2_cuda.PALLAS_CONTRACT, "j2_fast": j2_cuda.J2_FAST_CONTRACT}
    # tolerances: f64 to 1e-10 of each field's scale; f32 as the Pallas
    # kernel's own test (tests/test_pallas_j2.py). The tangent column holds Ct
    # for the full kernel and fac = [2 mu beta, gamma] for the factored one,
    # both on the scale of E. The expanded factored tangent against the full
    # kernel's Ct: 1e-5 E in f32, 1e-12 E in f64 (the two take nbar from the
    # trial and from the returned stress).
    tol = {
        torch.float64: dict(sig=1e-10, tangent=1e-10, state=1e-10, expand=1e-12),
        torch.float32: dict(sig=2e-4, tangent=5e-4, state=1e-6, expand=1e-5),
    }
    kernels = {
        "full": (j2_cuda.j2_radial_return, j2_cuda.j2_radial_return_reference),
        "factored": (j2_cuda.j2_radial_return_factored, j2_cuda.j2_radial_return_factored_reference),
    }
    log(f"[j2] {J2_N} points, feature-major; times are medians of {REPS} CUDA-event reps")
    worst = {"full": 0.0, "factored": 0.0}
    base = j2_inputs(J2_N, 0, DEVICE)
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        for lname, law in laws.items():
            eps, eps_p, p = feature_major(off_yield_surface(*base, el, law), base[1], base[2], dtype)
            for cname, c in contracts.items():
                outs = {}
                for kname, (kernel, plain) in kernels.items():
                    factored = kname == "factored"
                    out = outs[kname] = kernel(eps, eps_p, p, el, law, **c)
                    ref = plain(eps, eps_p, p, el, law, **c)
                    torch.cuda.synchronize()
                    errs = dict(
                        sig=rel_err(out[0], ref[0], ref[0].abs().max()),
                        tangent=rel_err(out[1], ref[1], E),
                        # f64: relative to each state field's own scale; f32: absolute
                        state=max(rel_err(o, r, r.abs().max() if f64 else 1.0)
                                  for o, r in zip(out[2:], ref[2:])),
                    )
                    if factored:
                        Ct = j2_cuda.expand_factored_tangent(el, out[0], out[1])
                        errs["expand"] = rel_err(Ct, outs["full"][1], E)
                        del Ct
                    plastic = float((ref[3] > p).double().mean())
                    ok = all(errs[k] <= tol[dtype][k] for k in errs) and plastic >= 0.2  # the batch must mix elastic and plastic points
                    if f64:
                        worst[kname] = max(worst[kname],
                                           max(float((o - r).abs().max()) for o, r in zip(out, ref)))
                    del ref
                    t_k = cuda_ms(lambda: kernel(eps, eps_p, p, el, law, **c))
                    t_p = cuda_ms(lambda: plain(eps, eps_p, p, el, law, **c), reps=5)
                    bnd, by = bound_ms(j2_bytes(J2_N, dtype, factored),
                                       j2_ops_per_point(c["n_iter"], factored) * J2_N, dtype)
                    log(
                        f"[j2] {kname:8s} {str(dtype)[6:]:8s} {lname:7s} {cname:8s} plastic={plastic:.3f} err "
                        + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                        + f" kernel_ms={t_k:.4f} bound_ms={bnd:.4f} ({by}) plain_ms={t_p:.3f} "
                        f"{'ok' if ok else 'FAIL'}"
                    )
                    if not ok:
                        raise AssertionError(
                            f"J2 {kname} kernel disagrees with its plain version: {dtype} {lname} {cname}")
    return worst


# ------------------------------------------------------------------ phase 3
def take_bytes(plan, table, windowed):
    """Inputs read once (table, the plan's int32 base/row/lane arrays, nq for
    the window kernel, the int64 patch lists) and the output written once."""
    b = table.numel() * table.element_size() + plan.n_out * table.element_size()
    for t in (plan.base8, plan.rloc, plan.cloc) + ((plan.nq,) if windowed else ()):
        b += t.numel() * t.element_size()
    for pos, idx in plan.patch_layers:
        b += (pos.numel() + idx.numel()) * 8 + pos.numel() * 2 * table.element_size()
    return b


def take_ops(plan):
    """One add per kept (slot, layer) entry and per patch."""
    return int((plan.rloc >= 0).sum()) + sum(len(pos) for pos, _ in plan.patch_layers)


def take_matrix(plan, dtype):
    """The take as a CSR matrix S (n_out, n_src) of ones, out = S @ table:
    the one-call PyTorch yardstick (cuSPARSE SpMV); never used by the port."""
    from dolfinx_materials_tpu_torch.ops.banded_gather import LANE

    rl = plan.rloc.reshape(plan.ns, plan.K, plan.C).long()
    cl = plan.cloc.reshape(plan.ns, plan.K, plan.C).long()
    col = (plan.base8[:, :, None].long() * plan.sub + rl) * LANE + cl
    row = (torch.arange(plan.ns * plan.C, device=rl.device).reshape(plan.ns, 1, plan.C)
           .expand(plan.ns, plan.K, plan.C))
    keep = (rl >= 0) & (row < plan.n_out)
    rows = torch.cat([row[keep], plan.patch_pos])
    cols = torch.cat([col[keep], plan.patch_idx])
    S = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), torch.ones(len(rows), dtype=dtype, device=rows.device),
        (plan.n_out, plan.n_src),
    ).coalesce()
    return S.to_sparse_csr()


def phase_take(nx):
    from dolfinx_materials_tpu_torch import fem
    from dolfinx_materials_tpu_torch.fem.assembly import QuadratureDomain
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg

    t0 = time.perf_counter()
    mesh = fem.create_rectangle((0.0, 0.0), (LX, LY), (nx, 2 * nx), "quad")
    V = fem.FunctionSpace(mesh, degree=2, shape=(2,))
    dom = QuadratureDomain(V, 4, device=DEVICE)
    if dom._banded is None or dom._banded.get("fm") is None:
        raise AssertionError("the plate did not get its cell, fm and asm plans")
    log(f"[take] {nx}x{2 * nx} P2 plate: plans in {time.perf_counter() - t0:.2f}s")
    tol = {torch.float32: 1e-6, torch.float64: 1e-13}
    g = torch.Generator(device=DEVICE).manual_seed(1)
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for key, plan in dom._banded.items():
            table = torch.randn(plan.n_src, generator=g, dtype=torch.float64, device=DEVICE).to(dtype)
            chosen = bg._best_take(plan, dtype).__name__
            a = bg.banded_take_streaming(table, plan)
            b = bg.banded_take_windowed(table, plan)
            ref = bg.banded_take_reference(table, plan)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            e_s, e_w = rel_err(a, ref, scale), rel_err(b, ref, scale)
            bitwise = torch.equal(a, b)
            S = take_matrix(plan, dtype)
            e_lib = rel_err(S @ table, ref, scale)
            ok = bitwise and e_s <= tol[dtype] and e_w <= tol[dtype] and e_lib <= tol[dtype]
            t_s = cuda_ms(lambda: bg.banded_take_streaming(table, plan))
            t_w = cuda_ms(lambda: bg.banded_take_windowed(table, plan))
            t_p = cuda_ms(lambda: bg.banded_take_reference(table, plan))
            t_l = cuda_ms(lambda: S @ table)
            b_s = bound_ms(take_bytes(plan, table, False), take_ops(plan), dtype)[0]
            b_w = bound_ms(take_bytes(plan, table, True), take_ops(plan), dtype)[0]
            log(
                f"[take] {str(dtype)[6:]:8s} {key:4s} R={plan.R} K={plan.K} C={plan.C} "
                f"max_nq={plan.max_nq} patches={len(plan.patch_pos)} chosen={chosen} "
                f"bitwise={bitwise} err stream={e_s:.1e} window={e_w:.1e} csr={e_lib:.1e} "
                f"stream_ms={t_s:.4f} (bound {b_s:.4f}) window_ms={t_w:.4f} (bound {b_w:.4f}) "
                f"plain_ms={t_p:.4f} csr_spmv_ms={t_l:.4f} {'ok' if ok else 'FAIL'}"
            )
            if not ok:
                raise AssertionError(f"banded take disagrees: {dtype} {key}")
            rows[(dtype, key)] = dict(
                err_s=float((a - ref).abs().max()), err_w=float((b - ref).abs().max()),
                t_s=t_s, t_w=t_w, t_p=t_p, t_l=t_l, b_s=b_s, b_w=b_w,
            )
    return rows


# ------------------------------------------------------------ phases 4 and 5
def build_plate(nx, device, general=False):
    """The plane-strain J2 plate of demos/plane_elastoplasticity.py: bottom
    clamped, top pulled in y; P2 quads, degree-4 quadrature, f64. With
    ``general`` the same von Mises law as ``GeneralIsotropicHardening``, which
    has no whole-batch fast path and goes through the generic update."""
    import dolfinx_materials_tpu_torch as dm
    from dolfinx_materials_tpu_torch import fem
    from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d
    from dolfinx_materials_tpu_torch.models import (
        GeneralIsotropicHardening, LinearElasticIsotropic, VoceHardening, vonMisesIsotropicHardening,
    )

    mesh = fem.create_rectangle((0.0, 0.0), (LX, LY), (nx, 2 * nx), "quad")
    V = fem.FunctionSpace(mesh, degree=2, shape=(2,))
    law = GeneralIsotropicHardening if general else vonMisesIsotropicHardening
    material = dm.Material(
        law(LinearElasticIsotropic(E, NU), VoceHardening(SIG0, SIGU, B_VOCE)), device=device
    )
    qmap = dm.QuadratureMap(V, 4, material)
    qmap.register_gradient("Strain", mandel_strain_2d())
    bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0))
    top_y = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], LY), 1)
    bc_top = fem.DirichletBC(top_y, 0.0)
    u = fem.Function(V)
    problem = dm.NonlinearMaterialProblem(qmap, u, bcs=[fem.DirichletBC(bottom, 0.0), bc_top])
    return problem, qmap, bc_top, top_y


def run_slice_steps(nx, device):
    problem, qmap, bc_top, _ = build_plate(nx, device)
    newton = []
    for uy in SLICE_LOADS:
        bc_top.set(uy)
        converged, its = problem.solve()
        if not converged:
            raise AssertionError(f"slice on {device}: load {uy} did not converge")
        newton.append(its)
    p = qmap.field_array("p").reshape(-1).cpu()
    return torch.as_tensor(problem.u.x), p, newton


def phase_slice_cpu_vs_card():
    t0 = time.perf_counter()
    u_c, p_c, n_c = run_slice_steps(16, DEVICE)
    t1 = time.perf_counter()
    u_h, p_h, n_h = run_slice_steps(16, "cpu")
    t2 = time.perf_counter()
    e_u = rel_err(u_c, u_h, u_h.abs().max())
    e_p = rel_err(p_c, p_h, p_h.abs().max())
    ok = e_u <= 1e-8 and e_p <= 1e-8 and n_c == n_h and float(p_h.max()) > 0
    log(
        f"[slice16] card {t1 - t0:.2f}s newton={n_c} | cpu {t2 - t1:.2f}s newton={n_h} | "
        f"u rel err {e_u:.2e} p rel err {e_p:.2e} p max {float(p_h.max()):.3e} "
        f"{'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError("16x32 slice: card and CPU runs disagree")


def reset_counts():
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg
    from dolfinx_materials_tpu_torch.ops import j2_cuda

    for fn in (j2_cuda.j2_radial_return, j2_cuda.j2_radial_return_factored,
               bg.banded_take_streaming, bg.banded_take_windowed):
        fn.launches = 0


def read_counts():
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg
    from dolfinx_materials_tpu_torch.ops import j2_cuda

    return {
        "j2_radial_return": j2_cuda.j2_radial_return.launches,
        "j2_radial_return_factored": j2_cuda.j2_radial_return_factored.launches,
        "banded_take_streaming": bg.banded_take_streaming.launches,
        "banded_take_windowed": bg.banded_take_windowed.launches,
    }


def phase_main(nx, nsteps0=6):
    """The main path: solve_adaptive on the full-width plate up to
    u_y = 2 sig0/E L_y. Returns the launch counts and the last constitutive
    inputs (for timing the J2 kernel on main-path data)."""
    import dolfinx_materials_tpu_torch as dm
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg
    from dolfinx_materials_tpu_torch.utils.timers import reset_timings, timing

    t0 = time.perf_counter()
    problem, qmap, bc_top, top_y = build_plate(nx, DEVICE)
    dom = qmap.domain
    chosen = {k: bg._best_take(p, torch.float64).__name__ for k, p in dom._banded.items()}
    log(
        f"[main] {nx}x{2 * nx} P2 plate: {qmap.num_points} Gauss points, "
        f"{problem.u.space.num_dofs} dofs, set-up {time.perf_counter() - t0:.2f}s, takes {chosen}"
    )
    reactions, records, last = [], [], {}
    solve = problem.solve

    def solve_and_record():
        t = time.perf_counter()
        s0 = dict(qmap.material.data_manager.s0.internal)
        converged, its = solve()
        torch.cuda.synchronize()
        m = problem.metrics
        records.append((float(bc_top.value), converged, sum(m["cg_iterations"])))
        log(
            f"[main] u_y={float(bc_top.value):.6g} converged={converged} newton={its} "
            f"cg={sum(m['cg_iterations'])} ({m['cg_iterations']}) wall_s={time.perf_counter() - t:.3f}"
        )
        if converged:
            R = problem._residual(torch.as_tensor(problem.u.x, device=DEVICE))
            reactions.append(float(R[torch.as_tensor(top_y, device=DEVICE)].sum()))
            last["state"] = s0
        return converged, its

    problem.solve = solve_and_record
    t_end = 2.0 * SIG0 / E * LY
    reset_timings()
    reset_counts()
    t1 = time.perf_counter()
    accepted = dm.solve_adaptive(problem, bc_top.set, t_end, nsteps0=nsteps0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    p = qmap.field_array("p").reshape(-1)
    plastic = float((p > 0).double().mean())
    rising = all(b > a for a, b in zip(reactions, reactions[1:]))
    cutbacks = sum(1 for _, c, _ in records if not c)
    log(
        f"[main] {len(accepted)} steps accepted, {cutbacks} cut back, reached u_y="
        f"{accepted[-1]:.6g} of {t_end:.6g} in {wall:.2f}s; p max {float(p.max()):.4e}, "
        f"plastic share {plastic:.3f}, reactions {['%.6g' % r for r in reactions]}"
    )
    log(f"[main] launches {counts}")
    newton_s = timing("solver: Newton solve")[1]
    split = {k: timing(f"solver: {k}")[1] for k in ("constitutive update", "jacobian assembly", "linear solve")}
    split["residual and line search"] = newton_s - sum(split.values())
    n_cg = sum(r[2] for r in records)
    log("[main] time split: " + ", ".join(f"{k} {v:.2f}s ({100 * v / newton_s:.1f}%)" for k, v in split.items())
        + f"; {n_cg} CG iterations, {1e3 * split['linear solve'] / max(n_cg, 1):.3f} ms each")
    ok = (
        abs(accepted[-1] - t_end) <= 1e-12 * t_end
        and float(p.max()) > 0 and plastic > 0.5 and rising
        and counts["j2_radial_return"] > 0
        and all(counts[name] > 0 for name in set(chosen.values()))
    )
    if not ok:
        raise AssertionError("main path: load program, plasticity, reactions or launch counts wrong")
    # the last step's constitutive inputs: final strain, state before the step
    gradients = qmap._gradient_values(torch.as_tensor(problem.u.x, device=DEVICE))
    return counts, gradients, last["state"], qmap.material.behavior


def time_j2_main(gradients, state, behavior, factored=False):
    """One J2 kernel on the given strains and the main path's last-step state
    (point-major, f64, j2_fast contract): held against its plain version on
    those inputs, then timed on them. Call it outside the counted runs: its
    launches are comparisons and timings, not a path's."""
    from dolfinx_materials_tpu_torch.ops import j2_cuda

    kernel, plain = (
        (j2_cuda.j2_radial_return_factored, j2_cuda.j2_radial_return_factored_reference)
        if factored else (j2_cuda.j2_radial_return, j2_cuda.j2_radial_return_reference)
    )
    el, law = behavior.elasticity, behavior.yield_stress
    args = (gradients.contiguous(), state["eps_p"].contiguous(), state["p"].contiguous(), el, law)
    kw = dict(j2_cuda.J2_FAST_CONTRACT, feature_major=False)
    out = kernel(*args, **kw)
    ref = plain(*args, **kw)
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    scale = float(ref[0].abs().max())
    if rel_err(out[0], ref[0], scale) > 1e-10 or rel_err(out[1], ref[1], E) > 1e-10:
        raise AssertionError("J2 kernel disagrees with its plain version on main-path inputs")
    n = gradients.shape[0]
    t_k = cuda_ms(lambda: kernel(*args, **kw))
    t_p = cuda_ms(lambda: plain(*args, **kw), reps=5)
    bnd, by = bound_ms(j2_bytes(n, torch.float64, factored),
                       j2_ops_per_point(kw["n_iter"], factored) * n, torch.float64)
    log(f"[j2-main] {'factored' if factored else 'full':8s} {n} points f64 point-major: kernel_ms={t_k:.4f} "
        f"bound_ms={bnd:.4f} ({by}) plain_ms={t_p:.3f} max_abs_err={err:.2e}")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by, max_abs_err=err)


# ------------------------------------------------------------------ phase 6
def seconds_per_call(fn, reps=3):
    """Median host seconds of ``fn()`` ending in a device synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times))


def phase_point(gradients, state, behavior):
    """The material-point path at the plate's width: strains and state in,
    stress, state and tangent out, no mesh. Returns the launch counts of the
    path, the seconds per update of each route and the strains it ran on."""
    import dolfinx_materials_tpu_torch as dm
    from dolfinx_materials_tpu_torch.models import (
        GeneralizedMaxwell, LinearElasticIsotropic, LinearHardening, NortonViscoplasticity,
    )
    from dolfinx_materials_tpu_torch.ops import j2_cuda

    el, law = behavior.elasticity, behavior.yield_stress
    eps_p, p = state["eps_p"].contiguous(), state["p"].contiguous()
    eps = off_yield_surface(gradients, eps_p, p, el, law).contiguous()
    n = eps.shape[0]
    mat = dm.Material(behavior, device=DEVICE)
    mat.set_data_manager(n)
    mat.set_initial_state_dict({"eps_p": eps_p, "p": p})
    s0 = mat.data_manager.s0.internal

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sig_f, isv_f, Ct_f = mat.integrate(eps)  # fast path: the full-tangent kernel
    sig_k, fac, epsp_k, p_k = j2_cuda.j2_radial_return_factored(  # the factored-tangent kernel
        eps, eps_p, p, el, law, feature_major=False, **j2_cuda.J2_FAST_CONTRACT)
    sig_g, Ct_g, st_g = mat.batched_constitutive_update(eps, {}, s0, 0.0)  # generic IFT path
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # fast path against generic path: the bars of tests/test_j2_fast.py
    scale = float(sig_g.abs().max())
    s1 = mat.data_manager.s1
    errs = dict(
        sig=rel_err(sig_f, sig_g, scale), Ct=rel_err(Ct_f, Ct_g, E),
        p=float((s1["p"].reshape(-1) - st_g["p"]).abs().max()),
        eps_p=float((s1["eps_p"] - st_g["eps_p"]).abs().max()),
        # factored kernel: same stress and state as the full one, and its
        # expansion is the full tangent (1e-12 E in f64)
        k2_sig=rel_err(sig_k, sig_f, scale), k2_p=float((p_k - s1["p"].reshape(-1)).abs().max()),
        k2_expand=rel_err(j2_cuda.expand_factored_tangent(el, sig_k, fac, feature_major=False), Ct_f, E),
    )
    bars = dict(sig=1e-8, Ct=1e-7, p=1e-12, eps_p=1e-12, k2_sig=1e-13, k2_p=1e-14, k2_expand=1e-12)
    plastic = float((st_g["p"] > p).double().mean())
    ok = all(errs[k] <= bars[k] for k in bars) and plastic > 0.05
    t_fast = seconds_per_call(lambda: mat.integrate(eps))
    t_gen = seconds_per_call(lambda: mat.batched_constitutive_update(eps, {}, s0, 0.0))
    t_flux = seconds_per_call(lambda: mat.batched_flux_update(eps, {}, s0, 0.0))
    log(f"[point] {n} points f64, von Mises + Voce, plastic share {plastic:.3f}: fast path against generic "
        + " ".join(f"{k}={v:.2e}" for k, v in errs.items()) + f" {'ok' if ok else 'FAIL'}")
    log(f"[point] seconds per update: Material.integrate (fast path) {t_fast:.5f}, generic vmap(jacfwd) "
        f"{t_gen:.4f} ({t_gen / t_fast:.0f}x), generic flux-only {t_flux:.4f}; peak device memory "
        f"{peak_gib:.2f} GiB; launches {counts}")
    if not ok:
        raise AssertionError("material-point path: fast path, factored kernel and generic path disagree")

    # behaviors with no fast path, at full width; card against CPU on a subset
    others = {
        "norton": (NortonViscoplasticity(LinearElasticIsotropic(E, NU), LinearHardening(100.0, 1e3),
                                         K=150.0, n=3.0), {"eps_p": eps_p, "p": p}, 0.05),
        "maxwell": (GeneralizedMaxwell(50e3, 10e3, [(20e3, 0.5), (8e3, 5.0), (3e3, 50.0)]),
                    {"epsv": torch.stack([0.5 * eps_p, 0.25 * eps_p, -0.5 * eps_p], dim=1)}, 0.3),
    }
    seconds = {"fast": t_fast, "generic": t_gen, "generic_flux": t_flux}
    sub = torch.arange(0, n, n // POINT_SUBSET, device=DEVICE)[:POINT_SUBSET]
    for name, (beh, st, dt) in others.items():
        full = dm.Material(beh, device=DEVICE)
        full.set_data_manager(n)
        full.set_initial_state_dict(st)
        flux, isv, Ct = full.integrate(eps, dt)
        finite = bool(torch.isfinite(flux).all() and torch.isfinite(Ct).all() and torch.isfinite(isv).all())
        seconds[name] = seconds_per_call(lambda: full.integrate(eps, dt))
        outs = {}
        for dev in (DEVICE, "cpu"):
            m = dm.Material(beh, device=dev)
            m.set_data_manager(POINT_SUBSET)
            m.set_initial_state_dict({k: v[sub].to(dev) for k, v in st.items()})
            outs[dev] = [t.cpu() for t in m.integrate(eps[sub].to(dev), dt)]
        # card against CPU: 1e-10 of each array's scale (same code, other sums)
        e = [rel_err(a, b, b.abs().max()) for a, b in zip(outs[DEVICE], outs["cpu"])]
        ok = finite and max(e) <= 1e-10
        log(f"[point] {name}: integrate at {n} points {seconds[name]:.4f} s per update, dt={dt}; "
            f"{POINT_SUBSET}-point subset card against CPU: flux {e[0]:.2e} isv {e[1]:.2e} tangent {e[2]:.2e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"material-point path: {name} disagrees between card and CPU")
    if counts["j2_radial_return"] < 1 or counts["j2_radial_return_factored"] < 1:
        raise AssertionError("material-point path did not launch both J2 kernels")
    return counts, seconds, eps


# ------------------------------------------------------------------ phase 7
def run_generic_steps(nx, general):
    from dolfinx_materials_tpu_torch.utils.timers import reset_timings, timing

    problem, qmap, bc_top, _ = build_plate(nx, DEVICE, general=general)
    reset_timings()
    torch.cuda.reset_peak_memory_stats()
    newton, cg_its = [], []
    t0 = time.perf_counter()
    y = np.asarray(problem.u.space.node_coords)[:, 1]
    for uy in GENERIC_LOADS:
        bc_top.set(uy)
        # start Newton from the uniform stretch u_y = uy y / L_y: from the last
        # displacement with the new boundary value imposed, the whole increment
        # sits in the top row of cells and steps of this size fail (PERF.md 7)
        lifted = np.asarray(problem.u.x).reshape(-1, 2).copy()
        lifted[:, 1] = uy * y / LY
        problem.u.x = lifted.reshape(-1)
        converged, its = problem.solve()
        if not converged:
            raise AssertionError(f"generic phase (general={general}): load {uy} did not converge")
        newton.append(its)
        cg_its.append(sum(problem.metrics["cg_iterations"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    newton_s = timing("solver: Newton solve")[1]
    split = {k: timing(f"solver: {k}")[1] for k in ("constitutive update", "jacobian assembly", "linear solve")}
    split["residual and line search"] = newton_s - sum(split.values())
    return dict(u=torch.as_tensor(problem.u.x), p=qmap.field_array("p").reshape(-1).cpu(),
                newton=newton, cg=cg_its, wall=wall, split=split, newton_s=newton_s,
                updates=timing("solver: constitutive update")[0],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def phase_generic(nx):
    """The generic constitutive path through QuadratureMap.update and
    NonlinearMaterialProblem.solve (CG + two-level) at the main path's width,
    against the fast-path plate at the same load steps."""
    reset_counts()
    gen = run_generic_steps(nx, general=True)
    counts = read_counts()
    fast = run_generic_steps(nx, general=False)
    # both plates solve the same steps to the same Newton tolerance (1e-10 of
    # the first residual) with CG at 1e-12, from tangents that agree to 1e-7 E:
    # the converged u and p agree far inside 1e-6 of their scale
    e_u = rel_err(gen["u"], fast["u"], fast["u"].abs().max())
    e_p = rel_err(gen["p"], fast["p"], fast["p"].abs().max())
    plastic = float((fast["p"] > 0).double().mean())
    ok = e_u <= 1e-6 and e_p <= 1e-6 and plastic > 0.01
    for name, r in (("generic", gen), ("fast", fast)):
        log(f"[generic] {name:7s} {nx}x{2 * nx}: loads {GENERIC_LOADS} (lifted starts) newton={r['newton']} cg={r['cg']} "
            f"wall_s={r['wall']:.2f}; " + ", ".join(
                f"{k} {v:.2f}s ({100 * v / r['newton_s']:.1f}%)" for k, v in r["split"].items())
            + f"; {r['updates']} full constitutive updates (gradients + material integration), "
            f"{r['split']['constitutive update'] / r['updates']:.4f} s each; peak device memory "
            f"{r['peak_gib']:.2f} GiB")
    log(f"[generic] generic against fast-path plate: u rel err {e_u:.2e} p rel err {e_p:.2e} "
        f"p max {float(fast['p'].max()):.3e} plastic share {plastic:.3f} launches {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("generic path through the FEM entry points disagrees with the fast-path plate")
    if counts["j2_radial_return"] or counts["j2_radial_return_factored"]:
        raise AssertionError("the generic plate must not launch a J2 kernel")
    return gen, fast


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 1
    import dolfinx_materials_tpu_torch  # noqa: F401  (fails outside the repository)

    nx_full = 128
    t0 = time.perf_counter()
    smi = phase_build()
    f64 = torch.float64
    j2_worst = phase_j2()
    takes = phase_take(nx_full)
    phase_slice_cpu_vs_card()
    counts, grads, state, behavior = phase_main(nx_full)
    k1 = time_j2_main(grads, state, behavior)
    # the factored kernel's path is the material-point one: no FEM path
    # launches it (the JAX package has no element-matrix consumer of it). It
    # is held against its plain version and timed on the strains that its
    # counted launch in [point] ran on
    point_counts, _, eps_point = phase_point(grads, state, behavior)
    k2 = time_j2_main(eps_point, state, behavior, factored=True)
    phase_generic(nx_full)
    log(f"[total] {time.perf_counter() - t0:.1f}s")

    keys = ("cell", "fm", "asm")

    def take_row(name, kind, replaces):
        s = "s" if kind == "stream" else "w"
        return {
            "name": name, "route": "cuda",
            "source": "dolfinx_materials_tpu_torch/csrc/banded_take.cu",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(takes[(f64, k)][f"err_{s}"] for k in keys),
            # one take of each of the slice's three plans, f64
            "ms": sum(takes[(f64, k)][f"t_{s}"] for k in keys),
            "plain_ms": sum(takes[(f64, k)]["t_p"] for k in keys),
            "bound_ms": sum(takes[(f64, k)][f"b_{s}"] for k in keys),
            "bound_by": "bytes",
            "library_ms": sum(takes[(f64, k)]["t_l"] for k in keys),
        }

    def j2_row(name, replaces, launches, timed, worst):
        return {
            "name": name, "route": "cuda",
            "source": "dolfinx_materials_tpu_torch/csrc/j2_radial_return.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(timed["max_abs_err"], worst),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "library_ms": None,
        }

    kernels = [
        j2_row("j2_radial_return", "dolfinx_materials_tpu/ops/pallas_j2.py:103",
               counts["j2_radial_return"], k1, j2_worst["full"]),
        j2_row("j2_radial_return_factored", "dolfinx_materials_tpu/ops/pallas_j2.py:196",
               point_counts["j2_radial_return_factored"], k2, j2_worst["factored"]),
        take_row("banded_take_streaming", "stream", "dolfinx_materials_tpu/ops/banded_gather.py:188"),
        take_row("banded_take_windowed", "window", "dolfinx_materials_tpu/ops/banded_gather.py:268"),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
