#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dolfinx_materials_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels of ``dolfinx_materials_tpu_torch/csrc`` with nvcc
(sm_90a) into ``build/kernels/`` and runs nine phases; any failure exits
non-zero before the result line is printed:

1. build: every kernel, with the compiler's register report per template
   instantiation;
2. J2: the two return-map kernels (full and factored tangent) against their
   plain PyTorch versions at 2^21 points, feature- and point-major (Linear,
   Voce, Swift, Ramberg-Osgood; the Pallas and j2_fast contracts; f32 and
   f64), the two layouts bitwise against each other, the expanded factored
   tangent against the full one, each row timed per call, on the device and
   on the host; then 1 to 4,099 points on arrays that start one element into
   their storage (the tail and alignment routes);
3. banded take: the ELL and CSR gather kernels against the plain version,
   and bitwise against each other and their own plain version, on the
   128x256 P2 plate's cell, fm and asm plans and a 64x128 triangle plate's
   assembly plan with overflow patches, in f32 and f64; each timed per call,
   on the device (a CUDA graph of back-to-back takes) and on the host;
4. the J2 plate slice on a 16x32 mesh, 3 load steps, on the card and on the
   CPU: displacement and plastic strain agree to 1e-8, Newton counts equal;
5. the main path at full width: the 128x256 P2 plate (294,912 Gauss points,
   263,682 dofs) through ``solve_adaptive``, counting kernel launches; then
   CG on the plate's last tangent for a fixed number of iterations: wall ms
   per iteration, and the device time and busy share from torch.profiler;
6. the material-point path at that width (the plate's last-step strains and
   state, f64): ``Material.integrate`` (fast path, full-tangent kernel) and
   the factored-tangent kernel against the generic ``vmap(jacfwd)`` update
   with implicit-function-theorem roots; then Norton viscoplasticity and a
   generalized Maxwell solid, card against CPU on a 4,096-point subset;
7. the generic path through the FEM entry points: the same plate with
   ``GeneralIsotropicHardening`` (no fast path, 7-unknown local Newton), 3
   load steps into the plastic range, each started from the uniform stretch
   (a lifted first iterate set through ``problem.u.x``, not the load stepping
   of ``solve_adaptive``), against the fast-path plate at the same steps;
8. the fused load step (``parallel.make_sharded_newton_step``) in bench.py's
   configuration, a 64x64 P1 plate, 6 Newton x 30 CG, two-level, in f32 and
   f64: best of 4 calls, counts and K1 launches; the f64 card run against
   the CPU port's (u to 1e-8, equal counts);
9. the main path's plate through the fused step
   (``make_sharded_newton_step_general``), the three loads of phase 7: Newton
   and CG counts, wall seconds, residuals and K1/K3/K4 launches per step,
   u and p against phase 7's host-path plate to 1e-6, wall ms per CG
   iteration and the device-busy share of a step; a mixed-precision step
   (f32 warmup, f64 polish, f32 launches); one Newton update with the CG
   loop replayed as a CUDA graph and run eagerly, bitwise equal; the plate's
   coarse matrix built twice by the fixed-order sum, bitwise equal (and the
   atomic ``index_add_`` twice, for comparison).

Then it prints the card's name and power limit, one JSON line with every
kernel's launches, error, time and bound, and as the last line the contract
JSON ``{"ok": true, "device": {...}}``; a kernel's ``launches`` there add up
its counted paths (``launches_by_path``). Times are CUDA-event medians on this
card (``ms`` one call, ``device_ms`` per call of a replayed CUDA graph) and
host microseconds per un-synchronised call (``host_us``); bounds use the
H100 SXM data-sheet rates in :data:`PEAK`.
"""

from __future__ import annotations

import json
import re
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
J2_RAGGED = (1, 31, 129, 4099)  # point counts of the tail and alignment check
J2_GRAPH = 10  # J2 calls captured in one CUDA graph for a device time
J2_HOST = 200  # un-synchronised J2 calls for a host time
REPS = 20
TAKE_GRAPH = 50  # takes captured in one CUDA graph for a device time
TAKE_HOST = 1000  # un-synchronised takes for a host time
CG_ITERS = 500  # fixed CG iterations (tolerance 0) per timed solve
CG_REPS = 3
CG_PROFILED = 100  # CG iterations under torch.profiler for the device time
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
def kernel_name(mangled):
    """A readable name for the ptxas report of this repository's kernel
    templates (their mangled template arguments); others as mangled."""
    dt = {"f": "f32", "d": "f64"}
    m = re.search(r"j2_radial_return_kernelI([fd])Lb([01])ELb([01])E", mangled)
    if m:
        form = "factored" if m.group(2) == "1" else "full"
        layout = "feature-major" if m.group(3) == "1" else "point-major"
        return f"j2_radial_return_kernel<{dt[m.group(1)]}, {form}, {layout}>"
    m = re.search(r"compact_take_kernelI([fd])Lb([01])E", mangled)
    if m:
        return f"compact_take_kernel<{dt[m.group(1)]}, {'ell' if m.group(2) == '1' else 'csr'}>"
    return mangled


def phase_build():
    from dolfinx_materials_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    for src, text in logs.items():
        log(f"[build] {src} -> {cuda_build.library_path(src)}")
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                log(f"[build]   {kernel_name(entry.group(1))}")
            elif "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build]     {line.strip()}")
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


def point_major(eps, eps_p, p, dtype):
    return tuple(t.to(dtype).contiguous() for t in (eps, eps_p, p))


def at_offset(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    storage (one element: a data pointer off the 16-byte grid)."""
    out = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:].view(t.shape)
    return out.copy_(t)


def as_point_major(out):
    """A feature-major kernel result in the point-major layout (views)."""
    return out[0].T, out[1].T, out[2].T, out[3][0]


#: J2 tolerances: f64 to 1e-10 of each field's scale; f32 as the Pallas
#: kernel's own test (tests/test_pallas_j2.py). The tangent column holds Ct
#: for the full kernel and fac = [2 mu beta, gamma] for the factored one,
#: both on the scale of E. The expanded factored tangent against the full
#: kernel's Ct: 1e-5 E in f32, 1e-12 E in f64 (the two take nbar from the
#: trial and from the returned stress).
J2_TOL = {
    torch.float64: dict(sig=1e-10, tangent=1e-10, state=1e-10, expand=1e-12),
    torch.float32: dict(sig=2e-4, tangent=5e-4, state=1e-6, expand=1e-5),
}


def j2_errors(out, ref, dtype):
    """Errors of a J2 kernel's outputs against its plain version's, on the
    scales of :data:`J2_TOL`."""
    f64 = dtype == torch.float64
    return dict(
        sig=rel_err(out[0], ref[0], ref[0].abs().max()),
        tangent=rel_err(out[1], ref[1], E),
        # f64: relative to each state field's own scale; f32: absolute
        state=max(rel_err(o, r, r.abs().max() if f64 else 1.0) for o, r in zip(out[2:], ref[2:])),
    )


def phase_j2():
    """Both J2 kernels in both layouts against their plain versions at 2^21
    points (four laws, two contracts, f32 and f64), the layouts bitwise
    against each other, each row timed per call, on the device and on the
    host; then the ragged and misaligned sizes. Returns the worst f64 error
    of each kernel."""
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
    log(f"[j2] {J2_N} points, feature- and point-major; call_ms: CUDA events around one call (median of "
        f"{REPS}); device_ms: {J2_GRAPH} calls in one CUDA graph; host_us: {J2_HOST} un-synchronised calls; "
        "bitwise: point-major outputs equal to the feature-major ones")
    worst = {"full": 0.0, "factored": 0.0}
    base = j2_inputs(J2_N, 0, DEVICE)
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        for lname, law in laws.items():
            eps = off_yield_surface(*base, el, law)
            layouts = {"feature": feature_major(eps, base[1], base[2], dtype),
                       "point": point_major(eps, base[1], base[2], dtype)}
            del eps
            for cname, c in contracts.items():
                full_ct = {}
                for kname in ("full", "factored"):
                    factored = kname == "factored"
                    launch = j2_cuda.J2Launch(el, law, factored=factored, **c)
                    outs = {}
                    for layout, args in layouts.items():
                        fm = layout == "feature"
                        out = outs[layout] = launch(*args, feature_major=fm)
                        ref = launch.plain(*args, el, law, feature_major=fm, **c)
                        torch.cuda.synchronize()
                        errs = j2_errors(out, ref, dtype)
                        if factored:
                            Ct = j2_cuda.expand_factored_tangent(el, out[0], out[1], feature_major=fm)
                            errs["expand"] = rel_err(Ct, full_ct.pop(layout), E)
                            del Ct
                        else:
                            full_ct[layout] = out[1]
                        plastic = float((ref[3] > args[2]).double().mean())
                        if f64:
                            worst[kname] = max(worst[kname],
                                               max(float((o - r).abs().max()) for o, r in zip(out, ref)))
                        del ref
                        bitwise = layout == "feature" or all(
                            torch.equal(a, b) for a, b in zip(out, as_point_major(outs["feature"])))
                        # the batch must mix elastic and plastic points
                        ok = all(errs[k] <= J2_TOL[dtype][k] for k in errs) and plastic >= 0.2 and bitwise

                        def call():
                            return launch(*args, feature_major=fm)

                        row = dict(
                            call=cuda_ms(call), device=graph_ms(call, n=J2_GRAPH), host=host_us(call, n=J2_HOST),
                            plain=cuda_ms(lambda: launch.plain(*args, el, law, feature_major=fm, **c), reps=5),
                            bound=bound_ms(j2_bytes(J2_N, dtype, factored),
                                           j2_ops_per_point(c["n_iter"], factored) * J2_N, dtype),
                        )
                        log(
                            f"[j2] {kname:8s} {str(dtype)[6:]:8s} {lname:7s} {cname:8s} {layout:7s} "
                            f"plastic={plastic:.3f} err " + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                            + f" call_ms={row['call']:.4f} device_ms={row['device']:.4f} host_us={row['host']:.1f} "
                            f"bound_ms={row['bound'][0]:.4f} ({row['bound'][1]}) plain_ms={row['plain']:.3f}"
                            + ("" if layout == "feature" else f" bitwise={bitwise}") + f" {'ok' if ok else 'FAIL'}"
                        )
                        if not ok:
                            raise AssertionError(f"J2 {kname} kernel disagrees with its plain version or "
                                                 f"across layouts: {dtype} {lname} {cname} {layout}")
                    del outs
            del layouts
    phase_j2_ragged(el, laws["voce"])
    return worst


def phase_j2_ragged(el, law):
    """Both kernels, both layouts, f32 and f64, at point counts that leave a
    partial tile and slabs off the 16-byte grid, on arrays that start at the
    storage's first element and at its second (the kernel's element-wise
    route), against the plain versions (j2_fast contract)."""
    from dolfinx_materials_tpu_torch.ops import j2_cuda

    worst = {}
    for n in J2_RAGGED:
        base = j2_inputs(n, n, DEVICE)
        for offset in (0, 1):
            for dtype in (torch.float32, torch.float64):
                for layout, make in (("feature", feature_major), ("point", point_major)):
                    fm = layout == "feature"
                    args = [at_offset(t, offset) for t in make(*base, dtype)]
                    for factored in (False, True):
                        launch = j2_cuda.J2Launch(el, law, factored=factored, **j2_cuda.J2_FAST_CONTRACT)
                        out = launch(*args, feature_major=fm)
                        errs = j2_errors(out, launch.plain(*args, el, law, feature_major=fm,
                                                           **j2_cuda.J2_FAST_CONTRACT), dtype)
                        torch.cuda.synchronize()
                        if not all(errs[k] <= J2_TOL[dtype][k] for k in errs):
                            raise AssertionError(f"J2 kernel (factored={factored}) disagrees with its plain "
                                                 f"version: n={n} offset={offset} {dtype} {layout} {errs}")
                        for k, v in errs.items():
                            worst[(dtype, k)] = max(worst.get((dtype, k), 0.0), v)
    log(f"[j2] ragged and misaligned: n in {J2_RAGGED}, storage offset 0 and 1 element, both kernels, both "
        "layouts, j2_fast contract, Voce: worst err "
        + " ".join(f"{str(d)[6:]}:{k}={v:.2e}" for (d, k), v in sorted(worst.items(), key=str)) + " ok")


# ------------------------------------------------------------------ phase 3
def take_bytes(plan, table):
    """The work of one take, whatever implements it: the table read once, the
    output written once and a 4-byte index per entry (kept or patched)."""
    return (plan.n_src + plan.n_out) * table.element_size() + 4 * take_ops(plan)


def take_ops(plan):
    """One add per entry: the length of the plan's compact list."""
    return plan.csr_idx.numel()


def window_take_bytes(plan, table):
    """What a windowed take over the TPU layout (rows, lanes and windows) read
    per call beyond the table: the 8-byte (row, lane) index of every padded
    (slot, layer), and the shared-memory windows it staged."""
    from dolfinx_materials_tpu_torch.ops.banded_gather import LANE

    return 8 * plan.rloc.numel(), int(plan.nq.sum()) * plan.sub * LANE * table.element_size()


def take_matrix(plan, dtype):
    """The take as a CSR matrix S (n_out, n_src) of ones, out = S @ table:
    the one-call PyTorch yardstick (cuSPARSE SpMV); never used by the port."""
    rows = torch.repeat_interleave(torch.arange(plan.n_out, device=plan.device), plan.csr_ptr.diff().long())
    cols = plan.csr_idx.long()
    S = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), torch.ones(len(rows), dtype=dtype, device=rows.device),
        (plan.n_out, plan.n_src),
    ).coalesce()
    return S.to_sparse_csr()


def graph_ms(fn, n=TAKE_GRAPH):
    """Device milliseconds per call of ``fn``: ``n`` back-to-back calls
    captured in one CUDA graph, replayed under CUDA events, divided by n."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    t = cuda_ms(g.replay, reps=10, warmup=2) / n
    del g
    return t


def host_us(fn, n=TAKE_HOST):
    """Host microseconds per call of ``fn`` over ``n`` un-synchronised calls."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * t / n


def overflow_plan(nx):
    """Assembly plan of the nx x 2nx P2 triangle plate with k_quantile 0.01:
    its max-valence dofs spill into the patch list, with repeated positions,
    and per-output entry counts of 1 to 6."""
    from dolfinx_materials_tpu_torch import fem
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg

    V = fem.FunctionSpace(fem.create_rectangle((0.0, 0.0), (LX, LY), (nx, 2 * nx), "triangle"), 2, (2,))
    return bg.plan_slotwise_assembly(V.dofmap, V.num_dofs, chunk=1024, max_R=256, k_quantile=0.01,
                                     device=DEVICE)


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
    plans = dict(dom._banded, asm_overflow=overflow_plan(nx // 2))
    log(f"[take] {nx}x{2 * nx} P2 plate (and the {nx // 2}x{nx} triangle plate's asm_overflow): "
        f"plans in {time.perf_counter() - t0:.2f}s; call_ms: CUDA events around one call; device_ms: "
        f"{TAKE_GRAPH} calls in one CUDA graph; host_us: {TAKE_HOST} un-synchronised calls")
    tol = {torch.float32: 1e-6, torch.float64: 1e-13}
    kernels = {"ell": bg.banded_take_ell, "csr": bg.banded_take_csr}
    g = torch.Generator(device=DEVICE).manual_seed(1)
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for key, plan in plans.items():
            table = torch.randn(plan.n_src, generator=g, dtype=torch.float64, device=DEVICE).to(dtype)
            outs = {k: fn(table, plan) for k, fn in kernels.items()}
            plain = {k: bg.compact_take_reference(table, plan, k) for k in kernels}
            ref = bg.banded_take_reference(table, plan)
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            bitwise = all(torch.equal(outs["ell"], x) for x in (outs["csr"], *plain.values()))
            err = {k: rel_err(o, ref, scale) for k, o in outs.items()}
            S = take_matrix(plan, dtype)
            e_lib = rel_err(S @ table, ref, scale)
            ok = bitwise and all(e <= tol[dtype] for e in (*err.values(), e_lib))
            index_windowed, staged = window_take_bytes(plan, table)
            row = dict(
                err={k: float((o - ref).abs().max()) for k, o in outs.items()},
                call={k: cuda_ms(lambda: fn(table, plan)) for k, fn in kernels.items()},
                device={k: graph_ms(lambda: fn(table, plan)) for k, fn in kernels.items()},
                host={k: host_us(lambda: fn(table, plan)) for k, fn in kernels.items()},
                t_p=cuda_ms(lambda: bg.banded_take_reference(table, plan)),
                t_l=cuda_ms(lambda: S @ table),
                bound=bound_ms(take_bytes(plan, table), take_ops(plan), dtype)[0],
            )
            log(
                f"[take] {str(dtype)[6:]:8s} {key:12s} n_out={plan.n_out} entries={take_ops(plan)} "
                f"patches={len(plan.patch_pos)} ell_padding={plan.ell_padding:.4f} "
                f"index_MB={4e-6 * take_ops(plan):.2f} (windowed: {1e-6 * index_windowed:.2f}, "
                f"staged {1e-6 * staged:.2f}) "
                f"chosen={bg._best_take(plan).__name__} bitwise={bitwise} err "
                + " ".join(f"{k}={v:.1e}" for k, v in err.items()) + f" csr_spmv={e_lib:.1e} | "
                + " ".join(f"{k}: call_ms={row['call'][k]:.4f} device_ms={row['device'][k]:.4f} "
                           f"host_us={row['host'][k]:.1f} |" for k in kernels)
                + f" bound_ms={row['bound']:.4f} plain_ms={row['t_p']:.4f} csr_spmv_ms={row['t_l']:.4f} "
                f"{'ok' if ok else 'FAIL'}"
            )
            if not ok:
                raise AssertionError(f"banded take disagrees: {dtype} {key}")
            rows[(dtype, key)] = row
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
               bg.banded_take_ell, bg.banded_take_csr):
        fn.launches = 0
        fn.f32_launches = 0


def read_f32_counts():
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg
    from dolfinx_materials_tpu_torch.ops import j2_cuda

    return {fn.__name__: fn.f32_launches for fn in (
        j2_cuda.j2_radial_return, bg.banded_take_ell, bg.banded_take_csr)}


def read_counts():
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg
    from dolfinx_materials_tpu_torch.ops import j2_cuda

    return {
        "j2_radial_return": j2_cuda.j2_radial_return.launches,
        "j2_radial_return_factored": j2_cuda.j2_radial_return_factored.launches,
        "banded_take_ell": bg.banded_take_ell.launches,
        "banded_take_csr": bg.banded_take_csr.launches,
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
    chosen = {k: bg._best_take(p).__name__ for k, p in dom._banded.items()}
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
    return counts, gradients, last["state"], qmap.material.behavior, problem


def device_busy_ms(fn):
    """Milliseconds in which the card ran a kernel, copy or set of ``fn()``:
    the union of torch.profiler's device-event intervals (each kernel counted
    once, whatever launched it), or None where it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3 if busy > 0 else None


def phase_cg(problem):
    """CG with the plate's two-level preconditioner on the main path's last
    tangent and a seeded right-hand side, for exactly ``CG_ITERS`` iterations
    (tolerance 0): host wall ms per iteration (each ends in the stopping
    test's host sync), CUDA-event ms of one operator and one preconditioner
    application, take launches per iteration, and the device-busy share:
    profiled device ms per iteration over the unprofiled wall ms."""
    from dolfinx_materials_tpu_torch import solvers
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs

    ndofs = problem.u.space.num_dofs
    mask = torch.as_tensor(combine_bcs(problem.bcs, ndofs)[0], device=DEVICE)
    u = problem._tensor(problem.u.x)
    problem._constitutive_update(u)
    Kels = problem._element_matrices(u)
    g = torch.Generator(device=DEVICE).manual_seed(2)
    rhs = torch.randn(ndofs, generator=g, dtype=problem.dtype, device=DEVICE)
    A, b, M = problem._cg_system(Kels, rhs, mask)
    solvers.cg(A, b, 0.0, 20, M)  # warm-up
    takes = sum(read_counts()[k] for k in ("banded_take_ell", "banded_take_csr"))
    per_iter = []
    for _ in range(CG_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        x, k = solvers.cg(A, b, 0.0, CG_ITERS, M)
        torch.cuda.synchronize()
        per_iter.append(1e3 * (time.perf_counter() - t) / k)
        if k != CG_ITERS:
            raise AssertionError(f"CG stopped after {k} of {CG_ITERS} iterations")
    takes = (sum(read_counts()[k] for k in ("banded_take_ell", "banded_take_csr")) - takes) / (CG_REPS * k)
    res = float(torch.linalg.norm(A(x) - b) / torch.linalg.norm(b))
    busy = device_busy_ms(lambda: solvers.cg(A, b, 0.0, CG_PROFILED, M))
    wall = float(np.median(per_iter))
    dev_ms = busy / CG_PROFILED if busy is not None else None
    ok = bool(torch.isfinite(x).all()) and res < 1e-3
    log(f"[cg] {ndofs} dofs, last tangent, {CG_ITERS} iterations x {CG_REPS}: wall ms per iteration "
        f"{' '.join(f'{t:.4f}' for t in per_iter)} (median {wall:.4f}); operator_ms={cuda_ms(lambda: A(b)):.4f} "
        f"preconditioner_ms={cuda_ms(lambda: M(b)):.4f}; take launches per iteration {takes:.2f}; "
        + (f"device ms per iteration {dev_ms:.4f} ({CG_PROFILED} profiled), busy share {dev_ms / wall:.3f}"
           if dev_ms is not None else "device time not measured (the profiler recorded no device event)")
        + f"; relative residual {res:.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fixed-iteration CG: non-finite iterate or no decrease of the residual")


def time_j2_main(gradients, state, behavior, factored=False):
    """One J2 kernel on the given strains and the main path's last-step state
    (point-major, f64, j2_fast contract): held against its plain version on
    those inputs, then timed on them. Call it outside the counted runs: its
    launches are comparisons and timings, not a path's."""
    from dolfinx_materials_tpu_torch.ops import j2_cuda

    el, law = behavior.elasticity, behavior.yield_stress
    # built once, as the fast path holds its launch (ops/j2_fast.py)
    launch = j2_cuda.J2Launch(el, law, factored=factored, **j2_cuda.J2_FAST_CONTRACT)
    args = (gradients.contiguous(), state["eps_p"].contiguous(), state["p"].contiguous())

    def call():
        return launch(*args, feature_major=False)

    out = call()
    ref = launch.plain(*args, el, law, feature_major=False, **j2_cuda.J2_FAST_CONTRACT)
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    scale = float(ref[0].abs().max())
    if rel_err(out[0], ref[0], scale) > 1e-10 or rel_err(out[1], ref[1], E) > 1e-10:
        raise AssertionError("J2 kernel disagrees with its plain version on main-path inputs")
    n = gradients.shape[0]
    t_k = cuda_ms(call)
    t_d = graph_ms(call, n=J2_GRAPH)
    t_h = host_us(call, n=J2_HOST)
    t_p = cuda_ms(lambda: launch.plain(*args, el, law, feature_major=False, **j2_cuda.J2_FAST_CONTRACT), reps=5)
    bnd, by = bound_ms(j2_bytes(n, torch.float64, factored),
                       j2_ops_per_point(j2_cuda.J2_FAST_CONTRACT["n_iter"], factored) * n, torch.float64)
    log(f"[j2-main] {'factored' if factored else 'full':8s} {n} points f64 point-major: call_ms={t_k:.4f} "
        f"device_ms={t_d:.4f} host_us={t_h:.1f} bound_ms={bnd:.4f} ({by}) plain_ms={t_p:.3f} "
        f"max_abs_err={err:.2e}")
    return dict(ms=t_k, device_ms=t_d, host_us=t_h, plain_ms=t_p, bound_ms=bnd, bound_by=by, max_abs_err=err)


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
    newton, cg_its, step_s = [], [], []
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
        t_step = time.perf_counter()
        converged, its = problem.solve()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t_step)
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
                newton=newton, cg=cg_its, wall=wall, step_s=step_s, split=split, newton_s=newton_s,
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


# ------------------------------------------------------------ phases 8 and 9
#: [fused]: the fused step's budgets and tolerance, and the two-level coarse
#: space of the host path's (22 coordinate boxes a dimension, 968 coarse dofs
#: on the plate; the fused step's default of 8 gives 128)
FUSED_NEWTON, FUSED_CG, FUSED_CG_RTOL, FUSED_BOXES = 16, 3000, 1e-6, 22
FUSED_MIXED_CG_RTOL = 1e-4
FUSED_BENCH_NX = 64
FUSED_BENCH_REPS = 4


def build_bench(nx, device, dtype):
    """bench.py's fused-step configuration (bench.py:274-313): nx x nx P1
    quads, J2 with Voce, left u_x, bottom u_y and right u_x = 2 sig0/E."""
    import dolfinx_materials_tpu_torch as dm
    from dolfinx_materials_tpu_torch import fem
    from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d
    from dolfinx_materials_tpu_torch.models import LinearElasticIsotropic, VoceHardening, vonMisesIsotropicHardening

    mat = dm.Material(vonMisesIsotropicHardening(LinearElasticIsotropic(E, NU), VoceHardening(SIG0, SIGU, B_VOCE)),
                      dtype=dtype, device=device)
    V = fem.FunctionSpace(fem.create_unit_square(nx, nx, "quad"), 1, (2,))
    qmap = dm.QuadratureMap(V, 2, mat)
    qmap.register_gradient("Strain", mandel_strain_2d())
    left = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0), 0)
    bot = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0), 1)
    right = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1), 0)
    bcs = [fem.DirichletBC(left, 0.0), fem.DirichletBC(bot, 0.0), fem.DirichletBC(right, 2 * SIG0 / E)]
    return mat, qmap, V, bcs, dm.NonlinearMaterialProblem(qmap, fem.Function(V), bcs=bcs)


def bench_stats(device, dtype):
    """One call of the general builder in bench.py's configuration:
    ``(u, residual, newton, cg)``."""
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step_general

    mat, qmap, V, bcs, prob = build_bench(FUSED_BENCH_NX, device, dtype)
    step, pad = make_sharded_newton_step_general(prob, device_mesh(1, devices=[device]), n_newton=6, n_cg=30,
                                                 pc="two_level", return_info="stats")
    mask, vals = combine_bcs(bcs, V.num_dofs)
    u, _, rn, _, (nn, ncg) = step(np.zeros(V.num_dofs), pad([mat.data_manager.s0.internal]), mask, vals, 0.0)
    return u.cpu(), float(rn), nn, ncg


def phase_fused_bench():
    """bench.py's fused step on the card in f32 and f64: best of 4 calls
    after a warm-up (host clock, each call ending in a synchronise), the
    residual, Newton and CG counts and K1 launches; the f64 card run against
    the CPU port's."""
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step

    rows = {}
    for dtype in (torch.float32, torch.float64):
        mat, qmap, V, bcs, prob = build_bench(FUSED_BENCH_NX, DEVICE, dtype)
        step, pad = make_sharded_newton_step(qmap, prob, device_mesh(1), n_newton=6, n_cg=30, pc="two_level")
        mask, vals = combine_bcs(bcs, V.num_dofs)
        st0 = pad(mat.data_manager.s0.internal)
        u0 = torch.zeros(V.num_dofs, dtype=dtype, device=DEVICE)
        reset_counts()
        u, _, rn = step(u0, st0, mask, vals, 0.0)
        torch.cuda.synchronize()
        k1 = read_counts()["j2_radial_return"]
        best = np.inf
        for _ in range(FUSED_BENCH_REPS):
            t = time.perf_counter()
            u, _, rn = step(u0, st0, mask, vals, 0.0)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        u_g, rn_g, nn, ncg = bench_stats(DEVICE, dtype)
        same = torch.equal(u_g, u.cpu())
        rows[dtype] = dict(u=u_g, nn=nn, ncg=ncg)
        log(f"[fused-bench] {FUSED_BENCH_NX}x{FUSED_BENCH_NX} P1 J2 plate {str(dtype)[6:]}, 6 Newton x 30 CG, "
            f"two-level: best of {FUSED_BENCH_REPS} {1e3 * best:.2f} ms, residual {float(rn):.4e}, newton={nn} "
            f"cg={ncg}, K1 launches per call {k1}, wrapper and general builder bitwise={same}")
        if not (same and k1 > 0 and np.isfinite(float(rn))):
            raise AssertionError("fused bench step: wrapper and general builder differ, or no K1 launch")
    t = time.perf_counter()
    u_h, rn_h, nn_h, ncg_h = bench_stats("cpu", torch.float64)
    card = rows[torch.float64]
    e_u = rel_err(card["u"], u_h, u_h.abs().max())
    ok = e_u <= 1e-8 and (card["nn"], card["ncg"]) == (nn_h, ncg_h)
    log(f"[fused-bench] f64 card against the CPU port ({time.perf_counter() - t:.2f}s): u rel err {e_u:.2e}, "
        f"counts card {card['nn']}/{card['ncg']} cpu {nn_h}/{ncg_h} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fused bench step: card and CPU disagree")


def lifted(u, uy, y):
    """The uniform stretch u_y = uy y / L_y over u's u_x (as [generic])."""
    out = u.reshape(-1, 2).clone()
    out[:, 1] = uy * y / LY
    return out.reshape(-1)


def graph_snapshot(cg):
    """The replays so far of each CUDA graph of a fused step's CG."""
    return {k: g["replays"] for k, g in cg._graphs.items()}


def fused_launches(cg, before, calls, f32=False):
    """The fused path's launches since ``before`` (a ``graph_snapshot``),
    from the wrappers' counts of their calls since then (``calls``; float32
    calls with ``f32``): less the calls that the graphs captured since then
    recorded (a capture records, it launches nothing), plus each graph's
    replays since then times what one replay launches. Returns the launches
    and, per kernel, the factors (calls, captured, replays, per replay)."""
    i = 1 if f32 else 0
    new = [g for k, g in cg._graphs.items() if k not in before]
    replays = {k: g["replays"] - before.get(k, 0) for k, g in cg._graphs.items()}
    out, factors = {}, {}
    for name, n in calls.items():
        captured = sum(g["recorded"][name][i] for g in new)
        per = [(replays[k], g["recorded"][name][i]) for k, g in cg._graphs.items()]
        out[name] = n - captured + sum(r * c for r, c in per)
        factors[name] = dict(calls=n, captured=captured, replays=sum(r for r, _ in per),
                             per_replay=[c for _, c in per])
    return out, factors


def phase_fused(nx, fast):
    """The main path's plate through the fused step: the three loads of
    [generic] from its lifted starts, against the host path's run of the
    same steps (``fast``); CG wall ms per iteration and the device-busy
    share; one mixed-precision step; one Newton update with the CG graph
    against the eager blocks; two builds of the coarse matrix. Returns the
    launch counts of the three steps and their factors (``fused_launches``)."""
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step_general
    from dolfinx_materials_tpu_torch.parallel import sharding

    problem, qmap, bc_top, _ = build_plate(nx, DEVICE)
    ndofs = problem.u.space.num_dofs
    y = torch.as_tensor(problem.u.space.node_coords[:, 1], device=DEVICE)
    opts = dict(n_newton=FUSED_NEWTON, n_cg=FUSED_CG, cg_rtol=FUSED_CG_RTOL, pc="two_level",
                pc_boxes=FUSED_BOXES, return_info="stats")
    t0 = time.perf_counter()
    step, pad = make_sharded_newton_step_general(problem, device_mesh(1), **opts)
    log(f"[fused] {nx}x{2 * nx} P2 plate, {qmap.num_points} Gauss points, {ndofs} dofs, f64: n_newton={FUSED_NEWTON} "
        f"n_cg={FUSED_CG} cg_rtol={FUSED_CG_RTOL:g} pc=two_level pc_boxes={FUSED_BOXES}; set-up "
        f"{time.perf_counter() - t0:.2f}s")
    cg_wall = [0.0]
    solve = step.cg.solve

    def timed_solve(ops, b):  # the CG solves' wall time, for ms per CG iteration
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = solve(ops, b)
        torch.cuda.synchronize()
        cg_wall[0] += time.perf_counter() - t
        return out

    step.cg.solve = timed_solve
    u = torch.zeros(ndofs, dtype=torch.float64, device=DEVICE)
    states = pad([qmap.material.data_manager.s0.internal])
    total = dict.fromkeys(read_counts(), 0)
    factors = {k: dict(calls=0, captured=0, replays=0) for k in total}
    inputs, n_cg, walls = [], 0, []
    for i, uy in enumerate(GENERIC_LOADS):
        bc_top.set(uy)
        mask, vals = combine_bcs(problem.bcs, ndofs)
        u0 = lifted(u, uy, y)
        inputs.append((u0, states, mask, vals))
        reset_counts()
        before = graph_snapshot(step.cg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        u, states, rn, rn0, (nn, ncg) = step(u0, states, mask, vals, 0.0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        counts, fac = fused_launches(step.cg, before, read_counts())
        total = {k: total[k] + v for k, v in counts.items()}
        for k, f in fac.items():
            factors[k] = dict(calls=factors[k]["calls"] + f["calls"], captured=factors[k]["captured"] + f["captured"],
                              replays=factors[k]["replays"] + f["replays"], per_replay=f["per_replay"])
        n_cg += ncg
        log(f"[fused] u_y={uy:g}: newton={nn} cg={ncg} wall_s={walls[-1]:.3f} (host path {fast['step_s'][i]:.3f} s, "
            f"newton={fast['newton'][i]} cg={fast['cg'][i]}) residual {float(rn):.4e} ({float(rn) / float(rn0):.2e} "
            f"of entering) cg blocks {step.cg.blocks} (last solve) launches {counts} = wrapper calls "
            f"- captured + replays x per replay: {fac}")
        if not all(counts[k] > 0 for k in ("j2_radial_return", "banded_take_ell", "banded_take_csr")):
            raise AssertionError("fused step: K1, K3 and K4 must each launch on the fused path")
        if not float(rn) <= 1e-10 * float(rn0):
            raise AssertionError("fused step: a load step did not converge")
    p = states[0]["p"].reshape(-1).cpu()
    e_u = rel_err(u.cpu(), fast["u"], fast["u"].abs().max())
    e_p = rel_err(p, fast["p"], fast["p"].abs().max())
    ms_cg = 1e3 * cg_wall[0] / n_cg
    step.cg.solve = solve
    # device-busy share over the first step, from its inputs again
    wall = seconds_per_call(lambda: step(*inputs[0], 0.0), reps=1)
    busy = device_busy_ms(lambda: step(*inputs[0], 0.0))
    share = busy / (1e3 * wall) if busy is not None else None
    ok = e_u <= 1e-6 and e_p <= 1e-6
    log(f"[fused] three steps {sum(walls):.3f} s against the host path's {sum(fast['step_s']):.3f} s; "
        f"{n_cg} CG iterations at {ms_cg:.4f} ms each (wall of the CG solves); first step {1e3 * wall:.1f} ms, "
        + (f"device busy {busy:.1f} ms, busy share {share:.3f}" if busy is not None
           else "device time not measured (the profiler recorded no device event)")
        + f"; against the host path u rel err {e_u:.2e} p rel err {e_p:.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fused step: disagrees with the host path on the same steps")

    # mixed precision: one step from the first load's start; its CG is f32,
    # which does not reach the f64 runs' 1e-12 reduction of rz
    mixed, _ = make_sharded_newton_step_general(problem, device_mesh(1),
                                                **dict(opts, precision="mixed", cg_rtol=FUSED_MIXED_CG_RTOL))
    u0, st0, mask, vals = inputs[0]
    reset_counts()
    t = time.perf_counter()
    u_m, _, rn, rn0, (nn, ncg) = mixed(u0, st0, mask, vals, 0.0)
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    info = mixed.info
    launched, _ = fused_launches(mixed.cg, {}, read_counts())
    f32, f32_fac = fused_launches(mixed.cg, {}, read_f32_counts(), f32=True)
    log(f"[fused] mixed precision (cg_rtol={FUSED_MIXED_CG_RTOL:g}), u_y={GENERIC_LOADS[0]:g}: {t:.3f} s, f32 warmup newton={info['warmup_newton']} "
        f"cg={info['warmup_cg']}, f64 polish newton={info['polish_newton']} cg={info['polish_cg']}, residual "
        f"{float(rn):.4e} ({float(rn) / float(rn0):.2e} of entering); launches {launched}, of them f32 {f32} "
        f"(f32 factors {f32_fac})")
    if not (f32["j2_radial_return"] > 0 and f32["banded_take_ell"] > 0 and np.isfinite(float(rn))):
        raise AssertionError("mixed step: the f32 warmup must launch K1 and the takes in f32")

    # one Newton update with the CG graph and with the eager blocks
    # (the graph run's coarse sums are kept, to hold them against the plain
    # version below)
    one, sums = {}, []

    def recording_sum(v, plan):
        out = bg.fixed_sum(v, plan)
        if not sums:
            sums.append((v, plan, out))
        return out

    for graph in (True, False):
        s1, _ = make_sharded_newton_step_general(problem, device_mesh(1), **dict(opts, n_newton=1))
        s1.cg.graph = graph
        sharding.fixed_sum = recording_sum
        try:
            u1, _, _, _, (nn, ncg) = s1(u0, st0, mask, vals, 0.0)
        finally:
            sharding.fixed_sum = bg.fixed_sum
        one[graph] = (u1, ncg, len(s1.cg._graphs))
    same = torch.equal(one[True][0], one[False][0]) and one[True][1] == one[False][1]
    log(f"[fused] one Newton update, CUDA graph against eager blocks: cg {one[True][1]} / {one[False][1]}, "
        f"graphs captured {one[True][2]} / {one[False][2]}, u bitwise equal={same} {'ok' if same else 'FAIL'}")
    if not same or one[True][2] != 1 or one[False][2] != 0:
        raise AssertionError("fused step: the replayed CG graph and the eager blocks differ")

    # the fused step's coarse sum against the plain version on the CPU, on
    # a CPU plan rebuilt from the kernel's lists
    v, plan, out = sums[0]
    ptr, idx = plan.csr_ptr.cpu().numpy(), plan.csr_idx.cpu().numpy()
    tgt = np.empty(plan.n_src, np.int64)
    tgt[idx] = np.repeat(np.arange(plan.n_out), np.diff(ptr))
    ref = bg.fixed_sum_reference(v.cpu(), bg.plan_fixed_sum(tgt, plan.n_out))
    same = torch.equal(out.cpu(), ref)
    log(f"[fused] fused step's coarse matrix ({plan.n_src} terms into {plan.n_out} entries): banded_take_csr "
        f"against the plain version bitwise equal={same}, max abs diff {float((out.cpu() - ref).abs().max()):.3e} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("fused coarse matrix: the kernel's fixed-order sum differs from its plain version")

    # the host path's coarse matrix at the last displacement, built twice
    problem._constitutive_update(u)
    Kels = problem._element_matrices(u)
    nagg, coarse_dof, _ = problem._node_aggregates()
    ncoarse = nagg * 2
    plan = problem._coarse_plans(ncoarse)[0]
    w = (~torch.as_tensor(mask, device=DEVICE)).to(torch.float64)[qmap.domain.dofmap]
    Kw = (Kels[0] * w[:, :, None] * w[:, None, :]).reshape(-1)
    builds = [bg.fixed_sum(Kw, plan) for _ in range(2)]
    cd = coarse_dof[qmap.domain.dofmap]
    target = (cd[:, :, None] * ncoarse + cd[:, None, :]).reshape(-1)
    atomic = [Kw.new_zeros(plan.n_out).index_add_(0, target, Kw) for _ in range(2)]
    same = torch.equal(*builds)
    # the plain version on the CPU, on a CPU plan of the same target
    ref = bg.fixed_sum_reference(Kw.cpu(), bg.plan_fixed_sum(target.cpu().numpy(), plan.n_out))
    plain = torch.equal(builds[0].cpu(), ref)
    log(f"[fused] coarse matrix ({ncoarse} coarse dofs, {plan.n_src} terms into {plan.n_out} entries) built twice: "
        f"fixed-order sum bitwise equal={same}, against the plain version bitwise equal={plain} (max abs diff "
        f"{float((builds[0].cpu() - ref).abs().max()):.3e}); atomic index_add_ bitwise equal={torch.equal(*atomic)}, "
        f"max difference {float((atomic[0] - atomic[1]).abs().max()):.3e}, against the fixed-order sum "
        f"{rel_err(atomic[0], builds[0], builds[0].abs().max()):.2e} {'ok' if same and plain else 'FAIL'}")
    if not same:
        raise AssertionError("coarse matrix: two fixed-order builds differ")
    if not plain:
        raise AssertionError("coarse matrix: the kernel's fixed-order sum differs from its plain version")
    return total, factors


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
    counts, grads, state, behavior, problem = phase_main(nx_full)
    phase_cg(problem)
    del problem
    k1 = time_j2_main(grads, state, behavior)
    # the factored kernel's path is the material-point one: no FEM path
    # launches it (the JAX package has no element-matrix consumer of it). It
    # is held against its plain version and timed on the strains that its
    # counted launch in [point] ran on
    point_counts, _, eps_point = phase_point(grads, state, behavior)
    k2 = time_j2_main(eps_point, state, behavior, factored=True)
    _, fast = phase_generic(nx_full)
    phase_fused_bench()
    fused_counts, fused_factors = phase_fused(nx_full, fast)
    log(f"[total] {time.perf_counter() - t0:.1f}s")

    keys = ("cell", "fm", "asm")

    def take_row(name, layout, replaces):
        def total(f):  # one take of each of the slice's three plans, f64
            return sum(f(takes[(f64, k)]) for k in keys)

        return {
            "name": name, "route": "cuda",
            "source": "dolfinx_materials_tpu_torch/csrc/banded_take.cu",
            "replaces": replaces, "launches": counts[name] + fused_counts[name],
            "launches_by_path": {"main": counts[name], "fused": fused_counts[name]},
            "fused_launches_from": fused_factors[name],
            "max_abs_err": max(takes[(f64, k)]["err"][layout] for k in keys),
            "ms": total(lambda r: r["call"][layout]),
            "device_ms": total(lambda r: r["device"][layout]),
            "host_us": total(lambda r: r["host"][layout]),
            "plain_ms": total(lambda r: r["t_p"]),
            "bound_ms": total(lambda r: r["bound"]),
            "bound_by": "bytes",
            "library_ms": total(lambda r: r["t_l"]),
        }

    def j2_row(name, replaces, by_path, timed, worst):
        return {
            "name": name, "route": "cuda",
            "source": "dolfinx_materials_tpu_torch/csrc/j2_radial_return.cu",
            "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
            **({"fused_launches_from": fused_factors[name]} if "fused" in by_path else {}),
            "max_abs_err": max(timed["max_abs_err"], worst),
            "ms": timed["ms"], "device_ms": timed["device_ms"], "host_us": timed["host_us"],
            "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "library_ms": None,
        }

    kernels = [
        j2_row("j2_radial_return", "dolfinx_materials_tpu/ops/pallas_j2.py:103",
               {"main": counts["j2_radial_return"], "fused": fused_counts["j2_radial_return"]}, k1, j2_worst["full"]),
        j2_row("j2_radial_return_factored", "dolfinx_materials_tpu/ops/pallas_j2.py:196",
               {"point": point_counts["j2_radial_return_factored"]}, k2, j2_worst["factored"]),
        take_row("banded_take_csr", "csr", "dolfinx_materials_tpu/ops/banded_gather.py:188"),
        take_row("banded_take_ell", "ell", "dolfinx_materials_tpu/ops/banded_gather.py:268"),
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
