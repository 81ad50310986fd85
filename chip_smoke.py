#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dolfinx_materials_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

It builds the CUDA kernels of ``dolfinx_materials_tpu_torch/csrc`` with nvcc
(sm_90a) into ``build/kernels/`` and runs twenty-one phases; any failure
exits non-zero before the result line is printed:

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
   128x256 P2 plate's cell, fm and asm plans, a 64x128 triangle plate's
   assembly plan with overflow patches and the N = 10 P2-tet Ogden block's
   three plans, in f32 and f64; each timed per call, on the device (a CUDA
   graph of back-to-back takes) and on the host;
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
   (Mandel strains: f64 tangents and CG, the warmup's u in f32); one Newton
   update with the CG loop replayed as a CUDA graph and run eagerly, bitwise
   equal; the plate's
   coarse matrix built twice by the fixed-order sum, bitwise equal (and the
   atomic ``index_add_`` twice, for comparison);
10. the 3D Ogden benchmark (``demos.ogden_block``): the unit cube on P2
    tets, 10 mixed-precision steps to 20 % compression at N = 10 (6,000
    tets), timed warm after a first run of its first step, and the first
    step at N = 20 (48,000 tets, from a lifted first iterate), run once:
    per-step relative residual (<= 1e-4), Newton and CG counts, warm seconds,
    the CG solves' share, K3/K4 launches;
11. the same block on P1 hexes at N = 19 in f32 (the 3D stencil);
12. the composite (``demos.composite_hyperelasticity``): Ogden matrix and
    SVK inclusions at 1e12, cfg (2, 1, 3), 10 mixed steps;
13. the tet block at N = 4, the composite at cfg (1, 1, 2) and the hex
    block at N = 3 in f32, 3 steps each, on the card and on the CPU: u to
    1e-6 on the mixed protocols, to 1e-5 in f32; then the composite with
    every step solved to rtol 1e-8, u to 1e-6 after every step and equal
    Newton counts;
14. law programs (run right after phase 2): both J2 kernels running a
    traced hardening law (a tanh law and Voce written as a lambda) at 2^21
    points, f32 and f64, both layouts, against the plain return map on the
    same program within phase 2's tolerances, the Voce lambda also against
    the built-in Voce kernel, each timed beside the built-in one;
15. the README's plane demo twin at its default N = 24 on the card (K1, K3
    and K4 launches, its VTK read back), at N = 6 on the card and the CPU
    (steps, forces, max p to 1e-8; the continuous projection of p to
    1e-10), and the curved-cylinder twin at N = 6 on both;
16. FeFp (``[fefp]``): the whole-batch update at bench.py's 131,072 points,
    f64 and f32, both tangent modes and the flux-only update, card against
    the CPU port on the same inputs, warm ms and torch.profiler's kernel
    count per update; the finite-strain demo's bar on P2 tets at N = 8
    (129,024 Gauss points, 42,483 dofs) through ``solve_adaptive`` (steps,
    Newton and CG counts, time split, K3/K4 launches); the bar at N = 2 on
    card and CPU (u and max p to 1e-8);
17. crystal (``[crystal]``): Meric-Cailletaud at bench.py's 16,384 points, 2
    chained updates at dt = 1e-2, f64 and f32, card against CPU (stress and
    state to 1e-9, tangent to 1e-8 in f64), Newton counts (one host read
    each), warm ms and kernel counts, and the flux-only update;
18. the families' demo twins (``[families]``): finite strain, heat transfer,
    thermomechanics, conic return mapping and the NN surrogate on the card
    at the JAX demos' defaults, card against CPU at their smoke sizes, and
    ``calibration.fit_parameters`` for 25 Adam steps on both;
19. multi-field problems (``[blocked]``): the multimaterial interface demo
    twin (20x10 P1, host LU) card against CPU; the stiff thermo-mechanical
    coupling of tests/test_blocked.py at N = 6 through the host LU solve,
    the fused blocked step and ``solve_coupled`` (20 outer iterations), card
    against CPU; the interface problem on a 256x128 P2 parent (294,912 Gauss
    points, 264,196 dofs) through ``parallel.make_sharded_blocked_step``:
    Newton and BiCGStab counts, |R| <= 1e-7 E, wall seconds, ms per BiCGStab
    iteration, the device-busy share of its first Newton iteration, K1/K3/K4
    launches; at 64x32 against the host LU solve on the card;
20. the parity cases that the JAX package tests only under ``slow``
    (``[owed]``), each on the card and on the CPU: FeFp through
    ``make_sharded_newton_step`` on 5x5 P1 quads, the transient phase change
    through ``make_sharded_newton_step_general`` and the blocked step with a
    per-point Young modulus and a rotated frame (u and p to 1e-8, equal
    Newton counts, Krylov counts within 5 %), with each case's K1/K3/K4
    launches;
21. the multi-rank layer (``[dist]``, ``parallel.multiprocess``): (a) the
    phase-9 plate and first load through one NCCL rank of a process group
    (``python3 chip_smoke.py --dist-worker ...``, launched by
    ``multiprocess.launch``), u, p and counts bitwise equal to phase 9's
    first step, K1/K3/K4 launched on the rank; (b) two ranks sharing the
    card over gloo on phase 8's plate (on the banded route), both dof
    layouts, and (c) the fused blocked step over the same two ranks at
    phase 19's 64x32, each against its one-rank card run (u or z and p to
    1e-8, equal Newton counts, Krylov counts within 5 %), every rank
    launching K1, K3 and K4; ms per load step of each.

Then it prints the card's name and power limit, one JSON line with every
kernel's launches, error, time and bound, and as the last line the contract
JSON ``{"ok": true, "device": {...}}``; a kernel's ``launches`` there add up
its counted paths (``launches_by_path``). Times are CUDA-event medians on this
card (``ms`` one call, ``device_ms`` per call of a replayed CUDA graph) and
host microseconds per un-synchronised call (``host_us``); bounds use the
H100 SXM data-sheet rates in :data:`PEAK`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
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
    m = re.search(r"(j2_radial_return_kernel|j2_law_program_kernel)I([fd])Lb([01])ELb([01])E", mangled)
    if m:
        form = "factored" if m.group(3) == "1" else "full"
        layout = "feature-major" if m.group(4) == "1" else "point-major"
        return f"{m.group(1)}<{dt[m.group(2)]}, {form}, {layout}>"
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
def j2_ops_per_point(n_iter, factored=False, hardening_ops=10):
    """Floating-point operations of one point of the J2 kernels, counted from
    csrc/j2_radial_return.cu: trial state and norm ~45, each hardening
    evaluation ``hardening_ops`` (~10 for a closed form, one exp or pow
    counted as one; ~3 an instruction of a law program, value and slope),
    each Newton step ~8, stress/state update ~30, the two tangent factors
    ~15, and for the full tangent 36 x 4 more."""
    return 45 + hardening_ops * (n_iter + 2) + 8 * n_iter + 30 + 15 + (0 if factored else 36 * 4)


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


def tet_plans(N):
    """The cell, fm and asm plans of the N^3 P2-tet Ogden block ([ogden-tet]),
    keyed ``tet_cell``, ``tet_fm``, ``tet_asm``."""
    from dolfinx_materials_tpu_torch import fem
    from dolfinx_materials_tpu_torch.fem.assembly import QuadratureDomain

    V = fem.FunctionSpace(fem.create_unit_cube(N, N, N, "tetrahedron"), degree=2, shape=(3,))
    dom = QuadratureDomain(V, 4, device=DEVICE)
    if dom._banded is None or dom._banded.get("fm") is None:
        raise AssertionError("the P2-tet block did not get its cell, fm and asm plans")
    return {f"tet_{k}": p for k, p in dom._banded.items()}


def phase_take(nx, tet_n):
    from dolfinx_materials_tpu_torch import fem
    from dolfinx_materials_tpu_torch.fem.assembly import QuadratureDomain
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg

    t0 = time.perf_counter()
    mesh = fem.create_rectangle((0.0, 0.0), (LX, LY), (nx, 2 * nx), "quad")
    V = fem.FunctionSpace(mesh, degree=2, shape=(2,))
    dom = QuadratureDomain(V, 4, device=DEVICE)
    if dom._banded is None or dom._banded.get("fm") is None:
        raise AssertionError("the plate did not get its cell, fm and asm plans")
    plans = dict(dom._banded, asm_overflow=overflow_plan(nx // 2), **tet_plans(tet_n))
    log(f"[take] {nx}x{2 * nx} P2 plate (and the {nx // 2}x{nx} triangle plate's asm_overflow, the N={tet_n} "
        f"P2-tet Ogden block's tet_*): plans in {time.perf_counter() - t0:.2f}s; call_ms: CUDA events around one "
        f"call; device_ms: {TAKE_GRAPH} calls in one CUDA graph; host_us: {TAKE_HOST} un-synchronised calls")
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
            # table[idx] over the flat entry list: the take itself where each
            # output has one entry (cell, fm), the gather half of a sum (asm)
            idx = plan.csr_idx.long()
            gather = idx.numel() == plan.n_out
            e_sel = rel_err(table.index_select(0, idx), ref, scale) if gather else 0.0
            ok = bitwise and all(e <= tol[dtype] for e in (*err.values(), e_lib, e_sel))
            index_windowed, staged = window_take_bytes(plan, table)
            row = dict(
                err={k: float((o - ref).abs().max()) for k, o in outs.items()},
                call={k: cuda_ms(lambda: fn(table, plan)) for k, fn in kernels.items()},
                device={k: graph_ms(lambda: fn(table, plan)) for k, fn in kernels.items()},
                host={k: host_us(lambda: fn(table, plan)) for k, fn in kernels.items()},
                t_p=cuda_ms(lambda: bg.banded_take_reference(table, plan)),
                t_l=cuda_ms(lambda: S @ table),
                t_i=cuda_ms(lambda: table.index_select(0, idx)),
                device_i=graph_ms(lambda: table.index_select(0, idx)),
                gather=gather,
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
                + f"index_select_ms={row['t_i']:.4f} (device_ms {row['device_i']:.4f})"
                + f"{'' if gather else ' (gather only, no sum)'} "
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
    launch counts of the three steps, their factors (``fused_launches``) and
    the first step's u, p, counts and seconds ([dist] (a)'s reference)."""
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
        if i == 0:  # [dist] (a) holds its rank's first step against this one
            first = dict(u=u.cpu(), p=states[0]["p"].reshape(-1).cpu(), newton=nn, cg=ncg, s=walls[-1],
                         counts=counts)
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

    # mixed precision: one step from the first load's start. The plate's
    # Mandel strains give f64 tangents and CG (as the JAX package's promote
    # to), with u and the residual of the warmup in f32; cg_rtol stays
    # that of PR 5's f32 CG
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
    log(f"[fused] mixed precision (cg_rtol={FUSED_MIXED_CG_RTOL:g}), u_y={GENERIC_LOADS[0]:g}: {t:.3f} s, warmup "
        f"newton={info['warmup_newton']} cg={info['warmup_cg']}, f64 polish newton={info['polish_newton']} "
        f"cg={info['polish_cg']}, CG operands {info['cg_dtype']}, residual {float(rn):.4e} "
        f"({float(rn) / float(rn0):.2e} of entering); launches {launched}, of them f32 {f32} (f32 factors {f32_fac})")
    if not (info["cg_dtype"] == torch.float64 and launched["j2_radial_return"] > 0
            and launched["banded_take_ell"] > 0 and np.isfinite(float(rn))):
        raise AssertionError("mixed step on the Mandel-strain plate: tangents and CG must be f64, and K1 and the "
                             "takes must launch")

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
    return total, factors, first


# ---------------------------------------------------------- phases 10 to 13
#: [ogden-tet]: the fine P2-tet block (6,000 tets, 27,783 dofs, 84,000 Gauss
#: points) for 10 steps, then N = 20 (48,000 tets, 206,763 dofs, 672,000
#: points) for its first step; [ogden-hex]: the P1-hex block at N = 19;
#: [composite]: the coarse composite; [ogden-cpu]: card against CPU (the
#: tet block at N = 4, the smallest N whose plans the banded route builds,
#: the composite at cfg (1, 1, 2) and the hex block at N = 3, 3 steps each)
OGDEN_TET_N, OGDEN_TET_BIG_N, OGDEN_TET_BIG_STEPS = 10, 20, 1
OGDEN_HEX_N = 19
#: [ogden-hex]'s warm run: the protocol's first steps (its 10 steps took
#: 43 s, PR 9; cut to make room for [dist])
OGDEN_HEX_WARM_STEPS = 4
COMPOSITE_CFG = (2, 1, 3)
OGDEN_CPU_N, OGDEN_CPU_CFG, OGDEN_CPU_HEX_N, OGDEN_CPU_STEPS = 4, (1, 1, 2), 3, 3
#: per-step relative residual bars: the mixed protocols' rtol (1e-4), and
#: for the f32 hex protocol about 3x its f32 floor (rtol 2e-5 is below the
#: floor: steps end on the Newton budget, at up to 1.3e-3 of the entering
#: residual on the CPU at N = 3 over 10 steps and up to 9.0e-4 on an H100
#: at N = 19)
MIXED_BAR, HEX_BAR = 1e-4, 3e-3
#: card against CPU: u to 1e-6 of its largest entry on the mixed protocols
#: (the tolerance of tests/test_torch_ogden_block.py against the JAX
#: package), and to 1e-5 on the f32 hex protocol (5x the spread of the two
#: packages' f32 runs on the CPU, 2.1e-6 at N = 3 after 3 steps,
#: tests/test_torch_ogden_hex.py)
MIXED_CPU_TOL, HEX_CPU_TOL = 1e-6, 1e-5
#: [ogden-cpu]'s composite again with every step solved to rtol 1e-8 (30
#: Newton x 300 CG, the protocol's cg_rtol 1e-3: tests/test_torch_composite.py),
#: u after every step held to MIXED_CPU_TOL, equal Newton counts
OGDEN_STRICT = dict(n_newton=30, n_cg=300, rtol=1e-8, cg_rtol=1e-3)
TAKES = ("banded_take_ell", "banded_take_csr")


def run_ogden(tag, proto, run_steps, bar=MIXED_BAR, once=False, warm_steps=None):
    """A protocol's first load step (the first build: kernels, CUDA-graph
    captures), then all its steps (or its first ``warm_steps``) again from
    u = 0 (``run_steps(proto, n)``, n None for all), the warm run; with
    ``once`` only the second run (its first build included). The counts are set to 0 before each run and
    the last run's launches derived as [fused] derives them. Prints
    per-step relative |R|, Newton and CG counts, the wall seconds of each
    run and the launches, and holds every step to ``bar``, the CG to f32
    and, on a tet mesh, K3 and K4 to f32 launches. Returns ``(u, stats,
    seconds, launches)``."""
    seconds, cg = [], proto["step"].cg
    solve, cg_wall = cg.solve, [0.0]

    def timed_solve(ops, b):  # the CG solves' wall time, as [fused] takes it
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = solve(ops, b)
        torch.cuda.synchronize()
        cg_wall[0] += time.perf_counter() - t
        return out

    for n in (warm_steps,) if once else (1, warm_steps):
        reset_counts()
        before = graph_snapshot(cg)
        cg_wall[0] = 0.0
        cg.solve = solve if n else timed_solve
        torch.cuda.synchronize()
        t = time.perf_counter()
        u, stats = run_steps(proto, n)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        launches, factors = fused_launches(cg, before, read_counts())
        f32, _ = fused_launches(cg, before, read_f32_counts(), f32=True)
    cg.solve = solve
    n_cg = sum(st["cg"] for st in stats)
    rel = [st["res"] / max(st["res0"], 1e-300) for st in stats]
    for k, st in enumerate(stats):
        log(f"[{tag}]   step {k + 1}: rel |R| {rel[k]:.3e} (|R| {st['res']:.4e}) newton={st['newton']} "
            f"cg={st['cg']}")
    # deformation gradients: f32 tangents and CG, so the mixed CG's takes
    # run in f32 (the f32 hex protocol is f32 throughout)
    cg_dtype = proto["step"].info["cg_dtype"]
    ok = all(np.isfinite(r) and r <= bar for r in rel) and bool(torch.isfinite(u).all()) and (
        cg_dtype == torch.float32) and (not proto["tet"] or all(launches[k] > 0 and f32[k] > 0 for k in TAKES))
    log(f"[{tag}] {len(stats)} steps: wall_s {seconds[-1]:.3f} "
        + ("(one run, its first build included); " if once else
           f"warm (the first step alone, first build: {seconds[0]:.3f}); ")
        + f"newton={sum(st['newton'] for st in stats)} cg={n_cg}; CG solves {cg_wall[0]:.3f}s of the timed run "
        f"({100 * cg_wall[0] / seconds[-1]:.1f}%, {1e3 * cg_wall[0] / max(n_cg, 1):.4f} ms per CG iteration, a "
        f"synchronise around each solve); CG operands {cg_dtype}; launches of the last run (f32 {f32}) "
        f"{launches} = wrapper calls - captured + replays x per replay: {factors}; max rel |R| {max(rel):.3e} "
        f"(bar {bar:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: a step missed its residual bar, u is not finite, the CG was not f32, or "
                             "K3/K4 did not launch (in f32)")
    return u, stats, seconds, launches


def ogden_tet(N, n_steps, device=DEVICE, lift_first=False):
    """The P2-tet block's mixed protocol (demos.ogden_block, its defaults)."""
    from dolfinx_materials_tpu_torch.demos import ogden_block

    proto = ogden_block.make_protocol(N, "tetrahedron", 2, "mixed", device=device)
    proto["tet"] = True
    return proto, lambda p, n=None: ogden_block.run_steps(p, n or n_steps, lift_first=lift_first)


def composite(cfg, n_steps=10, device=DEVICE):
    """The composite's protocol (demos.composite_hyperelasticity, its
    defaults), ``n_steps`` of its 2 % increments."""
    from dolfinx_materials_tpu_torch.demos import composite_hyperelasticity

    proto = composite_hyperelasticity.make_protocol(cfg, n_steps=n_steps, exx_max=0.02 * n_steps, device=device)
    proto["tet"] = True
    return proto, composite_hyperelasticity.run_steps


def describe(proto):
    doms = [q.domain for q in proto.get("qmaps") or [proto["qmap"]]]
    return (f"{sum(d.ne for d in doms)} cells, {proto['V'].num_dofs} dofs, {sum(d.num_points for d in doms)} "
            f"Gauss points, banded plans {[sorted(k for k, v in (d._banded or {}).items() if v is not None) for d in doms]}")


def phase_ogden_tet():
    """[ogden-tet]: the reference's timed 3D Ogden protocol on its own P2
    tets through the mixed fused step, N = 10 for 10 steps, then N = 20 for
    its first. Returns the launches of the two warm runs, summed."""
    total = dict.fromkeys(read_counts(), 0)
    for N, n_steps in ((OGDEN_TET_N, 10), (OGDEN_TET_BIG_N, OGDEN_TET_BIG_STEPS)):
        t = time.perf_counter()
        # from N = 17 on the protocol's first iterate inverts the top layer
        # of cells (demos.ogden_block.run_steps): N = 20 starts lifted
        lift = N >= 17
        proto, run = ogden_tet(N, n_steps, lift_first=lift)
        log(f"[ogden-tet] N={N} P2 tets, mixed, P1 coarse space, rtol 1e-4, cg_rtol 1e-3"
            f"{', first step from the uniform compression' if lift else ''}: {describe(proto)}; "
            f"set-up {time.perf_counter() - t:.2f}s")
        torch.cuda.reset_peak_memory_stats()
        # N = 20 runs its one step once, its first build included
        _, _, _, launches = run_ogden("ogden-tet", proto, run, once=N == OGDEN_TET_BIG_N)
        log(f"[ogden-tet] N={N}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        total = {k: total[k] + launches[k] for k in total}
        del proto, run
    return total


def phase_ogden_hex():
    """[ogden-hex]: the P1-hex block at N = 19, f32, make_sharded_newton_step
    on the 3D stencil (no take launches); its first ``OGDEN_HEX_WARM_STEPS``
    steps warm."""
    t = time.perf_counter()
    proto, run = ogden_hex(OGDEN_HEX_N)
    stencil = proto["qmap"].domain._stencil
    log(f"[ogden-hex] N={OGDEN_HEX_N} P1 hexes, f32, rtol 2e-5, 20 Newton x 150 CG: {describe(proto)}, stencil "
        f"{stencil}; set-up {time.perf_counter() - t:.2f}s")
    if stencil is None:
        raise AssertionError("ogden-hex: the hex block did not take the 3D stencil")
    return run_ogden("ogden-hex", proto, run, bar=HEX_BAR, warm_steps=OGDEN_HEX_WARM_STEPS)[3]


def phase_composite():
    """[composite]: Ogden matrix and SVK inclusions at 1e12, coarse cfg, 10
    steps, mixed, rigid-body coarse modes per material."""
    t = time.perf_counter()
    proto, run = composite(COMPOSITE_CFG)
    log(f"[composite] cfg {COMPOSITE_CFG}, P2 tets, Ogden + SVK (E_pen 1e12), mixed, rbm coarse modes split by "
        f"material: {describe(proto)}; set-up {time.perf_counter() - t:.2f}s")
    return run_ogden("composite", proto, run)[3]


def ogden_hex(N, device=DEVICE):
    """The P1-hex block's f32 protocol (demos.ogden_block, its defaults)."""
    from dolfinx_materials_tpu_torch.demos import ogden_block

    proto = ogden_block.make_protocol(N, "hexahedron", 1, "f32", device=device)
    proto["tet"] = False
    return proto, ogden_block.run_steps


class StepRecorder:
    """A protocol's step that keeps a host copy of every step's u (its
    attributes, ``info`` and ``cg``, are the step's own)."""

    def __init__(self, step):
        self.step, self.u = step, []

    def __call__(self, *a, **k):
        out = self.step(*a, **k)
        self.u.append(out[0].detach().cpu().clone())
        return out

    def __getattr__(self, name):
        return getattr(self.step, name)


def phase_ogden_cpu():
    """[ogden-cpu]: the tet block, the composite and the hex block, 3 steps
    each, on the card and on the CPU: u after the last step to
    ``MIXED_CPU_TOL`` on the mixed protocols and to ``HEX_CPU_TOL`` on the
    f32 one, every step to its bar (the f32 CGs round differently on the
    two, so counts are printed, not compared). The card-against-CPU error
    of u after every step is printed."""
    for name, make, tol, bar in (
            ("tet", lambda dev: ogden_tet(OGDEN_CPU_N, OGDEN_CPU_STEPS, dev), MIXED_CPU_TOL, MIXED_BAR),
            ("composite", lambda dev: composite(OGDEN_CPU_CFG, OGDEN_CPU_STEPS, dev), MIXED_CPU_TOL, MIXED_BAR),
            ("hex f32", lambda dev: ogden_hex(OGDEN_CPU_HEX_N, dev), HEX_CPU_TOL, HEX_BAR)):
        out = {}
        for dev in (DEVICE, "cpu"):
            proto, run = make(dev)
            proto["step"] = rec = StepRecorder(proto["step"])
            t = time.perf_counter()
            u, stats = run(proto, OGDEN_CPU_STEPS)
            if dev == DEVICE:
                torch.cuda.synchronize()
            out[dev] = (u.cpu(), stats, time.perf_counter() - t, describe(proto), rec.u)
        (u_c, st_c, t_c, d, us_c), (u_h, st_h, t_h, _, us_h) = out[DEVICE], out["cpu"]
        err = rel_err(u_c, u_h, u_h.abs().max())
        per_step = [rel_err(a, b, b.abs().max()) for a, b in zip(us_c, us_h)]
        rel = [s["res"] / s["res0"] for s in st_c + st_h]
        ok = err <= tol and max(rel) <= bar and u_c.dtype == u_h.dtype
        log(f"[ogden-cpu] {name} ({d}), {OGDEN_CPU_STEPS} steps, u {u_c.dtype}: card {t_c:.2f}s newton="
            f"{[s['newton'] for s in st_c]} cg={[s['cg'] for s in st_c]} | cpu {t_h:.2f}s newton="
            f"{[s['newton'] for s in st_h]} cg={[s['cg'] for s in st_h]} | u rel err {err:.2e} (tol "
            f"{tol:g}; after each step {' '.join(f'{e:.2e}' for e in per_step)}), max rel |R| {max(rel):.2e} "
            f"(bar {bar:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ogden-cpu: {name} card and CPU disagree")
    phase_ogden_cpu_strict()


def phase_ogden_cpu_strict():
    """[ogden-cpu]'s composite with every step solved to rtol 1e-8
    (``OGDEN_STRICT``) on the card and on the CPU: equal Newton counts, every
    step's relative residual <= 1e-8 and u after the last step to
    ``MIXED_CPU_TOL`` of its largest entry; u after every step is held to
    the same bar and printed (the first step's misses it on the H100,
    2.21e-05, with 6 Newton on both: at this contrast the residual does not
    bound u, and both packages' own mixed and f64 solves of that step end
    ~1e-5 apart, tests/test_torch_composite_precision.py)."""
    from dolfinx_materials_tpu_torch.demos import composite_hyperelasticity

    out = {}
    for dev in (DEVICE, "cpu"):
        proto = composite_hyperelasticity.make_protocol(OGDEN_CPU_CFG, n_steps=OGDEN_CPU_STEPS,
                                                        exx_max=0.02 * OGDEN_CPU_STEPS, device=dev, **OGDEN_STRICT)
        proto["step"] = rec = StepRecorder(proto["step"])
        t = time.perf_counter()
        _, stats = composite_hyperelasticity.run_steps(proto)
        if dev == DEVICE:
            torch.cuda.synchronize()
        out[dev] = (rec.u, stats, time.perf_counter() - t)
    (us_c, st_c, t_c), (us_h, st_h, t_h) = out[DEVICE], out["cpu"]
    per_step = [rel_err(a, b, b.abs().max()) for a, b in zip(us_c, us_h)]
    rel = [s["res"] / s["res0"] for s in st_c + st_h]
    newton = ([s["newton"] for s in st_c], [s["newton"] for s in st_h])
    every_step = max(per_step) <= MIXED_CPU_TOL
    ok = per_step[-1] <= MIXED_CPU_TOL and newton[0] == newton[1] and max(rel) <= OGDEN_STRICT["rtol"]
    log(f"[ogden-cpu] composite {OGDEN_CPU_CFG}, {OGDEN_CPU_STEPS} steps each solved to rtol "
        f"{OGDEN_STRICT['rtol']:g} ({OGDEN_STRICT['n_newton']} Newton x {OGDEN_STRICT['n_cg']} CG, cg_rtol "
        f"{OGDEN_STRICT['cg_rtol']:g}): card {t_c:.2f}s newton={newton[0]} cg={[s['cg'] for s in st_c]} | cpu "
        f"{t_h:.2f}s newton={newton[1]} cg={[s['cg'] for s in st_h]} | u rel err after each step "
        f"{' '.join(f'{e:.2e}' for e in per_step)} (tol {MIXED_CPU_TOL:g}: after every step "
        f"{'met' if every_step else 'missed, as the precision spread of both packages allows'}), max rel |R| {max(rel):.2e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ogden-cpu: the composite solved to rtol 1e-8: Newton counts, a residual or the last "
                             "step's u card against CPU")


# ------------------------------------------------------------------ phase 14
def user_law(p):
    """A hardening law with no closed form in the kernels: it runs there as a
    law program (tests/test_torch_cuda.py's user_law)."""
    return 350.0 + 2e3 * p + 50.0 * torch.tanh(100.0 * p)


def voce_lambda(p):
    """The Voce law of [j2] written as a plain callable: a law program."""
    return SIG0 + (SIGU - SIG0) * (1.0 - torch.exp(-B_VOCE * p))


def phase_law():
    """[law]: both J2 kernels running a law program (ops/law_program.py) at
    2^21 points, f32 and f64, both layouts, j2_fast contract, against the
    plain return map driven by the same program, within [j2]'s tolerances;
    the Voce lambda also against the built-in LAW_VOCE kernel; call, device
    and host times of each beside the built-in Voce kernel's. Returns the
    worst f64 error of each kernel and the f64 point-major timings of each
    law."""
    from dolfinx_materials_tpu_torch.models import LinearElasticIsotropic, VoceHardening
    from dolfinx_materials_tpu_torch.ops import j2_cuda
    from dolfinx_materials_tpu_torch.ops.law_program import LAW_PROGRAM, trace_law

    t0 = time.perf_counter()
    el = LinearElasticIsotropic(E, NU)
    voce = VoceHardening(SIG0, SIGU, B_VOCE)
    laws = {"voce_builtin": voce, "voce_lambda": voce_lambda, "user_law": user_law}
    c = j2_cuda.J2_FAST_CONTRACT
    base = j2_inputs(J2_N, 7, DEVICE)
    worst = {"full": 0.0, "factored": 0.0}
    timed = {}
    for dtype in (torch.float32, torch.float64):
        builtin = {}
        for lname, law in laws.items():
            program = None if lname == "voce_builtin" else trace_law(law)
            # the same inputs for both Voce forms: off the yield surface of the closed form
            eps = off_yield_surface(*base, el, voce if lname.startswith("voce") else law)
            layouts = {"feature": feature_major(eps, base[1], base[2], dtype),
                       "point": point_major(eps, base[1], base[2], dtype)}
            del eps
            for kname in ("full", "factored"):
                factored = kname == "factored"
                launch = j2_cuda.J2Launch(el, law, factored=factored, **c)
                if (launch.law_id == LAW_PROGRAM) != (program is not None):
                    raise AssertionError(f"[law] {lname}: law id {launch.law_id}")
                for layout, args in layouts.items():
                    fm = layout == "feature"
                    out = launch(*args, feature_major=fm)
                    ref = launch.plain(*args, el, program or law, feature_major=fm, **c)
                    torch.cuda.synchronize()
                    errs = j2_errors(out, ref, dtype)
                    if dtype == torch.float64:
                        worst[kname] = max(worst[kname], max(float((o - r).abs().max()) for o, r in zip(out, ref)))
                    del ref
                    if lname == "voce_builtin":
                        builtin[(kname, layout)] = out
                    elif lname == "voce_lambda":
                        vs = j2_errors(out, builtin[(kname, layout)], dtype)
                        errs.update({f"vs_builtin_{k}": v for k, v in vs.items()})
                    tol = J2_TOL[dtype]
                    ok = all(v <= tol[k.replace("vs_builtin_", "")] for k, v in errs.items())

                    def call():
                        return launch(*args, feature_major=fm)

                    n_ins = 0 if program is None else len(program.code)
                    row = dict(
                        ms=cuda_ms(call), device_ms=graph_ms(call, n=J2_GRAPH), host_us=host_us(call, n=J2_HOST),
                        plain_ms=cuda_ms(lambda: launch.plain(*args, el, program or law, feature_major=fm, **c),
                                         reps=3),
                        bound=bound_ms(j2_bytes(J2_N, dtype, factored),
                                       j2_ops_per_point(c["n_iter"], factored, 3 * n_ins or 10) * J2_N, dtype),
                        instructions=n_ins,
                    )
                    log(f"[law] {kname:8s} {str(dtype)[6:]:8s} {lname:12s} {layout:7s} instructions={n_ins} err "
                        + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                        + f" call_ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} host_us={row['host_us']:.1f}"
                        f" bound_ms={row['bound'][0]:.4f} ({row['bound'][1]}) plain_ms={row['plain_ms']:.3f} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"[law] J2 {kname} kernel with {lname} disagrees: {dtype} {layout}")
                    if dtype == torch.float64 and layout == "point":
                        timed[(kname, lname)] = row
                    del out
            del layouts
        del builtin
    for kname in ("full", "factored"):
        b = timed[(kname, "voce_builtin")]["device_ms"]
        log(f"[law] {kname} f64 point-major device ms: builtin Voce {b:.4f}, "
            + ", ".join(f"{ln} {timed[(kname, ln)]['device_ms']:.4f} ({timed[(kname, ln)]['device_ms'] / b:.2f}x)"
                        for ln in ("voce_lambda", "user_law")))
    log(f"[law] {time.perf_counter() - t0:.1f}s")
    return worst, timed


# ------------------------------------------------------------------ phase 15
DEMO_N = 24  # the plane demo's default: 24 x 48 Q2 quads, 10,368 Gauss points
DEMO_SMALL_N = 6
DEMO_CYLINDER_N = 6
DEMO_TOL = 1e-8  # card against CPU: reaction forces and max p, relative
DEMO_CG_TOL = 1e-10  # project_on("p", ("CG", 1)) card against CPU, of its scale


def read_vtk_cell_scalar(path, name):
    """One cell scalar of a legacy ASCII VTK file (fem/io.py write_vtk)."""
    lines = open(path).read().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("CELL_DATA")).split()[1])
    k = lines.index(f"SCALARS {name} double 1") + 2
    return np.array([float(v) for v in lines[k:k + n]])


def phase_demo():
    """[demo]: the README's plane demo twin (demos/plane_elastoplasticity.py)
    at its default N = 24 on the card, counting K1/K3/K4 launches (each must
    be non-zero), its VTK read back; the same twin at N = 6 on the card and
    the CPU (the same accepted steps, forces and max p to 1e-8), and
    project_on("p", ("CG", 1)) of one p field on the card and on the CPU to
    1e-10; the curved-cylinder twin at N = 6 on both, its Lame errors on the
    card bounded by the CPU's. Returns the N = 24 run's launch counts."""
    import os
    import tempfile

    from dolfinx_materials_tpu_torch.demos import curved_cylinder, plane_elastoplasticity

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t = time.perf_counter()
        full = plane_elastoplasticity.main(DEMO_N, device=DEVICE, out_dir=tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        qmap = full["qmap"]
        p_vtk = read_vtk_cell_scalar(os.path.join(tmp, "plane_elastoplasticity.vtk"), "p")
        p_cells = qmap.project_on("p", ("DG", 0)).ravel()
        vtk_err = float(np.abs(p_vtk - p_cells).max() / np.abs(p_cells).max())  # written with 10 digits
        ok = (counts["j2_radial_return"] > 0 and counts["banded_take_ell"] > 0 and counts["banded_take_csr"] > 0
              and qmap.domain.banded_active and abs(full["steps"][-1] - 6 * SIG0 / E * LY) < 1e-12
              and len(p_vtk) == qmap.domain.ne and vtk_err <= 1e-9 and full["max_p"] > 0)
        log(f"[demo] plane N={DEMO_N}: {qmap.num_points} Gauss points, {qmap.space.num_dofs} dofs, "
            f"{len(full['steps'])} steps in {wall:.2f}s, max p {full['max_p']:.6e}, last force "
            f"{full['forces'][-1]:.6e}; launches {counts}; VTK read back err {vtk_err:.1e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[demo] plane demo at full size: load program, VTK or launch counts wrong")
        small = {}
        for dev in (DEVICE, "cpu"):
            t = time.perf_counter()
            small[dev] = plane_elastoplasticity.main(DEMO_SMALL_N, device=dev, out_dir=tmp)
            small[dev]["seconds"] = time.perf_counter() - t
    card, cpu = small[DEVICE], small["cpu"]
    f_err = rel_err(torch.tensor(card["forces"]), torch.tensor(cpu["forces"]), max(abs(f) for f in cpu["forces"]))
    p_err = abs(card["max_p"] - cpu["max_p"]) / cpu["max_p"]
    # one p field projected on both: the card run's, copied into the CPU map
    p_card = card["qmap"].material.data_manager.s1["p"]
    cpu["qmap"].material.data_manager.s1["p"] = p_card.cpu()
    space, cg_card = card["qmap"].project_on("p", ("CG", 1))
    _, cg_cpu = cpu["qmap"].project_on("p", ("CG", 1))
    cg_err = float(np.abs(cg_card - cg_cpu).max() / np.abs(cg_cpu).max())
    ok = (card["steps"] == cpu["steps"] and f_err <= DEMO_TOL and p_err <= DEMO_TOL and cg_err <= DEMO_CG_TOL
          and cg_card.shape == (space.num_dofs, 1))
    log(f"[demo] plane N={DEMO_SMALL_N}: card {card['seconds']:.2f}s, cpu {cpu['seconds']:.2f}s, steps "
        f"{card['steps'] == cpu['steps']} ({len(cpu['steps'])}), forces rel err {f_err:.2e}, max p rel err "
        f"{p_err:.2e} (tol {DEMO_TOL:g}); project_on p CG1 card vs cpu {cg_err:.2e} (tol {DEMO_CG_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[demo] plane demo: card and CPU disagree")
    errs = {}
    for dev in (DEVICE, "cpu"):
        t = time.perf_counter()
        errs[dev] = curved_cylinder.main(DEMO_CYLINDER_N, device=dev)
        errs[dev]["seconds"] = time.perf_counter() - t
    ok = all(errs[DEVICE][k] <= errs["cpu"][k] * (1 + DEMO_TOL) for k in ("straight", "curved")) \
        and errs["cpu"]["curved"] < errs["cpu"]["straight"]
    log(f"[demo] curved_cylinder N={DEMO_CYLINDER_N}: Lame max rel err card straight "
        f"{errs[DEVICE]['straight']:.6e} curved {errs[DEVICE]['curved']:.6e} ({errs[DEVICE]['seconds']:.2f}s) | cpu "
        f"straight {errs['cpu']['straight']:.6e} curved {errs['cpu']['curved']:.6e} ({errs['cpu']['seconds']:.2f}s) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[demo] curved cylinder: card errors above the CPU's")
    log(f"[demo] {time.perf_counter() - t0:.1f}s")
    return counts


# ------------------------------------------------------------------ phases 16-18
#: [fefp]: bench.py's FeFp batch (131,072 points, F = I + 2e-2 N(0, 1) from
#: default_rng(1), identity state) and the bar of the finite-strain demo on
#: P2 tets (N = 8: 9,216 tets, 129,024 Gauss points, 42,483 dofs)
FEFP_N, FEFP_BAR_N, FEFP_BAR_CPU_N = 1 << 17, 8, 2
#: card against CPU on the same inputs: f64 to 1e-10 of each field's largest
#: magnitude; f32 to 1e-4 of it: f32 rounds at 6e-8, and the series log, the
#: 16-step radial return and the 81-wide tangent (differences of O(E) terms
#: through the log's jvp) each take the difference between two orders of
#: rounding up by a few hundred at most
FEFP_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
FEFP_BAR_TOL = 1e-8  # N = 2 bar, card against CPU: u and max p, relative
#: the bar's load program, cut in depth: the first 2 of solve_adaptive's 10
#: increments (to 1 % elongation; the whole program to 5 %, the demo twin's
#: ``8 tet`` run, took 258.9 s on an H100 with 16 cut-backs and 338,044 CG
#: iterations, PERF.md)
FEFP_NSTEPS0, FEFP_BAR_STEPS = 10, 2
#: [crystal]: bench.py's crystal batch (16,384 points, eps = 2e-3 N(0, 1)
#: from default_rng(2)), 2 chained updates at dt = 1e-2
CRYSTAL_N, CRYSTAL_DT, CRYSTAL_STEPS = 1 << 14, 1e-2, 2
CRYSTAL_TOL, CRYSTAL_CT_TOL = 1e-9, 1e-8  # f64, of each field's scale
#: f32 on the card against the f64 CPU run, of each field's scale: the f32
#: Newton stops on steps of 3e-6; an f32 chain on a 256-point batch stays
#: within 9.4e-6 of the f64 one (the tangent; the stress 4.2e-7), and the f32
#: card run within 1.1e-5 of the f32 CPU run at 16,384 points (an H100)
CRYSTAL_F32_TOL = 1e-4
#: [families]: card against CPU at the smoke sizes
FAMILY_TOL, CONIC_TOL, NN_TOL, FIT_TOL = 1e-8, 1e-10, 1e-6, 1e-8
FIT_STEPS = 25  # Adam steps of fit_parameters, on card and CPU


def kernel_events(fn):
    """``(kernels, device ops)`` of one ``fn()`` under torch.profiler: the
    kernels the card ran, and all its device events (kernels, copies and
    sets)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset", "[memory]"))]
    return len(kernels), len(dev)


def field_errors(got, want, names):
    """Each field's max |card - CPU| over its largest CPU magnitude."""
    return {n: rel_err(g.cpu().to(w.dtype), w, max(float(w.abs().max()), 1e-300)) for n, g, w in zip(names, got, want)}


def fefp_batch(dtype, device):
    rng = np.random.default_rng(1)
    F = np.tile(np.eye(3), (FEFP_N, 1, 1)) + 2e-2 * rng.standard_normal((FEFP_N, 3, 3))
    Fv = F.reshape(FEFP_N, 9)[:, [0, 4, 8, 1, 3, 2, 6, 5, 7]]
    state = {"be": np.tile([1.0, 1, 1, 0, 0, 0], (FEFP_N, 1)), "p": np.zeros(FEFP_N),
             "F_prev": np.tile([1.0, 1, 1, 0, 0, 0, 0, 0, 0], (FEFP_N, 1))}
    like = dict(dtype=dtype, device=device)
    return torch.tensor(Fv, **like), {k: torch.tensor(v, **like) for k, v in state.items()}


def phase_fefp_point():
    """[fefp] (a): FeFp's whole-batch update (both tangent modes) and its
    flux-only update at bench.py's batch, f64 and f32, card against the CPU
    port on the same inputs; warm ms and the launches of each update."""
    from dolfinx_materials_tpu_torch import models

    beh = models.FeFpJ2Plasticity(models.LinearElasticIsotropic(70e3, 0.3), models.VoceHardening(350.0, 500.0, 1e3))
    names = ("PK1", "Ct", "be", "p")
    for dtype in (torch.float64, torch.float32):
        Fc, sc = fefp_batch(dtype, DEVICE)
        Fh, sh = fefp_batch(dtype, "cpu")
        for mode in ("analytic", "jvp", "flux"):
            if mode == "flux":
                call = lambda F, s: beh.batched_flux(F, s, 0.0)  # noqa: E731
                pick = lambda out: (out[0], out[1]["be"], out[1]["p"])  # noqa: E731
                fields = ("PK1", "be", "p")
            else:
                beh.tangent_mode = mode
                call = lambda F, s: beh.batched_update(F, s, 0.0)  # noqa: E731
                pick = lambda out: (out[0], out[1], out[2]["be"], out[2]["p"])  # noqa: E731
                fields = names
            t = time.perf_counter()
            want = pick(call(Fh, sh))
            cpu_s = time.perf_counter() - t
            got = pick(call(Fc, sc))
            ms = cuda_ms(lambda: call(Fc, sc), reps=5, warmup=1)
            kernels, ops = kernel_events(lambda: call(Fc, sc))
            errs = field_errors(got, want, fields)
            plastic = float((want[-1] > 0).double().mean())
            ok = all(bool(torch.isfinite(g).all()) for g in got) and max(errs.values()) <= FEFP_TOL[dtype] \
                and plastic > 0
            log(f"[fefp] point {FEFP_N} {str(dtype).split('.')[1]} {mode}: warm {ms:.3f} ms/update on the card "
                f"(CPU port {1e3 * cpu_s:.1f} ms), {kernels} kernels ({ops} device ops) per update by torch.profiler; "
                f"plastic share {plastic:.3f}; card vs CPU {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} "
                f"(tol {FEFP_TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[fefp] {dtype} {mode}: card and CPU disagree or the batch is not plastic")


def fefp_bar(N, device):
    """The bar on P2 tets, its first iterate lifted to the uniform stretch of
    the first of ``solve_adaptive``'s 10 increments."""
    from dolfinx_materials_tpu_torch.demos import finite_strain_elastoplasticity as demo

    proto = demo.build(N, "tetrahedron", device=device)
    V = proto["V"]
    u = np.zeros((V.num_nodes, 3))
    u[:, 0] = demo.STRETCH / FEFP_NSTEPS0 * V.node_coords[:, 0]
    proto["problem"].u.x = u.reshape(-1)
    return proto, demo


def phase_fefp_bar():
    """[fefp] (b): the finite-strain demo's bar on P2 tets at N = 8 through
    solve_adaptive from 10 initial increments, f64, the default Krylov
    options, cut to its first ``FEFP_BAR_STEPS`` increments (to 1 %
    elongation, into the plastic range) from a lifted first iterate; (c):
    the same protocol at N = 2 on the card and the CPU. Returns the K3/K4
    launches of the N = 8 run."""
    from dolfinx_materials_tpu_torch.utils.timers import reset_timings, timing

    t0 = time.perf_counter()
    proto, demo = fefp_bar(FEFP_BAR_N, DEVICE)
    qmap, V = proto["qmap"], proto["V"]
    qmap.update(proto["problem"].u.x)  # the first update, outside the timed run
    torch.cuda.synchronize()
    log(f"[fefp] bar N={FEFP_BAR_N}: {qmap.domain.ne} P2 tets, {qmap.num_points} Gauss points, {V.num_dofs} dofs, "
        f"banded plans {sorted(k for k, v in (qmap.domain._banded or {}).items() if v is not None)}; first "
        f"{FEFP_BAR_STEPS} of {FEFP_NSTEPS0} increments, lifted first iterate; set-up {time.perf_counter() - t0:.2f}s")
    reset_timings()
    reset_counts()
    t = time.perf_counter()
    steps = demo.run(proto, nsteps0=FEFP_NSTEPS0, n_steps=FEFP_BAR_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    cut = proto["cutbacks"]
    newton = sum(s["newton"] for s in steps + cut)
    n_cg = sum(s["cg"] for s in steps + cut)
    newton_s = timing("solver: Newton solve")[1]
    split = {k: timing(f"solver: {k}")[1] for k in ("constitutive update", "jacobian assembly", "linear solve")}
    split["residual and line search"] = newton_s - sum(split.values())
    p = qmap.field_array("p").reshape(-1)
    for s in steps:
        log(f"[fefp]   load {s['load']:.6g}: newton={s['newton']} cg={s['cg']} wall_s={s['seconds']:.3f}")
    target = demo.STRETCH * demo.L * FEFP_BAR_STEPS / FEFP_NSTEPS0
    ok = (abs(steps[-1]["load"] - target) < 1e-12 and float(p.max()) > 0
          and all(counts[k] > 0 for k in TAKES) and bool(np.isfinite(steps[-1]["u"]).all()))
    log(f"[fefp] bar N={FEFP_BAR_N}: {len(steps)} steps accepted, {len(cut)} cut back, newton={newton} cg={n_cg}, "
        f"warm wall {wall:.2f}s; max p {float(p.max()):.6e}; time split: "
        + ", ".join(f"{k} {v:.2f}s ({100 * v / newton_s:.1f}%)" for k, v in split.items())
        + f"; {1e3 * split['linear solve'] / max(n_cg, 1):.3f} ms per CG iteration; launches {counts} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[fefp] bar: load program, plasticity or K3/K4 launches wrong")
    del proto, qmap

    runs = {}
    for dev in (DEVICE, "cpu"):
        proto, demo = fefp_bar(FEFP_BAR_CPU_N, dev)
        t = time.perf_counter()
        steps = demo.run(proto, nsteps0=FEFP_NSTEPS0, n_steps=FEFP_BAR_STEPS)
        runs[dev] = (steps, float(proto["qmap"].field_array("p").max()), time.perf_counter() - t)
    (sc, pc, tc), (sh, ph, th) = runs[DEVICE], runs["cpu"]
    same = [s["load"] for s in sc] == [s["load"] for s in sh]
    u_err = max(rel_err(torch.tensor(a["u"]), torch.tensor(b["u"]), np.abs(b["u"]).max()) for a, b in zip(sc, sh)) \
        if same else float("inf")
    p_err = abs(pc - ph) / ph
    ok = same and u_err <= FEFP_BAR_TOL and p_err <= FEFP_BAR_TOL and ph > 0
    log(f"[fefp] bar N={FEFP_BAR_CPU_N} card ({tc:.2f}s) vs CPU ({th:.2f}s): steps equal {same} ({len(sh)}), u rel "
        f"err {u_err:.2e}, max p rel err {p_err:.2e} (tol {FEFP_BAR_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[fefp] bar N=2: card and CPU disagree")
    return counts


def crystal_batch(dtype, device):
    rng = np.random.default_rng(2)
    eps = [2e-3 * rng.standard_normal((CRYSTAL_N, 6))]
    for _ in range(CRYSTAL_STEPS - 1):
        eps.append(eps[-1] + 1e-3 * rng.standard_normal((CRYSTAL_N, 6)))
    return [torch.tensor(e, dtype=dtype, device=device) for e in eps]


def crystal_chain(beh, eps, device, flux=False):
    """CRYSTAL_STEPS chained updates from the virgin state: per step
    ``(outputs, Newton iterations, seconds)``."""
    state = {k: torch.zeros((CRYSTAL_N,) + np.shape(v), dtype=eps[0].dtype, device=device)
             for k, v in beh.init_state().items()}
    out = []
    for e in eps:
        if device != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        res = beh.batched_flux(e, state, CRYSTAL_DT) if flux else beh.batched_update(e, state, CRYSTAL_DT)
        if device != "cpu":
            torch.cuda.synchronize()
        out.append((res, beh.last_newton_iters, time.perf_counter() - t))
        state = res[-1]
    return out


def phase_crystal():
    """[crystal]: the Meric-Cailletaud whole-batch update at bench.py's batch,
    2 chained steps at dt = 1e-2, f64 against the CPU port, f32 against that
    f64 CPU run, and the flux-only update; warm ms, launches and host reads
    per update."""
    from dolfinx_materials_tpu_torch import models

    beh = models.MericCailletaudCrystalPlasticity()
    t0 = time.perf_counter()
    t = time.perf_counter()
    want = crystal_chain(beh, crystal_batch(torch.float64, "cpu"), "cpu")
    log(f"[crystal] {CRYSTAL_N} points, CPU port f64 chain {time.perf_counter() - t:.1f}s")
    names = ("sig", "Ct", "eps_p", "g", "p", "a")
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[1]
        eps_c = crystal_batch(dtype, DEVICE)
        got = crystal_chain(beh, eps_c, DEVICE)
        for k, ((g, gi, gs), (w, wi, ws)) in enumerate(zip(got, want)):
            errs = field_errors([g[0], g[1]] + [g[2][n] for n in names[2:]],
                                [w[0], w[1]] + [w[2][n] for n in names[2:]], names)
            tol = {n: (CRYSTAL_CT_TOL if n == "Ct" else CRYSTAL_TOL) if dtype == torch.float64 else CRYSTAL_F32_TOL
                   for n in errs}
            ok = all(errs[n] <= tol[n] for n in errs) and all(bool(torch.isfinite(x).all()) for x in g[:2])
            log(f"[crystal] {tag} step {k + 1}: card {1e3 * gs:.2f} ms, {gi} Newton iterations = {gi} host reads "
                f"(CPU port f64: {wi} iterations, {1e3 * ws:.1f} ms); against the CPU f64 run "
                f"{', '.join(f'{n} {v:.2e}' for n, v in errs.items())} (tol {tol['sig']:g}) {'ok' if ok else 'FAIL'}")
            if dtype == torch.float64 and gi != wi:
                log(f"[crystal] f64 step {k + 1}: Newton counts differ, card {gi} vs CPU {wi}: the exit test "
                    f"compares the batch's largest step with 1e-12, and rounding decides the last iteration")
            if not ok:
                raise AssertionError(f"[crystal] {tag} step {k + 1}: card and CPU disagree")
        state = got[0][0][2]
        kernels, ops = kernel_events(lambda: beh.batched_update(eps_c[1], state, CRYSTAL_DT))
        its = beh.last_newton_iters
        flux = crystal_chain(beh, eps_c, DEVICE, flux=True)
        f_err = max(rel_err(f[0][0], g[0][0], float(g[0][0].abs().max())) for f, g in zip(flux, got))
        ok = f_err == 0.0  # the same Newton, less the tangent
        log(f"[crystal] {tag}: one update (step 2, {its} iterations) {kernels} kernels ({ops} device ops), "
            f"{kernels / max(its, 1):.0f} per iteration; flux-only "
            f"{', '.join(f'{1e3 * s:.2f}' for _, _, s in flux)} ms per step, stress against the full update "
            f"{f_err:.1e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[crystal] flux-only update disagrees with the full update")
    log(f"[crystal] {time.perf_counter() - t0:.1f}s")


def phase_families():
    """[families]: the five families' demo twins on the card at the JAX
    demos' defaults (nn_surrogate: 1,000 steps), each held against the same
    twin on the CPU at its smoke size; then fit_parameters for 25 Adam steps
    on the Voce path of tests/test_calibration.py, card against CPU."""
    import tempfile

    from dolfinx_materials_tpu_torch import calibration, models
    from dolfinx_materials_tpu_torch.demos import (conic_return_mapping, finite_strain_elastoplasticity,
                                                   heat_transfer, nn_surrogate, thermomechanics)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def timed(fn, *a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        fs, s1 = timed(finite_strain_elastoplasticity.main, 4, device=DEVICE, out_dir=tmp)
        st, s2 = timed(heat_transfer.stationary, 40, device=DEVICE)
        ph, s3 = timed(heat_transfer.phase_change, 60, 15, device=DEVICE, out_dir=tmp)
        tm, s4 = timed(thermomechanics.main, 16, device=DEVICE, out_dir=tmp)
        cn, s5 = timed(conic_return_mapping.main, 16, device=DEVICE, out_dir=tmp)
        nn, s6 = timed(nn_surrogate.main, 1000, device=DEVICE)
        ok = (abs(fs["steps"][-1] - 0.15) < 1e-12 and fs["max_p"] > 0 and st["flux_err"] < 1e-3
              and ph["fronts"][-1] > 0 and bool((np.diff(ph["fronts"]) >= 0).all()) and tm["stress"][:, 0].min() < 0
              and nn["history"][-1] < 1e-2 * nn["history"][0])
        log(f"[families] card at the demos' defaults: finite_strain N=4 {len(fs['steps'])} steps max p "
            f"{fs['max_p']:.6f} ({s1:.2f}s); heat stationary nx=40 flux err {st['flux_err']:.3e} ({s2:.2f}s); phase "
            f"change nx=60 15 steps front {ph['fronts'][-1]:.6f} ({s3:.2f}s); thermomechanics N=16 min sxx "
            f"{tm['stress'][:, 0].min():.4f} ({s4:.2f}s); conic n_dirs=16 ({s5:.2f}s); nn_surrogate 1000 steps loss "
            f"{nn['history'][0]:.3e} -> {nn['history'][-1]:.3e}, u err {nn['err']:.3e} ({s6:.2f}s) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[families] a demo twin on the card gave a wrong result")

        small = {}
        for dev in (DEVICE, "cpu"):
            small[dev] = dict(st=heat_transfer.stationary(16, device=dev),
                              ph=heat_transfer.phase_change(24, 4, device=dev, out_dir=tmp),
                              tm=thermomechanics.main(6, device=dev, out_dir=tmp),
                              cn=conic_return_mapping.main(6, device=dev, out_dir=tmp),
                              nn=nn_surrogate.main(200, device=dev))
    c, h = small[DEVICE], small["cpu"]
    errs = {
        "stationary flux err (card - cpu)": c["st"]["flux_err"] - h["st"]["flux_err"],
        "phase change T": rel_err(torch.tensor(c["ph"]["T"]), torch.tensor(h["ph"]["T"]), np.abs(h["ph"]["T"]).max()),
        "phase change fronts": float(np.abs(np.subtract(c["ph"]["fronts"], h["ph"]["fronts"])).max()),
        "thermomechanics stress": rel_err(torch.tensor(c["tm"]["stress"]), torch.tensor(h["tm"]["stress"]),
                                          np.abs(h["tm"]["stress"]).max()),
        "conic": max(float(np.abs(c["cn"][k] - h["cn"][k]).max()) for k in h["cn"]) / 30.0,
        "nn loss history": float(np.abs(np.array(c["nn"]["history"]) / np.array(h["nn"]["history"]) - 1).max()),
    }
    ok = (c["st"]["flux_err"] <= h["st"]["flux_err"] * (1 + FAMILY_TOL) and errs["phase change T"] <= FAMILY_TOL
          and errs["phase change fronts"] == 0.0 and errs["thermomechanics stress"] <= FAMILY_TOL
          and errs["conic"] <= CONIC_TOL and errs["nn loss history"] <= NN_TOL)
    log(f"[families] card vs CPU at the smoke sizes: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol heat/thermo {FAMILY_TOL:g}, conic {CONIC_TOL:g} of fc, nn {NN_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[families] card and CPU twins disagree")

    E_, nu_, true = 70e3, 0.3, dict(sig0=350.0, sigu=500.0, b=1e3)

    def factory(th):
        return models.vonMisesIsotropicHardening(models.LinearElasticIsotropic(E_, nu_), models.VoceHardening(
            true["sig0"] * torch.exp(th["ls0"]), true["sigu"] * torch.exp(th["lsu"]), true["b"] * torch.exp(th["lb"])))

    # the 10-step Voce path of tests/test_calibration.py's gradient test (its
    # recovery test's 40-step path costs 4x: autograd through 40 updates a loss)
    path = np.zeros((10, 6))
    path[:, 0] = np.linspace(0, 4 * 350.0 / 70e3, 11)[1:]
    zero = {k: torch.tensor(0.0, dtype=torch.float64) for k in ("ls0", "lsu", "lb")}
    target = calibration.make_path_simulator(factory, zero)(zero, torch.tensor(path)).numpy()
    theta0 = {"ls0": np.log(0.8), "lsu": np.log(1.25), "lb": np.log(0.6)}
    fits = {}
    for dev in (DEVICE, "cpu"):
        t = time.perf_counter()
        fits[dev] = calibration.fit_parameters(factory, theta0, path, target, steps=FIT_STEPS, learning_rate=0.05,
                                               device=dev) + (time.perf_counter() - t,)
    (pc, hc, tc), (ph_, hh, th_) = fits[DEVICE], fits["cpu"]
    h_err = float(np.abs(np.array(hc) / np.array(hh) - 1).max())
    ok = h_err <= FIT_TOL and hc[-1] < 0.1 * hc[0]
    names = {"ls0": "sig0", "lsu": "sigu", "lb": "b"}
    fitted = {names[k]: round(true[names[k]] * float(torch.exp(v)), 4) for k, v in pc.items()}
    log(f"[families] fit_parameters {FIT_STEPS} Adam steps: card {tc:.2f}s, CPU {th_:.2f}s; loss {hc[0]:.3e} -> {hc[-1]:.3e}; "
        f"history card vs CPU {h_err:.2e} (tol {FIT_TOL:g}); fitted {fitted} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[families] fit_parameters: card and CPU disagree or the loss did not fall")
    log(f"[families] {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------------ phase 19
#: [blocked] (c): the interface problem at the main plate's width (a 256 x 128
#: P2 parent, degree-4 quadrature: 32,768 cells, 294,912 Gauss points), and
#: at 64 x 32 its checks against the host LU solve on the card and against
#: the same step on the CPU. The demo's
#: traction is replaced by a pull of the inclusion's right edge (the fused
#: step, as the JAX one, takes its load through the Dirichlet values), from
#: the uniform stretch; the JAX step's defaults otherwise (two-level, 8
#: coordinate boxes a dimension a field, cg_rtol 1e-8), with a BiCGStab budget
#: the fine grid needs
BLOCKED_NX, BLOCKED_CHECK_NX, BLOCKED_PULL = 256, 64, 1.5e-2
BLOCKED_OPTS = dict(n_newton=12, n_cg=8000)
BLOCKED_WINDOW_CG = 200  # the BiCGStab iterations of the profiled window
BLOCKED_WARM_CG = 50  # the warm-up's BiCGStab budget (one Newton iteration)
BLOCKED_TAKE_TOL = 1e-13  # a field's full-width plans against the plain take, f64 ([take]'s)
#: (b): the stiff thermo-mechanical coupling of tests/test_blocked.py at N = 6,
#: with solve_coupled cut to 20 outer iterations (it needs 217 at its
#: default rtol on the CPU: the point of the monolithic solve)
BLOCKED_THERMO_N, BLOCKED_GS_OUTER = 6, 20
BLOCKED_TOL = 1e-8  # card against CPU, of each field's scale
BLOCKED_CHECK_TOL = 1e-5  # the fused step against the host LU solve (test_blocked_step_interface)
#: (c) at 64 x 32: the card's BiCGStab count against the CPU's (their dots and
#: batched products round in another order, and the stopping test at 1e-8
#: of |b| meets that rounding)
BLOCKED_CG_SPREAD = 0.05
BLOCKED_STEP_TOL = 1e-6  # (b): the fused step against the host LU solve (test_blocked_step_thermomechanical)


def blocked_step(blocked, z0, **opts):
    """One fused blocked step from ``z0`` (BC values put in):
    ``(z, |R|, states, step)``."""
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_blocked_step

    dev = blocked.device
    step, pad = make_sharded_blocked_step(blocked, device_mesh(1, devices=[dev]), **opts)
    mask, vals = blocked._masks()
    z0 = torch.where(mask, vals, torch.as_tensor(z0, dtype=vals.dtype, device=dev))
    states = pad([q.material.data_manager.s0.internal for p in blocked.problems for q in p.qmaps])
    z, states, rn = step(z0, states, mask, vals, 0.0)
    return z, float(rn), states, step


def blocked_thermo_three_ways(device):
    """(b) on one device: the host LU solve, the fused step and
    solve_coupled. Returns their results and Newton / outer counts."""
    from dolfinx_materials_tpu_torch import BlockedNonlinearProblem, solve_coupled
    from dolfinx_materials_tpu_torch.demos.blocked_thermomechanics import build

    heat, mech, qT, qu, coups = build(BLOCKED_THERMO_N, device)
    lu = BlockedNonlinearProblem([heat, mech], coups, options={"ksp_type": "lu"})
    ok, its = lu.solve()
    if not ok:
        raise AssertionError(f"[blocked] the stiff coupling's LU solve did not converge on {device}")
    z_lu = np.concatenate([heat.u.x, mech.u.x])

    heat, mech, qT, qu, coups = build(BLOCKED_THERMO_N, device)
    z0 = np.concatenate([heat.u.x, mech.u.x])
    z, rn, _, step = blocked_step(BlockedNonlinearProblem([heat, mech], coups), z0, n_newton=16, n_cg=400)

    heat, mech, qT, qu, coups = build(BLOCKED_THERMO_N, device)
    ev = qu.domain.make_eval(coups[1][5])

    def push_T():
        qu.material.update_external_state_variable(
            "Temperature", qT._eval_fns["Temperature"](torch.as_tensor(heat.u.x, device=device)))

    def push_ev():
        qT.material.update_external_state_variable("VolStrain", ev(torch.as_tensor(mech.u.x, device=device)))

    ok_gs, n_gs = solve_coupled([heat, mech], [push_ev, push_T], max_outer=BLOCKED_GS_OUTER)
    return dict(lu=z_lu, lu_its=its, step=z.cpu().numpy(), step_rn=rn, step_info=dict(step.info),
                gs=np.concatenate([heat.u.x, mech.u.x]), gs_ok=ok_gs, gs_outer=n_gs)


def phase_blocked():
    """[blocked]: (a) the multimaterial demo twin at the JAX demo's size on
    the card and the CPU; (b) the stiff thermo-mechanical coupling three ways
    (host LU, fused step, solve_coupled) on both; (c) the interface problem at
    the main plate's width through the fused blocked step, its launches,
    times and device-busy share, and at 64 x 32 against the host LU solve
    on the card and against the CPU. Returns the K1/K3/K4 launches of (a)'s card solve and
    (c)'s timed step, and (c)'s 64 x 32 card run ([dist] (c)'s reference)."""
    from dolfinx_materials_tpu_torch.demos import multimaterial_interface as mmi
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg
    from dolfinx_materials_tpu_torch.parallel import blocked as blocked_mod
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_blocked_step

    t0 = time.perf_counter()
    # (a) the demo twin, 20 x 10 P1, host LU
    t = time.perf_counter()
    res = {}
    for dev in (DEVICE, "cpu"):
        b = mmi.build(device=dev)
        reset_counts()
        t = time.perf_counter()
        ok, its = b["blocked"].solve()
        if dev != "cpu":
            torch.cuda.synchronize()
        counts = read_counts()
        (p_m, p_i), (mat_m, mat_i) = b["problems"], b["materials"]
        res[dev] = dict(ok=ok, its=its, s=time.perf_counter() - t, counts=counts,
                        u=np.concatenate([p_m.u.x, p_i.u.x]),
                        p=[float(m.data_manager.s0["p"].max()) for m in (mat_m, mat_i)],
                        jump=b["interface"].jump(p_m.u.x, p_i.u.x).numpy())
    c, h = res[DEVICE], res["cpu"]
    demo_counts = c["counts"]
    errs = dict(u=rel_err(torch.tensor(c["u"]), torch.tensor(h["u"]), np.abs(h["u"]).max()),
                p_max_m=abs(c["p"][0] - h["p"][0]) / h["p"][0], p_max_i=abs(c["p"][1] - h["p"][1]) / h["p"][1],
                jump=rel_err(torch.tensor(c["jump"]), torch.tensor(h["jump"]), np.abs(h["jump"]).max()))
    ok = (c["ok"] and h["ok"] and c["its"] == h["its"] and all(e <= BLOCKED_TOL for e in errs.values())
          and h["p"][0] > 1e-4 and demo_counts["j2_radial_return"] > 0 and demo_counts["banded_take_csr"] > 0)
    log(f"[blocked] (a) demo twin 20x10 P1: card newton={c['its']} ({c['s']:.2f}s) | cpu newton={h['its']} "
        f"({h['s']:.2f}s); p max matrix {h['p'][0]:.6f} inclusion {h['p'][1]:.6f}, jump_x mean "
        f"{h['jump'][..., 0].mean():.4e}; card vs CPU " + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {BLOCKED_TOL:g}); launches {demo_counts}; {time.perf_counter() - t:.1f}s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[blocked] (a) the demo twin: card and CPU disagree, or K1/K3 did not launch")

    # (b) the stiff coupling three ways
    t = time.perf_counter()
    th = {dev: blocked_thermo_three_ways(dev) for dev in (DEVICE, "cpu")}
    c, h = th[DEVICE], th["cpu"]
    scale = np.abs(h["lu"]).max()
    errs = {k: float(np.abs(c[k] - h[k]).max() / scale) for k in ("lu", "step", "gs")}
    e_step_lu = float(np.abs(c["step"] - c["lu"]).max() / scale)
    ok = (all(e <= BLOCKED_TOL for e in errs.values()) and c["lu_its"] == h["lu_its"]
          and c["step_info"]["newton"] == h["step_info"]["newton"] and c["gs_outer"] == h["gs_outer"]
          and c["gs_ok"] == h["gs_ok"] and e_step_lu <= BLOCKED_STEP_TOL and c["step_rn"] <= 1e-7 * E)
    log(f"[blocked] (b) stiff thermo-mechanics N={BLOCKED_THERMO_N}: host LU newton={c['lu_its']} (cpu "
        f"{h['lu_its']}); fused step newton={c['step_info']['newton']} bicgstab={c['step_info']['bicgstab']} (cpu "
        f"{h['step_info']['newton']}/{h['step_info']['bicgstab']}) |R|={c['step_rn']:.3e}, against host LU "
        f"{e_step_lu:.2e} (tol {BLOCKED_STEP_TOL:g}); solve_coupled converged={c['gs_ok']} after {c['gs_outer']} "
        f"outer iterations (cpu {h['gs_ok']}/{h['gs_outer']}, max {BLOCKED_GS_OUTER}); card vs CPU z: "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {BLOCKED_TOL:g}); {time.perf_counter() - t:.1f}s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[blocked] (b) the stiff coupling: card and CPU disagree, or the step misses the LU solve")

    # (c) at the main plate's width
    t = time.perf_counter()
    b = mmi.build(BLOCKED_NX, BLOCKED_NX // 2, 2, device=DEVICE, pull=BLOCKED_PULL)
    blocked = b["blocked"]
    npts = sum(q.num_points for q in b["qmaps"])
    chosen = [{k: bg_name(p) for k, p in q.domain._banded.items()} if q.domain.banded_active else None
              for q in b["qmaps"]]
    mask, vals = blocked._masks()
    z0 = torch.where(mask, vals, torch.as_tensor(b["start"], device=DEVICE))
    step, pad = make_sharded_blocked_step(blocked, device_mesh(1, devices=[DEVICE]), **BLOCKED_OPTS)
    states0 = pad([q.material.data_manager.s0.internal for q in b["qmaps"]])
    log(f"[blocked] (c) {BLOCKED_NX}x{BLOCKED_NX // 2} P2 parent: {len(b['qmaps'][0].cells)} + "
        f"{len(b['qmaps'][1].cells)} cells, {npts} Gauss points, {blocked.ndofs} dofs "
        f"({b['interface'].num_facets} interface facets), f64, {BLOCKED_OPTS}, pull {BLOCKED_PULL:g}; takes "
        f"{chosen}; set-up {time.perf_counter() - t:.2f}s")
    if not all(chosen):
        raise AssertionError("[blocked] (c) a field did not get its banded plans")
    bicg, solves = [0.0], []

    def timed_bicgstab(*a, **k):  # the BiCGStab solves' wall time
        if not solves:
            solves.append(a[:3])  # (Av, b, M) of the first solve
        torch.cuda.synchronize()
        tb = time.perf_counter()
        out = pbicgstab(*a, **k)
        torch.cuda.synchronize()
        bicg[0] += time.perf_counter() - tb
        return out

    pbicgstab = blocked_mod._pbicgstab
    # warm-up (first calls, the allocator's growth): one Newton iteration cut
    # to BLOCKED_WARM_CG BiCGStab iterations, not counted
    tw = time.perf_counter()
    warm, _ = make_sharded_blocked_step(blocked, device_mesh(1, devices=[DEVICE]),
                                        **dict(BLOCKED_OPTS, n_newton=1, n_cg=BLOCKED_WARM_CG))
    warm(z0, states0, mask, vals, 0.0)
    torch.cuda.synchronize()
    log(f"[blocked] (c) warm-up ({warm.info['bicgstab']} BiCGStab): {time.perf_counter() - tw:.2f}s")
    del warm
    reset_counts()
    blocked_mod._pbicgstab = timed_bicgstab
    try:
        torch.cuda.synchronize()
        tw = time.perf_counter()
        z, states, rn = step(z0, states0, mask, vals, 0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
    finally:
        blocked_mod._pbicgstab = pbicgstab
    full_counts = read_counts()
    info = step.info
    log(f"[blocked] (c) timed: newton={info['newton']} bicgstab={info['bicgstab']} "
        f"({info['bicgstab_per_newton']}) |R|={float(rn):.4e} (entering {info['residuals'][0]:.4e}) "
        f"wall_s={wall:.3f}, BiCGStab {bicg[0]:.3f} s = {1e3 * bicg[0] / max(info['bicgstab'], 1):.4f} ms "
        f"an iteration; launches {full_counts}")
    p = [float(st["p"].max()) for st in states]
    # each field's full-width plans against the plain take on a seeded f64
    # table (these launches are not counted: the counts were read above)
    g = torch.Generator(device=DEVICE).manual_seed(2)
    plan_errs = {}
    for fi, q in enumerate(b["qmaps"]):
        for key, plan in q.domain._banded.items():
            if plan is None:
                continue
            table = torch.randn(plan.n_src, generator=g, dtype=torch.float64, device=DEVICE)
            ref = bg.banded_take_reference(table, plan)
            for kname, fn in (("ell", bg.banded_take_ell), ("csr", bg.banded_take_csr)):
                plan_errs[f"{fi}.{key}.{kname}"] = rel_err(fn(table, plan), ref, ref.abs().max())
    ok_plans = bool(plan_errs) and all(e <= BLOCKED_TAKE_TOL for e in plan_errs.values())
    log(f"[blocked] (c) each field's plans (field.plan.kernel) against the plain take, f64: "
        + " ".join(f"{k} {v:.1e}" for k, v in plan_errs.items()) + f" (tol {BLOCKED_TAKE_TOL:g}) "
        f"{'ok' if ok_plans else 'FAIL'}")
    # device-busy share of the steady BiCGStab loop: a window of exactly
    # BLOCKED_WINDOW_CG iterations (tolerance 0) on the first Newton
    # iteration's operator and preconditioner, profiled device time over the
    # unprofiled wall time
    Av, rhs, M = solves[0]

    def window():
        return pbicgstab(Av, rhs, M, maxiter=BLOCKED_WINDOW_CG, tol=0.0)

    tp = time.perf_counter()
    n_win = window()[1]
    wall1 = seconds_per_call(window)
    busy = device_busy_ms(window)
    share = busy / (1e3 * wall1) if busy is not None else None
    tp = time.perf_counter() - tp
    ok = (ok_plans and float(rn) <= 1e-7 * E and full_counts["j2_radial_return"] > 0
          and full_counts["banded_take_ell"] > 0 and full_counts["banded_take_csr"] > 0 and min(p) > 0
          and bool(torch.isfinite(z).all()) and n_win == BLOCKED_WINDOW_CG)
    log(f"[blocked] (c) p max matrix {p[0]:.6f} inclusion {p[1]:.6f}; BiCGStab window of {n_win} iterations "
        f"{1e3 * wall1:.1f} ms = {1e3 * wall1 / max(n_win, 1):.4f} ms an iteration, "
        + (f"device busy {busy:.1f} ms, busy share {share:.3f}" if busy is not None
           else "device time not measured (the profiler recorded no device event)")
        + f" (measured and profiled in {tp:.1f}s); |R| <= 1e-7 E: {float(rn) <= 1e-7 * E} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[blocked] (c) full width: not converged, a plan disagrees with the plain take, or "
                             "K1/K3/K4 did not all launch")
    del b, blocked, step, states0, states, solves, Av, rhs, M
    # (c) at 64 x 32: the fused step on the card against the host LU solve
    # on the card, and against the same fused step on the CPU (both fields
    # on the banded route: K4 and K3 on per-field plans)
    t = time.perf_counter()
    check = {}
    for dev in (DEVICE, "cpu"):
        b = mmi.build(BLOCKED_CHECK_NX, BLOCKED_CHECK_NX // 2, 2, device=dev, pull=BLOCKED_PULL)
        if not all(q.domain.banded_active for q in b["qmaps"]):
            raise AssertionError(f"[blocked] (c) {BLOCKED_CHECK_NX}x{BLOCKED_CHECK_NX // 2}: a field did not get "
                                 f"its banded plans on {dev}")
        reset_counts()
        tc = time.perf_counter()
        z, rn, states, step = blocked_step(b["blocked"], b["start"], **BLOCKED_OPTS)
        if dev != "cpu":
            torch.cuda.synchronize()
        check[dev] = dict(b=b, z=z.cpu().numpy(), rn=rn, p=[st["p"].cpu().numpy() for st in states],
                          info=dict(step.info), counts=read_counts(), s=time.perf_counter() - tc)
    c, h = check[DEVICE], check["cpu"]
    blocked = c["b"]["blocked"]
    for p, part in zip(blocked.problems, np.split(c["b"]["start"], [blocked.sizes[0]])):
        p.u.x = part.copy()
    ok_lu, its_lu = blocked.solve(commit=False)
    z_lu = np.concatenate([p.u.x for p in blocked.problems])
    e_lu = float(np.abs(c["z"] - z_lu).max())
    errs = {"z": float(np.abs(c["z"] - h["z"]).max() / np.abs(h["z"]).max())}
    for i, (a, b_) in enumerate(zip(c["p"], h["p"])):
        errs[f"p{i}"] = float(np.abs(a - b_).max() / np.abs(b_).max())
    k_c, k_h = c["info"]["bicgstab"], h["info"]["bicgstab"]
    ok = (ok_lu and np.allclose(c["z"], z_lu, rtol=BLOCKED_CHECK_TOL, atol=1e-9) and max(c["rn"], h["rn"]) <= 1e-7 * E
          and c["info"]["newton"] == h["info"]["newton"] and abs(k_c - k_h) <= BLOCKED_CG_SPREAD * k_h
          and all(e <= BLOCKED_TOL for e in errs.values()) and min(x.max() for x in h["p"]) > 0
          and all(c["counts"][k] > 0 for k in ("j2_radial_return", "banded_take_ell", "banded_take_csr")))
    log(f"[blocked] (c) {BLOCKED_CHECK_NX}x{BLOCKED_CHECK_NX // 2} P2, {blocked.ndofs} dofs: fused step card "
        f"newton={c['info']['newton']} bicgstab={k_c} |R|={c['rn']:.3e} ({c['s']:.1f}s, launches {c['counts']}) | "
        f"cpu newton={h['info']['newton']} bicgstab={k_h} |R|={h['rn']:.3e} ({h['s']:.1f}s); card vs CPU "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {BLOCKED_TOL:g}, BiCGStab counts within "
        f"{BLOCKED_CG_SPREAD:.0%}); host LU on the card newton={its_lu}, max |z - z_lu| {e_lu:.3e} of |z| "
        f"{np.abs(z_lu).max():.3e} (rtol {BLOCKED_CHECK_TOL:g}); {time.perf_counter() - t:.1f}s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[blocked] (c) the fused blocked step: card and CPU or host LU disagree, or K1/K3/K4 "
                             "did not all launch")

    log(f"[blocked] {time.perf_counter() - t0:.1f}s")
    return {k: demo_counts[k] + full_counts[k] for k in full_counts}, {k: v for k, v in c.items() if k != "b"}


# ------------------------------------------------------------------ phase 20
#: [owed]: three parity cases of the JAX package's slow tests, each on the
#: card and on the CPU: (1) FeFp through make_sharded_newton_step
#: (tests/test_sharding.py), (2) the transient phase change through
#: make_sharded_newton_step_general (tests/test_sharding_general.py), (3)
#: the blocked step with a per-point Young modulus and a rotated frame
#: (tests/test_sharding_general.py). The card against the CPU by [blocked]'s
#: rule: u (and p) to 1e-8 of its largest entry, equal Newton counts, Krylov
#: counts within 5 %
OWED_TOL, OWED_KRYLOV_SPREAD = 1e-8, 0.05
OWED_DT, OWED_ANGLE, T0_OWED = 2.0, 0.25, 293.15


def owed_fefp(device):
    """(1) 5x5 P1 quads, FeFp J2 with Voce hardening, u_x = 2 sig0/E on the
    right edge, 14 Newton x 200 CG."""
    from dolfinx_materials_tpu_torch import Material, NonlinearMaterialProblem, QuadratureMap, fem, models
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.fem.forms import deformation_gradient_2d
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step

    V = fem.FunctionSpace(fem.create_unit_square(5, 5, "quad"), 1, (2,))
    mat = Material(models.FeFpJ2Plasticity(models.LinearElasticIsotropic(E, NU), models.VoceHardening(SIG0, 500.0, 1e2)),
                   device=device)
    q = QuadratureMap(V, 2, mat)
    q.register_gradient("F", deformation_gradient_2d())
    loc = fem.locate_dofs_geometrical
    bcs = [fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 0), 0), 0.0),
           fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 1], 0), 1), 0.0),
           fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 1), 0), 2 * SIG0 / E)]
    prob = NonlinearMaterialProblem(q, fem.Function(V), bcs=bcs)
    step, pad_state = make_sharded_newton_step(q, prob, device_mesh(1, devices=[prob.device]), n_newton=14, n_cg=200)
    mask, vals = combine_bcs(bcs, V.num_dofs)
    u, st, rn = step(np.zeros(V.num_dofs), pad_state(mat.data_manager.s0.internal), mask, vals, 0.0)
    ok = np.isfinite(float(rn)) and float(rn) < 1e-7 * E
    return dict(u=u, p=st["p"], newton=step.info["newton"], krylov=step.info["cg"], rn=float(rn), ok=ok)


def owed_phase_change(device):
    """(2) a 12x1 strip at Tm - 50, its left end at Tm + 150: one implicit
    step of dt = 2 with the Enthalpy ISV in the residual, the conduction
    scaled by -dt and the previous enthalpy as the external force; 25
    Newton x 300 CG, atol 1e-4."""
    from dolfinx_materials_tpu_torch import Material, NonlinearMaterialProblem, QuadratureMap, fem, models
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.fem.forms import scalar_gradient, scalar_value
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step_general

    beh = models.PhaseChangeHeatTransfer(Tsmooth=5.0, dim=2)
    V = fem.FunctionSpace(fem.create_rectangle((0, 0), (0.1, 0.1 / 12), (12, 1), "quad"), 1, ())
    mat = Material(beh, device=device)
    q = QuadratureMap(V, 2, mat)
    q.register_gradient("TemperatureGradient", scalar_gradient())
    q.register_external_state_variable("Temperature", scalar_value())
    T = fem.Function(V)
    T.x[:] = beh.Tm - 50.0
    bcs = [fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0)), beh.Tm + 150.0)]
    prob = NonlinearMaterialProblem(
        q, T, bcs=bcs, residual_terms=[[("Enthalpy", scalar_value()), ("HeatFlux", scalar_gradient(), lambda: -OWED_DT)]])
    q.update(torch.as_tensor(T.x, device=mat.device))
    q.advance()
    f_ext = q.domain.make_residual([scalar_value()])(torch.as_tensor(T.x, device=mat.device),
                                                    [mat.data_manager.s0["Enthalpy"]])
    step, pad = make_sharded_newton_step_general(prob, device_mesh(1, devices=[prob.device]), n_newton=25, n_cg=300,
                                                 atol=1e-4, return_info="stats")
    mask, vals = combine_bcs(bcs, V.num_dofs)
    u0 = np.array(T.x)
    u0[mask] = vals[mask]
    u, _, rn, _, (nn, ncg) = step(u0, pad([mat.data_manager.s0.internal]), mask, vals, OWED_DT, f_ext=f_ext)
    ok = float(rn) < 2e-4 and int((u > beh.Tm).sum()) >= 1
    return dict(u=u, p=None, newton=int(nn), krylov=int(ncg), rn=float(rn), ok=ok)


def fiber_behavior():
    """Thermo-elasticity with a per-point Young modulus (a material
    property) and a fiber stiffening along the material x-axis."""
    from dolfinx_materials_tpu_torch.models.base import Behavior
    from dolfinx_materials_tpu_torch.ops import tensors as tn

    class VaryingFiberThermoElastic(Behavior):
        material_properties = {"YoungModulus": 1}
        gradients = {"Strain": 6}
        fluxes = {"Stress": 6}
        external_state_variables = {"Temperature": 1}
        extra_tangent_blocks = [("Stress", "Temperature")]

        def constitutive_update(self, inputs, state, dt):
            Ev, eps, T = inputs["YoungModulus"], inputs["Strain"], inputs["Temperature"][0]
            I2 = torch.as_tensor(tn.I2, dtype=eps.dtype, device=eps.device)
            e = eps - 1e-3 * (T - T0_OWED) * I2
            lmbda, mu = Ev * NU / (1 + NU) / (1 - 2 * NU), Ev / 2 / (1 + NU)
            x_axis = torch.as_tensor(np.eye(6)[0], dtype=eps.dtype, device=eps.device)
            return {"Stress": lmbda * tn.tr(e) * I2 + 2 * mu * e + 0.4 * Ev * e[0] * x_axis}, state

    return VaryingFiberThermoElastic()


def owed_fiber(device, N=6):
    """(3) the thermo-mechanical pair at N = 6, the mechanics behavior the
    fiber law with E (1 + x / 2) at each Gauss point and its frame rotated
    0.25 rad; the fused blocked step, 16 Newton x 400 BiCGStab."""
    from dolfinx_materials_tpu_torch import BlockedNonlinearProblem, Material, NonlinearMaterialProblem, QuadratureMap
    from dolfinx_materials_tpu_torch import fem
    from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d, scalar_gradient, scalar_value
    from dolfinx_materials_tpu_torch.models.thermal import ThermoMechanicalHeat

    mesh = fem.create_rectangle((0, 0), (1.0, 1.0), (N, N), "quad")
    loc = fem.locate_dofs_geometrical
    VT = fem.FunctionSpace(mesh, 1, ())
    qT = QuadratureMap(VT, 2, Material(ThermoMechanicalHeat(k=1.0, kappa=1.0, chi=6e3, T0=T0_OWED), device=device))
    qT.register_gradient("TemperatureGradient", scalar_gradient())
    qT.register_external_state_variable("Temperature", scalar_value())
    T = fem.Function(VT)
    T.x[:] = T0_OWED
    heat = NonlinearMaterialProblem(
        qT, T, bcs=[fem.DirichletBC(loc(VT, lambda x: np.isclose(x[:, 0], 0.0)), T0_OWED + 50.0),
                    fem.DirichletBC(loc(VT, lambda x: np.isclose(x[:, 0], 1.0)), T0_OWED)],
        residual_terms=[[("HeatFlux", scalar_gradient(), -1.0), ("Source", scalar_value(), 1.0)]])
    Vu = fem.FunctionSpace(mesh, 1, (2,))
    mat_u = Material(fiber_behavior(), device=device)
    c, s = np.cos(OWED_ANGLE), np.sin(OWED_ANGLE)
    mat_u.rotation_matrix = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    qu = QuadratureMap(Vu, 2, mat_u)
    qu.register_gradient("Strain", mandel_strain_2d())
    qu.register_external_state_variable("Temperature", T0_OWED)
    x_q = qu.domain.x_q.cpu().numpy().reshape(-1, qu.domain.x_q.shape[-1])
    mat_u.update_material_property("YoungModulus", E * (1.0 + 0.5 * x_q[:, 0]))
    mech = NonlinearMaterialProblem(qu, fem.Function(Vu), bcs=[fem.DirichletBC(
        loc(Vu, lambda x: np.isclose(x[:, 0], 0.0) | np.isclose(x[:, 0], 1.0)), 0.0)])

    def vol_strain(ctx):
        return torch.stack([ctx.grad[0, 0] + ctx.grad[1, 1]])

    blocked = BlockedNonlinearProblem([heat, mech], [(1, 0, qu, "Stress", "Temperature", scalar_value()),
                                                     (0, 1, qT, "Source", "VolStrain", vol_strain)])
    z, rn, _, step = blocked_step(blocked, np.concatenate([T.x, mech.u.x]), n_newton=16, n_cg=400)
    return dict(u=z, p=None, newton=step.info["newton"], krylov=step.info["bicgstab"], rn=rn, ok=rn < 1e-7 * E)


def phase_owed():
    """[owed]: the three cases on the card and on the CPU, each card run's
    K1/K3/K4 launches printed: no case has a J2 update (no K1) and every
    mesh is below the banded route's size (no gathers by K3/K4), so each
    launches K3 once, for the fixed-order sum of its two-level coarse
    matrix. Returns the launches of the three card runs."""
    t0 = time.perf_counter()
    total = dict.fromkeys(("j2_radial_return", "banded_take_ell", "banded_take_csr"), 0)
    for name, case in (("fefp", owed_fefp), ("phase_change", owed_phase_change), ("fiber_props_rotation", owed_fiber)):
        out = {}
        for dev in (DEVICE, "cpu"):
            reset_counts()
            t = time.perf_counter()
            r = case(dev)
            if dev == DEVICE:
                torch.cuda.synchronize()
            r["s"], r["counts"] = time.perf_counter() - t, read_counts()
            out[dev] = r
        c, h = out[DEVICE], out["cpu"]
        errs = {"u": rel_err(c["u"].cpu(), h["u"].cpu(), h["u"].abs().max())}
        if h["p"] is not None:
            errs["p"] = rel_err(c["p"].cpu(), h["p"].cpu(), h["p"].abs().max())
        launches = {k: c["counts"][k] for k in total}
        for k in total:
            total[k] += launches[k]
        spread = abs(c["krylov"] - h["krylov"]) / max(h["krylov"], 1)
        ok = (c["ok"] and h["ok"] and c["newton"] == h["newton"] and spread <= OWED_KRYLOV_SPREAD
              and all(e <= OWED_TOL for e in errs.values()))
        log(f"[owed] {name}: card newton={c['newton']} krylov={c['krylov']} |R|={c['rn']:.3e} ({c['s']:.2f}s) | cpu "
            f"newton={h['newton']} krylov={h['krylov']} |R|={h['rn']:.3e} ({h['s']:.2f}s); card vs CPU "
            + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {OWED_TOL:g}, Krylov counts within "
            f"{OWED_KRYLOV_SPREAD:.0%}); launches {launches}"
            + ("" if any(launches.values()) else " (this case's route launches no K1, K3 or K4)")
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[owed] {name}: card and CPU disagree, or the step did not converge")
    log(f"[owed] {time.perf_counter() - t0:.1f}s")
    return total


# ------------------------------------------------------------------ phase 21
#: [dist]: (a) one NCCL rank through the process group at [fused]'s width
#: and first load; (b) two ranks sharing the card over gloo on
#: [fused-bench]'s 64 x 64 P1 plate (6 Newton x 30 CG, two-level), both dof
#: layouts, its map on the banded route (K3/K4), each step timed as the
#: second of two calls; (c) the fused blocked
#: step over the same two ranks at [blocked]'s 64 x 32. (b) and (c) against
#: the one-rank card runs by [blocked]'s rule: u (z) and p to 1e-8 of their
#: largest entry, equal Newton counts, Krylov counts within 5 %
DIST_TIMEOUT = 400  # seconds a launch may take
DIST_TOL, DIST_CG_SPREAD = 1e-8, 0.05
DIST_BENCH = dict(N=FUSED_BENCH_NX, hardening="voce", load=2.0, layouts="replicated,sharded", n_newton=6, n_cg=30,
                  banded=True, reps=1)
DIST_KERNELS = ("j2_radial_return", "banded_take_ell", "banded_take_csr")


def dist_worker(argv):
    """[dist] (a), one rank of ``python3 chip_smoke.py --dist-worker OUT nx
    pid nproc coordinator``: [fused]'s plate at ``nx`` and its first load
    from the lifted start with [fused]'s options, through the process
    group's mesh (NCCL), called twice; writes u, p, counts, seconds and the
    first call's launches, derived as [fused] derives them, to OUT."""
    import torch.distributed as dist

    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step_general
    from dolfinx_materials_tpu_torch.parallel import multiprocess as mp

    out, nx, pid, nproc, coord = argv
    device = mp.initialize(int(pid), int(nproc), coord)
    problem, qmap, bc_top, _ = build_plate(int(nx), device)
    ndofs = problem.u.space.num_dofs
    step, pad = make_sharded_newton_step_general(
        problem, device_mesh(int(nproc)), n_newton=FUSED_NEWTON, n_cg=FUSED_CG, cg_rtol=FUSED_CG_RTOL,
        pc="two_level", pc_boxes=FUSED_BOXES, return_info="stats")
    bc_top.set(GENERIC_LOADS[0])
    mask, vals = combine_bcs(problem.bcs, ndofs)
    y = torch.as_tensor(problem.u.space.node_coords[:, 1], device=device)
    u0 = lifted(torch.zeros(ndofs, dtype=torch.float64, device=device), GENERIC_LOADS[0], y)
    states = pad([qmap.material.data_manager.s0.internal])
    walls = []
    for _ in range(2):  # the first call (the CG graph's capture) and a second one
        reset_counts()
        before = graph_snapshot(step.cg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        u, st, rn, rn0, (nn, ncg) = step(u0, states, mask, vals, 0.0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if len(walls) == 1:
            counts, factors = fused_launches(step.cg, before, read_counts())
    if int(pid) == 0:
        np.savez(out, u=u.cpu().numpy(), p=st[0]["p"].reshape(-1).cpu().numpy(), newton=nn, cg=ncg,
                 walls=np.asarray(walls), graphs=len(step.cg._graphs), graph=bool(step.cg.graph),
                 **{f"launches_{k}": v for k, v in counts.items()})
    print(f"[dist] rank {pid}: newton={nn} cg={ncg} |R|={float(rn):.4e} launches {counts} ({factors})", flush=True)
    dist.destroy_process_group()
    return 0


def phase_dist(nx, fused_first, blocked_ref):
    """[dist]: the multi-rank layer on the card (the constants above).
    Returns the K1/K3/K4 launches of its ranks, summed."""
    from dolfinx_materials_tpu_torch.demos import sharded_scaling
    from dolfinx_materials_tpu_torch.parallel import device_mesh
    from dolfinx_materials_tpu_torch.parallel import multiprocess as mp

    t0 = time.perf_counter()
    total = dict.fromkeys(DIST_KERNELS, 0)
    # (a) one NCCL rank at full width against [fused]'s first step
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "a.npz")
        t = time.perf_counter()
        mp.launch([sys.executable, os.path.abspath(__file__), "--dist-worker", out, str(nx)], 1, timeout=DIST_TIMEOUT)
        s_a = time.perf_counter() - t
        with np.load(out) as f:
            a = dict(f)
    ref = fused_first
    same = (np.array_equal(a["u"], ref["u"].numpy()) and np.array_equal(a["p"], ref["p"].numpy())
            and (int(a["newton"]), int(a["cg"])) == (ref["newton"], ref["cg"]))
    launched = {k: int(a[f"launches_{k}"]) for k in DIST_KERNELS}
    ok = same and all(v > 0 for v in launched.values())
    log(f"[dist] (a) {nx}x{2 * nx} P2 plate, one NCCL rank through the process group, [fused]'s first load: "
        f"newton={int(a['newton'])} cg={int(a['cg'])} (fused {ref['newton']}/{ref['cg']}); u, p and counts "
        f"bitwise equal to [fused]'s first step={same}; step {1e3 * a['walls'][0]:.1f} ms first call, "
        f"{1e3 * a['walls'][1]:.1f} ms second ([fused]'s first step {1e3 * ref['s']:.1f} ms); CG graph "
        f"{bool(a['graph'])} ({int(a['graphs'])} captured); rank launches {launched} ([fused] {ref['counts']}); "
        f"launch {s_a:.1f}s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[dist] (a) the one-rank group step differs from [fused]'s, or K1/K3/K4 did not launch")
    total = {k: total[k] + v for k, v in launched.items()}

    # (b) and (c): two ranks sharing the card over gloo, in one launch
    t = time.perf_counter()
    opts = [w for k, v in DIST_BENCH.items() if k != "banded"
            for w in (f"--{k.replace('_', '-')}", v)] + ["--banded", "--blocked", "interface", "--device", "cuda",
                                                       "--backend", "gloo"]
    two = sharded_scaling.launch_worker(2, opts, timeout=DIST_TIMEOUT)
    s_two = time.perf_counter() - t
    one = sharded_scaling.solve_plate(device_mesh(1), argparse.Namespace(**DIST_BENCH), torch.device(DEVICE))
    for layout in ("replicated", "sharded"):
        u1, p1 = one[f"u_{layout}"].cpu().numpy(), one[f"p_{layout}"].cpu().numpy()
        e_u = float(np.abs(two[f"u_{layout}"] - u1).max() / np.abs(u1).max())
        e_p = float(np.abs(two[f"p_{layout}"] - p1).max() / np.abs(p1).max())
        nn1, cg1 = one[f"newton_{layout}"], one[f"cg_{layout}"]
        nn2, cg2 = int(two[f"newton_{layout}"]), int(two[f"cg_{layout}"])
        ranks = [{k: int(two[f"rank{r}_launches_{layout}_{k}"]) for k in DIST_KERNELS} for r in (0, 1)]
        ok = (e_u <= DIST_TOL and e_p <= DIST_TOL and nn1 == nn2 and abs(cg2 - cg1) <= DIST_CG_SPREAD * cg1
              and all(v > 0 for r in ranks for v in r.values()) and int(two[f"replays_{layout}"]) == 0)
        log(f"[dist] (b) {FUSED_BENCH_NX}x{FUSED_BENCH_NX} P1 J2 plate, banded route, {layout} dofs, two ranks on "
            f"the card over gloo: newton={nn2} cg={cg2} |R|={float(two[f'res_{layout}'][0]):.4e} step "
            f"{float(two[f'ms_{layout}']):.1f} ms | one rank newton={nn1} cg={cg1} step {one[f'ms_{layout}']:.1f} ms; "
            f"u rel err {e_u:.2e} p rel err {e_p:.2e} (tol {DIST_TOL:g}, CG within {DIST_CG_SPREAD:.0%}); launches "
            f"rank 0 {ranks[0]} rank 1 {ranks[1]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[dist] (b) {layout}: two ranks and one disagree, or a rank did not launch K1/K3/K4")
        for r in ranks:
            total = {k: total[k] + r[k] for k in total}
    z1, p1 = blocked_ref["z"], blocked_ref["p"]
    e_z = float(np.abs(two["z_blocked"] - z1).max() / np.abs(z1).max())
    e_p = [float(np.abs(two[f"p{i}_blocked"] - p.reshape(-1)).max() / np.abs(p).max()) for i, p in enumerate(p1)]
    nn1, k1 = blocked_ref["info"]["newton"], blocked_ref["info"]["bicgstab"]
    nn2, k2 = int(two["newton_blocked"]), int(two["bicgstab_blocked"])
    ranks = [{k: int(two[f"rank{r}_launches_blocked_{k}"]) for k in DIST_KERNELS} for r in (0, 1)]
    ok = (e_z <= DIST_TOL and max(e_p) <= DIST_TOL and nn1 == nn2 and abs(k2 - k1) <= DIST_CG_SPREAD * k1
          and float(two["res_blocked"][0]) <= 1e-7 * E and all(v > 0 for r in ranks for v in r.values()))
    log(f"[dist] (c) blocked interface step {BLOCKED_CHECK_NX}x{BLOCKED_CHECK_NX // 2} P2, two ranks over gloo: "
        f"newton={nn2} bicgstab={k2} |R|={float(two['res_blocked'][0]):.3e} step {float(two['ms_blocked']):.1f} ms | "
        f"[blocked]'s one-device card run newton={nn1} bicgstab={k1} ({1e3 * blocked_ref['s']:.1f} ms); z rel err "
        f"{e_z:.2e} p rel err {' '.join(f'{e:.2e}' for e in e_p)} (tol {DIST_TOL:g}, BiCGStab within "
        f"{DIST_CG_SPREAD:.0%}); launches rank 0 {ranks[0]} rank 1 {ranks[1]}; launch of (b) and (c) {s_two:.1f}s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[dist] (c) the two-rank blocked step and the one-device run disagree, or a rank did "
                             "not launch K1/K3/K4")
    for r in ranks:
        total = {k: total[k] + r[k] for k in total}
    log(f"[dist] {time.perf_counter() - t0:.1f}s")
    return total


def bg_name(plan):
    from dolfinx_materials_tpu_torch.ops import banded_gather as bg

    return bg._best_take(plan).__name__ if plan is not None else None


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
    law_worst, law_timed = phase_law()
    takes = phase_take(nx_full, OGDEN_TET_N)
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
    fused_counts, fused_factors, fused_first = phase_fused(nx_full, fast)
    ogden = {"ogden_tet": phase_ogden_tet(), "ogden_hex": phase_ogden_hex(), "composite": phase_composite()}
    phase_ogden_cpu()
    demo_counts = phase_demo()
    t_fefp = time.perf_counter()
    phase_fefp_point()
    fefp_counts = phase_fefp_bar()
    log(f"[fefp] {time.perf_counter() - t_fefp:.1f}s")
    phase_crystal()
    phase_families()
    blocked_counts, blocked_check = phase_blocked()
    owed_counts = phase_owed()
    dist_counts = phase_dist(nx_full, fused_first, blocked_check)
    log(f"[total] {time.perf_counter() - t0:.1f}s")

    keys = ("cell", "fm", "asm")
    tet_keys = ("tet_cell", "tet_fm", "tet_asm")

    def take_row(name, layout, replaces):
        def total(f, ks=keys):  # one take of each of a slice's three plans, f64
            return sum(f(takes[(f64, k)]) for k in ks)

        def times(ks):
            return {"ms": total(lambda r: r["call"][layout], ks), "device_ms": total(lambda r: r["device"][layout], ks),
                    "host_us": total(lambda r: r["host"][layout], ks), "plain_ms": total(lambda r: r["t_p"], ks),
                    "bound_ms": total(lambda r: r["bound"], ks),
                    # one library call a plan: table[idx] where the take is a
                    # gather, the CSR SpMV where it sums (asm)
                    "library_ms": total(lambda r: r["t_i"] if r["gather"] else r["t_l"], ks),
                    "index_select_ms": total(lambda r: r["t_i"], ks),
                    "index_select_device_ms": total(lambda r: r["device_i"], ks),
                    "csr_spmv_ms": total(lambda r: r["t_l"], ks)}

        by_path = {"main": counts[name], "fused": fused_counts[name],
                   **{k: ogden[k][name] for k in ("ogden_tet", "ogden_hex", "composite")},
                   "demo": demo_counts[name], "fefp": fefp_counts[name], "blocked": blocked_counts[name],
                   "owed": owed_counts[name], "dist": dist_counts[name]}
        plate = times(keys)
        return {
            "name": name, "route": "cuda",
            "source": "dolfinx_materials_tpu_torch/csrc/banded_take.cu",
            "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
            "fused_launches_from": fused_factors[name],
            "max_abs_err": max(takes[(f64, k)]["err"][layout] for k in keys + tet_keys),
            "ms": plate["ms"], "device_ms": plate["device_ms"], "host_us": plate["host_us"],
            "plain_ms": plate["plain_ms"], "bound_ms": plate["bound_ms"], "bound_by": "bytes",
            "library_ms": plate["library_ms"], "index_select_ms": plate["index_select_ms"],
            "index_select_device_ms": plate["index_select_device_ms"], "csr_spmv_ms": plate["csr_spmv_ms"],
            # the same three takes on the fine P2-tet block's plans
            "p2_tet": times(tet_keys),
        }

    def j2_row(name, replaces, by_path, timed, worst, kname):
        # the law programs of [law] (f64, point-major, 2^21 points) beside
        # the built-in Voce closed form on the same inputs
        programs = {ln: {k: r[k] for k in ("ms", "device_ms", "host_us", "plain_ms", "instructions")}
                    | {"bound_ms": r["bound"][0]} for (kn, ln), r in law_timed.items() if kn == kname}
        return {
            "name": name, "route": "cuda",
            "source": "dolfinx_materials_tpu_torch/csrc/j2_radial_return.cu",
            "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
            **({"fused_launches_from": fused_factors[name]} if "fused" in by_path else {}),
            "max_abs_err": max(timed["max_abs_err"], worst, law_worst[kname]),
            "ms": timed["ms"], "device_ms": timed["device_ms"], "host_us": timed["host_us"],
            "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "library_ms": None, "law_programs": programs,
        }

    kernels = [
        j2_row("j2_radial_return", "dolfinx_materials_tpu/ops/pallas_j2.py:103",
               {"main": counts["j2_radial_return"], "fused": fused_counts["j2_radial_return"],
                "demo": demo_counts["j2_radial_return"], "blocked": blocked_counts["j2_radial_return"],
                "owed": owed_counts["j2_radial_return"], "dist": dist_counts["j2_radial_return"]},
               k1, j2_worst["full"], "full"),
        j2_row("j2_radial_return_factored", "dolfinx_materials_tpu/ops/pallas_j2.py:196",
               {"point": point_counts["j2_radial_return_factored"]}, k2, j2_worst["factored"], "factored"),
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
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2:]))
    sys.exit(main())
