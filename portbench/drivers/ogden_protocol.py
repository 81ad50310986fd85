#!/usr/bin/env python3
"""Traffic of whole load protocols through a fused load step, in a closed
loop: the Ogden block's protocol.

A protocol starts from the virgin state (u = 0) and applies the
configuration's ``steps`` uniform load steps, one fused step each, each
step from the secant predictor ``u_(k-1) + (u_(k-1) - u_(k-2))``
(``u_0 = u_(-1) = 0``) with step k's boundary values, as the port's
``demos/ogden_block.py`` ``run_steps`` forms it. One protocol runs at a
time. A step counts as converged when its own relative residual (the
step's ``res`` over its ``res0``) is within the step's ``rtol``. The
protocol has no randomness: the seed draws only the protocol that the
check keeps (a reservoir of one over the window's whole protocols).

A window that is not profiled runs on from its ``seconds`` to the end of
the protocol under way, so that it holds whole protocols. A profiled window
runs in profiler sessions of one step each (``trace.PART``'s 3 s sessions
would hold two steps: a step under the profiler takes 4-8 s and launches
175,000-375,000 device operations, where a session has kept as few as
321,670 before its buffer filled); the protocol goes on in the next
session. Profiled, the material's whole-batch update and flux calls
(``_fast_update``, ``_fast_flux``) are wrapped in the harness span
``constitutive``, between two synchronisations of the card.

The check (``compare``): for every step k of the kept protocol, ``res``,
the plain reference's float64 residual norm on the free dofs at the
program's ``u_k`` over the same norm at the step's entering guess ``g_k``
(the protocol's promise, its ``rtol``, held by an independent residual),
``u``, the largest ``|u_k - u_ref,k|`` over the largest ``|u_ref,k|``
against the reference's tightly solved step, and ``u_later``, the same over
steps 2 to the last. ``u`` is a guard: the first step enters from u = 0 and
the protocol's promise leaves its u loose. ``u_later`` separates the program
from the float32 control.

The control of the check: ``python3 -m portbench.drivers.ogden_protocol
--seeds 11 12 13`` puts the reference computed in float32 in the program's
place and prints each seed's numbers beside the cell's limits (the
protocol has no randomness, so the seeds repeat one computation).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core, trace  # noqa: E402

#: the harness's span around the material's calls
SPANS = ("constitutive",)
#: the program's scopes of the Ogden update (``models/hyperelasticity.py``)
SCOPES = ("hyperelastic: constitutive update", "hyperelastic: flux")


def idle_in_scopes(prof):
    """``(device events, idle seconds)`` of a finished profiler session:
    the device's idle inside the host ranges of the program's ``SCOPES``
    (their length less the device's busy time inside them; None where the
    program opened none). The gaps' owners in ``trace.summarize`` are taken
    on the host thread with the most events, which on this cell is the
    autograd engine's device thread (the Hessian's backward passes), not
    the thread that opens the scopes."""
    from torch.autograd import DeviceType

    device, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() in SCOPES:
                ranges.append((e.start_ns(), e.end_ns()))
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns()))
    if not ranges:
        return len(device), None
    ranges = trace.merged(ranges)
    busy = trace.clipped_seconds(trace.merged(device), ranges)
    return len(device), (sum(b - a for a, b in ranges) - busy) / 1e9


class Driver:
    def __init__(self, cell, seed, device, cfg):
        import torch

        self.torch, self.cfg, self.device = torch, cfg, device
        self.limits = cell.spec["limits"]
        self.reference = cell.reference()
        t = time.perf_counter()
        self.block = cell.builder().build(cfg, device)
        core.log(f"problem, plans and fused step built {time.perf_counter() - t:.3f} s")
        self.shapes = self.block.shapes
        self.steps = len(self.block.loads)
        self.sampling = np.random.default_rng([seed, 1])
        self.n_done = 0
        self.kept = self.protocol = None
        self._warm()

    def _sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def _new_protocol(self):
        u = self.torch.zeros(self.block.ndofs, dtype=self.block.dtype, device=self.device)
        return dict(u=u, u_prev=u, state=self.block.state, outputs=[], newton=0, cg=0)

    def load_step(self, pr):
        """Step ``len(pr["outputs"])`` of the protocol ``pr`` from the
        secant predictor: ``(u, state, res, res0, newton, cg)``."""
        b = self.block
        guess = pr["u"] + (pr["u"] - pr["u_prev"])
        u, states, res, res0 = b.step(guess, [pr["state"]], b.mask, b.loads[len(pr["outputs"])], 0.0)
        info = b.step.info
        return u, states[0], float(res), float(res0), int(info["newton"]), int(info["cg"])

    def _warm(self):
        """One whole protocol, left out of every window: each step's shapes
        and kernels loaded, the CG block captured as a CUDA graph, and the
        card's caching allocator brought to the state in which every later
        protocol starts. Where the Newton iteration is sensitive to rounding,
        a protocol's iteration counts follow that state (an Ogden tangent
        that lost accuracy at coincident stretches took 50 Newton iterations
        in the first protocol after a warm-up of one step and 57 in each
        later one)."""
        t = time.perf_counter()
        pr = self._new_protocol()
        for _ in range(self.steps):
            u, state, *_ = self.load_step(pr)
            pr["u_prev"], pr["u"], pr["state"] = pr["u"], u, state
            pr["outputs"].append(None)
        self._sync()
        core.log(f"warm-up protocol {time.perf_counter() - t:.3f} s")

    def window(self, seconds, instrument=False, profile=False):
        """Protocols for ``seconds`` of wall time and on to the end of the
        protocol under way (profiled: to the end of the step under way, at
        most ``trace.SECONDS``). ``instrument`` changes nothing here: the
        program's own scopes time the update."""
        w = core.Window()
        if not profile:
            w.seconds = self._timed_loop(w, seconds, False)
            return w
        m = self.block.material
        update, flux = m._fast_update, m._fast_flux

        def wrapped(kind, fn):
            def call(x, state, dt):
                self._sync()
                t = time.perf_counter()
                with trace.span("constitutive", True):
                    out = fn(x, state, dt)
                    self._sync()
                w.spans["constitutive"].append(time.perf_counter() - t)
                w.counts[f"{kind}.{str(x.dtype).rsplit('.', 1)[-1]}"] += 1
                return out
            return call

        m._fast_update, m._fast_flux = wrapped("update", update), wrapped("flux", flux)
        try:
            w.trace = self._profiled(w, min(seconds, trace.SECONDS))
            w.seconds = w.trace.window_s
        finally:
            m._fast_update, m._fast_flux = update, flux
        return w

    def _profiled(self, w, seconds):
        """Profiler sessions of one step each until ``seconds`` are
        profiled."""
        total, dropped = trace.Summary(), 0
        while total.window_s < seconds:
            calls = {k: w.counts[k] for k in list(w.counts) if k.startswith(("update.", "flux."))}
            spans = len(w.spans["constitutive"])
            with trace.profiler() as prof:
                with trace.span("window", True):
                    elapsed = self._timed_loop(w, 0.0, True)
            n, idle = idle_in_scopes(prof)
            try:
                total.add(trace.summarize(prof, elapsed, SPANS))
                if idle is not None:
                    w.idle_in_scopes = (getattr(w, "idle_in_scopes", None) or 0.0) + idle
            except RuntimeError as e:  # the profiler's buffer filled: the session's update calls are left out
                dropped += 1
                core.log(f"profiler session of {n} device events dropped: {e}")
                if dropped > 2:
                    raise
                for k in [k for k in w.counts if k.startswith(("update.", "flux."))]:
                    w.counts[k] = calls.get(k, 0)
                del w.spans["constitutive"][spans:]
                continue
            core.log(f"profiler session {elapsed:.3f} s, {n} device events")
        return total

    def _timed_loop(self, w, seconds, profile):
        t0 = time.perf_counter()
        while True:  # at least one step
            if self.protocol is None:
                self.protocol = self._new_protocol()
            pr = self.protocol
            t = time.perf_counter()
            with trace.span("load_step", profile):
                u, state, res, res0, nn, ncg = self.load_step(pr)
                self._sync()
            w.spans["load_step"].append(time.perf_counter() - t)
            ok = res <= self.block.rtol * res0
            w.counts["attempted"] += 1
            w.counts["converged"] += ok
            w.counts["failed"] += not ok
            w.counts["newton"] += nn
            w.counts["cg"] += ncg
            pr["u_prev"], pr["u"], pr["state"] = pr["u"], u, state
            pr["outputs"].append((u, res, res0))  # new tensors each step: kept by reference
            pr["newton"] += nn
            pr["cg"] += ncg
            if len(pr["outputs"]) == self.steps:
                self.n_done += 1
                if not profile:  # a profiled protocol spans windows
                    core.log(f"protocol {self.n_done}: {sum(w.spans['load_step'][-self.steps:]):.3f} s, "
                             f"{pr['newton']} Newton, {pr['cg']} CG")
                if self.sampling.integers(self.n_done) == 0:  # a reservoir of one protocol
                    # on the host, so that what the card holds, and where the
                    # next protocols' tensors land, does not follow the seed
                    self.kept = [(u.cpu(), res, res0) for u, res, res0 in pr["outputs"]]
                self.protocol = None
            if time.perf_counter() - t0 >= seconds and (profile or self.protocol is None):
                break
        self._sync()
        return time.perf_counter() - t0

    def release(self):
        """The kept protocol's outputs, ``[(u_k in the reference's dof
        order, res_k, res0_k)]`` on the CPU, with the program's state
        freed."""
        outputs = self.kept or self.protocol["outputs"]
        dofs = self.reference.dof_order(self.cfg, self.block.node_coords)
        kept = [(u.cpu().double().numpy()[dofs], res, res0) for u, res, res0 in outputs]
        del self.block, self.kept, self.protocol, outputs
        if self.device != "cpu":
            self.torch.cuda.empty_cache()
        return kept

    def compare(self, kept):
        return compare(self.cfg, kept, self.limits, self.reference, self.device)


def compare(cfg, outputs, limits, reference, device):
    """The kept protocol's ``[(u_k, res_k, res0_k)]`` (``u`` in the
    reference's numbering; the step's own norms, or None) against the plain
    reference: ``res``, the largest float64 ``|R(u_k)| / |R(g_k)|`` on the
    free dofs, ``u``, the largest ``|u_k - u_ref,k|`` over the largest
    ``|u_ref,k|``, and ``u_later``, the same from the second step on (None
    in a protocol of one step). Logs each step's norms beside the program's
    own."""
    us = [u for u, _, _ in outputs]
    ratios = reference.residual_ratios(cfg, us, device)
    ref = reference.solve(cfg, device)
    e_res, d_us = 0.0, []
    for k, ((u, res, res0), (r_u, r_g), u_r) in enumerate(zip(outputs, ratios, ref)):
        d_u = float(np.abs(u - u_r).max() / np.abs(u_r).max())
        e_res = max(e_res, r_u / r_g)
        d_us.append(d_u)
        own = f"; the step's own {res!r} / {res0!r}" if res is not None else ""
        core.log(f"step {k + 1}: u {d_u!r}; reference |R(u)| {r_u!r} / |R(g)| {r_g!r} = {r_u / r_g!r}{own}")
    got = {"res": {"value": e_res, "limit": limits["res"]}, "u": {"value": max(d_us), "limit": limits["u"]}}
    if len(d_us) > 1:
        got["u_later"] = {"value": max(d_us[1:]), "limit": limits["u_later"]}
    return got


def control_readings(cell, seed, device, sizes=None):
    """The control's compared numbers: the plain reference computed in
    float32 in the program's place, judged by the cell's comparison.
    ``seed`` draws nothing (the protocol has no randomness)."""
    import torch

    cfg = dict(cell.config, **(sizes or {}))
    ref = cell.reference()
    low = ref.solve(cfg, device, dtype=torch.float32)
    return compare(cfg, [(u, None, None) for u in low], cell.spec["limits"], ref, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="The control of the Ogden protocol's check, seed by seed.")
    ap.add_argument("--workload", default="ogden.tet-protocol")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload, ROOT)
    for seed in args.seeds:
        got = control_readings(cell, seed, args.device)
        fails = [k for k, c in got.items() if not c["value"] <= c["limit"]]
        print(json.dumps({"workload": cell.name, "seed": seed, "control": got, "not_correct": bool(fails)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
