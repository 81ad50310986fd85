"""Traffic of load programs through a fused load step, in a closed loop.

A program starts from the virgin state and applies ``len(factors)`` load
increments of ``increment * factor`` to the boundary condition, one fused
load step each, each step starting from the lifted predictor on the carried
state (u_x carried, u_y = u_top y / L_y). Every seed gets the same set of
programs, every rotation of the factors once a cycle (so each size comes
once in each position); the seed decides the order of the programs in each
cycle. One program runs at a time, and the next starts when the last step
of the one before has converged or failed. A window that is not profiled
runs on from its ``seconds`` to the end of the cycle under way, so that it
holds whole cycles: the same programs for every seed, whatever their order
(a window cut inside a cycle would hold the seed's first programs of it,
and the programs' times differ up to 1.5x). A profiled window, in sessions
of a few seconds, stops at the step under way; its program goes on in the
next session.

The cell's ``params``: ``increment`` (the top displacement of one step),
``factors`` (the sizes of a program's steps, in units of ``increment``).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import core, trace


def programs(params, seed):
    """The load programs of the seed, in order: cycles of the rotations of
    the factors (each size once in each position of a cycle), each cycle in
    an order drawn from the seed."""
    f = list(params["factors"])
    orders = [f[i:] + f[:i] for i in range(len(f))]
    rng = np.random.default_rng([seed, 0])
    while True:
        for i in rng.permutation(len(orders)):
            yield [float(params["increment"]) * x for x in orders[i]]


class Driver:
    def __init__(self, cell, seed, device, cfg):
        import torch

        self.torch, self.cfg, self.device = torch, cfg, device
        params = cell.spec["params"]
        self.limits = cell.spec["limits"]
        self.reference = cell.reference()
        t = time.perf_counter()
        self.plate = cell.builder().build(cfg, device)
        core.log(f"problem, plans and fused step built {time.perf_counter() - t:.3f} s")
        self.shapes = self.plate.shapes
        self.cell_increment = float(params["increment"])
        self.programs = programs(params, seed)
        self.cycle = len(params["factors"])  # programs a cycle
        self.started = 0
        self.sampling = np.random.default_rng([seed, 1])
        self.n_done = 0
        self.kept = self.program = None
        self._warm()

    def _sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def load_step(self, u, states, uy):
        """One fused load step to the top displacement ``uy`` from ``u``."""
        from dolfinx_materials_tpu_torch.fem.bc import combine_bcs

        pl = self.plate
        pl.bc_top.set(uy)
        mask, vals = combine_bcs(pl.problem.bcs, pl.ndofs)
        u0 = u.reshape(-1, 2).clone()
        u0[:, 1] = uy * pl.y / self.cfg["ly"]
        u, states, rn, rn0, (nn, ncg) = pl.step(u0.reshape(-1), states, mask, vals, 0.0)
        converged = bool(float(rn) <= self.cfg["newton_rtol"] * float(rn0))
        return u, states, converged, nn, ncg

    def _warm(self):
        """One step of a program: every kernel of the step loaded and the CG
        block captured as a CUDA graph (the shapes of every later step)."""
        pl = self.plate
        u = self.torch.zeros(pl.ndofs, dtype=pl.dtype, device=self.device)
        t = time.perf_counter()
        self.load_step(u, pl.virgin, self.cell_increment)
        self._sync()
        core.log(f"warm-up step {time.perf_counter() - t:.3f} s")

    def window(self, seconds, instrument=False, profile=False):
        """Programs for ``seconds`` of wall time and on to the end of the
        cycle under way (profiled: to the end of the step under way).
        ``instrument``: the CG solves timed
        between two synchronisations; ``profile``: under the profiler, at
        most ``trace.SECONDS``."""
        w = core.Window()
        cg = self.plate.step.cg
        solve = cg.solve

        def timed_solve(ops, b):
            self._sync()
            t = time.perf_counter()
            with trace.span("cg_solve", profile):
                out = solve(ops, b)
                self._sync()
            w.spans["cg_solve"].append(time.perf_counter() - t)
            return out

        if instrument:
            cg.solve = timed_solve
        try:
            if profile:
                w.trace = trace.profiled(lambda part: self._timed_loop(w, part, True), min(seconds, trace.SECONDS),
                                         ("cg_solve", "load_step"))
                w.seconds = w.trace.window_s
            else:
                w.seconds = self._timed_loop(w, seconds, False)
        finally:
            cg.solve = solve
        return w

    def _timed_loop(self, w, seconds, profile):
        t0 = time.perf_counter()
        self._loop(w, t0, seconds, profile)
        self._sync()
        return time.perf_counter() - t0

    def _loop(self, w, t0, seconds, profile):
        """Load steps until ``seconds`` are up and, unless ``profile``, the
        cycle under way has ended."""
        pl = self.plate
        while time.perf_counter() - t0 < seconds or not (profile or self._cycle_done()):
            if self.program is None:  # the next program, from the virgin state
                u = self.torch.zeros(pl.ndofs, dtype=pl.dtype, device=self.device)
                self.program = dict(incs=next(self.programs), u=u, states=pl.virgin, uy=0.0, outputs=[])
                self.started += 1
            pr = self.program
            pr["uy"] += pr["incs"][len(pr["outputs"])]
            t = time.perf_counter()
            with trace.span("load_step", profile):
                pr["u"], pr["states"], ok, nn, ncg = self.load_step(pr["u"], pr["states"], pr["uy"])
                self._sync()
            w.spans["load_step"].append(time.perf_counter() - t)
            w.counts["attempted"] += 1
            w.counts["converged"] += ok
            w.counts["failed"] += not ok
            w.counts["newton"] += nn
            w.counts["cg"] += ncg
            pr["outputs"].append((pr["u"], pr["states"][0]["p"]))  # new tensors each step: kept by reference
            if len(pr["outputs"]) == len(pr["incs"]):
                self.n_done += 1
                if self.sampling.integers(self.n_done) == 0:  # a reservoir of one program
                    self.kept = (pr["incs"], pr["outputs"])
                self.program = None

    def _cycle_done(self):
        return self.program is None and self.started % self.cycle == 0

    def release(self):
        """The sampled program's increments and outputs (u in the
        reference's dof order, p in its Gauss-point order, on the CPU), with
        the program's state freed."""
        pr = self.program
        incs, outputs = self.kept or (pr["incs"][: len(pr["outputs"])], pr["outputs"])
        dofs = self.reference.dof_order(self.cfg, self.plate.node_coords)
        points = self.reference.point_order(self.cfg, self.plate.x_q)
        kept = [(u.cpu().double().numpy()[dofs], p.reshape(-1).cpu().double().numpy()[points]) for u, p in outputs]
        del self.plate, self.kept, self.program, outputs
        if self.device != "cpu":
            self.torch.cuda.empty_cache()
        return incs, kept

    def compare(self, kept):
        incs, outputs = kept
        return compare(self.cfg, incs, outputs, self.limits, self.reference, self.device)


def compare(cfg, incs, outputs, limits, reference, device):
    """A program's ``(u, p)`` after each step (in the reference's
    numbering) against the plain reference's solve of the same increments:
    the largest |u - u_ref| over the largest |u_ref|, and |p - p_ref| over
    the yield strain sig0 / E."""
    ref = reference.solve(cfg, incs, device)
    e_u = e_p = 0.0
    for (u, p), (u_r, p_r) in zip(outputs, ref):
        e_u = max(e_u, float(np.abs(u - u_r).max() / np.abs(u_r).max()))
        e_p = max(e_p, float(np.abs(p - p_r).max() / (cfg["sig0"] / cfg["E"])))
    return {"u": {"value": e_u, "limit": limits["u"]}, "p": {"value": e_p, "limit": limits["p"]}}
