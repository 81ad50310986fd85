"""Traffic of batched constitutive updates at material points, in a closed
loop.

Every point follows its own strain direction to its total (``strain_std``
a component, normal), in ``increments`` equal steps. The set of totals is
the same for every seed; the seed assigns them to the points, so each seed
does the same work in another order.
An increment is one ``Material.integrate`` on the whole batch, the commit of
the trial state, and one host read (the norm of the new p, as a Newton
iteration reads its residual's norm); after the last increment the state
goes back to the virgin one and the path starts again.

The cell's ``params``: ``increments``, ``strain_std``, ``law`` (null for the
configuration's closed-form hardening, else a law as text, see ``laws.py``),
``kept`` (how many increments of the window are kept for the check).
"""

from __future__ import annotations

import math
import time

import numpy as np

from portbench import core, trace


class Driver:
    def __init__(self, cell, seed, device, cfg):
        import torch

        self.torch, self.cfg, self.device, self.seed = torch, cfg, device, seed
        params = cell.spec["params"]
        self.limits = cell.spec["limits"]
        self.reference = cell.reference()
        self.n = n = int(cfg["n_points"])
        self.n_inc = int(params["increments"])
        self.std = float(params["strain_std"])
        self.law = params["law"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.material = cell.builder().build(cfg, self.law, device)
        self.strain = strain_path(n, self.std, self.n_inc, seed, self.dtype, device)
        self.path = [self.strain(k) for k in range(self.n_inc)]
        self.virgin = {"eps_p": torch.zeros(n, 6, dtype=self.dtype, device=device),
                       "p": torch.zeros(n, dtype=self.dtype, device=device)}
        self.sampling = np.random.default_rng([seed, 1])
        self.size = int(params["kept"])
        self.kept, self.seen = [], 0
        self.shapes = dict(n_points=n, dtype=cfg["dtype"], law=self.law)
        t = time.perf_counter()
        warm = core.Window()
        for k in range(2):  # the kernel loaded, a law traced, the allocator's blocks made
            self._increment(k, warm, False)
        self.reset()
        self.k = 0
        self._sync()
        core.log(f"warm-up increments {time.perf_counter() - t:.3f} s")

    def _sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def reset(self):
        self.material.set_initial_state_dict(self.virgin)

    def _increment(self, k, w, profile):
        """Update, commit, read; recorded in ``w``. Returns the outputs."""
        m = self.material
        ta = time.perf_counter()
        with trace.span("update", profile):
            sig, _, Ct = m.integrate(self.path[k])
        m.data_manager.update()
        tb = time.perf_counter()
        s0 = m.data_manager.s0.internal
        with trace.span("read", profile):
            value = float(self.torch.linalg.vector_norm(s0["p"]))
        tc = time.perf_counter()
        w.spans["increment"].append(tc - ta)
        w.spans["host"].append(tb - ta)
        w.counts["attempted"] += 1
        w.counts["failed"] += not math.isfinite(value)
        w.counts["point_updates"] += self.n
        return sig, Ct, s0["eps_p"], s0["p"]

    def window(self, seconds, instrument=False, profile=False):
        """Increments for ``seconds`` of wall time (``profile``: under the
        profiler, at most ``trace.SECONDS``)."""
        w = core.Window()
        if profile:
            w.trace = trace.profiled(lambda part: self._run(w, part, True), min(seconds, trace.SECONDS), ("update",))
            w.seconds = w.trace.window_s
        else:
            w.seconds = self._run(w, seconds, False)
        return w

    def _run(self, w, seconds, profile):
        """Increments for ``seconds``; the path under way goes on in the
        next call."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if self.k == self.n_inc:
                self.reset()
                self.k = 0
            self._keep(self.k, self._increment(self.k, w, profile))
            self.k += 1
        self._sync()
        return time.perf_counter() - t0

    def _keep(self, k, outputs):
        """A reservoir of ``kept`` increments of the window, drawn from the
        seed: the outputs are new tensors each increment, kept by
        reference."""
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((k, outputs))
        else:
            j = self.sampling.integers(self.seen)
            if j < self.size:
                self.kept[j] = (k, outputs)

    def release(self):
        kept = self.kept
        del self.material, self.path, self.virgin, self.kept
        if self.device != "cpu":
            self.torch.cuda.empty_cache()
        return kept

    def compare(self, kept):
        return compare(self.cfg, self.law, self.strain, kept, self.limits, self.reference)


TOTALS_SEED = 20210521  # the one draw of strain totals that every seed permutes


def strain_path(n, std, n_inc, seed, dtype, device):
    """``path(k)``: the strains of increment ``k``, ``(k + 1) / n_inc`` of
    each point's total. The totals (``std`` a component, normal) are one
    fixed draw on the device; the seed permutes them over the points."""
    import torch

    def path(k):
        g = torch.Generator(device=device).manual_seed(TOTALS_SEED)
        total = std * torch.randn(n, 6, generator=g, dtype=dtype, device=device)
        order = torch.randperm(n, generator=g.manual_seed(seed), device=device)
        return (total[order] * ((k + 1) / n_inc)).contiguous()

    return path


def compare(cfg, law, strain, kept, limits, reference):
    """Each kept increment's ``(sig, Ct, eps_p, p)`` against the reference's
    from the virgin state along the same path: the largest |difference|
    over the largest |sigma_ref|, over E, and (eps_p, p) over the yield
    strain sig0 / E."""
    e = dict.fromkeys(("sig", "tangent", "eps_p", "p"), 0.0)
    refs = reference.run(cfg, law, strain, {k for k, _ in kept})
    for k, out in kept:
        ref = refs[k]
        scales = (ref[0].abs().max(), cfg["E"], cfg["sig0"] / cfg["E"], cfg["sig0"] / cfg["E"])
        for name, o, r, s in zip(e, out, ref, scales):
            e[name] = max(e[name], float((o.reshape(r.shape).double() - r).abs().max() / s))
    return {name: {"value": v, "limit": limits[name]} for name, v in e.items()}
