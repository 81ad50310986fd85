"""Banded gather: unstructured FEM gathers and assembly as planned takes.

``out[n] = sum_k table[idx[n, k]]`` (idx -1 = skip) for a static index set,
planned once on the host (numpy) and run by a CUDA kernel
(``csrc/banded_take.cu``) on the card:

- the output slots are cut into chunks; per chunk and per index layer k all
  indices live in a small window of consecutive 128-wide table rows, so the
  plan stores a window base per (chunk, layer) and per slot its (row, lane)
  in the window; the few out-of-window outliers go to a patch list;
- layered index sets turn scatter-add assembly into a gather: for local slot
  i the cells whose slot i touches dof d form a few (ndofs,) layers over
  feature-major element values (:func:`plan_slotwise_assembly`).

Counterparts of dolfinx_materials_tpu/ops/banded_gather.py: the planners are
copied (arrays as torch tensors on the plan's device), the plain version
:func:`banded_take_reference` mirrors ``banded_take_xla``, and the two kernel
wrappers replace the Pallas ``make_banded_take`` / ``make_banded_take_vmem``.
Patches are applied deterministically: the patch list is grouped at plan time
into layers of unique output positions, so repeated positions (assembly
overflow) never race.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

LANE = 128
SUB = 8  # window rows per sub-block

#: largest shared-memory window (bytes) the window kernel stages per
#: (chunk, layer); a plan whose largest occupied window exceeds it runs the
#: streaming kernel. 96 KB keeps two blocks resident per SM.
SMEM_WINDOW_BYTES = 96 << 10


@dataclass
class BandedTakePlan:
    """Host-planned take out[n] = sum_k table[idx[n, k]] (static idx)."""

    n_out: int
    n_src: int
    K: int
    C: int
    S: int
    ns: int
    R: int  # window rows per (chunk, layer), multiple of sub
    nrows: int  # padded table rows (the TPU kernels' layout; kept for parity)
    sub: int
    base8: torch.Tensor  # (ns, K) int32 window base in sub-row units
    rloc: torch.Tensor  # (ns, K, S, LANE) int32 window row, -1 = masked
    cloc: torch.Tensor  # (ns, K, S, LANE) int32 lane column in [0, LANE)
    nq: torch.Tensor  # (ns, K) int32 occupied sub-blocks per (chunk, layer)
    max_nq: int  # largest entry of nq
    frac_patched: float
    patch_pos: torch.Tensor = None  # (npatch,) int64 output positions of outliers
    patch_idx: torch.Tensor = None  # (npatch,) int64 table indices of outliers
    patch_layers: list = None  # [(pos, idx)] with unique pos per layer

    @property
    def device(self):
        return self.rloc.device


def _set_patches(plan: BandedTakePlan, pos: np.ndarray, idx: np.ndarray) -> None:
    """Store the patch list and its grouping into layers of unique output
    positions (occurrence rank of each position, in list order)."""
    pos = np.asarray(pos, np.int64)
    idx = np.asarray(idx, np.int64)
    dev = plan.device
    plan.patch_pos = torch.as_tensor(pos, device=dev)
    plan.patch_idx = torch.as_tensor(idx, device=dev)
    layers = []
    if len(pos):
        order = np.argsort(pos, kind="stable")
        sp = pos[order]
        starts = np.r_[0, np.nonzero(np.diff(sp))[0] + 1]
        counts = np.diff(np.r_[starts, len(sp)])
        rank = np.empty(len(pos), np.int64)
        rank[order] = np.arange(len(sp)) - np.repeat(starts, counts)
        for r in range(int(rank.max()) + 1):
            sel = np.nonzero(rank == r)[0]
            layers.append(
                (torch.as_tensor(pos[sel], device=dev), torch.as_tensor(idx[sel], device=dev))
            )
    plan.patch_layers = layers


def plan_banded_take(
    idx, n_src, chunk=1024, max_R=64, max_patch_frac=0.20, row_quantile=0.99,
    sub=SUB, device="cpu",
) -> BandedTakePlan | None:
    """Plan a banded take. ``idx``: (N,) or (N, K) int array, entries in
    [0, n_src) or -1 (skip). Each layer k gets its own per-chunk window.

    ``row_quantile``: R is sized for this quantile of the window-row
    distribution; long-range outliers go to the patch list instead of
    inflating every chunk's window. Returns None if more than
    ``max_patch_frac`` of the entries would need patching."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.ndim == 1:
        idx = idx[:, None]
    N, K = idx.shape
    C = int(chunk)
    assert C % LANE == 0
    S = C // LANE
    N_pad = -(-N // C) * C
    ns = N_pad // C
    idx_p = np.full((N_pad, K), -1, np.int64)
    idx_p[:N] = idx
    chunks = idx_p.reshape(ns, C, K).transpose(0, 2, 1)  # (ns, K, C)

    valid = chunks >= 0
    big = np.where(valid, chunks, np.int64(1 << 60))
    # robust window base: a low quantile, not the min (below-base outliers
    # are patched instead of inflating every other entry's window row)
    srt = np.sort(big, axis=2)
    lo_i = max(0, int(round((1.0 - row_quantile) * C)))
    cmin = srt[:, :, lo_i]
    cmin = np.where(cmin == (1 << 60), 0, cmin)
    base8 = (cmin // LANE) // sub

    rel_row = chunks // LANE - (base8 * sub)[:, :, None]
    inside = valid & (rel_row >= 0)
    R_q = int(np.quantile(rel_row[inside], row_quantile)) + 1 if inside.any() else 1
    R = min(int(max_R), -(-R_q // sub) * sub)
    out_of_window = valid & ((rel_row < 0) | (rel_row >= R))

    keep = valid & ~out_of_window
    rloc = np.where(keep, rel_row, -1).astype(np.int32)
    cloc = np.where(keep, chunks % LANE, 0).astype(np.int32)

    oow = out_of_window.transpose(0, 2, 1).reshape(N_pad, K)
    pos_flat = np.nonzero(oow)
    patch_pos = pos_flat[0]
    patch_idx = idx_p[pos_flat[0], pos_flat[1]]
    frac = len(patch_pos) / max(1, int(valid.sum()))
    if frac > max_patch_frac:
        return None

    nrows = -(-n_src // LANE) + R + sub
    nrows = -(-nrows // sub) * sub
    max_row = np.where(keep, rel_row, -1).max(axis=2)  # (ns, K)
    nq = np.ceil((max_row + 1) / sub).astype(np.int32)
    dev = torch.device(device)

    def arr(a):  # C order: the kernels index the flat buffers
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    plan = BandedTakePlan(
        n_out=N,
        n_src=int(n_src),
        K=K,
        C=C,
        S=S,
        ns=ns,
        R=R,
        nrows=nrows,
        sub=int(sub),
        base8=arr(base8.astype(np.int32)),
        rloc=arr(rloc.reshape(ns, K, S, LANE)),
        cloc=arr(cloc.reshape(ns, K, S, LANE)),
        nq=arr(nq),
        max_nq=int(nq.max()) if nq.size else 0,
        frac_patched=frac,
    )
    _set_patches(plan, patch_pos, patch_idx)
    return plan


def plan_slotwise_assembly(
    dofmap, ndofs, chunk=1024, max_R=64, k_quantile=0.99, sub=SUB, device="cpu"
):
    """Plan scatter-add assembly y[dm[e, i]] += vals[i, e] as ONE banded take
    over FEATURE-MAJOR (nd, ne) element values, flattened.

    For each local slot i the inverse map "cells whose slot i hits dof d"
    gives k_i layers of (ndofs,) indices into cell space, offset by i*ne.
    ``k_quantile`` sizes k_i; the few max-valence dofs spill their excess
    occurrences into the patch list. Returns the plan or None."""
    dm = np.asarray(dofmap)
    ne, nd = dm.shape
    layers = []
    extra_pos, extra_idx = [], []
    for i in range(nd):
        col = dm[:, i]
        order = np.argsort(col, kind="stable")
        sorted_d = col[order]
        counts = np.bincount(sorted_d, minlength=ndofs)
        k_full = int(counts.max()) if ne else 0
        k_i = max(1, int(np.quantile(counts[counts > 0], k_quantile))) if ne else 0
        k_i = min(k_i, k_full)
        gm = np.full((ndofs, k_full), -1, np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(ne) - np.repeat(starts, counts)
        gm[sorted_d, within] = order + i * ne
        if k_i < k_full:
            ov_d, ov_k = np.nonzero(gm[:, k_i:] >= 0)
            extra_pos.append(ov_d)
            extra_idx.append(gm[ov_d, k_i + ov_k])
            gm = gm[:, :k_i]
        layers.append(gm)
    idx = np.concatenate(layers, axis=1)  # (ndofs, sum_i k_i)
    plan = plan_banded_take(idx, nd * ne, chunk=chunk, max_R=max_R, sub=sub, device=device)
    if plan is not None and extra_pos:
        _set_patches(
            plan,
            np.concatenate([plan.patch_pos.cpu().numpy()] + extra_pos),
            np.concatenate([plan.patch_idx.cpu().numpy()] + extra_idx),
        )
    return plan


def _apply_patches(plan: BandedTakePlan, out, table):
    """Add the out-of-window outliers; each layer's positions are unique, so
    the result does not depend on any scheduling order."""
    for pos, idx in plan.patch_layers:
        out[pos] += table[idx]
    return out


def banded_take_reference(table, plan: BandedTakePlan):
    """Plain PyTorch version of the take (the counterpart of
    ``banded_take_xla``): one scalar gather over all (slot, layer) pairs."""
    rl = plan.rloc.reshape(plan.ns, plan.K, -1)
    cl = plan.cloc.reshape(plan.ns, plan.K, -1)
    gidx = (plan.base8[:, :, None].long() * plan.sub + rl) * LANE + cl
    vals = torch.where(
        rl >= 0, table[gidx.clamp(0, plan.n_src - 1)], torch.zeros((), dtype=table.dtype, device=table.device)
    )
    out = vals.sum(dim=1).reshape(-1)[: plan.n_out].clone()
    return _apply_patches(plan, out, table)


_STREAM = {torch.float32: "banded_take_stream_f32", torch.float64: "banded_take_stream_f64"}
_WINDOW = {torch.float32: "banded_take_window_f32", torch.float64: "banded_take_window_f64"}


def _check_cuda(table, plan, name):
    if not table.is_cuda:
        raise ValueError(f"{name}: unsupported device {table.device}")
    if table.dtype not in _STREAM:
        raise TypeError(f"{name}: unsupported dtype {table.dtype}")
    if table.shape != (plan.n_src,) or not table.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous ({plan.n_src},) table, got {tuple(table.shape)}"
        )
    if plan.device != table.device:
        raise ValueError(f"{name}: plan on {plan.device}, table on {table.device}")
    if not all(t.is_contiguous() for t in (plan.base8, plan.rloc, plan.cloc, plan.nq)):
        raise ValueError(f"{name}: plan arrays must be contiguous")


SOURCE = "banded_take.cu"


def banded_take_streaming(table, plan: BandedTakePlan):
    """Streaming take kernel on CUDA tables (counterpart of the Pallas
    ``make_banded_take``); plain version on CPU tables."""
    if table.device.type == "cpu":
        return banded_take_reference(table, plan)
    _check_cuda(table, plan, "banded_take_streaming")
    from .cuda_build import check, function

    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = function(SOURCE, _STREAM[table.dtype], [vp] * 5 + [ctypes.c_longlong, ci, ci, ci, vp])
    out = torch.empty(plan.n_out, dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(
            table.data_ptr(), plan.base8.data_ptr(), plan.rloc.data_ptr(),
            plan.cloc.data_ptr(), out.data_ptr(), plan.n_out, plan.K, plan.C,
            plan.sub, stream,
        )
    check(rc, SOURCE, "banded_take_streaming")
    banded_take_streaming.launches += 1
    return _apply_patches(plan, out, table)


banded_take_streaming.launches = 0


def window_bytes(plan: BandedTakePlan, dtype) -> int:
    """Shared memory the window kernel needs for ``plan``'s largest window."""
    return plan.max_nq * plan.sub * LANE * torch.empty((), dtype=dtype).element_size()


def banded_take_windowed(table, plan: BandedTakePlan):
    """Shared-memory window take kernel on CUDA tables (counterpart of the
    Pallas ``make_banded_take_vmem``); plain version on CPU tables."""
    if table.device.type == "cpu":
        return banded_take_reference(table, plan)
    _check_cuda(table, plan, "banded_take_windowed")
    if plan.C > 2048:
        raise ValueError(f"banded_take_windowed: chunk {plan.C} > 2048")
    from .cuda_build import check, function

    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = function(SOURCE, _WINDOW[table.dtype],
                  [vp, ctypes.c_longlong] + [vp] * 5 + [ctypes.c_longlong] + [ci] * 5 + [vp])
    out = torch.empty(plan.n_out, dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(
            table.data_ptr(), plan.n_src, plan.base8.data_ptr(), plan.nq.data_ptr(),
            plan.rloc.data_ptr(), plan.cloc.data_ptr(), out.data_ptr(), plan.n_out,
            plan.ns, plan.K, plan.C, plan.sub, plan.max_nq * plan.sub, stream,
        )
    check(rc, SOURCE, "banded_take_windowed")
    banded_take_windowed.launches += 1
    return _apply_patches(plan, out, table)


banded_take_windowed.launches = 0


def _best_take(plan: BandedTakePlan, dtype):
    """Kernel selection: the window kernel when the plan's largest window fits
    :data:`SMEM_WINDOW_BYTES` (and its chunk one block), the streaming kernel
    otherwise."""
    if plan.C <= 2048 and window_bytes(plan, dtype) <= SMEM_WINDOW_BYTES:
        return banded_take_windowed
    return banded_take_streaming
