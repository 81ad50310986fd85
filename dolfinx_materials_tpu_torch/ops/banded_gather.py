"""Banded gather: unstructured FEM gathers and assembly as planned takes.

``out[n] = sum_k table[idx[n, k]]`` (idx -1 = skip) for a static index set,
planned once on the host (numpy) and run by a CUDA kernel
(``csrc/banded_take.cu``) on the card:

- the planners are the JAX package's: the output slots are cut into chunks;
  per chunk and per index layer k all indices live in a small window of
  consecutive 128-wide table rows, so the plan stores a window base per
  (chunk, layer) and per slot its (row, lane) in the window; the few
  out-of-window outliers go to a patch list;
- layered index sets turn scatter-add assembly into a gather: for local slot
  i the cells whose slot i touches dof d form a few (ndofs,) layers over
  feature-major element values (:func:`plan_slotwise_assembly`);
- at plan time the window layout and the patch list are folded into one
  compact list per output of absolute int32 table indices, in the order of
  the adds of the windowed take (kept layers by ascending k, then the
  output's patches in list order), stored twice: sliced ELL (slices of 32
  outputs, slot-fastest, padded with -1) and CSR. The two kernels walk
  these lists, one launch per take with the patches inside.

Counterparts of dolfinx_materials_tpu/ops/banded_gather.py: the planners are
copied (arrays as torch tensors on the plan's device); ``make_banded_take``,
``make_banded_take_vmem`` and ``banded_take_xla`` become the kernel wrappers
:func:`banded_take_csr` and :func:`banded_take_ell` and the plain version
:func:`banded_take_reference`; the dispatcher :func:`banded_take` keeps its
name. ``VMEM_TABLE_BYTES``, the TPU's on-chip table budget that chose between
the two Pallas kernels, has no counterpart: the card's kernels read the
table from global memory, and :func:`_best_take` chooses by the ELL padding
of the plan (:data:`ELL_MAX_PADDING`). :func:`compact_take_reference` is the
plain version of the two kernels: the same lists, the same adds in the same
order.

A scatter-add over a static index (the two-level coarse matrices, the
block-Jacobi node blocks) is planned the same way: :func:`plan_fixed_sum`
lists each output's terms in ascending order and :func:`fixed_sum` runs the
CSR kernel over them, so the sum is the same bits in every run, where an
atomic ``index_add_`` on the card is not; :func:`gather_map` does it as a
padded gather and a row sum for few outputs with many terms each.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .cuda_build import check, function

LANE = 128
SUB = 8  # window rows per sub-block
WARP = 32  # outputs per ELL slice: one warp reads a slice's slot row at once

#: largest ELL padding (ELL slots / entries) at which :func:`_best_take`
#: still picks the ELL kernel. On the H100 the two kernels tie on the
#: unpadded plans (1.0; ELL ahead by at most 0.0002 ms, inside the spread
#: between runs) and at 1.78, and CSR is 30 % faster at 2.0 (PERF.md)
ELL_MAX_PADDING = 1.5


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
    # compact lists (see the module docstring), int32
    ell_ptr: torch.Tensor = None  # (ceil(n_out / WARP) + 1,) first slot of each slice
    ell_idx: torch.Tensor = None  # (ell_ptr[-1],) entry j of output 32 s + t at ell_ptr[s] + 32 j + t
    csr_ptr: torch.Tensor = None  # (n_out + 1,) first entry of each output
    csr_idx: torch.Tensor = None  # (entries,)
    ell_padding: float = 1.0  # ELL slots / entries
    # (layout, dtype) -> (ctypes entry point, index pointers), set at first launch
    _launch_cache: dict = field(default_factory=dict, repr=False)

    @property
    def device(self):
        return self.rloc.device


def _set_patches(plan: BandedTakePlan, pos: np.ndarray, idx: np.ndarray) -> None:
    """Store the patch list, its grouping into layers of unique output
    positions (occurrence rank of each position, in list order), and the
    compact lists that fold patches and kept slots together."""
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
    _set_compact(plan, pos, idx)


def _set_compact(plan: BandedTakePlan, pos: np.ndarray, idx: np.ndarray) -> None:
    """Each output's entries as absolute table indices: its kept slots by
    ascending layer k, then its patches in list order, which is the order of
    the adds of the windowed take followed by the layer-wise patches."""
    rl = plan.rloc.cpu().numpy().reshape(plan.ns, plan.K, plan.C)
    cl = plan.cloc.cpu().numpy().reshape(plan.ns, plan.K, plan.C)
    base = plan.base8.cpu().numpy().astype(np.int64) * plan.sub
    s, c, k = np.nonzero(rl.transpose(0, 2, 1) >= 0)  # by output slot, then layer
    out = np.concatenate([s * plan.C + c, pos])
    ent = np.concatenate([(base[s, k] + rl[s, k, c]) * LANE + cl[s, k, c], idx])
    order = np.argsort(out, kind="stable")  # kept slots stay ahead of patches
    out, ent = out[order], ent[order]
    n = plan.n_out
    counts = np.bincount(out, minlength=n)
    csr_ptr = np.r_[0, np.cumsum(counts)]
    rank = np.arange(len(out)) - csr_ptr[out]
    nsl = -(-n // WARP)
    width = np.zeros(nsl * WARP, np.int64)
    width[:n] = counts
    width = width.reshape(nsl, WARP).max(axis=1)
    ell_ptr = np.r_[0, np.cumsum(width * WARP)]
    if max(plan.n_src, n, int(ell_ptr[-1])) >= 2**31 - WARP:
        raise ValueError("banded take: the compact lists need int32 indices and offsets")
    ell_idx = np.full(int(ell_ptr[-1]), -1, np.int32)
    ell_idx[ell_ptr[out // WARP] + rank * WARP + out % WARP] = ent
    dev = plan.device

    def arr(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)

    plan.ell_ptr, plan.ell_idx = arr(ell_ptr), arr(ell_idx)
    plan.csr_ptr, plan.csr_idx = arr(csr_ptr), arr(ent)
    plan.ell_padding = len(ell_idx) / max(1, len(ent))
    plan._launch_cache = {}


def _plan_device(device) -> torch.device:
    """The plan's device. The take kernels launch on the current CUDA
    device's current stream and enter no device context, so a CUDA plan must
    be made on the current device: checked here, once, rather than at the
    first take."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(
            f"banded take: plan device {dev} is not the current CUDA device "
            f"cuda:{torch.cuda.current_device()}; call torch.cuda.set_device first"
        )
    return dev


def plan_banded_take(
    idx, n_src, chunk=1024, max_R=64, max_patch_frac=0.20, row_quantile=0.99,
    sub=SUB, device="cpu",
) -> BandedTakePlan | None:
    """Plan a banded take. ``idx``: (N,) or (N, K) int array, entries in
    [0, n_src) or -1 (skip). Each layer k gets its own per-chunk window.

    ``row_quantile``: R is sized for this quantile of the window-row
    distribution; long-range outliers go to the patch list instead of
    inflating every chunk's window. Returns None if more than
    ``max_patch_frac`` of the entries would need patching. A CUDA
    ``device`` must be the current CUDA device, as the kernels launch there."""
    dev = _plan_device(device)
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


def compact_take_reference(table, plan: BandedTakePlan, layout: str):
    """Plain PyTorch version of the two kernels: walks ``layout``'s ("ell"
    or "csr") compact lists entry by entry, adding in the kernels' order, so
    on the card it is bitwise equal to both."""
    n = plan.n_out
    o = torch.arange(n, device=table.device)
    if layout == "ell":
        ptr, idx = plan.ell_ptr.long(), plan.ell_idx.long()
        start = ptr[o // WARP] + o % WARP
        width = (ptr[o // WARP + 1] - ptr[o // WARP]) // WARP
        step = WARP
    elif layout == "csr":
        ptr, idx = plan.csr_ptr.long(), plan.csr_idx.long()
        start = ptr[:-1]
        width = ptr[1:] - start
        step = 1
    else:
        raise ValueError(f"compact_take_reference: unknown layout {layout!r}")
    acc = torch.zeros(n, dtype=table.dtype, device=table.device)
    for j in range(int(width.max()) if n else 0):
        e = idx[(start + j * step).clamp(max=max(len(idx) - 1, 0))]
        live = (j < width) & (e >= 0)  # ELL pads each row's tail with -1
        acc = torch.where(live, acc + table[e.clamp(min=0)], acc)
    return acc


SOURCE = "banded_take.cu"
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _launch(table, plan: BandedTakePlan, layout: str, wrapper):
    """Check ``table`` and launch ``layout``'s kernel once on the current
    device's current stream (the table and the plan must be on that device);
    the entry point and the list pointers are cached on the plan."""
    if table.dtype not in _SUFFIX:
        raise TypeError(f"{wrapper.__name__}: unsupported dtype {table.dtype}")
    if table.shape != (plan.n_src,) or not table.is_contiguous():
        raise ValueError(
            f"{wrapper.__name__}: expected a contiguous ({plan.n_src},) table, got {tuple(table.shape)}"
        )
    dev = table.device.index
    if not table.is_cuda or dev != torch.cuda.current_device():
        raise ValueError(f"{wrapper.__name__}: table on {table.device}, not on the current CUDA device")
    if plan.device != table.device:
        raise ValueError(f"{wrapper.__name__}: plan on {plan.device}, table on {table.device}")
    cached = plan._launch_cache.get((layout, table.dtype))
    if cached is None:
        vp = ctypes.c_void_p
        fn = function(SOURCE, f"banded_take_{layout}_{_SUFFIX[table.dtype]}",
                      [vp, vp, vp, vp, ctypes.c_int, vp])
        ptr, idx = (plan.ell_ptr, plan.ell_idx) if layout == "ell" else (plan.csr_ptr, plan.csr_idx)
        cached = plan._launch_cache[(layout, table.dtype)] = (fn, ptr.data_ptr(), idx.data_ptr())
    fn, ptr, idx = cached
    out = torch.empty(plan.n_out, dtype=table.dtype, device=table.device)
    # the current stream's raw handle, as PyTorch's generated kernel launchers
    # take it: torch.cuda.current_stream() builds a Stream object, which costs
    # more host time than the whole launch (PERF.md)
    rc = fn(table.data_ptr(), ptr, idx, out.data_ptr(), plan.n_out,
            torch._C._cuda_getCurrentRawStream(dev))
    check(rc, SOURCE, wrapper.__name__)
    wrapper.launches += 1
    wrapper.f32_launches += table.dtype == torch.float32
    return out


def banded_take_ell(table, plan: BandedTakePlan):
    """The take as one gather kernel over the sliced-ELL lists on CUDA
    tables (counterpart of the Pallas ``make_banded_take_vmem``); the plain
    version on CPU tables. A CUDA table and its plan must be on the current
    CUDA device."""
    if table.device.type == "cpu":
        return banded_take_reference(table, plan)
    return _launch(table, plan, "ell", banded_take_ell)


banded_take_ell.launches = 0
banded_take_ell.f32_launches = 0  # the float32 share of ``launches``


def banded_take_csr(table, plan: BandedTakePlan):
    """The take as one gather kernel over the CSR lists on CUDA tables
    (counterpart of the Pallas ``make_banded_take``), for plans whose
    per-output entry counts are uneven; the plain version on CPU tables. A
    CUDA table and its plan must be on the current CUDA device."""
    if table.device.type == "cpu":
        return banded_take_reference(table, plan)
    return _launch(table, plan, "csr", banded_take_csr)


banded_take_csr.launches = 0
banded_take_csr.f32_launches = 0


def _best_take(plan: BandedTakePlan):
    """Kernel selection: ELL unless its padding exceeds
    :data:`ELL_MAX_PADDING`, then CSR."""
    return banded_take_ell if plan.ell_padding <= ELL_MAX_PADDING else banded_take_csr


def banded_take(table, plan: BandedTakePlan):
    """The take, dispatched (counterpart of the JAX package's
    ``banded_take``): on a CUDA table the kernel that :func:`_best_take`
    picks for the plan, on a CPU table the plain version. A table and a
    plan on different devices raise."""
    if plan.device != table.device:
        raise ValueError(f"banded_take: plan on {plan.device}, table on {table.device}")
    if table.device.type == "cpu":
        return banded_take_reference(table, plan)
    return _best_take(plan)(table, plan)


# ------------------------------------------------------------ fixed-order sums
def gather_map(target, n_out) -> np.ndarray:
    """For each output i the positions p with ``target[p] == i``, ascending,
    padded with ``len(target)``: ``cat([vals, 0])[map].sum(1)`` is the
    scatter-add ``out[target[p]] += vals[p]`` as one gather and a row sum,
    no atomics. For sums of few outputs with many terms each, where one
    thread per output (:func:`fixed_sum`) would walk long lists alone."""
    target = np.asarray(target, np.int64).reshape(-1)
    order = np.argsort(target, kind="stable")
    counts = np.bincount(target, minlength=int(n_out))
    gm = np.full((int(n_out), int(counts.max()) if len(target) else 0), len(target), np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    gm[target[order], np.arange(len(target)) - np.repeat(starts, counts)] = order
    return gm


@dataclass
class SumPlan:
    """A scatter-add ``out[target[p]] += vals[p]`` with a static ``target``,
    recast as a take: output i sums the ``vals[p]`` with ``target[p] == i``
    in ascending p (CSR lists, the layout the CSR take kernel walks)."""

    n_out: int
    n_src: int
    csr_ptr: torch.Tensor  # (n_out + 1,) int32
    csr_idx: torch.Tensor  # (n_src,) int32: the p of each output, ascending
    target: torch.Tensor | None  # (n_src,) int64 on CPU plans (the plain version's index)
    _launch_cache: dict = field(default_factory=dict, repr=False)

    @property
    def device(self):
        return self.csr_idx.device


def plan_fixed_sum(target, n_out, device="cpu") -> SumPlan:
    """Plan the fixed-order sum of values landing on ``target`` (any shape,
    entries in [0, n_out)). A CUDA ``device`` must be the current device."""
    dev = _plan_device(device)
    target = np.asarray(target, np.int64).reshape(-1)
    if max(len(target), int(n_out)) >= 2**31 - WARP:
        raise ValueError("fixed-order sum: the CSR lists need int32 indices and offsets")
    order = np.argsort(target, kind="stable")
    ptr = np.r_[0, np.cumsum(np.bincount(target, minlength=int(n_out)))]

    def arr(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)

    return SumPlan(
        n_out=int(n_out), n_src=len(target), csr_ptr=arr(ptr), csr_idx=arr(order),
        target=torch.as_tensor(target) if dev.type == "cpu" else None,
    )


def fixed_sum_reference(vals, plan: SumPlan):
    """Plain PyTorch version of :func:`fixed_sum` on CPU values:
    ``index_add_``, whose loop over a 1-D source adds in ascending p, the
    kernel's order, so the two are bitwise equal (on the card
    ``index_add_`` is atomic and its order changes between runs)."""
    return vals.new_zeros(plan.n_out).index_add_(0, plan.target, vals)


def fixed_sum(vals, plan: SumPlan):
    """``out[i] = sum of vals[p] over target[p] == i``, in ascending p
    whatever the device: the CSR take kernel (:func:`banded_take_csr`, one
    launch, no atomics) on CUDA values, the plain version on CPU values.
    The values and the plan must be on one device."""
    if vals.device.type == "cpu":
        if plan.target is None:
            raise ValueError("fixed_sum: CPU values with a CUDA plan")
        return fixed_sum_reference(vals, plan)
    return _launch(vals, plan, "csr", banded_take_csr)


def balance_cell_slots(cells, cell_type):
    """Permute each cell's vertex list (orientation-preserving) to even out
    how often each vertex lands in each local slot: the assembly plan's
    entries per slot then drop from the largest valence toward valence/nloc.
    Tets take the even permutations (3-cycles fixing vertex 0 and one double
    transposition), other cells the cyclic rotations.

    A strided greedy: cells are taken in 128 interleaved strides
    (``cells[k::128]``), so a vertex's incident cells, contiguous after a
    min-vertex sort, fall in different strides and see each other's counts;
    per stride each cell takes the permutation of least summed
    (vertex, slot) count, then the counts are updated. Host-side numpy."""
    cells = np.asarray(cells)
    ne, nv = cells.shape
    if cell_type == "tetrahedron":
        perms = np.array([(0, 1, 2, 3), (0, 2, 3, 1), (0, 3, 1, 2), (1, 0, 3, 2)])
    else:
        perms = np.array([np.roll(np.arange(nv), -r) for r in range(nv)])
    S = 128
    slot_count = np.zeros((int(cells.max()) + 1, nv), np.int32)
    out = np.empty_like(cells)
    arange_nv = np.arange(nv)
    for k in range(min(S, ne)):
        idx = np.arange(k, ne, S)
        cand = cells[idx][:, perms]  # (b, nperm, nv)
        best = np.argmin(slot_count[cand, arange_nv].sum(axis=2), axis=1)
        chosen = np.take_along_axis(cand, best[:, None, None], axis=1)[:, 0]
        out[idx] = chosen
        np.add.at(slot_count, (chosen, arange_nv), 1)
    return out.astype(cells.dtype)
