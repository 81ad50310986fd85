"""The aggregate coarse correction of the fused step's two-level
preconditioner: two CUDA kernels (``csrc/coarse_correction.cu``) and their
plain PyTorch versions.

With ``P`` the map from the ``nmodes`` coarse values of each node aggregate
onto its dofs through the mode weights ``W`` (``(nnodes, ncomp, nmodes)``,
``parallel/coarse.py`` ``_coord_agg_modes``):

- :func:`coarse_restrict`: ``rc = P^T r0`` with ``r0 = s_inv * where(mask,
  0, r)``;
- :func:`coarse_prolong`: ``z + where(mask, 0, s_inv * P (Ac_inv @ rc))``.

:func:`plan_aggregates` lists each aggregate's dofs once (CSR, int32); the
kernels run one block per aggregate over these lists. The plain versions keep
the arithmetic the fused step had before the kernels (a padded gather of
node values and a row sum, a dense product, a gather of each node's coarse
values), with their tables derived from the same lists on first use. The
kernels sum in another order: f64 results agree to ~1e-13 of their scale.
The design and the bound on the card are noted in the CUDA source.

The wrappers launch the kernel on CUDA tensors or raise; they take the plain
version for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .banded_gather import _plan_device
from .cuda_build import check, function

#: the mode counts the kernels are built for ("trans": ncomp; "rbm": 3 in
#: 2D, 6 in 3D)
MAX_MODES = 6


@dataclass
class AggregatePlan:
    """Node aggregates of a ``ncomp``-component space, each with ``nmodes``
    coarse dofs (``a * nmodes + m``); the dofs of aggregate ``a`` are
    ``agg_dofs[agg_ptr[a]:agg_ptr[a + 1]]``, ascending."""

    nagg: int
    ncomp: int
    nmodes: int
    agg_ptr: torch.Tensor  # (nagg + 1,) int32
    agg_dofs: torch.Tensor  # (ndofs,) int32
    # device -> (node-mode gather map, aggregate of each node), built on first use
    _plain: dict = field(default_factory=dict, repr=False)

    @property
    def ndofs(self) -> int:
        return self.agg_dofs.shape[0]

    @property
    def ncoarse(self) -> int:
        return self.nagg * self.nmodes

    @property
    def device(self):
        return self.agg_dofs.device

    def plain_tables(self, device):
        """The plain version's tables on ``device``, from the lists: for
        coarse dof ``a * nmodes + m`` the positions ``n * nmodes + m`` of
        its aggregate's nodes ``n`` ascending, padded with ``nnodes *
        nmodes`` (int64); and each node's aggregate (int64)."""
        device = torch.device(device)
        tables = self._plain.get(device)
        if tables is None:
            ptr = self.agg_ptr.cpu().numpy().astype(np.int64) // self.ncomp
            nodes = self.agg_dofs.cpu().numpy()[:: self.ncomp].astype(np.int64) // self.ncomp
            counts = np.diff(ptr)
            nnodes = len(nodes)
            slot = np.arange(nnodes) - np.repeat(ptr[:-1], counts)
            gm = np.full((self.nagg, int(counts.max()) if nnodes else 0), nnodes, np.int64)
            gm[np.repeat(np.arange(self.nagg), counts), slot] = nodes
            modes = np.arange(self.nmodes)
            node_map = np.where(gm[:, None, :] < nnodes, gm[:, None, :] * self.nmodes + modes[None, :, None],
                                nnodes * self.nmodes).reshape(self.ncoarse, -1)
            agg_node = np.empty(nnodes, np.int64)
            agg_node[nodes] = np.repeat(np.arange(self.nagg), counts)
            tables = self._plain[device] = (torch.as_tensor(node_map, device=device),
                                            torch.as_tensor(agg_node, device=device))
        return tables


def plan_aggregates(agg_of_node, ncomp, nmodes, device=None) -> AggregatePlan:
    """The per-aggregate dof lists of ``agg_of_node`` (each node's aggregate
    in ``[0, nagg)``, every aggregate non-empty): aggregates in order, each
    node's ``ncomp`` dofs ``node * ncomp + c``, ascending. A CUDA ``device``
    must be the current device."""
    dev = _plan_device(device)
    agg = np.asarray(agg_of_node, np.int64).reshape(-1)
    nagg = int(agg.max()) + 1 if len(agg) else 0
    counts = np.bincount(agg, minlength=nagg)
    if nagg and counts.min() == 0:
        raise ValueError("plan_aggregates: every aggregate needs a node")
    if not 1 <= int(nmodes) <= MAX_MODES:
        raise ValueError(f"plan_aggregates: {nmodes} modes an aggregate, the kernels take 1 to {MAX_MODES}")
    if len(agg) * int(ncomp) >= 2**31 or nagg * int(nmodes) >= 2**31:
        raise ValueError("plan_aggregates: the lists need int32 dofs")
    nodes = np.argsort(agg, kind="stable")  # ascending nodes within each aggregate
    dofs = (nodes[:, None] * ncomp + np.arange(ncomp)[None, :]).reshape(-1)
    ptr = np.r_[0, np.cumsum(counts * ncomp)]
    return AggregatePlan(
        nagg=nagg, ncomp=int(ncomp), nmodes=int(nmodes),
        agg_ptr=torch.as_tensor(ptr.astype(np.int32), device=dev),
        agg_dofs=torch.as_tensor(dofs.astype(np.int32), device=dev),
    )


# ------------------------------------------------------------ plain versions
def coarse_restrict_reference(r, plan: AggregatePlan, W, mask=None, s_inv=None):
    """Plain PyTorch version of :func:`coarse_restrict`: the node values
    ``sum_c r0[n, c] W[n, c, m]``, gathered per coarse dof and summed in
    ascending node order."""
    r0 = r if mask is None else torch.where(mask, r.new_zeros(()), r)
    if s_inv is not None:
        r0 = r0 * s_inv
    node_map, _ = plan.plain_tables(r.device)
    # elementwise: an einsum here runs as a batched product of 2x2s
    vals = (r0.reshape(-1, plan.ncomp)[:, :, None] * W).sum(dim=1).reshape(-1)
    return torch.cat([vals, r0.new_zeros(1)])[node_map].sum(dim=1)


def coarse_prolong_reference(rc, Ac_inv, plan: AggregatePlan, W, z=None, mask=None, s_inv=None):
    """Plain PyTorch version of :func:`coarse_prolong`: ``Ac_inv @ rc``, each
    node's aggregate values gathered and weighed, then scaled, masked and
    added to ``z``."""
    _, agg_node = plan.plain_tables(rc.device)
    wc = Ac_inv @ rc
    corr = (W * wc.reshape(-1, plan.nmodes)[agg_node][:, None, :]).sum(dim=2).reshape(-1)
    if s_inv is not None:
        corr = corr * s_inv
    if mask is not None:
        corr = torch.where(mask, corr.new_zeros(()), corr)
    return corr if z is None else z + corr


# ------------------------------------------------------------------ kernels
SOURCE = "coarse_correction.cu"
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_VP = ctypes.c_void_p
_RESTRICT_ARGS = [_VP] * 7 + [ctypes.c_int] * 2 + [_VP]
_PROLONG_ARGS = [_VP] * 9 + [ctypes.c_int] * 2 + [_VP]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(what, plan, dtype, tensors):
    """Raise unless every ``(name, tensor, shape, dtype)`` of ``tensors``
    (tensor None: absent) is a contiguous tensor of that shape and dtype on
    the current CUDA device, the plan's."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{what}: unsupported dtype {dtype}")
    dev = plan.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"{what}: plan on {dev}, not on the current CUDA device")
    for name, t, shape, dt in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, plan on {dev}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{what}: expected {name} {shape} {dt}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _weights_shape(plan):
    return (plan.ndofs // plan.ncomp, plan.ncomp, plan.nmodes)


def coarse_restrict(r, plan: AggregatePlan, W, mask=None, s_inv=None):
    """``rc`` (``(ncoarse,)``): the masked (``mask`` True: 0) and scaled
    (``* s_inv``) ``r`` restricted to the coarse dofs through ``W``
    (``(nnodes, ncomp, nmodes)``). One kernel launch on CUDA tensors, the
    plain version on CPU tensors; raises for a CUDA tensor the kernel does
    not take or a failed launch."""
    if r.device.type == "cpu":
        return coarse_restrict_reference(r, plan, W, mask, s_inv)
    what, dt, n = "coarse_restrict", r.dtype, plan.ndofs
    _check(what, plan, dt, [("r", r, (n,), dt), ("W", W, _weights_shape(plan), dt),
                            ("mask", mask, (n,), torch.bool), ("s_inv", s_inv, (n,), dt)])
    fn = function(SOURCE, f"{what}_{_SUFFIX[dt]}", _RESTRICT_ARGS)
    rc = r.new_empty(plan.ncoarse)
    code = fn(r.data_ptr(), _ptr(mask), _ptr(s_inv), W.data_ptr(), plan.agg_ptr.data_ptr(),
             plan.agg_dofs.data_ptr(), rc.data_ptr(), plan.nagg, plan.nmodes,
             torch._C._cuda_getCurrentRawStream(r.device.index))
    check(code, SOURCE, what)
    coarse_restrict.launches += 1
    coarse_restrict.f32_launches += dt == torch.float32
    return rc


coarse_restrict.launches = 0
coarse_restrict.f32_launches = 0  # the float32 share of ``launches``


def coarse_prolong(rc, Ac_inv, plan: AggregatePlan, W, z=None, mask=None, s_inv=None):
    """``z + where(mask, 0, s_inv * P (Ac_inv @ rc))`` (``(ndofs,)``; ``z``
    None: 0), each block forming its aggregate's rows of ``Ac_inv @ rc``.
    One kernel launch on CUDA tensors, the plain version on CPU tensors;
    raises for a CUDA tensor the kernel does not take or a failed launch."""
    if rc.device.type == "cpu":
        return coarse_prolong_reference(rc, Ac_inv, plan, W, z, mask, s_inv)
    what, dt, n, nc = "coarse_prolong", rc.dtype, plan.ndofs, plan.ncoarse
    _check(what, plan, dt, [("rc", rc, (nc,), dt), ("Ac_inv", Ac_inv, (nc, nc), dt),
                            ("W", W, _weights_shape(plan), dt), ("z", z, (n,), dt),
                            ("mask", mask, (n,), torch.bool), ("s_inv", s_inv, (n,), dt)])
    fn = function(SOURCE, f"{what}_{_SUFFIX[dt]}", _PROLONG_ARGS)
    out = rc.new_empty(n)
    code = fn(rc.data_ptr(), Ac_inv.data_ptr(), W.data_ptr(), plan.agg_ptr.data_ptr(),
             plan.agg_dofs.data_ptr(), _ptr(z), _ptr(mask), _ptr(s_inv), out.data_ptr(), plan.nagg,
             plan.nmodes, torch._C._cuda_getCurrentRawStream(rc.device.index))
    check(code, SOURCE, what)
    coarse_prolong.launches += 1
    coarse_prolong.f32_launches += dt == torch.float32
    return out


coarse_prolong.launches = 0
coarse_prolong.f32_launches = 0
