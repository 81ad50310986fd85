"""The fused Newton load step and the batched constitutive update, on one
card or over the ranks of a process group.

Counterparts of dolfinx_materials_tpu/parallel/sharding.py. There a load step
is one XLA program over a mesh of devices: gathers, constitutive update,
element residuals and matrices, an early-exit CG whose every iteration stays
on the device, a backtracking line search, all inside ``lax.while_loop``s.
Here each rank runs it on its own card:

- the element-level work is the port's own ``fem/assembly.py``
  (``QuadratureDomain``'s evaluation, residual, element-matrix and SpMV
  kernels, with their stencil, banded-take and gather-map routes), and the
  constitutive update is the material's (its fast path launches the J2
  kernel);
- the CG loop is cut into blocks of :data:`CG_BLOCK` masked iterations
  (an iteration past the stopping test changes nothing); on the card one
  block is captured as a CUDA graph and replayed until a flag on the device
  says the loop has stopped, so the host reads one flag per block. On the
  CPU the same block runs eagerly;
- Newton and the line search stay on the host: one read of the residual
  norm per Newton iteration and one per trial.

A mesh of more than one device is the ranks of a ``torch.distributed``
process group (:mod:`.multiprocess`), one device a rank, and the partition
is the JAX step's: each map's cells are padded to a multiple of the rank
count and rank r owns the r-th contiguous block of them and of their Gauss
points. Every rank runs the gathers and the assembly over the whole mesh
(the redundant-full pattern); the element work (constitutive update,
element residuals and matrices) runs on its block only. Where the JAX step
assembles its block's values and sums the assembled partial vectors
(``psum``), each rank here puts its block's element values among zeros over
every cell, sums that array across ranks with ``all_reduce`` (exact: a
cell's values are one rank's) and assembles it in full, so the assembled
vectors, the coarse matrix and the preconditioner are the one-device
step's to the bit at any rank count, and the Krylov counts with them.
With ``shard_dofs`` the dof vectors are split over the ranks as well (an
all-gather before the gathers, a summed dot product), the all-gather built
on ``all_reduce`` of each rank's slice among zeros.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..fem.forms import mixed_tangent_dtype
from ..ops import banded_gather as bg
from ..ops import j2_cuda
from ..ops.coarse_correction import coarse_prolong, coarse_restrict, plan_aggregates
from ..ops.banded_gather import fixed_sum, gather_map, plan_fixed_sum
from ..state import _slices
from ..utils.timers import count, timer
from .coarse import _coord_agg_modes, _p1_coarse
from .krylov import _sym_block_inv

#: masked CG iterations per block (one CUDA-graph replay, one host read).
#: A stopped loop wastes at most CG_BLOCK - 1 masked iterations of device
#: time; a longer block reads the flag less often
CG_BLOCK = 16

#: the ``all_reduce`` calls of :meth:`_Ranks.sum` in this process and the
#: bytes they summed. A CUDA-graph capture counts the calls it records, and
#: a replay calls nothing: :class:`MaskedCG` keeps what each capture recorded
#: under ``recorded["all_reduce"]`` as (calls, bytes)
REDUCED = {"calls": 0, "bytes": 0}


@dataclass
class DeviceMesh:
    """The device(s) a fused step runs on: ``devices`` shaped by the axis
    sizes, ``axis_names`` in order; over a process group, rank r's device at
    the row-major position r, ``group`` the group and ``rank`` this
    process's rank."""

    devices: np.ndarray
    axis_names: tuple
    group: object = None
    rank: int = 0

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices.flat[self.rank]


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def device_mesh(n_devices=None, axis="cells", devices=None) -> DeviceMesh:
    """The mesh a fused step runs on. ``axis`` may be a tuple of names with
    ``n_devices`` a tuple of sizes, outer axis first.

    Inside a process group (:func:`.multiprocess.initialize` in every rank)
    a mesh of as many devices as the group has ranks is the group's
    (:func:`.multiprocess.global_device_mesh`), one device a rank. Otherwise
    it is a mesh of one device: by default the current CUDA device (raising
    without a card, as :func:`~dolfinx_materials_tpu_torch.resolve_device`
    does); ``devices`` names it otherwise (``devices=["cpu"]``). More
    devices outside a group of that size raise ``RuntimeError``."""
    if isinstance(axis, (tuple, list)):
        sizes = tuple(int(s) for s in (n_devices or (1,) * len(axis)))
        names = tuple(axis)
    else:
        sizes = (1 if n_devices is None else int(n_devices),)
        names = (axis,)
    if len(sizes) != len(names):
        raise ValueError(f"mesh sizes {sizes} do not match its axes {names}")
    n = int(np.prod(sizes))
    if devices is None and _in_group() and n == dist.get_world_size():
        from .multiprocess import global_device_mesh

        return global_device_mesh(names, sizes)
    if n != 1:
        raise RuntimeError(
            f"a mesh of {n} devices runs one rank a device: call parallel.multiprocess.initialize in each of "
            f"{n} processes, then device_mesh({n_devices!r}) without `devices`")
    if devices is None:
        devices = [_canonical(resolve_device(None))]
    arr = np.empty(1, dtype=object)
    arr[0] = _canonical(devices[0])
    return DeviceMesh(arr.reshape(sizes), names)


def _mesh_device(mesh: DeviceMesh, axis) -> torch.device:
    """This rank's device of the mesh, after checking ``axis`` names the
    mesh's axes."""
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    missing = [a for a in names if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axis {missing} not in the mesh's axes {mesh.axis_names}")
    if mesh.group is None and mesh.size != 1:
        raise ValueError("a mesh of more than one device needs its process group")
    return mesh.device


class _Ranks:
    """A step's share of its mesh: this rank, the rank count, the blocks of
    rows each rank owns and the sums across ranks (``all_reduce``; on a
    mesh without a group, one rank and no collective)."""

    def __init__(self, mesh: DeviceMesh):
        self.group, self.rank = mesh.group, int(mesh.rank)
        self.n = mesh.size if mesh.group is not None else 1

    def block(self, n):
        """Rows ``[lo, hi)`` of this rank over ``n`` rows padded to a
        multiple of the rank count."""
        loc = -(-int(n) // self.n)
        return self.rank * loc, (self.rank + 1) * loc

    def sum(self, t):
        """``t`` summed over the ranks (a new tensor; ``t`` itself without
        a group)."""
        if self.group is None:
            return t
        t = t.clone(memory_format=torch.contiguous_format)
        REDUCED["calls"] += 1
        REDUCED["bytes"] += t.numel() * t.element_size()
        dist.all_reduce(t, group=self.group)
        return t

    def join(self, t, lo, n_all):
        """The ranks' row blocks joined: ``t`` holds this rank's rows from
        ``lo`` of ``n_all``; the rows of other ranks are theirs (exact: each
        row is summed with zeros)."""
        if self.group is None and lo == 0 and t.shape[0] == n_all:
            return t
        out = t.new_zeros((n_all,) + tuple(t.shape[1:]))
        out[lo: lo + t.shape[0]] = t
        return self.sum(out)


def _rows(a, lo, hi, fill=None):
    """Rows ``[lo, hi)`` of ``a``; rows past its end are ``fill`` (a
    tensor of one row's shape), else its last row."""
    if lo == 0 and hi == a.shape[0]:
        return a
    real = max(0, min(hi, a.shape[0]) - lo)
    part = a[min(lo, a.shape[0]): min(lo, a.shape[0]) + real]
    if real == hi - lo:
        return part
    tail = a[-1] if fill is None else fill
    return torch.cat([part, tail.expand((hi - lo - real,) + tuple(a.shape[1:]))])


def pad_to_multiple(arr, m, axis=0, fill=0):
    """Pad ``axis`` to a multiple of ``m``; returns ``(padded, original
    length)``. numpy arrays stay numpy, tensors stay tensors."""
    n = arr.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return arr, n
    if isinstance(arr, np.ndarray):
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        return np.pad(arr, widths, constant_values=fill), n
    shape = list(arr.shape)
    shape[axis] = pad
    return torch.cat([arr, arr.new_full(shape, fill)], dim=axis), n


def make_sharded_constitutive_update(material, mesh: DeviceMesh, axis="cells"):
    """``update(x (n, n_inputs), state, dt) -> (flux, Ct_flat, new_state)``:
    the material's batched update (``vmap`` of its ``jacfwd`` point update,
    as the JAX kernel runs it, or its fast path) over the batch. Over N
    ranks ``n`` must be a multiple of N (:func:`pad_to_multiple`): each rank
    updates its contiguous block of points and the outputs come back in
    full on every rank."""
    dev = _mesh_device(mesh, axis)
    if _canonical(material.device) != dev:
        raise ValueError(f"material on {material.device}, mesh on {dev}")
    ranks = _Ranks(mesh)

    def update(x, state, dt):
        x = torch.as_tensor(x, dtype=material.dtype, device=material.device)
        n = x.shape[0]
        if n % ranks.n:
            raise ValueError(f"{n} points do not split over {ranks.n} ranks: pad them (pad_to_multiple)")
        lo, hi = ranks.block(n)
        state = {k: torch.as_tensor(v, device=material.device)[lo:hi] for k, v in state.items()}
        flux, Ct, st = material.batched_constitutive_update(x[lo:hi], {}, state, dt)
        return (ranks.join(flux, lo, n), ranks.join(Ct, lo, n), {k: ranks.join(v, lo, n) for k, v in st.items()})

    return update


def make_sharded_newton_step(qmap, problem, mesh: DeviceMesh, axis="cells", n_newton=10, n_cg=60,
                             n_backtracks=10, rtol=None, atol=0.0, shard_dofs=False, pc="two_level",
                             pc_boxes=8, use_stencil=True, use_banded=True, cg_rtol=1e-8, smoother=None):
    """The fused load step of a single-material mechanics problem (one qmap):
    a thin configuration of :func:`make_sharded_newton_step_general`.

    Returns ``step(u, internal_state, bc_mask, bc_vals, dt=0.0) -> (u_new,
    new_internal_state, res_norm)`` and the single-state ``pad_state``;
    ``step.info`` and ``step.cg`` are the general step's."""
    terms = getattr(problem, "_terms", None)
    if not terms or len(terms) != 1 or terms[0]["qmap"] is not qmap:
        raise ValueError(
            "make_sharded_newton_step expects `problem` built on exactly the given single "
            "`qmap`; use make_sharded_newton_step_general for multi-material / multi-term problems"
        )
    gstep, pad_states = make_sharded_newton_step_general(
        problem, mesh, axis=axis, n_newton=n_newton, n_cg=n_cg, n_backtracks=n_backtracks,
        rtol=rtol, atol=atol, shard_dofs=shard_dofs, cg_rtol=cg_rtol, use_stencil=use_stencil,
        use_banded=use_banded, pc=pc, pc_boxes=pc_boxes, smoother=smoother,
    )

    def pad_state(state):
        return pad_states([state])[0]

    def step(u, internal_state, bc_mask, bc_vals, dt=0.0):
        u_new, new_states, res_norm = gstep(u, [internal_state], bc_mask, bc_vals, dt)
        step.info = gstep.info
        return u_new, new_states[0], res_norm

    step.info, step.cg = gstep.info, gstep.cg
    return step, pad_state


# ------------------------------------------------------------------ pytrees
def _tmap(fn, tree):
    """``fn`` on every tensor of nested lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tmap(fn, v) for v in tree)
    return tree


def _leaves(tree) -> list:
    out = []
    _tmap(out.append, tree)
    return out


def _signature(tree):
    return [(tuple(t.shape), t.dtype, t.stride()) for t in _leaves(tree)]


#: the kernel wrappers a CG block may launch: a capture records what they
#: were called for, and each replay launches that again without calling them
_COUNTED = (bg.banded_take_ell, bg.banded_take_csr, j2_cuda.j2_radial_return,
            j2_cuda.j2_radial_return_factored, coarse_restrict, coarse_prolong)


def _read(value, kind=float):
    """``kind(value)`` of a device value: a host read, counted in the
    ``"host reads"`` counter."""
    count("host reads")
    return kind(value)


def _launch_counts():
    counts = {w.__name__: (w.launches, w.f32_launches) for w in _COUNTED}
    counts["all_reduce"] = (REDUCED["calls"], REDUCED["bytes"])
    return counts


# ----------------------------------------------------------------- masked CG
class MaskedCG:
    """Early-exit preconditioned CG (the JAX step's loop: x0 = 0, iterate
    while ``it < n_cg`` and ``|rz| > cg_rtol^2 |rz0|``) run as blocks of
    ``block`` masked iterations: each computes ``active`` on the device and
    keeps x, r, z, p, rz and it unchanged where it is false, so a block gives
    the bits of the unmasked loop. ``Av(ops, v)`` and ``M(ops, r)`` read
    their data from ``ops``, a tree of tensors.

    With ``graph`` on CUDA tensors one block is captured as a CUDA graph per
    operand layout, on static copies of the operands and of the CG state
    (warmed up once on a side stream, then captured on it); a solve copies
    its operands and starting state in and replays the graph until the
    device flag says the loop stopped. A failed capture raises. The kernel
    wrappers count their calls during a capture as they count any call; a
    replay calls no wrapper, so each graph keeps what its capture recorded
    (``recorded``: wrapper name -> (calls, float32 calls), and
    ``"all_reduce"`` -> (calls, bytes) of :data:`REDUCED`) and how often it
    was replayed (``replays``), and the launches of the replays are their
    product. With ``graph`` False, or on the CPU, the blocks run eagerly
    (the same bits).

    ``dot`` is the inner product (a sum across ranks where the vectors are
    split). ``group``: the process group whose collectives ``Av``, ``M`` or
    ``dot`` call; ``graph=None`` captures only where they can be captured
    (no group, or NCCL's), and ``graph=True`` on another backend raises at
    the first solve on the card."""

    def __init__(self, Av, M, n_cg, cg_rtol, block=CG_BLOCK, graph=None, dot=torch.dot, group=None):
        self.Av, self.M, self.dot, self.group = Av, M, dot, group
        if graph is None:
            graph = group is None or dist.get_backend(group) == "nccl"
        self.n_cg, self.cg_rtol, self.block, self.graph = int(n_cg), float(cg_rtol), int(block), graph
        self._graphs = {}
        #: blocks run by the last solve
        self.blocks = 0

    def _iterations(self, ops, st, k):
        """``k`` masked iterations from the state ``st`` (a dict of x, r, z,
        p, rz, it, tol2); returns the new state and the continue flag."""
        x, r, z, p, rz, it, tol2 = (st[n] for n in ("x", "r", "z", "p", "rz", "it", "tol2"))
        zero = torch.zeros((), dtype=rz.dtype, device=rz.device)
        for _ in range(k):
            active = (it < self.n_cg) & (rz.abs() > tol2)
            Ap = self.Av(ops, p)
            den = self.dot(p, Ap)
            alpha = torch.where(den.abs() > 1e-30, rz / den, zero)
            x_n = x + alpha * p
            r_n = r - alpha * Ap
            z_n = self.M(ops, r_n)
            rz_n = self.dot(r_n, z_n)
            beta = torch.where(rz.abs() > 1e-30, rz_n / rz, zero)
            p_n = p * beta + z_n
            x = torch.where(active, x_n, x)
            r = torch.where(active, r_n, r)
            z = torch.where(active, z_n, z)
            p = torch.where(active, p_n, p)
            rz = torch.where(active, rz_n, rz)
            it = it + active.to(it.dtype)
        cont = (it < self.n_cg) & (rz.abs() > tol2)
        return dict(x=x, r=r, z=z, p=p, rz=rz, it=it, tol2=tol2), cont

    def _start(self, ops, b):
        """The CG state at x0 = 0 for the right-hand side ``b``."""
        z = self.M(ops, b)
        rz = self.dot(b, z)
        it = torch.zeros((), dtype=torch.int64, device=b.device)
        return dict(x=torch.zeros_like(b), r=b, z=z, p=z, rz=rz, it=it,
                    tol2=(self.cg_rtol * self.cg_rtol) * rz.abs())

    def solve(self, ops, b):
        """``(x, iterations)`` of CG on ``b``: one host read per block. Adds
        the iterations to the ``"cg: iterations"`` counter, and to ``"cg:
        budget iterations"`` where they reached ``n_cg``."""
        with timer("cg: solve"):
            x, its = self._solve(ops, b)
        count("cg: iterations", its)
        if its == self.n_cg:
            count("cg: budget iterations", its)
        return x, its

    def _solve(self, ops, b):
        st = self._start(ops, b)
        self.blocks = 0
        if self.graph and b.is_cuda:
            if self.group is not None and dist.get_backend(self.group) != "nccl":
                raise RuntimeError(f"a CUDA graph cannot capture the {dist.get_backend(self.group)} group's "
                                   "collectives: set graph=False")
            g = self._graph_for(ops, st)
            for s, t in zip(_leaves(g["ops"]), _leaves(ops)):
                s.copy_(t)
            for k, t in st.items():
                g["state"][k].copy_(t)
            while True:
                with timer("cg: replay", device=b.device):
                    g["graph"].replay()
                g["replays"] += 1
                self.blocks += 1
                if not _read(g["cont"], bool):
                    break
            return g["state"]["x"].clone(), _read(g["state"]["it"], int)
        while True:
            st, cont = self._iterations(ops, st, self.block)
            self.blocks += 1
            if not _read(cont, bool):
                return st["x"], _read(st["it"], int)

    def _graph_for(self, ops, st):
        key = (repr(_signature(ops)), repr(_signature(st)))
        g = self._graphs.get(key)
        if g is not None:
            return g
        static_ops = _tmap(torch.clone, ops)
        static = {k: t.clone() for k, t in st.items()}
        side = torch.cuda.Stream(device=st["x"].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up on copies: lazy handles, workspaces
            self._iterations(static_ops, {k: t.clone() for k, t in static.items()}, self.block)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(graph, stream=side):
            out, cont = self._iterations(static_ops, static, self.block)
            for k in ("x", "r", "z", "p", "rz", "it"):
                static[k].copy_(out[k])
        after = _launch_counts()
        recorded = {k: (after[k][0] - n, after[k][1] - n32) for k, (n, n32) in before.items()}
        g = self._graphs[key] = dict(graph=graph, ops=static_ops, state=static, cont=cont, recorded=recorded,
                                     replays=0)
        return g


# ---------------------------------------------------------------- the step
class _Term:
    """One qmap of the problem: its routes, per-dtype kernels and constants.
    ``coupled`` names the ESVs whose values the caller hands to
    :meth:`inputs` (a blocked problem's cross-field couplings). Over a
    process group (``ranks``) its element work runs on this rank's block of
    cells ``[lo, hi)`` (``dom`` a :meth:`~..fem.assembly.QuadratureDomain.
    block`), its per-point data on the block's points ``pts``."""

    def __init__(self, t, use_stencil, use_banded, dtypes, device, coupled=(), ranks=None):
        qmap = t["qmap"]
        self.material = m = qmap.material
        self.scales = t["scales"]
        dom = qmap.domain
        stencil = use_stencil and dom._stencil is not None and int(np.prod(dom._stencil)) == dom.ne
        self.dom = dom.variant(stencil=stencil, banded=use_banded)
        self.npts = dom.num_points
        self.lo, self.hi = 0, dom.ne
        if ranks is not None and ranks.group is not None:
            self.lo, self.hi = ranks.block(dom.ne)
            self.dom = self.dom.block(self.lo, self.hi, ranks.sum)
        self.pts = (self.lo * dom.nq, self.hi * dom.nq)
        #: the Gauss points of every rank's block: the real ones, then padding
        self.npts_pad = dom.nq * ranks.n * (self.hi - self.lo) if ranks is not None else self.npts
        self.ne, self.nloc, self.ncomp = self.dom.ne, dom.nloc, dom.ncomp
        self.init_tpl = m.behavior.init_state()
        self.dofmap = self.dom.dofmap
        self.dofmap_np = dom._dofmap_np

        tangent_structure, self.tstruct = [], []
        for (k, by, bx) in t["block_keys"]:
            x_expr = qmap.gradient_exprs.get(bx) or qmap.esv_exprs.get(bx)
            sl, sy, sx = qmap._block_slices[(by, bx)]
            tangent_structure.append((k, x_expr, None))
            self.tstruct.append((k, sl, sy, sx))
        flux_slices = _slices(m.fluxes)
        self.field_getters = [
            ("flux", flux_slices[n]) if n in flux_slices else ("isv", n) for n in t["field_names"]
        ]
        self.grad_exprs = [qmap.gradient_exprs[g] for g in m.gradient_names]
        self.esv_entries = [
            (name, size, "coupled" if name in coupled else "expr" if name in qmap.esv_exprs else "const")
            for name, size in m.external_state_variables.items()
        ]
        if m.rotation_matrix is not None and np.shape(m.rotation_matrix) != (3, 3):
            raise NotImplementedError(
                "fused step supports constant (3,3) rotations; got rotation_matrix of shape "
                f"{np.shape(m.rotation_matrix)}"
            )
        has_props = bool(getattr(m.behavior, "material_properties", {}))
        if has_props and (m._fast_update is not None or m._fast_flux is not None):
            raise NotImplementedError(
                "behavior declares material_properties but also a whole-batch fast path; the "
                "fused step's fast path ignores properties"
            )

        # per-dtype evaluation kernels and constant per-point inputs (past
        # the real points, padding repeats the last one: a zero ESV can push
        # a padded point out of the material's range, JAX's sharding.py)
        self.fns, self.consts, self.props, self.rot = {}, {}, {}, {}
        n = self.npts

        def mine(a):
            return _rows(a, *self.pts)

        for dt in dtypes:
            d = self.dom.variant(dtype=dt)
            self.fns[dt] = dict(
                evals=[d.make_eval(e) for e in self.grad_exprs],
                esv_evals={name: d.make_eval(qmap.esv_exprs[name])
                           for name, _, kind in self.esv_entries if kind == "expr"},
                residual=d.make_residual(t["exprs"]),
                Kel=d.make_element_matrices(t["exprs"], tangent_structure),
            )
            consts = {}
            for name, size, kind in self.esv_entries:
                if kind == "const":
                    v = m.external_state.get(name)
                    consts[name] = mine(m._to_batched(v, n, size) if v is not None
                                        else torch.zeros((n, size), dtype=m.dtype, device=device)).to(dt)
            self.consts[dt] = consts
            self.props[dt] = {k: mine(v).to(dt) for k, v in m._assemble_props(n).items()}
            if m.rotation_matrix is not None:
                self.rot[dt] = {k: v.to(dt) for k, v in m._rotation_ops(self.pts[1] - self.pts[0]).items()}

    def inputs(self, u, dt, coupled=None):
        """The material's differentiable inputs at every point: gradients,
        then ESVs (expressions of u, constants, or the ``coupled`` values),
        ``(npts, n_inputs)``."""
        fns = self.fns[dt]
        parts = [f(u) for f in fns["evals"]]
        for name, _, kind in self.esv_entries:
            if kind == "coupled":
                parts.append(coupled[name])
            else:
                parts.append(fns["esv_evals"][name](u) if kind == "expr" else self.consts[dt][name])
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    def integrate(self, x, state, dt, tdt, flux_only):
        """``(flux, Ct or None, new_state)``: the fast path where the
        material has one, else the generic ``vmap(jacfwd)`` update; rotated
        into the material frame and back."""
        m = self.material
        rot = self.rot.get(dt)
        if rot is not None:
            x = m._rotate_cols(x, m._input_sizes, rot, False)
        Ct = None
        if flux_only and m._fast_flux is not None:
            flux, st = m._fast_flux(x, state, tdt)
        elif m._fast_update is not None:
            flux, Ct, st = m._fast_update(x, state, tdt)
            Ct = Ct.reshape(x.shape[0], -1)
        elif flux_only:
            flux, st = m.batched_flux_update(x, self.props[dt], state, tdt)
        else:
            flux, Ct, st = m.batched_constitutive_update(x, self.props[dt], state, tdt)
        if rot is not None:
            flux = m._rotate_cols(flux, m.fluxes, rot, True)
            if Ct is not None:
                Ct = m._rotate_tangent(Ct, rot)
        return flux, Ct, st

    def fields(self, flux, state, scales):
        out = []
        for (kind, key), sc in zip(self.field_getters, scales):
            f = flux[:, key] if kind == "flux" else state[key].reshape(flux.shape[0], -1)
            out.append(sc * f)
        return out


@dataclass
class _Inputs:
    """What one precision's evaluations read: per-term states and scales, the
    external force, the time step and the dtype of the element kernels."""

    states: list
    scales: list
    f_ext: torch.Tensor
    dt: float
    dtype: torch.dtype


def make_sharded_newton_step_general(
    problem, mesh: DeviceMesh, axis="cells", n_newton=10, n_cg=100, n_backtracks=10, rtol=None,
    atol=0.0, shard_dofs=False, cg_rtol=1e-8, use_stencil=True, use_banded=True, pc="two_level",
    pc_boxes=8, smoother=None, precision="same", coarse_modes="trans", agg_split_materials=False,
    return_info=False, f32_warmup=True,
):
    """The fused Newton load step of a ``NonlinearMaterialProblem``, on the
    card that holds it (``problem.device``; ``mesh`` must name that device).

    Covers the JAX builder's cases: several qmaps (cell subsets), several
    gradients, ESVs given as constants or as expressions of u, residual terms
    on fluxes or internal state variables with per-call ``scales`` and
    ``f_ext``, constant (3,3) rotations, and every gather/assembly route
    (stencil, banded, gather map; ``use_stencil``/``use_banded`` force the
    next one).

    Returns ``step(u, states, bc_mask, bc_vals, dt=0.0, scales=None,
    f_ext=None) -> (u_new, new_states, res_norm)`` and ``pad_states``; with
    ``return_info=True`` also ``res0`` (the entering residual), with
    ``return_info="stats"`` also ``(newton_its, cg_its_total)``. ``states``
    is a list of per-qmap internal-state dicts. ``step.info`` holds the
    last call's counts, split by phase, the residual norm Newton measured
    against (``res0``) and the dtype of its CG operands.

    The loops are the JAX step's: Newton while ``res > rtol res0 + atol``
    and fewer than ``n_newton`` iterations (``rtol`` defaults to 1e-10 for
    float64 or ``precision="mixed"``, 1e-6 for float32); each iteration an
    early-exit CG (``n_cg`` is a budget, the test ``|rz| > cg_rtol^2
    |rz0|``) and a backtracking line search (``n_backtracks`` halvings while
    the trial norm is not below ``(1 - 1e-4 alpha) res``; the step is taken
    only if the norm fell).

    Preconditioners: ``pc="jacobi"`` or ``"two_level"``, which adds a coarse
    correction frozen at the entering tangent: ``coarse_modes`` "trans"
    (``pc_boxes`` coordinate boxes a dimension), "rbm" (rigid-body modes) or
    "p1" (the P2->P1 vertex space), ``agg_split_materials`` keeping each
    qmap's nodes in aggregates of their own. ``smoother``: "jacobi", "block"
    (node blocks) or None (block on 3D vector spaces).

    ``precision="mixed"`` (a float64 problem): residual, constitutive update
    and line search in f64, the tangents and the CG in a low dtype on the
    symmetrically diagonally scaled operator; with ``f32_warmup`` Newton
    first runs on a low-dtype copy of the problem until its progress stalls
    (at least one f64 iteration is left for the polish). The low dtype is
    the one the JAX package's element kernel produces for the problem's
    kinematics (``fem.forms.mixed_tangent_dtype``): float32 for deformation
    gradients, float64 for Mandel strains, whose float64 sqrt(2) promotes
    the JAX package's "f32" tangent and CG under x64.

    Over a process group's mesh each rank runs the element work of its
    block of cells (the module's partition); u, the states, ``bc_mask``,
    ``bc_vals``, ``f_ext`` and ``scales`` go in full on every rank and come
    out full on every rank, and ``step.info``'s counts are the global ones.
    ``shard_dofs=True`` splits u, R, the CG workspace and the bc arrays over
    the ranks inside the step (the dof count padded to a multiple of the
    rank count times the components, padded dofs pinned like Dirichlet
    rows); on one device it changes nothing. ``axis`` names the mesh's axes
    (the partition runs over all of them, outer first). On the card the CG
    blocks are replayed as a CUDA graph (``step.cg``, a :class:`MaskedCG`)
    where the group's collectives can be captured (NCCL).
    """
    dev = _mesh_device(mesh, axis)
    if _canonical(problem.device) != dev:
        raise ValueError(f"problem on {problem.device}, mesh on {dev}")
    device = problem.device
    ranks = _Ranks(mesh)
    if smoother not in (None, "jacobi", "block"):
        raise ValueError(f"smoother must be None, 'jacobi' or 'block', got {smoother!r}")
    if precision not in ("same", "mixed"):
        raise ValueError(f"precision must be 'same' or 'mixed', got {precision!r}")
    if pc not in ("jacobi", "two_level"):
        raise ValueError(f"pc must be 'jacobi' or 'two_level', got {pc!r}")
    if coarse_modes not in ("trans", "rbm", "p1"):
        raise ValueError(f"coarse_modes must be 'trans', 'rbm' or 'p1', got {coarse_modes!r}")
    mixed = precision == "mixed"
    f_hi = problem.dtype
    if mixed and f_hi != torch.float64:
        raise ValueError("precision='mixed' needs a float64 problem (the f64 residual path)")
    f_lo = torch.float32 if mixed else f_hi  # the warmup's u and residual
    # under "mixed" the element kernels of the tangents, the CG and the
    # warmup run in the dtype the JAX package's element kernel produces:
    # float64 for Mandel strains (its sqrt(2) constant promotes), float32
    # for deformation gradients
    f_K = mixed_tangent_dtype(
        [e for t in problem._terms for e in t["qmap"].gradient_exprs.values()]) if mixed else f_hi
    space = problem.u.space
    ndofs, nc = space.num_dofs, space.ncomp
    nnodes = ndofs // nc
    use_block = (smoother or ("block" if nc >= 3 else "jacobi")) == "block" and nc > 1
    if rtol is None:
        rtol = 1e-10 if (mixed or f_hi == torch.float64) else 1e-6
    dtypes = sorted({f_hi, f_lo, f_K}, key=str)
    terms = [_Term(t, use_stencil, use_banded, dtypes, device, ranks=ranks) for t in problem._terms]

    # ---- the dof layout: u, R and the CG vectors whole on every rank, or
    # (shard_dofs) this rank's slice of nd_p padded dofs
    nd_p = ndofs + (-ndofs) % (ranks.n * nc) if shard_dofs else ndofs
    dlo, dhi = ranks.block(nd_p) if shard_dofs else (0, ndofs)

    def embed(v):
        """This rank's slice among zeros, (ndofs,)."""
        out = v.new_zeros(nd_p)
        out[dlo:dhi] = v
        return out[:ndofs]

    def full(v):
        """A vector of the layout in full (ndofs,)."""
        return ranks.sum(embed(v)) if shard_dofs else v

    def mine(v, fill=0):
        """This rank's part of a full (ndofs,) vector (padded with ``fill``)."""
        if not shard_dofs:
            return v
        return _rows(v, dlo, dhi, v.new_full((), fill))

    def dot(a, b):
        d = torch.dot(a, b)
        return ranks.sum(d) if shard_dofs else d

    # ---- coarse space: tables, the fixed-order sums of Ac and restriction
    two_level = pc == "two_level"
    p1 = two_level and coarse_modes == "p1"

    def tables(a):  # a float32 coarse table in each working dtype
        a = torch.as_tensor(a, device=device)
        return {dt: a.to(dt) for dt in dtypes}

    if p1:
        ncoarse, parents_np, pw_np, vid, Wp1_np = _p1_coarse(space)
        nvloc = space.mesh.cells.shape[1]
        parents = torch.as_tensor(parents_np, dtype=torch.int64, device=device)
        pw, Wp1 = tables(pw_np), tables(Wp1_np)
        comp = np.arange(nc)[None, :]
        restrict_target = np.concatenate([parents_np[:, 0:1] * nc + comp, parents_np[:, 1:2] * nc + comp])
        # the restriction as a padded gather and a row sum
        restrict_map = torch.as_tensor(gather_map(restrict_target, ncoarse), device=device)
        for term in terms:
            vert = np.maximum(vid[term.dofmap_np[:, : nvloc * nc : nc] // nc], 0)
            term.coarse_plan = _coarse_plan(vert[:, :, None] * nc + comp[None], ncoarse, device)
    elif two_level:
        labels = None
        if agg_split_materials and len(terms) > 1:
            # node label = the last qmap touching the node (list stiff
            # inclusions after the matrix, so interface nodes join them)
            labels = np.zeros(nnodes, np.int64)
            for i, term in enumerate(terms):
                labels[np.unique(term.dofmap_np // nc)] = i
        ncoarse, agg_np, W_np = _coord_agg_modes(space, pc_boxes, modes=coarse_modes, labels=labels)
        nmodes = W_np.shape[2]
        aggs = plan_aggregates(agg_np, nc, nmodes, device=device)
        W_node = tables(W_np)
        for term in terms:
            nodes = term.dofmap_np[:, :: term.ncomp] // nc
            ci = agg_np[nodes].astype(np.int64)[:, :, None] * nmodes + np.arange(nmodes)[None, None, :]
            term.coarse_plan = _coarse_plan(ci, ncoarse, device)
            term.W = {dt: _rows(w, term.lo, term.hi, w.new_zeros(())) for dt, w in tables(W_np[nodes]).items()}
    else:
        ncoarse = 0

    zero_of = {}

    def zero(dtype):
        z = zero_of.get(dtype)
        if z is None:
            z = zero_of[dtype] = torch.zeros((), dtype=dtype, device=device)
        return z

    # ---- evaluations ----------------------------------------------------
    def evaluate(u, inp: _Inputs, mask, cast_K):
        """``(R, K_es, new_states)`` at u: the full constitutive update and
        the element kernels in ``inp.dtype``, the residual rounded to u's
        dtype, the element tangents cast to ``f_K`` under ``cast_K``."""
        dt = inp.dtype
        u_w, u = u, full(u).to(dt)
        R = torch.zeros(ndofs, dtype=dt, device=device)
        K_es, new_states = [], []
        for term, st, sc in zip(terms, inp.states, inp.scales):
            flux, Ct, st_new = term.integrate(term.inputs(u, dt), st, dt, inp.dt, False)
            flds = term.fields(flux, st_new, sc)
            R = R + term.fns[dt]["residual"](u, flds)
            n = flux.shape[0]
            Cs = [sc[k] * Ct[:, sl].reshape(n, sy, sx) for (k, sl, sy, sx) in term.tstruct]
            K = term.fns[dt]["Kel"](u, flds, Cs)
            if cast_K:
                K = K.to(f_K)
            K_es.append(K)
            new_states.append(st_new)
        return torch.where(mask, zero(dt), mine(R) - inp.f_ext).to(u_w.dtype), K_es, new_states

    def rnorm(u, inp: _Inputs, mask):
        """The residual norm from flux-only updates (line-search trials), in
        u's dtype."""
        dt = inp.dtype
        u_w, u = u, full(u).to(dt)
        R = torch.zeros(ndofs, dtype=dt, device=device)
        for term, st, sc in zip(terms, inp.states, inp.scales):
            flux, _, st_new = term.integrate(term.inputs(u, dt), st, dt, inp.dt, True)
            R = R + term.fns[dt]["residual"](u, term.fields(flux, st_new, sc))
        R = torch.where(mask, zero(dt), mine(R) - inp.f_ext).to(u_w.dtype)
        return _read(torch.sqrt(dot(R, R)))

    def assemble_diag(K_es, dtype):
        d = torch.zeros(ndofs, dtype=dtype, device=device)
        for term, K in zip(terms, K_es):
            d = d + term.dom.matrix_diagonal(K, ndofs)
        return mine(d)

    # ---- frozen coarse operator -----------------------------------------
    def build_coarse(K_es, mask):
        """``Ac^-1`` of Ac = W^T K W over all terms' entering tangents,
        summed in a fixed order; inverted on the symmetrically scaled matrix
        (the contrast of stiff inclusions), symmetrised both ways."""
        dtype = K_es[0].dtype
        Ac = torch.zeros(ncoarse * ncoarse, dtype=dtype, device=device)
        free = full((~mask).to(dtype))
        for term, K in zip(terms, K_es):
            w = free[term.dofmap]
            Kn = (K * w[:, :, None] * w[:, None, :]).reshape(term.ne, term.nloc, term.ncomp, term.nloc, term.ncomp)
            if p1:
                C_e = torch.einsum("ax,eacbd,by->excyd", Wp1[dtype], Kn, Wp1[dtype])
            else:
                C_e = torch.einsum("eacm,eacbd,ebdn->eambn", term.W[dtype], Kn, term.W[dtype])
            Ac = Ac + fixed_sum(term.dom._paste(C_e).reshape(-1), term.coarse_plan)
        Ac = Ac.reshape(ncoarse, ncoarse)
        dAc = torch.diagonal(Ac)
        ridge = 1e-8 * dAc.abs().max() + 1e-30
        eye = torch.eye(ncoarse, dtype=dtype, device=device)
        Ac = Ac + (ridge + (dAc.abs() < ridge).to(dtype)) * eye
        sc = 1.0 / torch.sqrt(dAc.abs() + ridge)
        As = Ac * sc[:, None] * sc[None, :]
        As = 0.5 * (As + As.T)
        Ai = torch.linalg.inv(As)
        Ai = 0.5 * (Ai + Ai.T) * sc[:, None] * sc[None, :]
        # the aggregate route's kernel on the card reads Ac_inv by rows; the
        # inverse comes back column-major, and the p1 route and the plain
        # versions on the CPU keep that layout (their products round by it)
        return Ai.contiguous() if Ai.is_cuda and not p1 else Ai

    def restrict(r0):
        if not p1:
            return coarse_restrict(r0, aggs, W_node[r0.dtype])
        rn = r0.reshape(nnodes, nc)
        pwc = pw[r0.dtype]
        parts = [(rn * pwc[:, :1]).reshape(-1), (rn * pwc[:, 1:]).reshape(-1)]
        return torch.cat(parts + [r0.new_zeros(1)])[restrict_map].sum(dim=1)

    def prolong(rc, Ac_inv):
        """``P Ac_inv rc`` in full (ndofs,)."""
        if not p1:
            return coarse_prolong(rc, Ac_inv, aggs, W_node[rc.dtype])
        wc = Ac_inv @ rc
        wn = wc.reshape(-1, nc)
        pwc = pw[wc.dtype]
        return (pwc[:, :1] * wn[parents[:, 0]] + pwc[:, 1:] * wn[parents[:, 1]]).reshape(-1)

    # ---- the CG operands and its two functions ----------------------------
    def Av(ops, v):
        mask = ops["mask"]
        v0 = full(torch.where(mask, zero(v.dtype), v))
        y = torch.zeros_like(v0)
        for term, K in zip(terms, ops["K"]):
            y = y + term.dom.spmv(K, v0)
        return torch.where(mask, v, mine(y))

    def M(ops, r):
        mask = ops["mask"]
        if "Binv" in ops:
            z = torch.einsum("nab,nb->na", ops["Binv"], r.reshape(-1, nc)).reshape(-1)
        elif "diag" in ops:
            z = r / ops["diag"]
        else:  # the scaled operator's unit diagonal
            z = r
        if "Ac_inv" not in ops:
            return z
        s_inv = ops.get("s_inv")
        if not (p1 or shard_dofs):  # two kernels, the mask, scaling and add inside
            W = W_node[r.dtype]
            rc = coarse_restrict(r, aggs, W, mask, s_inv)
            return coarse_prolong(rc, ops["Ac_inv"], aggs, W, z, mask, s_inv)
        r0 = torch.where(mask, zero(r.dtype), r)
        if s_inv is not None:
            r0 = r0 * s_inv
        # split dofs: each rank restricts its slice, the sums meet
        rc = ranks.sum(restrict(embed(r0))) if shard_dofs else restrict(r0)
        corr = mine(prolong(rc, ops["Ac_inv"]))
        if s_inv is not None:
            corr = corr * s_inv
        return z + torch.where(mask, zero(r.dtype), corr)

    cg = MaskedCG(Av, M, n_cg, cg_rtol, dot=dot, group=ranks.group)

    def newton_update(u, R, K_es, res, inp, mask, Ac_inv):
        """One Newton correction: CG in the tangent dtype (scaled under
        ``mixed``), then the line search. Returns ``(u_new, cg_its)``."""
        cg_dtype = K_es[0].dtype
        ops = {"mask": mask}
        if mixed:
            diag = assemble_diag(K_es, cg_dtype)
            diag = torch.where(mask | (diag.abs() < 1e-30), torch.ones_like(diag), diag.abs())
            s_vec = torch.rsqrt(diag)
            ops["s_inv"] = diag * s_vec
            s_full = full(s_vec)
            K_ops = []
            for term, K in zip(terms, K_es):
                s_e = s_full[term.dofmap]
                K_ops.append(K * s_e[:, :, None] * s_e[:, None, :])
        else:
            s_vec, K_ops = None, K_es
        ops["K"] = [term.dom.spmv_prepare(K) for term, K in zip(terms, K_ops)]
        if use_block:
            Bm = sum(term.dom.matrix_node_blocks(K, nnodes) for term, K in zip(terms, K_ops))
            if shard_dofs:
                Bm = _rows(Bm, dlo // nc, dhi // nc, Bm.new_zeros(()))
            mb = mask.reshape(-1, nc).to(cg_dtype)
            keep = 1.0 - mb
            eye = torch.eye(nc, dtype=cg_dtype, device=device)
            Bm = Bm * keep[:, :, None] * keep[:, None, :] + eye * mb[:, :, None]
            tr = torch.einsum("naa->n", Bm.abs())
            Bm = Bm + eye * torch.where(tr < 1e-30, torch.ones_like(tr), 1e-14 * tr)[:, None, None]
            ops["Binv"] = _sym_block_inv(Bm, eye)
        elif not mixed:
            diag = assemble_diag(K_es, cg_dtype)
            ops["diag"] = torch.where(mask | (diag.abs() < 1e-30), torch.ones_like(diag), diag)
        if Ac_inv is not None:
            ops["Ac_inv"] = Ac_inv
        b = (-R).to(cg_dtype)
        if mixed:
            b = b * s_vec
        b = torch.where(mask, zero(cg_dtype), b)
        du, cg_k = cg.solve(ops, b)
        if mixed:
            du = du * s_vec
        du = du.to(u.dtype)
        alpha, k = 1.0, 0
        with timer("fused: line search"):
            n_try = rnorm(u + du, inp, mask)
            while (not np.isfinite(n_try) or n_try >= (1 - 1e-4 * alpha) * res) and k < n_backtracks:
                alpha *= 0.5
                n_try = rnorm(u + alpha * du, inp, mask)
                k += 1
        if np.isfinite(n_try) and n_try < res:
            return u + alpha * du, cg_k
        return u, cg_k

    # ---- states ------------------------------------------------------------
    def pad_states(states):
        """Each map's states over every rank's points: the real points, then
        the behavior's initial state on the padding cells' points."""
        out = []
        for term, st in zip(terms, states):

            def pad_leaf(a, tpl):
                a = torch.as_tensor(a, device=device)
                if a.is_floating_point():
                    a = a.to(f_hi)
                fill = torch.as_tensor(np.asarray(tpl), dtype=a.dtype, device=device)
                return _rows(a, 0, term.npts_pad, fill)

            out.append({k: pad_leaf(v, term.init_tpl[k]) for k, v in st.items()})
        return out

    def step(u, states, bc_mask, bc_vals, dt=0.0, scales=None, f_ext=None):
        with timer("fused: step"):
            return _step(u, states, bc_mask, bc_vals, dt, scales, f_ext)

    def _step(u, states, bc_mask, bc_vals, dt, scales, f_ext):
        mask = mine(torch.as_tensor(np.asarray(bc_mask) if not torch.is_tensor(bc_mask) else bc_mask,
                                    device=device).to(torch.bool), True)
        vals = mine(torch.as_tensor(bc_vals, device=device).to(f_hi))
        u = mine(torch.as_tensor(u, device=device).to(f_hi))
        states = [{k: v[term.pts[0]: term.pts[1]] for k, v in st.items()}
                  for term, st in zip(terms, pad_states(states))]
        if scales is None:
            scales = [[problem._scale_value(s) for s in term.scales] for term in terms]
        scales = [[float(s) for s in ss] for ss in scales]
        f_ext = mine(torch.zeros(ndofs, dtype=f_hi, device=device) if f_ext is None
                     else torch.as_tensor(f_ext, device=device).to(f_hi))
        inp = _Inputs(states, scales, f_ext, float(dt), f_hi)
        u = torch.where(mask, vals, u)
        info = dict(warmup_newton=0, warmup_cg=0)

        res032 = None
        if mixed and f32_warmup:
            # Newton on an f32 copy of the problem (u, states, residual),
            # its element kernels in f_K: the entering states feed every
            # evaluation, so the warmup's states are dropped
            def lo(a):
                return a.to(f_lo).to(f_K) if a.is_floating_point() else a

            inp32 = _Inputs([_tmap(lo, st) for st in states], scales, lo(f_ext), float(dt), f_K)
            u32 = u.to(f_lo)
            R32, K_es, _ = evaluate(u32, inp32, mask, False)
            res = _read(torch.sqrt(dot(R32, R32)))
            res032 = max(res, 1e-30)
            Ac_inv = build_coarse(K_es, mask) if two_level else None
            it32 = cg32 = 0
            progress = True
            # stop at the f32 floor (no progress: the line search stayed or
            # the residual fell by less than 30 %), at the tolerance, or one
            # below the Newton budget so the f64 polish gets an iteration
            while it32 < n_newton - 1 and res > max(rtol, 2e-5) * res032 + atol and progress:
                u_new, cg_k = newton_update(u32, R32, K_es, res, inp32, mask, Ac_inv)
                R32, K_es, _ = evaluate(u_new, inp32, mask, False)
                res_n = _read(torch.sqrt(dot(R32, R32)))
                # the line search moved u on some rank (its slice, split)
                moved = (u_new != u32).any().to(f_lo)
                progress = _read(ranks.sum(moved) > 0 if shard_dofs else moved > 0, bool) and res_n < 0.7 * res
                u32, res = u_new, res_n
                it32 += 1
                cg32 += cg_k
            u = torch.where(mask, vals, u32.to(f_hi))
            info.update(warmup_newton=it32, warmup_cg=cg32)

        R, K_es, st_out = evaluate(u, inp, mask, mixed)
        info["cg_dtype"] = K_es[0].dtype
        res_t = torch.sqrt(dot(R, R))
        res = _read(res_t)
        if res032 is not None:
            # the step's true entering residual, measured by the warmup
            res_entering = torch.full((), max(res032, 1e-30), dtype=f_hi, device=device)
            res0 = _read(res_entering)
        else:
            res_entering = res_t
            res0 = max(res, 1e-30)
        Ac_inv = build_coarse(K_es, mask) if two_level else None
        n_it = cg_sum = 0
        while n_it < n_newton and res > rtol * res0 + atol:
            u, cg_k = newton_update(u, R, K_es, res, inp, mask, Ac_inv)
            R, K_es, st_out = evaluate(u, inp, mask, mixed)
            res_t = torch.sqrt(dot(R, R))
            res = _read(res_t)
            n_it += 1
            cg_sum += cg_k
        n_total, cg_total = n_it + info["warmup_newton"], cg_sum + info["warmup_cg"]
        info.update(polish_newton=n_it, polish_cg=cg_sum, newton=n_total, cg=cg_total, res0=res0)
        step.info = info
        new_states = [{k: ranks.join(v, term.pts[0], term.npts_pad)[: term.npts] for k, v in st.items()}
                      for term, st in zip(terms, st_out)]
        u = full(u)
        if return_info == "stats":
            return u, new_states, res_t, res_entering, (n_total, cg_total)
        if return_info:
            return u, new_states, res_t, res_entering
        return u, new_states, res_t

    step.info = {}
    step.cg = cg
    return step, pad_states


def make_sharded_blocked_step(*args, **kwargs):
    """See :func:`dolfinx_materials_tpu_torch.parallel.blocked.make_sharded_blocked_step`."""
    from .blocked import make_sharded_blocked_step as _impl

    return _impl(*args, **kwargs)


def _coarse_plan(ci, ncoarse, device):
    """The fixed-order sum of element coarse matrices (ne, nf, nf) into the
    dense (ncoarse, ncoarse) operator; ``ci`` the coarse dof of every
    element's (local node, mode)."""
    cif = ci.reshape(ci.shape[0], -1).astype(np.int64)
    return plan_fixed_sum(cif[:, :, None] * ncoarse + cif[:, None, :], ncoarse * ncoarse, device=device)
