"""Batched assembly on tabulated domains: residuals, element matrices, SpMV.

All element data lives in dense batched tensors (ncells, nq, ...); assembly
is a handful of batched products plus a gather-based sum into dofs, and the
global Jacobian is never stored: Newton-Krylov applies the element matrices
K_e directly (gather -> batched product -> assembly-as-gather).

Index routing, in order of preference:
- structured P1 quad/hex grids: shifted-slice stencils, no index arrays;
- meshes whose numbering is banded enough (every degree-2 space, after the
  spatial node renumbering of fem/space.py): the banded take engine
  (ops/banded_gather.py) on any device — its CUDA kernels on the card, its
  plain version on the CPU, so CPU runs drive the same route as the card;
- otherwise a precomputed gather map (one gather + row sum), never an
  atomic scatter.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from .. import resolve_device
from ..ops import banded_gather as bg
from .element import ReferenceElement
from .forms import Ctx
from .space import FunctionSpace


class QuadratureDomain:
    """Tabulated geometry/basis for (space, quadrature degree, cell subset):
    the Gauss-point set on which material state lives, with evaluation and
    assembly kernels on it."""

    _CORNERS_2D = ((0, 0), (1, 0), (1, 1), (0, 1))
    _CORNERS_3D = (
        (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
    )

    def __init__(self, space: FunctionSpace, quad_degree: int, cells=None,
                 dtype=torch.float64, device=None, weight=None):
        """``device=None`` is the card (the CPU needs ``device="cpu"``).
        ``weight``: optional callable x (m, dim) -> (m,) multiplying the
        integration measure (e.g. ``lambda x: 2*pi*x[:, 0]`` for axisymmetry)."""
        mesh = space.mesh
        self.space = space
        self.quad_degree = quad_degree
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cells = (
            np.arange(mesh.num_cells, dtype=np.int32)
            if cells is None
            else np.asarray(cells, dtype=np.int32)
        )
        elem = ReferenceElement(mesh.cell_type, space.degree, quad_degree)
        # isoparametric: a curved mesh (geom_degree 2, fem/mesh.py curve_mesh)
        # maps through the degree-2 element, a straight one is multilinear
        geo = ReferenceElement(mesh.cell_type, mesh.geom_degree, quad_degree)
        self.element = elem
        self.nq = elem.nq
        self.ne = len(self.cells)
        #: the cells the gathers and the assembly run over; ``ne`` is the
        #: cells of the element work (fewer on a :meth:`block`)
        self.ne_all = self.ne
        self._block, self._reduce = None, None
        self.num_points = self.ne * self.nq
        self.nloc = space.nloc
        self.ncomp = space.ncomp
        self.ndof_el = self.nloc * self.ncomp

        if mesh.geom_degree == 1:
            coords = mesh.points[mesh.cells[self.cells]]  # (ne, nverts, dim)
        else:
            coords = mesh.geom_points[mesh.geom_cells[self.cells]]  # (ne, ngeom, dim)
        J = np.einsum("cvi,qvj->cqij", coords, geo.dN)
        detJ = np.linalg.det(J)
        invJ = np.linalg.inv(J)
        dNdx = np.einsum("qvj,cqji->cqvi", elem.dN, invJ)
        x_q = np.einsum("qv,cvi->cqi", geo.N, coords)
        wdetJ = elem.qweights[None, :] * np.abs(detJ)
        if weight is not None:
            wdetJ = wdetJ * np.asarray(weight(x_q.reshape(-1, x_q.shape[-1]))).reshape(wdetJ.shape)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=self.device)

        self.dNdx = dev(dNdx)  # (ne, nq, nloc, dim)
        self.N = dev(elem.N)  # (nq, nloc)
        self.wdetJ = dev(wdetJ)  # (ne, nq)
        self.x_q = dev(x_q)  # (ne, nq, dim)
        self._dofmap_np = np.asarray(space.dofmap[self.cells])
        self.dofmap = dev(self._dofmap_np, torch.int64)  # (ne, ndof_el)
        self._dofmap_all = self.dofmap
        self.cell_volumes = self.wdetJ.sum(dim=1)
        self._build_gather_map()
        self._node_block_plan = None
        self._stencil = None
        if (
            getattr(mesh, "grid", None) is not None
            and space.degree == 1
            and cells is None
            and mesh.cell_type in ("quad", "hexahedron")
        ):
            self._stencil = tuple(int(g) for g in mesh.grid)
        self._banded = None
        if self._stencil is None and self.ne * self.ndof_el >= (1 << 13):
            self._build_banded()

    # ---------------------------------------------------------------- plans
    def _build_banded(self):
        """Banded-take plans (cell-major gather, feature-major gather,
        slot-wise assembly). The kernels read each plan's compact per-output
        entry lists, with the window layout and the patches folded in at plan
        time, so a plan is kept whenever it could be built (at most ``max_R``
        window rows); the TPU layout's window and patch budgets do not apply."""
        dm = self._dofmap_np
        ndofs = self.space.num_dofs
        dev = self.device

        def best_plan(fn, chunks=(2048, 1024, 512, 256)):
            for ch in chunks:
                p = fn(chunk=ch)
                if p is not None:
                    return p
            return None

        plans = {
            "cell": best_plan(
                lambda chunk: bg.plan_banded_take(dm.ravel(), ndofs, chunk=chunk, max_R=256, device=dev)
            ),
            "fm": best_plan(
                lambda chunk: bg.plan_banded_take(dm.T.ravel(), ndofs, chunk=chunk, max_R=256, device=dev)
            ),
            "asm": best_plan(
                lambda chunk: bg.plan_slotwise_assembly(dm, ndofs, chunk=chunk, max_R=256, device=dev),
                chunks=(1024, 512, 256),
            ),
        }
        # gather/assembly need cell+asm; the SpMV additionally uses fm when
        # it passed (consumers check per key)
        if plans["cell"] is not None and plans["asm"] is not None:
            self._banded = plans

    def _banded_take(self, key, table):
        """One planned take: the kernel chosen by ``_best_take`` on CUDA
        tables, the plain version on CPU tables (the wrappers route)."""
        plan = self._banded[key]
        return bg._best_take(plan)(table.contiguous(), plan)

    @property
    def banded_active(self):
        """True when the banded take engine serves gather/assembly/SpMV."""
        return self._banded is not None

    def _build_gather_map(self):
        """For every global dof, the (padded) positions of its element
        contributions in the flattened element-value array: assembly becomes
        one gather + row sum (deterministic, no atomics)."""
        gm = bg.gather_map(self._dofmap_np, self.space.num_dofs)
        self._gather_map = torch.as_tensor(gm, device=self.device)

    # ------------------------------------------------------------ cell blocks
    def block(self, lo, hi, reduce=None):
        """This domain with its element work on cells ``[lo, hi)`` only (the
        cells from ``ne`` on are padding: zero geometry and weight, dof 0),
        its gathers and its assembly still over every cell: :meth:`gather`
        cuts the block out of the full gather, and the assembly puts the
        block's element values among zeros over every cell, applies
        ``reduce`` to that array (the sum across the ranks that own the other
        blocks: exact, a cell's values are one rank's) and assembles it in
        full. A shallow copy sharing the plans."""
        dom = copy.copy(self)
        dom._block, dom._reduce = (int(lo), int(hi)), reduce
        dom.ne = int(hi) - int(lo)
        dom.num_points = dom.ne * self.nq
        for name in ("dNdx", "wdetJ", "x_q", "cell_volumes", "dofmap"):
            setattr(dom, name, dom._cut(getattr(self, name)))
        return dom

    def _cut(self, t, dim=0):
        """The block's rows (along ``dim``) of a tensor over every cell,
        zero rows for padding cells; ``t`` itself outside a block."""
        if self._block is None:
            return t
        lo, hi = self._block
        if lo == 0 and hi == self.ne_all:
            return t
        real = max(0, min(hi, self.ne_all) - lo)
        part = t.narrow(dim, min(lo, self.ne_all), real)
        if real == hi - lo:
            return part
        shape = list(t.shape)
        shape[dim] = hi - lo - real
        return torch.cat([part, t.new_zeros(shape)], dim=dim)

    def _paste(self, t, dim=0):
        """The block's rows (along ``dim``) among zeros over every cell,
        through ``reduce``; ``t`` itself outside a block."""
        if self._block is None:
            return t
        lo, hi = self._block
        if lo != 0 or hi != self.ne_all:
            real = max(0, min(hi, self.ne_all) - lo)
            shape = list(t.shape)
            shape[dim] = self.ne_all
            out = t.new_zeros(shape)
            out.narrow(dim, min(lo, self.ne_all), real).copy_(t.narrow(dim, 0, real))
            t = out
        return t if self._reduce is None else self._reduce(t)

    # ------------------------------------------------------- gather/assembly
    def scatter_dofs(self, vals_e):
        """Sum element-local values (ne, ndof_el) into a global (ndofs,) vector."""
        nc = self.ncomp
        vals_e = self._paste(vals_e)
        if self._stencil is not None and len(self._stencil) == 2:
            nx, ny = self._stencil
            vals = vals_e.reshape(nx, ny, self.nloc, nc)
            y = torch.zeros((nx + 1, ny + 1, nc), dtype=vals_e.dtype, device=vals_e.device)
            for k, (di, dj) in enumerate(self._CORNERS_2D):
                y[di : di + nx, dj : dj + ny] += vals[:, :, k]
            return y.reshape(-1)
        if self._stencil is not None:
            nx, ny, nz = self._stencil
            vals = vals_e.reshape(nx, ny, nz, self.nloc, nc)
            y = torch.zeros((nx + 1, ny + 1, nz + 1, nc), dtype=vals_e.dtype, device=vals_e.device)
            for k, (di, dj, dk) in enumerate(self._CORNERS_3D):
                y[di : di + nx, dj : dj + ny, dk : dk + nz] += vals[:, :, :, k]
            return y.reshape(-1)
        if self.banded_active:
            # assembly-as-gather over feature-major element values
            return self._banded_take("asm", vals_e.T.reshape(-1))
        vals = torch.cat([vals_e.reshape(-1), vals_e.new_zeros(1)])
        return vals[self._gather_map].sum(dim=1)

    def gather(self, u):
        """u (ndofs,) -> element dofs (ne, ndof_el)."""
        return self._cut(self._gather_all(u))

    def _gather_all(self, u):
        nc = self.ncomp
        if self._stencil is not None and len(self._stencil) == 2:
            nx, ny = self._stencil
            u2 = u.reshape(nx + 1, ny + 1, nc)
            parts = [u2[di : di + nx, dj : dj + ny].reshape(self.ne_all, nc) for (di, dj) in self._CORNERS_2D]
            return torch.cat(parts, dim=1)
        if self._stencil is not None:
            nx, ny, nz = self._stencil
            u3 = u.reshape(nx + 1, ny + 1, nz + 1, nc)
            parts = [
                u3[di : di + nx, dj : dj + ny, dk : dk + nz].reshape(self.ne_all, nc)
                for (di, dj, dk) in self._CORNERS_3D
            ]
            return torch.cat(parts, dim=1)
        if self.banded_active:
            return self._banded_take("cell", u).reshape(self.ne_all, self.ndof_el)
        return u[self._dofmap_all]

    def _cell_eval(self, expr, u_e, dNdx_c, x_c):
        """expr at all qps of one cell given its element dofs (ndof_el,)."""
        un = u_e.reshape(self.nloc, self.ncomp)
        u_q = self.N @ un  # (nq, ncomp)
        grad_q = torch.einsum("qvi,vc->qci", dNdx_c, un)  # (nq, ncomp, dim)
        return vmap(lambda u, g, x: expr(Ctx(u, g, x)))(u_q, grad_q, x_c)

    # --------------------------------------------------------- public kernels
    def make_eval(self, expr):
        """u (ndofs,) -> expression values (ne*nq, size)."""

        def f(u):
            u_e = self.gather(u)
            vals = vmap(lambda ue, d, x: self._cell_eval(expr, ue, d, x))(u_e, self.dNdx, self.x_q)
            return vals.reshape(self.num_points, -1)

        return f

    def make_B(self, expr):
        """u (ndofs,) -> B = d(expr)/d(u_e) at every point, (ne, nq, size,
        ndof_el): the cross-field tangent blocks' test and trial operators."""

        def f(u):
            u_e = self.gather(u)

            def cell(ue, d, x):
                return jacfwd(lambda w_: self._cell_eval(expr, w_, d, x))(ue)

            return vmap(cell)(u_e, self.dNdx, self.x_q)

        return f

    def _work(self, exprs, d, x, w, flds):
        """sum_k ∫ field_k · expr_k(u) over one cell, as a function of u_e."""

        def work(w_):
            tot = 0.0
            for expr, fld in zip(exprs, flds):
                g = self._cell_eval(expr, w_, d, x)  # (nq, size)
                tot = tot + torch.sum(w[:, None] * g * fld)
            return tot

        return work

    def make_residual(self, exprs):
        """Residual of the quadrature terms sum_k ∫ field_k · expr_k(u) dx:
        ``f(u, fields) -> R (ndofs,)`` with ``fields`` a list of (ne*nq,
        size_k) coefficient tensors held fixed."""

        def f(u, fields):
            u_e = self.gather(u)
            fields_e = [f_.reshape(self.ne, self.nq, -1) for f_ in fields]

            def cell_res(ue, d, x, w, *flds):
                return grad(self._work(exprs, d, x, w, flds))(ue)

            r_e = vmap(cell_res)(u_e, self.dNdx, self.x_q, self.wdetJ, *fields_e)
            return self.scatter_dofs(r_e)

        return f

    def make_element_matrices(self, exprs, tangent_structure):
        """Consistent element tangents K_e (ne, ndof_el, ndof_el):

            K_e = sum_(k, x) ∫ B_k^T C_(field_k, x) B_x dx   (material part)
                + hessian_u of sum_k ∫ field_k · expr_k(u) dx   (geometric part)

        ``tangent_structure``: list of (k_term, x_expr_fn, None); the C blocks
        come at call time as (ne*nq, size_y, size_x). Returns
        ``f(u, fields, Cs) -> K_e``."""

        def f(u, fields, Cs):
            u_e = self.gather(u)
            fields_e = [f_.reshape(self.ne, self.nq, -1) for f_ in fields]
            Cs_e = [C.reshape(self.ne, self.nq, C.shape[-2], C.shape[-1]) for C in Cs]

            def cell(ue, d, x, w, flds, Cblocks):
                Bcache = {}

                def B_of(expr):
                    key = id(expr)
                    if key not in Bcache:
                        Bcache[key] = jacfwd(lambda w_: self._cell_eval(expr, w_, d, x))(ue)
                    return Bcache[key]

                K = ue.new_zeros((self.ndof_el, self.ndof_el))
                for (k_term, x_expr, _), C in zip(tangent_structure, Cblocks):
                    By = B_of(exprs[k_term])  # (nq, size_y, ndof)
                    Bx = B_of(x_expr)  # (nq, size_x, ndof)
                    K = K + torch.einsum("qai,qab,qbj,q->ij", By, C, Bx, w)
                return K + hessian(self._work(exprs, d, x, w, flds))(ue)

            return vmap(cell)(u_e, self.dNdx, self.x_q, self.wdetJ, fields_e, Cs_e)

        return f

    # ------------------------------------------------------------ operators
    def spmv_prepare(self, K_e):
        """Pre-transpose element matrices to feature-major (nd*nd, ne) rows
        for the stencil and banded SpMVs (one transpose per Newton iteration
        for the ~100 CG matvecs that reuse it); else K_e unchanged."""
        if self._stencil is not None:
            kind = "fm"
        elif self.banded_active and self._banded.get("fm") is not None:
            kind = "bdfm"
        else:
            return K_e
        nd = self.ndof_el
        return (kind, K_e.permute(1, 2, 0).reshape(nd * nd, self.ne))

    def spmv(self, K_e, v):
        """Assembly-free SpMV y = A v from element matrices (raw or the
        output of :meth:`spmv_prepare`)."""
        nd = self.ndof_el
        if isinstance(K_e, tuple) and K_e[0] == "bdfm":
            # banded: feature-major gather -> per-row products -> assembly take
            u = self._cut(self._banded_take("fm", v).reshape(nd, self.ne_all), 1)
            y = torch.einsum("ije,je->ie", K_e[1].reshape(nd, nd, self.ne), u)
            return self._banded_take("asm", self._paste(y, 1).reshape(-1))
        if isinstance(K_e, tuple) and K_e[0] == "fm":
            vr = self._cut(torch.stack(self._gather_rows(v)), 1)  # (nd, ne)
            y = torch.einsum("ije,je->ie", K_e[1].reshape(nd, nd, self.ne), vr)
            return self._scatter_rows(self._paste(y, 1), v.dtype)
        v_e = self._banded_take("cell", v).reshape(self.ne_all, nd) if self.banded_active else v[self._dofmap_all]
        return self.scatter_dofs(torch.einsum("eij,ej->ei", K_e, self._cut(v_e)))

    def _gather_rows(self, u):
        """Stencil gather as a list of (ne,) rows (feature-major)."""
        nc = self.ncomp
        if len(self._stencil) == 2:
            nx, ny = self._stencil
            u2 = u.reshape(nx + 1, ny + 1, nc)
            return [
                u2[di : di + nx, dj : dj + ny, c].reshape(self.ne_all)
                for (di, dj) in self._CORNERS_2D
                for c in range(nc)
            ]
        nx, ny, nz = self._stencil
        u3 = u.reshape(nx + 1, ny + 1, nz + 1, nc)
        return [
            u3[di : di + nx, dj : dj + ny, dk : dk + nz, c].reshape(self.ne_all)
            for (di, dj, dk) in self._CORNERS_3D
            for c in range(nc)
        ]

    def _scatter_rows(self, rows, dtype):
        nc = self.ncomp
        shape = tuple(g + 1 for g in self._stencil) + (nc,)
        y = torch.zeros(shape, dtype=dtype, device=rows.device)
        corners = self._CORNERS_2D if len(self._stencil) == 2 else self._CORNERS_3D
        i = 0
        for corner in corners:
            sl = tuple(slice(c, c + g) for c, g in zip(corner, self._stencil))
            for c in range(nc):
                y[sl + (c,)] += rows[i].reshape(self._stencil)
                i += 1
        return y.reshape(-1)

    def matrix_diagonal(self, K_e, ndofs):
        return self.scatter_dofs(torch.diagonal(K_e, dim1=1, dim2=2))

    def matrix_node_blocks(self, K_e, nnodes):
        """Per-node (ncomp x ncomp) diagonal blocks of the assembled operator,
        (nnodes, ncomp, ncomp): the block-Jacobi preconditioner's data,
        summed in a fixed order (:func:`~..ops.banded_gather.fixed_sum`)."""
        nc = self.ncomp
        plan = self._node_block_plan
        if plan is None or plan.n_out != nnodes * nc * nc:
            nodes = self._dofmap_np[:, ::nc] // nc
            target = nodes[:, :, None, None] * nc * nc + np.arange(nc * nc).reshape(1, 1, nc, nc)
            plan = self._node_block_plan = bg.plan_fixed_sum(target, nnodes * nc * nc, device=self.device)
        diagb = torch.einsum("eiaib->eiab", K_e.reshape(self.ne, self.nloc, nc, self.nloc, nc))
        return bg.fixed_sum(self._paste(diagb).reshape(-1), plan).reshape(nnodes, nc, nc)

    def variant(self, dtype=None, stencil=True, banded=True):
        """This domain in another dtype, or without its stencil or banded
        route (then the next route of the module docstring's order serves
        it): a shallow copy sharing the index plans."""
        dom = copy.copy(self)
        if dtype is not None and dtype != self.dtype:
            dom.dtype = dtype
            for name in ("dNdx", "N", "wdetJ", "x_q", "cell_volumes"):
                setattr(dom, name, getattr(self, name).to(dtype))
        if not stencil:
            dom._stencil = None
        if not banded:
            dom._banded = None
        return dom

    def to_scipy_csr(self, K_e, ndofs):
        """The assembled sparse matrix on the host, for direct solves."""
        import scipy.sparse as sp

        dm = self._dofmap_np
        rows = np.repeat(dm, self.ndof_el, axis=1).ravel()
        cols = np.tile(dm, (1, self.ndof_el)).ravel()
        K = K_e.detach().cpu().numpy().ravel()
        return sp.coo_matrix((K, (rows, cols)), shape=(ndofs, ndofs)).tocsr()


def project_dg0(domain: QuadratureDomain, values_q):
    """Cell-averaged (DG-0) projection of a quadrature field, (ne, size)."""
    v = values_q.reshape(domain.ne, domain.nq, -1)
    num = torch.einsum("eq,eqk->ek", domain.wdetJ, v)
    return num / domain.cell_volumes[:, None]


def assemble_scalar(domain: QuadratureDomain, values_q):
    """∫ f dx over the domain, ``values_q`` at the quadrature points
    ((ne*nq,) or a scalar); a 0-d tensor on the domain's device."""
    v = torch.as_tensor(values_q, dtype=domain.dtype, device=domain.device)
    v = v.reshape(-1).expand(domain.num_points).reshape(domain.ne, domain.nq)
    return torch.sum(domain.wdetJ * v)


def project_cg(domain: QuadratureDomain, values_q, degree=1, smooth=None):
    """L2 projection of a quadrature field onto the continuous Lagrange space
    of ``degree`` on the same mesh: one mass-matrix CG solve per component
    (tolerance 1e-12, Jacobi preconditioner, the solvers' ``cg``) on the
    target domain's device, its gathers and assembly on the target domain's
    routes (the banded kernels where it has plans). ``smooth``: a Helmholtz
    filter length, adding ``smooth**2 ∫ grad(Pv).grad(w) dx`` to the
    operator. Returns ``(space, dof values (nnodes, k) numpy)``."""
    from ..solvers import cg

    target = FunctionSpace(domain.space.mesh, degree, ())
    tdom = QuadratureDomain(target, domain.quad_degree, domain.cells, dtype=domain.dtype,
                            device=domain.device)
    vals = torch.as_tensor(values_q, dtype=domain.dtype, device=domain.device).reshape(domain.ne, domain.nq, -1)
    Me = torch.einsum("eq,qi,qj->eij", tdom.wdetJ, tdom.N, tdom.N)
    if smooth is not None:
        Me = Me + float(smooth) ** 2 * torch.einsum("eq,eqid,eqjd->eij", tdom.wdetJ, tdom.dNdx, tdom.dNdx)
    rhs_e = torch.einsum("eq,qi,eqc->eic", tdom.wdetJ, tdom.N, vals)
    diag = tdom.scatter_dofs(torch.diagonal(Me, dim1=1, dim2=2).contiguous())
    diag = torch.where(diag <= 0, torch.ones_like(diag), diag)
    K = tdom.spmv_prepare(Me)
    cols = []
    for c in range(vals.shape[-1]):
        b = tdom.scatter_dofs(rhs_e[:, :, c].contiguous())
        x, _ = cg(lambda v: tdom.spmv(K, v), b, 1e-12, 10 * target.num_dofs, lambda v: v / diag)
        cols.append(x)
    return target, torch.stack(cols, dim=1).cpu().numpy()