"""The fused Newton load step of blocked (monolithic multi-field) problems,
on one card or over the ranks of a process group:
:func:`make_sharded_blocked_step`.

Counterpart of dolfinx_materials_tpu/parallel/blocked.py. There the step is
one XLA program with cells and interface facets sharded over a mesh of
devices and every partial sum ``psum``'d; here it is one Newton loop driven
from the host on each rank's card, with the same arithmetic. Over N ranks
each map's cells are split as in :mod:`.sharding` (the gathers and the
assembly over the whole mesh, the element work on the rank's block, its
element values summed across ranks before the assembly), so the residual,
the coarse matrix, the diagonal, the smoother's node blocks and the matvec
are the one-device step's to the bit; the iterate z stays whole on every
rank, and every rank runs the interface facets (few) in full.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.banded_gather import fixed_sum, gather_map, plan_fixed_sum
from ..solvers import blocked_apply, blocked_diagonal
from .coarse import _coord_agg_cdofs
from .krylov import _pbicgstab, _sym_block_inv
from .sharding import _canonical, _mesh_device, _Ranks, _rows, _Term


def _norm(v):
    return torch.sqrt(torch.dot(v, v))


class _BlockedTerm(_Term):
    """One (field, qmap) of the blocked problem: the general step's term,
    plus the couplings whose row map it is (their ESV values come from the
    col field, their blocks K_rc from the row term's test operator and the
    col expression's trial operator), per working dtype."""

    def __init__(self, t, field, prob, couplings, use_banded, dtypes, device, ranks):
        qmap = t["qmap"]
        mine = [c for c in couplings if c["qmap"] is qmap]
        super().__init__(t, True, use_banded, dtypes, device, coupled={c["x"] for c in mine}, ranks=ranks)
        self.field = field
        self.sc = [prob._scale_value(s) for s in t["scales"]]
        self.wdetJ = {dt: self.dom.wdetJ.to(dt) for dt in dtypes}
        self.coups = []
        for c in mine:
            k = t["field_names"].index(c["y"])
            col = c["col_dom"]
            if self.dom._block is not None:
                col = col.block(self.lo, self.hi, self.dom._reduce)
            dts = {dt: (self.dom.variant(dtype=dt), col.variant(dtype=dt)) for dt in dtypes}
            self.coups.append(dict(
                c, k_term=k, slice=qmap._block_slices[(c["y"], c["x"])], col_dofmap=col.dofmap,
                B_y={dt: d.make_B(t["exprs"][k]) for dt, (d, _) in dts.items()},
                B_x={dt: cd.make_B(c["x_expr_fn"]) for dt, (_, cd) in dts.items()},
                eval_x={dt: cd.make_eval(c["x_expr_fn"]) for dt, (_, cd) in dts.items()}))


def make_sharded_blocked_step(
    blocked, mesh, axis="cells", n_newton=12, n_cg=200, n_backtracks=10, rtol=None, atol=0.0,
    pc="two_level", pc_boxes=8, smoother=None, cg_rtol=1e-8, use_banded=True,
):
    """The fused Newton load step of a
    :class:`~dolfinx_materials_tpu_torch.solvers.BlockedNonlinearProblem`
    (several fields, cross-field tangent blocks, interface laws), on the card
    that holds it (``blocked.device``; ``mesh`` must name that device):

    - each field's maps run the general step's evaluation (gathers,
      constitutive update, element residuals and matrices, on the domain's
      stencil, banded or gather-map route); coupled ESVs are evaluated again
      from the current col iterate at every evaluation, Newton iterate and
      line-search trial alike;
    - off-diagonal blocks K_rc = scale B_y^T C_(y,x) B_x^col per row cell,
      interface blocks per facet, both applied inside the matvec; interface
      sums go through fixed-order plans;
    - the linear solve is preconditioned BiCGStab (``n_cg`` a budget, exit at
      ``cg_rtol`` relative to |b|) on the monolithic operator with
      concatenated Dirichlet masking; the line search backtracks on the
      flux-only residual.

    Preconditioning: ``pc="two_level"`` (default) adds a coarse correction
    frozen at the entering tangent over per-field coordinate-box aggregates
    (at most ``max(64, 2048 // nfields)`` coarse dofs a field), the
    monolithic ``P^T K P`` of every diagonal, coupling and interface block
    summed in a fixed order (:func:`~..ops.banded_gather.fixed_sum`) and
    inverted once; ``pc="jacobi"`` has none. Smoother: node-block Jacobi on
    vector fields (``smoother="block"``, the default when a 3D vector field
    is present) or the scalar diagonal (``"jacobi"``).

    As in the JAX step, the problems' external forces are not applied: the
    load comes through ``bc_vals``; the step runs in the dtype of ``z``
    (float32 inputs to a float64 problem run the whole step in float32).
    Over a process group's mesh each rank runs the element work of its
    block of cells, and z, the states and the bc arrays go in and come out
    whole on every rank (:mod:`.sharding`'s contract).

    Returns ``(step, pad_states)`` with ``step(z, states, bc_mask, bc_vals,
    dt=0.0) -> (z_new, states, |R|)``; ``states`` is the flat list of
    internal-state dicts over all problems' maps (problems[0]'s maps, then
    problems[1]'s, ...). ``step.info`` holds the last call's Newton and
    BiCGStab counts, its residual norms (entering, then after each Newton
    iteration) and the tolerance Newton stopped at.
    """
    dev = _mesh_device(mesh, axis)
    if _canonical(blocked.device) != dev:
        raise ValueError(f"problem on {blocked.device}, mesh on {dev}")
    ranks = _Ranks(mesh)
    if smoother not in (None, "jacobi", "block"):
        raise ValueError(f"smoother must be None, 'jacobi' or 'block', got {smoother!r}")
    if pc not in ("jacobi", "two_level"):
        raise ValueError(f"pc must be 'jacobi' or 'two_level', got {pc!r}")
    device, dtype = blocked.device, blocked.dtype
    offsets = [int(o) for o in blocked.offsets]
    sizes = [int(s) for s in blocked.sizes]
    problems = blocked.problems
    nfields = len(problems)
    if rtol is None:
        rtol = 1e-10 if dtype == torch.float64 else 1e-6
    field_ncomp = [int(p.u.space.ncomp) for p in problems]
    # node-block Jacobi by default only where a 3D vector field is present;
    # scalar fields always take the plain diagonal
    default_sm = "block" if any(nc >= 3 for nc in field_ncomp) else "jacobi"
    use_block = (smoother or default_sm) == "block" and any(nc > 1 for nc in field_ncomp)

    dtypes = sorted({dtype, torch.float32}, key=str)
    terms = [_BlockedTerm(t, fi, p, blocked._couplings, use_banded, dtypes, device, ranks)
             for fi, p in enumerate(problems) for t in p._terms]
    # the facets' index tables and plans (the same in every dtype)
    itfs = [(itf, itf.domain.tensors(device, dtype)) for itf in blocked.interfaces]

    def split(v):
        return [v[offsets[i]: offsets[i] + sizes[i]] for i in range(nfields)]

    # ---- coarse space: per-field aggregates at per-field coarse offsets,
    # so the monolithic coarse operator keeps the cross-field structure
    two_level = pc == "two_level"
    if two_level:
        budget = max(64, 2048 // nfields)
        coarse_offsets, cdof_fields = [0], []
        for p in problems:
            nci, cd = _coord_agg_cdofs(p.u.space, pc_boxes, budget=budget)
            cdof_fields.append(cd + coarse_offsets[-1])
            coarse_offsets.append(coarse_offsets[-1] + nci)
        ncoarse = coarse_offsets[-1]
        cdof_ids = np.concatenate(cdof_fields)
        cdof_t = torch.as_tensor(cdof_ids, dtype=torch.int64, device=device)
        restrict_map = torch.as_tensor(gather_map(cdof_ids, ncoarse), device=device)

        def pairs(a, b):
            return (a[:, :, None] * ncoarse + b[:, None, :]).reshape(-1)

        # one fixed-order sum over every block, in the JAX step's order: per
        # term its diagonal block then its couplings, then the interfaces
        targets = []
        for term in terms:
            cd = cdof_fields[term.field][term.dofmap_np]
            targets.append(pairs(cd, cd))
            for c in term.coups:
                targets.append(pairs(cd, cdof_fields[c["col"]][c["col_dom"]._dofmap_np]))
        for itf, _ in itfs:
            d1, d2 = itf.scatter_dofs()
            cd1, cd2 = cdof_fields[itf.i][d1], cdof_fields[itf.j][d2]
            targets += [pairs(cd1, cd1), pairs(cd2, cd2), pairs(cd1, cd2), pairs(cd2, cd1)]
        coarse_plan = plan_fixed_sum(np.concatenate(targets), ncoarse * ncoarse, device=device)

    # ---- node-block smoother: the interface's node-diagonal blocks, summed
    # into each side's (nnodes, nc, nc) blocks in a fixed order
    if use_block:
        itf_block_plans = []
        for itf, _ in itfs:
            nc = itf.domain.ncomp
            ab = np.arange(nc * nc).reshape(1, 1, nc, nc)
            itf_block_plans.append([
                plan_fixed_sum((d[:, ::nc] // nc)[:, :, None, None] * nc * nc + ab, n * nc, device=device)
                for d, n in zip(itf.scatter_dofs(), (sizes[itf.i], sizes[itf.j]))
            ])

    # ---- evaluations ------------------------------------------------------
    def coupled_values(term, parts, wd):
        return {c["x"]: c["eval_x"][wd](parts[c["col"]]) for c in term.coups}

    def masked_residual(R, parts, mask):
        """The per-field residuals ``R`` plus every interface's,
        concatenated, Dirichlet rows zeroed."""
        for itf, _ in itfs:
            r_i, r_j = itf.residuals(parts[itf.i], parts[itf.j], sizes[itf.i], sizes[itf.j])
            R[itf.i] = R[itf.i] + r_i
            R[itf.j] = R[itf.j] + r_j
        R = torch.cat(R)
        return torch.where(mask, torch.zeros_like(R), R)

    def evaluate(z, states, tdt, mask):
        """``(R, diag_Ks, coup_Ks, itf_Ks, new_states)`` at z: the
        constitutive update, the masked residual, each term's element
        matrices and coupling blocks, each interface's base block, in z's
        dtype."""
        wd = z.dtype
        parts = split(z)
        R = [torch.zeros(n, dtype=wd, device=device) for n in sizes]
        diag_Ks, coup_Ks, new_states = [], [], []
        for term, st in zip(terms, states):
            u_i = parts[term.field]
            flux, Ct, st_new = term.integrate(term.inputs(u_i, wd, coupled_values(term, parts, wd)), st, wd,
                                              tdt, False)
            flds = term.fields(flux, st_new, term.sc)
            fns = term.fns[wd]
            R[term.field] = R[term.field] + fns["residual"](u_i, flds)
            n = flux.shape[0]
            Cs = [term.sc[k] * Ct[:, sl].reshape(n, sy, sx) for (k, sl, sy, sx) in term.tstruct]
            diag_Ks.append(fns["Kel"](u_i, flds, Cs))
            Krc = []
            for c in term.coups:
                sl, sy, sx = c["slice"]
                C = Ct[:, sl].reshape(term.ne, -1, sy, sx)
                By = c["B_y"][wd](u_i)
                Bx = c["B_x"][wd](parts[c["col"]])
                Krc.append((c["scale"] * term.sc[c["k_term"]])
                           * torch.einsum("eqai,eqab,eqbj,eq->eij", By, C, Bx, term.wdetJ[wd]))
            coup_Ks.append(Krc)
            new_states.append(st_new)
        R = masked_residual(R, parts, mask)
        itf_Ks = [itf.base_matrix(parts[itf.i], parts[itf.j]) for itf, _ in itfs]
        return R, diag_Ks, coup_Ks, itf_Ks, new_states

    def residual_norm(z, states, tdt, mask):
        """|R| from flux-only updates (the line-search trials), on the host."""
        wd = z.dtype
        parts = split(z)
        R = [torch.zeros(n, dtype=wd, device=device) for n in sizes]
        for term, st in zip(terms, states):
            u_i = parts[term.field]
            flux, _, st_new = term.integrate(term.inputs(u_i, wd, coupled_values(term, parts, wd)), st, wd,
                                             tdt, True)
            R[term.field] = R[term.field] + term.fns[wd]["residual"](u_i, term.fields(flux, st_new, term.sc))
        return float(_norm(masked_residual(R, parts, mask)))

    def build_coarse(diag_Ks, coup_Ks, itf_Ks, mask):
        """The inverse of the monolithic coarse operator P^T K P (Dirichlet
        rows and columns zeroed, a ridge on its diagonal), frozen for the
        step."""
        wd = diag_Ks[0].dtype
        w = split((~mask).to(wd))
        vals = []
        for term, K, Krc in zip(terms, diag_Ks, coup_Ks):
            w_r = w[term.field][term.dofmap]
            vals.append(term.dom._paste(K * w_r[:, :, None] * w_r[:, None, :]).reshape(-1))
            for c, Kc in zip(term.coups, Krc):
                w_c = w[c["col"]][c["col_dofmap"]]
                vals.append(term.dom._paste(Kc * w_r[:, :, None] * w_c[:, None, :]).reshape(-1))
        for (itf, t), base in zip(itfs, itf_Ks):
            w1, w2 = w[itf.i][t["dofs1"]], w[itf.j][t["dofs2"]]
            for wa, wb, sgn in ((w1, w1, 1.0), (w2, w2, 1.0), (w1, w2, -1.0), (w2, w1, -1.0)):
                vals.append((sgn * base * wa[:, :, None] * wb[:, None, :]).reshape(-1))
        Ac = fixed_sum(torch.cat(vals), coarse_plan).reshape(ncoarse, ncoarse)
        dAc = torch.diagonal(Ac)
        ridge = 1e-8 * dAc.abs().max() + 1e-30
        Ac = Ac + (ridge + (dAc.abs() < ridge).to(wd)) * torch.eye(ncoarse, dtype=wd, device=device)
        return torch.linalg.inv(Ac)

    def coarse_correct(Ac_inv, r, mask):
        zero = r.new_zeros(())
        r0 = torch.where(mask, zero, r)
        rc = torch.cat([r0, r0.new_zeros(1)])[restrict_map].sum(dim=1)
        return torch.where(mask, zero, (Ac_inv @ rc)[cdof_t])

    def make_smoother(diag_Ks, itf_Ks, mask):
        """The first-level smoother: per-field node-block Jacobi on vector
        fields (with ``use_block``), else the scalar diagonal (interface
        entries included, unit on bc rows)."""
        wd = diag_Ks[0].dtype
        diag = blocked_diagonal(mask, sizes, [(term.field, term.dom, K) for term, K in zip(terms, diag_Ks)],
                                interface_blocks(itf_Ks), wd, device)
        if not use_block:
            return lambda r: r / diag
        mask_f, diag_f = split(mask), split(diag)
        binvs = {}
        for fi in range(nfields):
            nc = field_ncomp[fi]
            if nc <= 1:
                continue
            nnodes = sizes[fi] // nc
            Bm = torch.zeros((nnodes, nc, nc), dtype=wd, device=device)
            for term, K in zip(terms, diag_Ks):
                if term.field == fi:
                    Bm = Bm + term.dom.matrix_node_blocks(K, nnodes)
            for (itf, _), base, plans in zip(itfs, itf_Ks, itf_block_plans):
                if itf.domain.ncomp != nc:
                    continue
                k = itf.domain.nloc_f
                nb = torch.einsum("fvavc->fvac", base.reshape(-1, k, nc, k, nc)).reshape(-1)
                if itf.i == fi:
                    Bm = Bm + fixed_sum(nb, plans[0]).reshape(nnodes, nc, nc)
                if itf.j == fi:
                    Bm = Bm + fixed_sum(nb, plans[1]).reshape(nnodes, nc, nc)
            mb = mask_f[fi].reshape(-1, nc).to(wd)
            keep = 1.0 - mb
            eye = torch.eye(nc, dtype=wd, device=device)
            Bm = Bm * keep[:, :, None] * keep[:, None, :] + eye * mb[:, :, None]
            tr = torch.einsum("naa->n", Bm.abs())
            Bm = Bm + eye * torch.where(tr < 1e-30, torch.ones_like(tr), 1e-14 * tr)[:, None, None]
            binvs[fi] = _sym_block_inv(Bm, eye)

        def smooth(r):
            out = []
            for fi, r_f in enumerate(split(r)):
                if fi in binvs:
                    out.append(torch.einsum("nab,nb->na", binvs[fi], r_f.reshape(-1, field_ncomp[fi])).reshape(-1))
                else:
                    out.append(r_f / diag_f[fi])
            return torch.cat(out)

        return smooth

    def interface_blocks(itf_Ks):
        return [(itf.i, itf.j, t, base) for (itf, t), base in zip(itfs, itf_Ks)]

    def operator(diag_Ks, coup_Ks, itf_Ks, mask):
        """``Av(v)``: the monolithic matvec with bc rows/cols as identity
        (coupling columns gathered by plain indexing)."""
        diag = [(term.field, term.dom, term.dom.spmv_prepare(K)) for term, K in zip(terms, diag_Ks)]
        coup = [(term.field, c["col"], term.dom, lambda x, dm=c["col_dofmap"]: x[dm], Kc)
                for term, Krc in zip(terms, coup_Ks) for c, Kc in zip(term.coups, Krc)]
        itf = interface_blocks(itf_Ks)
        return lambda v: blocked_apply(v, mask, sizes, diag, coup, itf)

    def newton_update(z, R, diag_Ks, coup_Ks, itf_Ks, res, states, tdt, mask, Ac_inv):
        """One BiCGStab correction and the line search: ``(z_new, its)``.
        BiCGStab, not CG: the coupling blocks make the operator
        nonsymmetric."""
        smooth = make_smoother(diag_Ks, itf_Ks, mask)
        if Ac_inv is None:
            M = smooth
        else:
            def M(v):
                return smooth(v) + coarse_correct(Ac_inv, v, mask)
        b = torch.where(mask, torch.zeros_like(R), -R)
        du, its = _pbicgstab(operator(diag_Ks, coup_Ks, itf_Ks, mask), b, M, maxiter=n_cg, tol=cg_rtol)
        du = torch.where(torch.isfinite(du), du, torch.zeros_like(du))
        alpha, k = 1.0, 0
        n_try = residual_norm(z + du, states, tdt, mask)
        while (not np.isfinite(n_try) or n_try >= (1 - 1e-4 * alpha) * res) and k < n_backtracks:
            alpha *= 0.5
            n_try = residual_norm(z + alpha * du, states, tdt, mask)
            k += 1
        if np.isfinite(n_try) and n_try < res:
            return z + alpha * du, its
        return z, its

    # ---- states ------------------------------------------------------------
    def pad_states(states, wd=dtype):
        """Each map's states on the card in ``wd`` over every rank's points:
        the real points, then the behavior's initial state on the padding
        cells' points."""
        out = []
        for term, st in zip(terms, states):
            leaves = {}
            for k, v in st.items():
                a = torch.as_tensor(v, device=device)
                a = a.to(wd) if a.is_floating_point() else a
                fill = torch.as_tensor(np.asarray(term.init_tpl[k]), dtype=a.dtype, device=device)
                leaves[k] = _rows(a, 0, term.npts_pad, fill)
            out.append(leaves)
        return out

    def step(z, states, bc_mask, bc_vals, dt=0.0):
        z = torch.as_tensor(z, device=device)
        wd = torch.float32 if z.dtype == torch.float32 else dtype
        mask = torch.as_tensor(np.asarray(bc_mask) if not torch.is_tensor(bc_mask) else bc_mask,
                               device=device).to(torch.bool)
        vals = torch.as_tensor(bc_vals, device=device).to(wd)
        z = torch.where(mask, vals, z.to(wd))
        states = [{k: v[term.pts[0]: term.pts[1]] for k, v in st.items()}
                  for term, st in zip(terms, pad_states(states, wd))]
        tdt = float(dt)
        R, dK, cK, iK, st_out = evaluate(z, states, tdt, mask)
        res_t = _norm(R)
        res = float(res_t)
        res0 = max(res, 1e-30)
        # the coarse factor from the entering tangents, frozen for the step
        Ac_inv = build_coarse(dK, cK, iK, mask) if two_level else None
        n_it, its, history = 0, [], [res]
        while n_it < n_newton and res > rtol * res0 + atol:
            z, k = newton_update(z, R, dK, cK, iK, res, states, tdt, mask, Ac_inv)
            R, dK, cK, iK, st_out = evaluate(z, states, tdt, mask)
            res_t = _norm(R)
            res = float(res_t)
            n_it += 1
            its.append(k)
            history.append(res)
        step.info = dict(newton=n_it, bicgstab=sum(its), bicgstab_per_newton=its, residuals=history,
                         tolerance=rtol * res0 + atol)
        st_out = [{k: ranks.join(v, term.pts[0], term.npts_pad)[: term.npts] for k, v in st.items()}
                  for term, st in zip(terms, st_out)]
        return z, st_out, res_t

    step.info = {}
    return step, pad_states
