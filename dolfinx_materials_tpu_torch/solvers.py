"""Global nonlinear solver: Newton with matrix-free Krylov or host direct solves.

``NonlinearMaterialProblem`` is a Newton loop whose residual callback first
runs the constitutive update of every registered QuadratureMap, then
assembles. The linear solve is a hand-written preconditioned Krylov method
on the assembly-free element-matrix SpMV: CG, BiCGStab or restarted GMRES
(``ksp_type`` "cg", "bicgstab", "gmres"), each with the iteration and
stopping rule of its ``jax.scipy.sparse.linalg`` counterpart so iteration
counts compare with the JAX package; or a scipy LU on the host
(``ksp_type="lu"``). ``ksp_precision="f32"`` runs the Krylov solve of an f64
problem in float32 on the symmetrically scaled operator. Dirichlet BCs are
imposed by masking (rows/cols to identity). ``solve()`` commits state via
``advance()`` on every map after convergence.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .fem.bc import combine_bcs
from .fem.space import Function
from .ops.banded_gather import fixed_sum, gather_map, plan_fixed_sum
from .quadrature_map import QuadratureMap
from .utils.timers import timer


def cg(A, b, tol, maxiter, M):
    """Preconditioned conjugate gradients with the iteration and stopping rule
    of ``jax.scipy.sparse.linalg.cg``: x0 = 0, iterate while
    ``|r|^2 > tol^2 |b|^2`` and fewer than ``maxiter`` steps were taken.
    Returns ``(x, iterations)``. One host sync per iteration (the test)."""
    x = torch.zeros_like(b)
    r = b.clone()  # b - A(x0) with x0 = 0
    z = M(r)
    p = z
    gamma = torch.dot(r, z)
    atol2 = tol * tol * float(torch.dot(b, b))
    k = 0
    while k < maxiter and float(torch.dot(r, r)) > atol2:
        Ap = A(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = torch.dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x, k


def bicgstab(A, b, tol, maxiter, M):
    """Preconditioned BiCGStab with the iteration of
    ``jax.scipy.sparse.linalg.bicgstab``: x0 = 0, iterate while
    ``|r|^2 > tol^2 |b|^2``, fewer than ``maxiter`` steps were taken and no
    breakdown (rho, alpha or omega exactly 0) stopped it; a step whose
    intermediate residual s already passes the test ends at x + alpha phat.
    Returns ``(x, iterations)``."""
    x = torch.zeros_like(b)
    r = b.clone()
    rhat, p, q = r, r, r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    atol2 = tol * tol * float(torch.dot(b, b))
    k = 0
    while k < maxiter and float(torch.dot(r, r)) > atol2:
        rho_ = torch.dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = A(phat)
        alpha = rho_ / torch.dot(rhat, q)
        s = r - alpha * q
        shat = M(s)
        t = A(shat)
        omega = torch.dot(t, s) / torch.dot(t, t)
        rho = rho_
        k += 1
        if float(torch.dot(s, s)) < atol2:
            x, r = x + alpha * phat, s
        else:
            x, r = x + (alpha * phat + omega * shat), s - omega * t
        if float(rho_) == 0.0 or float(omega) == 0.0 or float(alpha) == 0.0:
            break
    return x, k


def _safe_normalize(x, thresh=None):
    """``(x / |x|, |x|)``, or ``(0, 0)`` where ``|x|`` is at most ``thresh``
    (the dtype's eps by default), as JAX's GMRES normalizes."""
    norm = torch.sqrt(torch.dot(x, x))
    thresh = torch.finfo(x.dtype).eps if thresh is None else thresh
    use = norm > thresh
    return torch.where(use, x / norm, torch.zeros_like(x)), torch.where(use, norm, torch.zeros_like(norm))


def gmres(A, b, tol, maxiter, M, restart=20):
    """Restarted, left-preconditioned GMRES with the iteration of
    ``jax.scipy.sparse.linalg.gmres`` (``solve_method="batched"``): each
    restart builds a ``restart``-dimensional Arnoldi basis of M A (classical
    Gram-Schmidt, stopping at a breakdown) and takes the least-squares update
    through the normal equations; restarts continue while the preconditioned
    residual norm exceeds ``tol |b|`` and fewer than ``maxiter`` restarts were
    made. Returns ``(x, Arnoldi steps)``."""
    n = b.shape[0]
    restart = min(restart, n)
    x = torch.zeros_like(b)
    atol = tol * float(torch.sqrt(torch.dot(b, b)))
    unit, rnorm = _safe_normalize(M(b - A(x)))
    eps = torch.finfo(b.dtype).eps
    steps = k = 0
    while k < maxiter and float(rnorm) > atol:
        V = b.new_zeros((restart + 1, n))  # the basis, one vector a row
        V[0] = unit
        H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
        for j in range(restart):
            v = M(A(V[j]))
            _, vnorm0 = _safe_normalize(v)
            h = V @ v  # one classical Gram-Schmidt pass
            v = v - V.T @ h
            unit_v, vnorm1 = _safe_normalize(v, thresh=eps * vnorm0)
            V[j + 1] = unit_v
            h[j + 1] = vnorm1
            H[j, :] = h
            steps += 1
            if float(vnorm1) == 0.0:
                break
        beta = b.new_zeros(restart + 1)
        beta[0] = rnorm
        # least squares min |H^T y - beta| through the normal equations
        HT = H.T
        L = torch.linalg.cholesky(HT.T @ HT)
        y = torch.cholesky_solve((HT.T @ beta)[:, None], L)[:, 0]
        x = x + V[:-1].T @ y
        unit, rnorm = _safe_normalize(M(b - A(x)))
        k += 1
    return x, steps


KRYLOV = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}


class NonlinearMaterialProblem:
    """Newton solver for residuals of the form

        R(u) = sum_qmaps sum_k ∫ field_k(u) · expr_k(u) dx  -  F_ext  = 0

    ``residual_terms``: per qmap, a list of (field_name, expr) or
    (field_name, expr, scale) entries; defaults to pairing each flux with its
    registered work-conjugate gradient expression. ``scale`` is a float or a
    0-arg callable evaluated at each assembly.

    Options: ``rtol``/``atol`` (dtype-aware defaults), ``max_it``,
    ``ksp_type`` ("cg", "bicgstab", "gmres" or "lu"), ``ksp_rtol``,
    ``ksp_maxiter``, ``ksp_precision`` ("same" or "f32"), ``pc_type``
    ("two_level" default, "block_jacobi", "jacobi"), ``pc_coarse_size``,
    ``predictor`` (secant load-step predictor), ``line_search``,
    ``max_backtracks``, ``verbose``.
    """

    def __init__(self, qmaps, u: Function, bcs=(), residual_terms=None,
                 external_force=None, options=None):
        self.qmaps = [qmaps] if isinstance(qmaps, QuadratureMap) else list(qmaps)
        self.u = u
        self.bcs = list(bcs)
        self.external_force = external_force
        self.device = self.qmaps[0].device
        self.dtype = self.qmaps[0].dtype
        o = dict(options or {})
        self.rtol = o.pop("rtol", None)
        self.atol = o.pop("atol", None)
        self.max_it = o.pop("max_it", 25)
        self.ksp_type = o.pop("ksp_type", "cg")
        self.ksp_rtol = o.pop("ksp_rtol", None)  # dtype-aware, resolved in solve
        self.ksp_maxiter = o.pop("ksp_maxiter", 2000)
        if self.ksp_type not in (*KRYLOV, "lu"):
            raise ValueError(f"ksp_type must be one of {[*KRYLOV, 'lu']}, got {self.ksp_type!r}")
        #: "f32": the Krylov solve of a float64 problem runs in float32 on the
        #: symmetrically diagonally scaled operator (every Krylov vector O(1));
        #: each correction is applied to the f64 iterate and the true f64
        #: residual measured again, so Newton still reaches the f64 tolerance
        self.ksp_precision = o.pop("ksp_precision", "same")
        if self.ksp_precision not in ("same", "f32"):
            raise ValueError(f"ksp_precision must be 'same' or 'f32', got {self.ksp_precision!r}")
        #: secant predictor: start Newton from the last committed solution
        #: extrapolated by the last committed increment
        self.predictor = o.pop("predictor", True)
        self._u_committed = None
        self._du_committed = None
        self.pc_type = o.pop("pc_type", "two_level")
        self.pc_coarse_size = o.pop("pc_coarse_size", 1024)
        self._agg = None
        self._coarse = None
        self.line_search = o.pop("line_search", True)
        self.max_backtracks = o.pop("max_backtracks", 12)
        self.verbose = o.pop("verbose", False)
        if o:
            raise TypeError(f"unknown options: {sorted(o)}")
        self.converged = False
        self.iterations = 0
        #: per-solve metrics: residual history, CG iterations, wall time
        self.metrics: dict = {}

        self._terms = []
        if residual_terms is None:
            residual_terms = [None] * len(self.qmaps)
        for qmap, terms in zip(self.qmaps, residual_terms):
            mat = qmap.material
            if terms is None:
                terms = [(f, qmap.gradient_exprs[g]) for f, g in zip(mat.flux_names, mat.gradient_names)]
            terms = [t if len(t) == 3 else (t[0], t[1], 1.0) for t in terms]
            field_names = [t[0] for t in terms]
            exprs = [t[1] for t in terms]
            tangent_structure, block_keys = [], []
            for k, y in enumerate(field_names):
                for (by, bx) in mat.tangent_blocks:
                    if by != y:
                        continue
                    x_expr = qmap.gradient_exprs.get(bx) or qmap.esv_exprs.get(bx)
                    if x_expr is None:
                        continue
                    tangent_structure.append((k, x_expr, None))
                    block_keys.append((k, by, bx))
            dom = qmap.domain
            self._terms.append(
                dict(
                    qmap=qmap,
                    field_names=field_names,
                    exprs=exprs,
                    scales=[t[2] for t in terms],
                    residual_fn=dom.make_residual(exprs),
                    Kel_fn=dom.make_element_matrices(exprs, tangent_structure),
                    block_keys=block_keys,
                )
            )

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------ core
    def _constitutive_update(self, u):
        for qmap in self.qmaps:
            qmap.update(u)

    def _constitutive_update_flux_only(self, u):
        for qmap in self.qmaps:
            qmap.update_flux_only(u)

    @staticmethod
    def _scale_value(s):
        return float(s()) if callable(s) else float(s)

    def _fields(self, t):
        return [
            self._scale_value(s) * t["qmap"].field_array(f)
            for f, s in zip(t["field_names"], t["scales"])
        ]

    def _residual(self, u):
        u = self._tensor(u)
        R = torch.zeros(self.u.space.num_dofs, dtype=self.dtype, device=self.device)
        for t in self._terms:
            R = R + t["residual_fn"](u, self._fields(t))
        if self.external_force is not None:
            F = self.external_force
            R = R - self._tensor(F(u) if callable(F) else F)
        return R

    def _element_matrices(self, u):
        out = []
        for t in self._terms:
            Cs = [
                self._scale_value(t["scales"][k]) * t["qmap"].tangent_block(y, x)
                for (k, y, x) in t["block_keys"]
            ]
            out.append(t["Kel_fn"](u, self._fields(t), Cs))
        return out

    def _node_aggregates(self):
        """Spatial node aggregation for the two-level preconditioner: node
        coordinates quantized into boxes sized so ~``pc_coarse_size`` coarse
        dofs result. Returns (agg ids (nnodes,), count, coarse dof of every
        dof (ndofs,), restriction gather map (ncoarse, max members) of dof
        indices padded with ``ndofs``): restriction and prolongation are 1-D
        gathers, with no atomic scatter."""
        if self._agg is not None:
            return self._agg
        coords = np.asarray(self.u.space.node_coords, dtype=np.float64)
        nnodes, dim = coords.shape
        lo = coords.min(axis=0)
        span = np.maximum(coords.max(axis=0) - lo, 1e-30)
        ncomp = max(1, self.u.space.num_dofs // nnodes)
        target = max(1, min(self.pc_coarse_size // ncomp, nnodes))
        boxes_per_dim = max(1, int(np.floor(target ** (1.0 / dim))))
        q = np.minimum((coords - lo) / span * boxes_per_dim, boxes_per_dim - 1).astype(np.int64)
        keys = q[:, 0]
        for d in range(1, dim):
            keys = keys * boxes_per_dim + q[:, d]
        _, agg = np.unique(keys, return_inverse=True)
        agg = agg.ravel()
        nagg = int(agg.max()) + 1
        coarse_dof = (agg[:, None] * ncomp + np.arange(ncomp)).ravel()
        gm = gather_map(coarse_dof, nagg * ncomp)
        dev = self.device
        self._agg = (
            nagg,
            torch.as_tensor(coarse_dof, device=dev),
            torch.as_tensor(gm, device=dev),
        )
        return self._agg

    def _coarse_plans(self, ncoarse):
        """Per term, the fixed-order sum that assembles the dense coarse
        operator from its element matrices (planned once): a repeatable
        coarse matrix, where an atomic scatter-add's order, and with it the
        CG counts, changed from run to run."""
        if self._coarse is None:
            _, coarse_dof, _ = self._node_aggregates()
            cd_np = coarse_dof.cpu().numpy()
            self._coarse = []
            for t in self._terms:
                cd = cd_np[t["qmap"].domain._dofmap_np]
                target = cd[:, :, None] * ncoarse + cd[:, None, :]
                self._coarse.append(plan_fixed_sum(target, ncoarse * ncoarse, device=self.device))
        return self._coarse

    def _preconditioner(self, Kels, mask):
        """``M(v)`` of ``pc_type`` for the element matrices ``Kels``, with bc
        rows as identity: the Jacobi diagonal, node-block Jacobi, or the
        additive two-level (Jacobi smoother + aggregate coarse solve); in
        the dtype of ``Kels``."""
        ndofs = self.u.space.num_dofs
        dtype, dev = Kels[0].dtype, self.device
        zero = torch.zeros((), dtype=dtype, device=dev)
        diag = torch.zeros(ndofs, dtype=dtype, device=dev)
        for t, K_e in zip(self._terms, Kels):
            diag = diag + t["qmap"].domain.matrix_diagonal(K_e, ndofs)
        diag = torch.where(mask | (diag.abs() < 1e-30), torch.ones_like(diag), diag)

        def M(v):
            return v / diag

        ncomp = self.u.space.ncomp
        if self.pc_type == "block_jacobi" and ncomp > 1:
            nnodes = self.u.space.num_nodes
            B = torch.zeros((nnodes, ncomp, ncomp), dtype=dtype, device=dev)
            for t, K_e in zip(self._terms, Kels):
                B = B + t["qmap"].domain.matrix_node_blocks(K_e, nnodes)
            eye = torch.eye(ncomp, dtype=dtype, device=dev)
            mn = mask.reshape(nnodes, ncomp)
            B = torch.where(mn[:, :, None] | mn[:, None, :], zero, B)
            B = B + mn.to(dtype)[:, :, None] * eye
            # singular-block guard: fall back to the scalar diagonal there
            detB = torch.linalg.det(B)
            dscale = torch.diagonal(B, dim1=1, dim2=2).abs().mean(dim=1)
            ok = detB.abs() > (1e-12 * dscale) ** ncomp
            Binv = torch.linalg.inv(torch.where(ok[:, None, None], B, eye[None]))
            dinv_blocks = (1.0 / diag).reshape(nnodes, ncomp)

            def M(v):  # noqa: F811 — block-Jacobi replaces the diagonal
                vb = v.reshape(nnodes, ncomp)
                xb = torch.einsum("nab,nb->na", Binv, vb)
                return torch.where(ok[:, None], xb, dinv_blocks * vb).reshape(-1)

        elif self.pc_type == "two_level":
            nagg, coarse_dof, gm = self._node_aggregates()
            ncoarse = nagg * ncomp
            # coarse operator Ac = P^T A P, P the piecewise-constant aggregate
            # prolongation, assembled from the element matrices (bc rows/cols
            # excluded), dense (ncoarse, ncoarse)
            notm = (~mask).to(dtype)
            Ac = torch.zeros(ncoarse * ncoarse, dtype=dtype, device=dev)
            for t, K_e, plan in zip(self._terms, Kels, self._coarse_plans(ncoarse)):
                w = notm[t["qmap"].domain.dofmap]
                Ac = Ac + fixed_sum((K_e * w[:, :, None] * w[:, None, :]).reshape(-1), plan)
            Ac = Ac.reshape(ncoarse, ncoarse)
            dAc = torch.diagonal(Ac)
            ridge = 1e-10 * dAc.abs().max() + 1e-30
            eye = torch.eye(ncoarse, dtype=dtype, device=dev)
            # empty/bc-only aggregates: unit diagonal keeps the factor regular
            Ac = Ac + ridge * eye + (dAc.abs() < ridge).to(dtype) * eye
            # explicit inverse: one matrix-vector product per apply, where an
            # LU solve runs two sequential triangular solves on the card
            Ac_inv = torch.linalg.inv(Ac)

            def M(v):  # noqa: F811 — additive two-level: smoother + coarse
                v0 = torch.where(mask, zero, v)
                vpad = torch.cat([v0, v0.new_zeros(1)])
                rc = vpad.index_select(0, gm.reshape(-1)).reshape(gm.shape).sum(dim=1)
                wc = Ac_inv @ rc
                out = v0 / diag + wc.index_select(0, coarse_dof)
                return torch.where(mask, v, out)

        return M

    def _cg_system(self, Kels, rhs, mask):
        """``(A, b, M)`` for a Krylov solve of J du = rhs with bc rows/cols
        as identity: the matrix-free operator, the right-hand side and the
        preconditioner, in the dtype of ``Kels``."""
        zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
        Kprep = [t["qmap"].domain.spmv_prepare(K_e) for t, K_e in zip(self._terms, Kels)]

        def Av(v):
            v0 = torch.where(mask, zero, v)
            y = torch.zeros_like(v)
            for t, K_p in zip(self._terms, Kprep):
                y = y + t["qmap"].domain.spmv(K_p, v0)
            return torch.where(mask, v, y)

        return Av, torch.where(mask, zero, rhs), self._preconditioner(Kels, mask)

    def _linear_solve(self, Kels, rhs, mask):
        """Solve J du = rhs with bc rows/cols as identity (du[bc] = 0).

        With ``ksp_precision="f32"`` on an f64 problem the Krylov solve runs
        in float32 on the symmetrically scaled system
        (S K S)(S^-1 du) = S rhs, S = diag(1/sqrt(|diag K|)), and the result
        comes back in f64; the direct ("lu") path stays in the problem dtype.
        Returns ``(du, Krylov iterations)``."""
        if not (self.ksp_precision == "f32" and self.ksp_type != "lu" and rhs.dtype == torch.float64):
            return self._linear_solve_core(Kels, rhs, mask)
        diag = torch.zeros_like(rhs)
        for t, K_e in zip(self._terms, Kels):
            diag = diag + t["qmap"].domain.matrix_diagonal(K_e, rhs.shape[0])
        diag = torch.where(mask | (diag.abs() < 1e-30), torch.ones_like(diag), diag.abs())
        s = torch.rsqrt(diag)
        Kels_s = []
        for t, K_e in zip(self._terms, Kels):
            s_e = s[t["qmap"].domain.dofmap]
            Kels_s.append((K_e * s_e[:, :, None] * s_e[:, None, :]).to(torch.float32))
        # the f64 default ksp_rtol (1e-12) is out of f32's reach: clamp it to
        # just above the f32 Krylov floor; Newton recovers the f64 accuracy
        du_s, its = self._linear_solve_core(
            Kels_s, (rhs * s).to(torch.float32), mask, tol=max(self.ksp_rtol or 0.0, 1e-6)
        )
        return du_s.to(rhs.dtype) * s, its

    def _linear_solve_core(self, Kels, rhs, mask, tol=None):
        tol = self.ksp_rtol if tol is None else tol
        zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)

        if self.ksp_type == "lu":
            import scipy.sparse.linalg as spla

            ndofs = rhs.shape[0]
            A = None
            for t, K_e in zip(self._terms, Kels):
                Ai = t["qmap"].domain.to_scipy_csr(K_e, ndofs)
                A = Ai if A is None else A + Ai
            A = A.tolil()
            bc_idx = np.nonzero(mask.cpu().numpy())[0]
            A[bc_idx, :] = 0.0
            A[:, bc_idx] = 0.0
            A[bc_idx, bc_idx] = 1.0
            b = torch.where(mask, zero, rhs).cpu().numpy()
            return self._tensor(spla.spsolve(A.tocsr(), b)), 0

        Av, b, M = self._cg_system(Kels, rhs, mask)
        du, its = KRYLOV[self.ksp_type](Av, b, tol, self.ksp_maxiter, M)
        # Krylov quality guard: a (near-)singular tangent can make the solve
        # return garbage; fall back to a preconditioned gradient step then
        lin_res = torch.linalg.norm(Av(du) - b)
        bad = ~torch.isfinite(lin_res) | (lin_res > 0.9 * torch.linalg.norm(b))
        return torch.where(bad, M(b), du), its

    # ----------------------------------------------------------------- solve
    def solve(self, commit: bool = True):
        """Newton iterations; returns ``(converged, iterations)``.

        ``commit=False`` skips ``advance()`` on convergence."""
        ndofs = self.u.space.num_dofs
        mask_np, bc_vals = combine_bcs(self.bcs, ndofs)
        mask = torch.as_tensor(mask_np, device=self.device)
        u_np = np.asarray(self.u.x)
        if (
            self.predictor
            and commit
            and self._du_committed is not None
            and np.array_equal(u_np, self._u_committed)
        ):
            # secant predictor: extrapolate by the last committed increment
            u_np = self._u_committed + self._du_committed
        u = torch.where(mask, self._tensor(bc_vals), self._tensor(u_np))
        eps_dtype = float(torch.finfo(self.dtype).eps)
        f64 = eps_dtype < 1e-9
        rtol = self.rtol if self.rtol is not None else (1e-10 if f64 else 50.0 * eps_dtype)
        atol = self.atol if self.atol is not None else (1e-10 if f64 else 0.0)
        if self.ksp_rtol is None:
            self.ksp_rtol = 1e-12 if f64 else 1e-7
        zero = torch.zeros((), dtype=self.dtype, device=self.device)

        def rnorm(R):
            return float(torch.linalg.norm(torch.where(mask, zero, R)))

        norm0 = None
        self.converged = False
        t_start = time.perf_counter()
        res_history, cg_iters = [], []
        with timer("solver: Newton solve", block_on=self.device):
            for it in range(self.max_it):
                with timer("solver: constitutive update", block_on=self.device):
                    self._constitutive_update(u)
                R = self._residual(u)
                norm = rnorm(R)
                if not np.isfinite(norm):
                    if self.verbose:
                        print("  non-finite residual; aborting Newton")
                    break
                res_history.append(norm)
                if norm0 is None:
                    norm0 = norm if norm > 0 else 1.0
                if self.verbose:
                    print(f"  Newton it {it}: |R| = {norm:.6e}")
                if norm < atol or norm < rtol * norm0:
                    self.converged = True
                    self.iterations = it
                    break
                with timer("solver: jacobian assembly", block_on=self.device):
                    Kels = self._element_matrices(u)
                with timer("solver: linear solve", block_on=self.device):
                    du, its = self._linear_solve(Kels, -R, mask)
                cg_iters.append(its)
                if not self.line_search:
                    u = u + du
                    continue
                # backtracking on the residual norm with flux-only trials
                alpha = 1.0
                best_alpha, best_n = None, np.inf
                for _ in range(self.max_backtracks):
                    u_try = u + alpha * du
                    self._constitutive_update_flux_only(u_try)
                    n_try = rnorm(self._residual(u_try))
                    if np.isfinite(n_try) and n_try < best_n:
                        best_alpha, best_n = alpha, n_try
                    if np.isfinite(n_try) and n_try < (1 - 1e-4 * alpha) * norm:
                        break
                    alpha *= 0.5
                if best_alpha is None or best_n >= norm:
                    # restore s1 to the kept u before any exit that commits
                    self._constitutive_update_flux_only(u)
                    self.iterations = it
                    # stagnation at the dtype's noise floor is convergence
                    if norm < np.sqrt(eps_dtype) * norm0:
                        self.converged = True
                        if self.verbose:
                            print(f"  converged at the dtype noise floor (|R|/|R0| = {norm / norm0:.2e})")
                        break
                    if self.verbose:
                        print("  line search stagnated; aborting Newton")
                    break
                u = u + best_alpha * du
                # align s1 with the accepted trial
                if best_n != n_try:
                    self._constitutive_update_flux_only(u)

        self.u.x = u.cpu().numpy().copy()
        self.metrics = {
            "converged": self.converged,
            "newton_iterations": self.iterations,
            "cg_iterations": cg_iters,
            "residual_history": res_history,
            "wall_time_s": time.perf_counter() - t_start,
            "gauss_points": sum(q.num_points for q in self.qmaps),
        }
        if self.converged and commit:
            if self._u_committed is not None:
                self._du_committed = self.u.x - self._u_committed
            self._u_committed = self.u.x.copy()
            for qmap in self.qmaps:
                qmap.advance()
        return self.converged, self.iterations


def solve_adaptive(problem, set_load, t_end, nsteps0=10, max_cutbacks=10, growth=1.5):
    """Load stepping with automatic cutback: on Newton failure restore the last
    converged solution, revert the trial state, halve the step and retry;
    grow the step again after successes. ``set_load(t)`` applies the load
    parameter t in [0, t_end]. Returns the list of accepted t values."""
    t, dt_step = 0.0, t_end / nsteps0
    accepted = []
    cutbacks = 0
    u_backup = problem.u.x.copy()
    while t < t_end - 1e-12 * t_end:
        t_try = min(t + dt_step, t_end)
        set_load(t_try)
        converged, _ = problem.solve()
        if converged:
            t = t_try
            accepted.append(t)
            u_backup = problem.u.x.copy()
            cutbacks = 0
            dt_step = min(dt_step * growth, t_end - t + 1e-30)
        else:
            problem.u.x = u_backup.copy()
            for qmap in problem.qmaps:
                qmap.revert()
            # the stored secant increment no longer matches the new step
            problem._du_committed = None
            dt_step *= 0.5
            cutbacks += 1
            if cutbacks > max_cutbacks:
                raise RuntimeError(
                    f"load stepping failed at t={t_try:.4g} after {max_cutbacks} cutbacks"
                )
    return accepted
