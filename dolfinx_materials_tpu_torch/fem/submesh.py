"""Submeshes and interface-law integrals for multi-material problems.

Counterpart of dolfinx_materials_tpu/fem/submesh.py: two displacement fields
on two cell-subset submeshes (dofs duplicated along the shared interface),
joined by an interface law

    R_interface(v) = ∫_Γ  t([[u]]) · [[v]]  dS,      [[u]] = u2 - u1,

with ``t`` any traction-separation law written in torch; its tangent
D = dt/d[[u]] comes from ``torch.func.jacfwd``, so the blocked Newton stays
consistent for nonlinear laws.

The interface is tabulated on the host once (numpy tables equal to the JAX
package's); the tensors are made on the device and in the dtype of the fields
they meet, once per (device, dtype). The residual scatters sum in a fixed
order through a :func:`~..ops.banded_gather.plan_fixed_sum` plan per side
(the CSR take kernel on the card, no atomics).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..ops.banded_gather import fixed_sum, plan_fixed_sum
from .element import FACETS, ReferenceElement
from .facets import _facet_cell_type, _facet_nodes
from .mesh import Mesh
from .space import FunctionSpace


def extract_submesh(mesh: Mesh, cells):
    """The submesh of a cell subset with its own (renumbered) vertices.

    Returns ``(submesh, vertex_map)`` with ``vertex_map[i_sub] = i_parent``.
    Vertices shared by two submeshes are duplicated across them: each
    submesh field carries its own dofs.
    """
    cells = np.asarray(cells, dtype=np.int32)
    sub_cells_parent = mesh.cells[cells]  # (ne_sub, nverts), parent ids
    vertex_map, inverse = np.unique(sub_cells_parent, return_inverse=True)
    sub_cells = inverse.reshape(sub_cells_parent.shape).astype(np.int32)
    sub = Mesh(mesh.points[vertex_map], sub_cells, mesh.cell_type)
    return sub, vertex_map.astype(np.int32)


def interface_facets(mesh: Mesh, cells1, cells2):
    """Facets shared by one cell of ``cells1`` and one of ``cells2``, as
    ``facet_verts (nf, nfv)`` in parent vertex ids."""
    lf = np.array(FACETS[mesh.cell_type])  # (nlf, nfv)
    fv = mesh.cells[:, lf]  # (ncells, nlf, nfv)
    ncells, nlf, nfv = fv.shape
    flat = fv.reshape(-1, nfv)
    keys = np.sort(flat, axis=1)
    uniq, first_occurrence, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    owner_cell = np.repeat(np.arange(ncells), nlf)
    in1 = np.zeros(ncells, bool)
    in1[np.asarray(cells1, dtype=np.int64)] = True
    in2 = np.zeros(ncells, bool)
    in2[np.asarray(cells2, dtype=np.int64)] = True
    side1 = np.bincount(inv, weights=in1[owner_cell], minlength=len(uniq)) > 0
    side2 = np.bincount(inv, weights=in2[owner_cell], minlength=len(uniq)) > 0
    return flat[first_occurrence[side1 & side2]].astype(np.int32)


class InterfaceDomain:
    """Tabulated interface quadrature joining two fields across facing
    submeshes.

    ``space1``/``space2`` live on submeshes extracted from the same parent
    mesh; ``facet_verts_parent`` are interface facets in parent vertex ids;
    ``vmap1``/``vmap2`` the submesh -> parent vertex maps of
    :func:`extract_submesh`. The fields must share ``ncomp``.

    Host tables (numpy): ``w`` (nf, nq) weighted area elements, ``x_q`` (nf,
    nq, dim), ``N`` (nq, nloc_f), ``dofs1``/``dofs2`` (nf, nloc_f, ncomp).
    """

    def __init__(self, space1: FunctionSpace, space2: FunctionSpace, facet_verts_parent, vmap1, vmap2,
                 quad_degree=4):
        if space1.ncomp != space2.ncomp:
            raise ValueError("interface fields must match ncomp")
        self.space1, self.space2 = space1, space2
        self.ncomp = space1.ncomp
        fvp = np.asarray(facet_verts_parent, dtype=np.int32)
        self.num_facets = len(fvp)

        def inv_map(vmap, npar):
            m = np.full(npar, -1, np.int32)
            m[vmap] = np.arange(len(vmap), dtype=np.int32)
            return m

        npar = int(max(vmap1.max(), vmap2.max())) + 1
        fv1, fv2 = inv_map(vmap1, npar)[fvp], inv_map(vmap2, npar)[fvp]
        if not ((fv1 >= 0).all() and (fv2 >= 0).all()):
            raise ValueError("interface facet has vertices missing from a submesh")
        # the two submeshes must coincide along the interface (side 1's
        # geometry carries the quadrature): a mismatched pair would couple
        # wrong locations silently
        c1 = space1.mesh.points[fv1]
        c2 = space2.mesh.points[fv2]
        scale = max(1.0, float(np.abs(c1).max()))
        if not np.allclose(c1, c2, atol=1e-10 * scale):
            raise ValueError(
                "interface submeshes are not conforming: side-2 facet coordinates deviate from "
                f"side 1 by up to {np.abs(c1 - c2).max():.3e}"
            )

        fct = _facet_cell_type(space1.mesh)
        geo = ReferenceElement(fct, 1, quad_degree)
        elem = ReferenceElement(fct, space1.degree, quad_degree)
        self.nq, self.nloc_f = elem.nq, elem.N.shape[1]
        J = np.einsum("fvi,qvj->fqij", c1, geo.dN)
        G = np.einsum("fqij,fqik->fqjk", J, J)
        self.w = elem.qweights[None, :] * np.sqrt(np.linalg.det(G))
        self.x_q = np.einsum("qv,fvi->fqi", geo.N, c1)
        self.N = np.asarray(elem.N)  # (nq, nloc_f)
        comp = np.arange(self.ncomp)[None, None, :]
        self.dofs1 = _facet_nodes(space1, fv1)[:, :, None] * self.ncomp + comp  # (nf, nloc_f, nc)
        self.dofs2 = _facet_nodes(space2, fv2)[:, :, None] * self.ncomp + comp
        self._tensors = {}

    def tensors(self, device, dtype):
        """``dict(w, N, dofs1, dofs2, plan1, plan2)`` on ``device`` in
        ``dtype`` (made once): the tables, the facet dof ids (nf, nloc_f *
        ncomp) and the fixed-order sums of each side's facet values into
        its field's dofs."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (device, dtype)
        t = self._tensors.get(key)
        if t is None:
            d1 = self.dofs1.reshape(self.num_facets, -1)
            d2 = self.dofs2.reshape(self.num_facets, -1)
            t = self._tensors[key] = dict(
                w=torch.as_tensor(self.w, dtype=dtype, device=device),
                N=torch.as_tensor(self.N, dtype=dtype, device=device),
                dofs1=torch.as_tensor(d1, dtype=torch.int64, device=device),
                dofs2=torch.as_tensor(d2, dtype=torch.int64, device=device),
                plan1=plan_fixed_sum(d1, self.space1.num_dofs, device=device),
                plan2=plan_fixed_sum(d2, self.space2.num_dofs, device=device),
            )
        return t

    # ------------------------------------------------------------------ eval
    @staticmethod
    def _field(u):
        return u if torch.is_tensor(u) else torch.as_tensor(np.asarray(u), dtype=torch.float64)

    def _u_q(self, t, u, dofs):
        u_n = u[dofs].reshape(self.num_facets, self.nloc_f, self.ncomp)
        return torch.einsum("qv,fvc->fqc", t["N"], u_n)

    def jump(self, u1, u2):
        """[[u]] = u2 - u1 at the interface quadrature points, (nf, nq, nc),
        on the fields' device (numpy fields: float64 on the CPU)."""
        u1, u2 = self._field(u1), self._field(u2)
        t = self.tensors(u1.device, u1.dtype)
        return self._u_q(t, u2, t["dofs2"]) - self._u_q(t, u1, t["dofs1"])


class InterfaceTerm:
    """An interface law between fields ``i`` and ``j`` of a blocked problem.

    ``traction``: a torch function ``jump (ncomp,) -> traction (ncomp,)``
    (it may close over parameters); its tangent comes from ``jacfwd``.
    Residual contributions:

        R_i -= ∫ t([[u]]) · N_i dS,    R_j += ∫ t([[u]]) · N_j dS.
    """

    def __init__(self, i: int, j: int, domain: InterfaceDomain, traction):
        self.i, self.j = i, j
        self.domain = domain
        self.traction = traction
        self._t_batch = vmap(vmap(traction))  # (nf, nq, nc) -> (nf, nq, nc)
        self._D_batch = vmap(vmap(jacfwd(traction)))  # -> (nf, nq, nc, nc)

    def residuals(self, u_i, u_j, ndofs_i, ndofs_j):
        """``(r_i (ndofs_i,), r_j (ndofs_j,))``, each summed in a fixed
        order."""
        d = self.domain
        t = d.tensors(u_i.device, u_i.dtype)
        t_q = self._t_batch(d.jump(u_i, u_j))
        contrib = torch.einsum("qv,fqc->fvc", t["N"], t["w"][:, :, None] * t_q).reshape(-1)
        return -fixed_sum(contrib, t["plan1"]), fixed_sum(contrib, t["plan2"])

    def base_matrix(self, u_i, u_j):
        """B[f, (v, c), (w, e)] = sum_q w N_v N_w D[c, e], (nf, k, k) with
        k = nloc_f * nc: the block every coupling block is +-."""
        d = self.domain
        t = d.tensors(u_i.device, u_i.dtype)
        D = self._D_batch(d.jump(u_i, u_j))  # (nf, nq, nc, nc)
        base = torch.einsum("fq,qv,qw,fqce->fvcwe", t["w"], t["N"], t["N"], D)
        k = d.nloc_f * d.ncomp
        return base.reshape(d.num_facets, k, k)

    def matrices(self, u_i, u_j):
        """Facet coupling blocks ``K_ii, K_ij, K_ji, K_jj``, each (nf, k, k),
        relating side-x test dofs to side-y trial dofs (signs included:
        d(R)/d(u))."""
        base = self.base_matrix(u_i, u_j)
        # R_i gets -t, R_j gets +t; the jump depends on -u_i and +u_j
        return base, -base, -base, base

    def scatter_dofs(self):
        """Facet dof ids of each side, two numpy (nf, nloc_f * nc) arrays."""
        d = self.domain
        return d.dofs1.reshape(d.num_facets, -1), d.dofs2.reshape(d.num_facets, -1)


def elastic_interface(K):
    """Linear elastic interface law t = K [[u]]; ``K`` a scalar stiffness
    or (ncomp,) per-component stiffnesses. The stiffness takes the jump's
    dtype and device."""

    def traction(jump):
        return torch.as_tensor(K, dtype=jump.dtype, device=jump.device) * jump

    return traction
