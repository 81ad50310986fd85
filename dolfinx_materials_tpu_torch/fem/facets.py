"""Boundary facet integrals: Neumann (traction) and body loads.

Host-side numpy, as the loads are assembled once per problem: boundary
facets are the facets whose sorted vertex key appears once across all cells;
a load vector is one batched product over the selected facets, on the
straight facet chords or, on curved meshes (``geom_degree`` 2), on the
degree-2 trace of the isoparametric geometry. The facet node and geometry-node
ids follow the JAX package's fem/facets.py, so the two packages assemble the
same vectors.
"""

from __future__ import annotations

import numpy as np

from .element import FACETS, ReferenceElement
from .space import FunctionSpace


def boundary_facets(mesh):
    """All boundary facets as (facet_verts (nf, nfv) int32, cell_ids (nf,)).

    A facet is on the boundary iff its sorted-vertex key appears once across all
    cells (host-side topology pass, the DOLFINx C++ connectivity role).
    """
    lf = np.array(FACETS[mesh.cell_type])  # (nlf, nfv)
    fv = mesh.cells[:, lf]  # (ncells, nlf, nfv)
    ncells, nlf, nfv = fv.shape
    flat = fv.reshape(-1, nfv)
    keys = np.sort(flat, axis=1)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    on_boundary = counts[inv] == 1
    cell_ids = np.repeat(np.arange(ncells, dtype=np.int32), nlf)[on_boundary]
    return flat[on_boundary].astype(np.int32), cell_ids


def _facet_cell_type(mesh):
    return {"triangle": "interval", "quad": "interval",
            "tetrahedron": "triangle", "hexahedron": "quad"}[mesh.cell_type]


def _facet_nodes(space: FunctionSpace, facet_verts):
    """Global node ids of all space nodes on each facet, ordered to match the
    facet reference element (vertices first, then edge midpoints). Ids are
    assembled in the CANONICAL layout (vertices, nv+edge, face/center) and
    mapped through ``space.node_renum`` at the end when the space was
    spatially renumbered (fem/space.py:_renumber_nodes)."""

    def renum(ids):
        return ids if space.node_renum is None else space.node_renum[ids]

    mesh = space.mesh
    if space.degree == 1:
        return facet_verts
    # degree 2: append midpoint nodes of every facet edge
    nv = mesh.num_vertices
    edge_verts = space._edge_verts
    lookup = {tuple(sorted(e)): i for i, e in enumerate(edge_verts.tolist())}
    fct = _facet_cell_type(mesh)
    if fct == "interval":
        edges_of_facet = [(0, 1)]
    elif fct == "triangle":
        edges_of_facet = [(0, 1), (1, 2), (2, 0)]
    else:
        edges_of_facet = [(0, 1), (1, 2), (2, 3), (3, 0)]
    mids = np.array(
        [
            [
                nv + lookup[tuple(sorted((fvs[a], fvs[b])))]
                for (a, b) in edges_of_facet
            ]
            for fvs in facet_verts.tolist()
        ],
        dtype=np.int32,
    )
    if fct == "interval":
        # interval P2 node order: v0, v1, midpoint
        return renum(np.concatenate([facet_verts, mids], axis=1))
    if fct == "triangle":
        return renum(np.concatenate([facet_verts, mids], axis=1))
    # quad facet of a Q2 hexahedron: verts, edge mids, face-center node
    # (matches ReferenceElement("quad", 2) ordering: 4 verts, 4 mids, center)
    face_lookup = {
        tuple(fv): i for i, fv in enumerate(np.sort(space._face_verts, axis=1).tolist())
    }
    centers = np.array(
        [
            [space._face_node_offset + face_lookup[tuple(sorted(fvs))]]
            for fvs in facet_verts.tolist()
        ],
        dtype=np.int32,
    )
    return renum(np.concatenate([facet_verts, mids, centers], axis=1))


def _facet_geom_nodes(mesh, facet_verts, fct):
    """Geometry-node ids (into ``mesh.geom_points``) of each facet for degree-2
    isoparametric meshes: vertices, facet-edge midpoints, and (quad facets)
    the face-center node — matching the ReferenceElement(fct, 2) node order.
    The geom layout comes from ``curve_mesh`` = the degree-2 FunctionSpace of
    the straight mesh (fem/space.py): mids at nv + edge_id, hex face centers
    at nv + nedges + face_id."""
    nv = mesh.num_vertices
    edge_verts, _ = mesh.edges()
    elookup = {tuple(sorted(e)): i for i, e in enumerate(edge_verts.tolist())}
    if fct == "interval":
        edges_of_facet = [(0, 1)]
    elif fct == "triangle":
        edges_of_facet = [(0, 1), (1, 2), (2, 0)]
    else:
        edges_of_facet = [(0, 1), (1, 2), (2, 3), (3, 0)]
    mids = np.array(
        [
            [nv + elookup[tuple(sorted((f[a], f[b])))] for (a, b) in edges_of_facet]
            for f in facet_verts.tolist()
        ],
        dtype=np.int32,
    )
    if fct != "quad":
        return np.concatenate([facet_verts, mids], axis=1)
    face_verts, _ = mesh.faces()
    flookup = {
        tuple(fv): i for i, fv in enumerate(np.sort(face_verts, axis=1).tolist())
    }
    ne = len(edge_verts)
    centers = np.array(
        [[nv + ne + flookup[tuple(sorted(f))]] for f in facet_verts.tolist()],
        dtype=np.int32,
    )
    return np.concatenate([facet_verts, mids, centers], axis=1)


def assemble_traction(space: FunctionSpace, where, value, quad_degree=4):
    """Assemble the surface-load vector F_i = ∫_{Γ} t · v_i ds over the boundary
    facets whose MIDPOINT satisfies ``where(coords (nf, dim)) -> bool``.

    ``value``: constant (ncomp,) vector or callable ``x (m, dim) -> (m, ncomp)``.
    Returns a numpy (ndofs,) vector for ``NonlinearMaterialProblem.external_force``.
    """
    mesh = space.mesh
    fverts, _ = boundary_facets(mesh)
    mids = mesh.points[fverts].mean(axis=1)
    sel = np.asarray(where(mids)).astype(bool)
    fverts = fverts[sel]
    if len(fverts) == 0:
        raise ValueError("no boundary facets selected")

    fct = _facet_cell_type(mesh)
    # facet geometry: P1 chords on straight meshes, the degree-2 trace of the
    # isoparametric geometry on curved meshes (mesh.geom_degree == 2) — keeps
    # surface loads consistent with the curved volume integration
    geo = ReferenceElement(fct, mesh.geom_degree, quad_degree)
    elem = ReferenceElement(fct, space.degree, quad_degree)

    if mesh.geom_degree == 2:
        coords = mesh.geom_points[_facet_geom_nodes(mesh, fverts, fct)]
    else:
        coords = mesh.points[fverts]  # (nf, nfv, dim)
    # facet Jacobian dx/dxi: (nf, nq, dim, dimf); area element = sqrt(det(J^T J))
    J = np.einsum("fvi,qvj->fqij", coords, geo.dN)
    G = np.einsum("fqij,fqik->fqjk", J, J)
    detA = np.sqrt(np.linalg.det(G))  # (nf, nq)
    w = elem.qweights[None, :] * detA
    x_q = np.einsum("qv,fvi->fqi", geo.N, coords)  # (nf, nq, dim)

    ncomp = space.ncomp
    if callable(value):
        t_q = np.asarray(value(x_q.reshape(-1, mesh.dim))).reshape(
            len(fverts), elem.nq, ncomp
        )
    else:
        t_q = np.broadcast_to(
            np.asarray(value, dtype=float).reshape(1, 1, ncomp),
            (len(fverts), elem.nq, ncomp),
        )

    # F contribution: sum_q w * N_i(q) * t_c(q) on node (i), comp (c)
    contrib = np.einsum("fq,qv,fqc->fvc", w, elem.N, t_q)
    nodes = _facet_nodes(space, fverts)  # (nf, nloc_f)
    dofs = nodes[:, :, None] * ncomp + np.arange(ncomp)[None, None, :]
    F = np.zeros(space.num_dofs)
    np.add.at(F, dofs.ravel(), contrib.ravel())
    return F


def assemble_body_force(space: FunctionSpace, value, quad_degree=4, cells=None):
    """Assemble the body-load vector ∫ f · v dx (constant or callable f)."""
    from .assembly import QuadratureDomain

    dom = QuadratureDomain(space, quad_degree, cells, device="cpu")  # float64
    ncomp = space.ncomp
    x_q = dom.x_q.numpy()
    if callable(value):
        f_q = np.asarray(value(x_q.reshape(-1, space.mesh.dim))).reshape(
            dom.ne, dom.nq, ncomp
        )
    else:
        f_q = np.broadcast_to(
            np.asarray(value, dtype=float).reshape(1, 1, ncomp),
            (dom.ne, dom.nq, ncomp),
        )
    contrib = np.einsum("eq,qv,eqc->evc", dom.wdetJ.numpy(), dom.N.numpy(), f_q)
    nodes = space.cell_nodes[dom.cells]
    dofs = nodes[:, :, None] * ncomp + np.arange(ncomp)[None, None, :]
    F = np.zeros(space.num_dofs)
    np.add.at(F, dofs.ravel(), contrib.ravel())
    return F
