"""Function spaces and Functions (dofmaps built on the host).

Blocked dof layout: ``dof = node * ncomp + comp``. Degree-2 spaces get their
edge/face/center nodes interleaved among the vertices they sit between
(:meth:`FunctionSpace._renumber_nodes`), which keeps every element's dofs in
a narrow band — what the banded gather engine's windows need.
"""

from __future__ import annotations

import numpy as np
import torch

from .element import _shape_functions
from .mesh import Mesh


def _elem_span_p99(cells):
    span = cells.max(axis=1) - cells.min(axis=1)
    return float(np.percentile(span, 99))


class FunctionSpace:
    def __init__(self, mesh: Mesh, degree: int = 1, shape: tuple = (), renumber=True):
        self.mesh = mesh
        self.degree = degree
        self.shape = tuple(shape)
        self.ncomp = int(np.prod(self.shape)) if self.shape else 1
        #: old node id -> new node id when the P2 node set was renumbered
        self.node_renum = None

        cell = mesh.cell_type
        if degree == 1:
            self.node_coords = mesh.points
            self.cell_nodes = mesh.cells
        elif degree == 2:
            edge_verts, cell_edges = mesh.edges()
            self._edge_verts = edge_verts
            parts = [mesh.points, mesh.points[edge_verts].mean(axis=1)]
            nv, ne = mesh.num_vertices, len(edge_verts)
            cn = [mesh.cells, nv + cell_edges]
            if cell == "quad":
                parts.append(mesh.points[mesh.cells].mean(axis=1))
                cn.append(nv + ne + np.arange(mesh.num_cells, dtype=np.int32)[:, None])
            elif cell == "hexahedron":
                # face-center nodes in [z0, z1, y0, y1, x0, x1] order =
                # FACETS indices [0, 1, 2, 4, 5, 3]
                face_verts, cell_faces = mesh.faces()
                self._face_verts = face_verts
                self._face_node_offset = nv + ne  # canonical id of face 0's node
                parts.append(mesh.points[face_verts].mean(axis=1))
                cn.append(nv + ne + cell_faces[:, [0, 1, 2, 4, 5, 3]])
                parts.append(mesh.points[mesh.cells].mean(axis=1))
                cn.append(
                    nv + ne + len(face_verts)
                    + np.arange(mesh.num_cells, dtype=np.int32)[:, None]
                )
            self.node_coords = np.vstack(parts)
            self.cell_nodes = np.hstack(cn).astype(np.int32)
            if mesh.geom_degree == 2:
                # isoparametric: the nodes sit at the curved geometry nodes
                # (the same canonical layout, fem/mesh.py curve_mesh)
                assert mesh.geom_points.shape == self.node_coords.shape
                self.node_coords = mesh.geom_points
            if renumber:
                self._renumber_nodes()
        else:
            raise NotImplementedError(f"degree {degree}")

        _, ref_nodes = _shape_functions(cell, degree)
        assert self.cell_nodes.shape[1] == len(ref_nodes)

        self.num_nodes = len(self.node_coords)
        self.num_dofs = self.num_nodes * self.ncomp
        nloc = self.cell_nodes.shape[1]
        dm = self.cell_nodes[:, :, None] * self.ncomp + np.arange(self.ncomp)[None, None, :]
        self.dofmap = dm.reshape(mesh.num_cells, nloc * self.ncomp).astype(np.int32)
        self.nloc = nloc

    def _renumber_nodes(self):
        """Sort every node by the mean vertex id it interpolates, so edge,
        face and center nodes sit among their vertices; kept only if it
        beats the canonical order on p99 element node span."""
        mesh = self.mesh
        cn = self.cell_nodes
        nn = len(self.node_coords)
        keys = [np.arange(mesh.num_vertices, dtype=np.float64), self._edge_verts.mean(axis=1)]
        if mesh.cell_type == "quad":
            keys.append(mesh.cells.mean(axis=1))
        elif mesh.cell_type == "hexahedron":
            keys.append(self._face_verts.mean(axis=1))
            keys.append(mesh.cells.mean(axis=1))
        key = np.concatenate(keys)
        assert len(key) == nn
        perm = np.argsort(key, kind="stable")  # old ids in new order
        inv = np.empty(nn, np.int64)
        inv[perm] = np.arange(nn)
        if _elem_span_p99(inv[cn]) < _elem_span_p99(cn):
            self.node_coords = self.node_coords[perm]
            self.cell_nodes = inv[cn].astype(np.int32)
            self.node_renum = inv.astype(np.int32)

    def dof_coords(self):
        """Coordinates of every dof (repeated per component), (ndofs, dim)."""
        return np.repeat(self.node_coords, self.ncomp, axis=0)

    def component_dofs(self, comp: int):
        """All global dofs of one vector component."""
        return np.arange(self.num_nodes) * self.ncomp + comp


class Function:
    """A dof vector bound to a space. ``x`` is a host numpy array of the
    Function's dtype; the solvers move it to the device as needed."""

    def __init__(self, space: FunctionSpace, name: str | None = None, dtype=torch.float64):
        self.space = space
        self.name = name or "f"
        self.dtype = dtype
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.x = np.zeros(space.num_dofs, dtype=self._np_dtype)

    def interpolate(self, fn):
        """Set the dofs from ``fn: node coords (n, dim) -> values (n,) or (n,
        ncomp)``."""
        vals = np.asarray(fn(self.space.node_coords))
        self.x = vals.reshape(self.space.num_dofs).astype(self._np_dtype).copy()
        return self

    def copy(self):
        g = Function(self.space, self.name, self.dtype)
        g.x = self.x.copy()
        return g
