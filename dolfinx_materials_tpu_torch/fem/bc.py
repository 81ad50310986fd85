"""Dirichlet boundary conditions by dof elimination.

BCs are (dof indices, values); the solvers enforce them by masking —
residual rows zeroed, operator rows/cols replaced by identity.
"""

from __future__ import annotations

import numpy as np

from .space import FunctionSpace


def locate_dofs_geometrical(space: FunctionSpace, predicate, component=None):
    """Dofs whose node coordinates satisfy ``predicate(coords) -> bool (n,)``;
    ``component`` restricts to one vector component."""
    nodes = np.nonzero(np.asarray(predicate(space.node_coords)))[0]
    if component is None:
        comps = np.arange(space.ncomp)
        return (nodes[:, None] * space.ncomp + comps[None, :]).ravel()
    return nodes * space.ncomp + component


class DirichletBC:
    def __init__(self, dofs, value=0.0):
        self.dofs = np.asarray(dofs, dtype=np.int32)
        self.value = value

    def values(self):
        v = np.asarray(self.value, dtype=np.float64)
        if v.ndim == 0:
            return np.full(len(self.dofs), float(v))
        return np.broadcast_to(v, (len(self.dofs),))

    def set(self, value):
        """Update the prescribed value (load stepping)."""
        self.value = value


def combine_bcs(bcs, ndofs):
    """Merge BCs into (mask (ndofs,) bool, values (ndofs,)). Later BCs win."""
    mask = np.zeros(ndofs, dtype=bool)
    vals = np.zeros(ndofs)
    for bc in bcs:
        mask[bc.dofs] = True
        vals[bc.dofs] = bc.values()
    return mask, vals
