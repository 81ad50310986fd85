"""Peaks of the card and the work of the timed kernels, counted from shapes.

The peaks are the NVIDIA H100 SXM data sheet's (dense rates, 700 W); a card
set to a lower ``power.limit`` runs below them, so every share is printed
beside the card's power limit. The byte counts follow ``chip_smoke.py``'s
``j2_bytes`` and ``take_bytes``: each input read once and each output
written once, whatever the kernels read again.
"""

from __future__ import annotations

#: HBM bytes/s and non-tensor-core FLOP/s by dtype name
PEAK = {"bytes": 3.35e12, "float32": 67e12, "float64": 34e12}

ITEMSIZE = {"float32": 4, "float64": 8}


def least_seconds(nbytes, ops, dtype):
    """The least time for the work: bytes over HBM rate or operations over
    the peak rate, whichever is longer."""
    return max(nbytes / PEAK["bytes"], ops / PEAK[dtype])


def j2_update_bytes(n, dtype):
    """One full-tangent J2 update of ``n`` points: eps, eps_p (6 each) and
    p read, sig (6), Ct (36), eps_p (6) and p written: 13 values in, 49
    out."""
    return (13 + 49) * n * ITEMSIZE[dtype]


def j2_update_ops(n, n_iter=12, hardening_ops=10):
    """Floating-point operations of ``n`` points of the full-tangent J2
    update, counted as ``chip_smoke.py``'s ``j2_ops_per_point`` counts them:
    trial state and norm ~45, each hardening evaluation ``hardening_ops``
    (~10 for a closed form), each Newton step ~8, stress and state ~30, the
    two tangent factors ~15 and the 36 tangent entries ~4 each."""
    return n * (45 + hardening_ops * (n_iter + 2) + 8 * n_iter + 30 + 15 + 36 * 4)


def cg_iteration_bytes(ne, ndof_el, ndofs, nnodes, ncomp, ncoarse, nmodes, dtype):
    """One iteration of the plate's preconditioned CG at its least: the
    element matrices (``ne`` x ``ndof_el``^2) read once; the dof vectors x,
    r, p and the Jacobi diagonal read, x, r and p written (the product, z
    and the gathered element vectors kept on chip); the dense coarse
    inverse (``ncoarse``^2) and the coarse modes of each node (``nnodes`` x
    ``ncomp`` x ``nmodes``) read, with each node's int64 aggregate index."""
    it = ITEMSIZE[dtype]
    elements = ne * ndof_el * ndof_el * it
    vectors = 7 * ndofs * it
    coarse = ncoarse * ncoarse * it + nnodes * ncomp * nmodes * it + nnodes * 8
    return elements + vectors + coarse
