"""The least work of the Ogden update, counted from shapes.

One call on ``n`` of the mesh's points (the identity points that
``models/hyperelasticity.py`` ``_chunked`` pads with are not counted): F
read (9 values a point), PK1 written (9) and, with the tangent, the
81-wide tangent written, each once, in the call's dtype. The operations are
a floor too: forming the outputs from S = 2 dW/dC and its 6x6 Mandel
Hessian alone (C = F^T F, P = F S, and for each of the nine tangent
columns dC, H : dC and F dS), not the energy, its eigenvalues or the
differentiation that give S and H.
"""

from __future__ import annotations

from portbench import roofline

#: operations a point: C (6 entries, 5 each) and P = F S (9 entries, 5 each)
FLUX_OPS = 6 * 5 + 9 * 5
#: and for each of the 9 tangent columns: dC (6 x 4), H : dC (6 x 11), F dS (9 x 5) and the add (9)
TANGENT_OPS = FLUX_OPS + 9 * (6 * 4 + 6 * 11 + 9 * 5 + 9)


def call_bytes(n, dtype, tangent):
    return (9 + 9 + (81 if tangent else 0)) * n * roofline.ITEMSIZE[dtype]


def call_seconds(n, dtype, tangent):
    """The least time of one call on ``n`` points: the bytes at the HBM
    rate or the operations at the dtype's peak, whichever is longer."""
    return roofline.least_seconds(call_bytes(n, dtype, tangent), n * (TANGENT_OPS if tangent else FLUX_OPS), dtype)


def least_seconds(counts, n):
    """The least time of the calls counted in ``counts`` (a window's
    ``update.<dtype>`` and ``flux.<dtype>`` counts), each on ``n``
    points."""
    total = 0.0
    for kind, tangent in (("update", True), ("flux", False)):
        for dtype in roofline.ITEMSIZE:
            total += counts.get(f"{kind}.{dtype}", 0) * call_seconds(n, dtype, tangent)
    return total
