"""The J2 radial-return kernels (``csrc/j2_radial_return.cu``) and their plain
PyTorch versions.

Counterparts of the two fused TPU kernels of
dolfinx_materials_tpu/ops/pallas_j2.py, which share one return map and differ
in how they hand back the closed-form Simo-Hughes tangent
``Ct = C - 2 mu beta K4 - gamma nbar (x) nbar``:

- :func:`j2_radial_return` (``make_j2_pallas_update``): ``(eps, eps_p, p) ->
  (sig, Ct (36 rows), eps_p_new, p_new)``;
- :func:`j2_radial_return_factored` (``make_j2_pallas_factored``): ``-> (sig,
  fac (2 rows) = [2 mu beta, gamma], eps_p_new, p_new)``, 15 values written a
  point in place of 49; :func:`expand_factored_tangent` rebuilds ``Ct`` from
  ``sig`` and ``fac`` where the dense tangent is wanted.

The kernels' design and their bound on the card are noted in the CUDA source.

Two contracts share the kernels and differ only in parameters:

- :data:`PALLAS_CONTRACT`: warm-started Newton, 4 iterations, regularizer
  ``(1e-7 (1 + sigY))^2`` (pallas_j2.py);
- :data:`J2_FAST_CONTRACT`: cold start, 12 iterations, regularizer
  ``(1e-14 (1 + sigY))^2`` (j2_fast.py) — what the FEM path runs.

Layouts: feature-major ``(6, n), (6, n), (1, n)`` as the TPU kernels took them,
or point-major ``(n, 6), (n, 6), (n,)`` as the FEM path holds them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import tensors

PALLAS_CONTRACT = dict(n_iter=4, warm_start=True, reg=1e-7)
J2_FAST_CONTRACT = dict(n_iter=12, warm_start=False, reg=1e-14)


def kernel_law(yield_stress):
    """``(law_id, params)`` of a hardening law the kernel evaluates in closed
    form, else None (the kernels then raise for it on the card)."""
    fn = getattr(yield_stress, "kernel_law", None)
    return None if fn is None else fn()


def _value_and_slope(yield_stress, p):
    return torch.func.jvp(yield_stress, (p,), (torch.ones_like(p),))


def _return_map(eps, eps_p, p, elasticity, yield_stress, n_iter, warm_start, reg):
    """The shared return map on point-major tensors: ``(sig, nbar, b2m, gamma,
    eps_p_new, p_new)`` with ``b2m = 2 mu beta``."""
    mu = float(elasticity.mu)
    lmbda = float(elasticity.lmbda)
    dtype = eps.dtype

    e = eps - eps_p
    sig_tr = torch.cat(
        [2.0 * mu * e[:, :3] + (lmbda * tensors.tr(e))[:, None], 2.0 * mu * e[:, 3:]],
        dim=1,
    )
    s = tensors.dev(sig_tr)
    sigY0, dY0 = _value_and_slope(yield_stress, p)
    q = torch.sqrt(1.5 * tensors.ddot(s, s) + (reg * (1.0 + sigY0)) ** 2)
    iq = 1.0 / q
    f_tr = q - sigY0
    f_act = torch.clamp(f_tr, min=0.0)
    if warm_start:
        dp = f_act / torch.clamp(3.0 * mu + dY0, min=1e-3 * mu)
    else:
        dp = torch.zeros_like(q)
    for _ in range(n_iter):
        Y, dY = _value_and_slope(yield_stress, p + dp)
        r = f_act - 3.0 * mu * dp - (Y - sigY0)
        dp = torch.clamp(dp - r / (-3.0 * mu - dY), min=0.0)
    _, Hp = _value_and_slope(yield_stress, p + dp)

    nb = s * iq[:, None]
    sig = sig_tr - (3.0 * mu * dp)[:, None] * nb
    eps_p_new = eps_p + (1.5 * dp)[:, None] * nb
    p_new = p + dp
    plastic = (f_tr > 0.0).to(dtype)
    b2m = 6.0 * mu * mu * dp * iq * plastic
    gamma = 9.0 * mu * mu * (1.0 / (3.0 * mu + Hp) - dp * iq) * plastic
    return sig, nb, b2m, gamma, eps_p_new, p_new


def _to_layout(outs, feature_major):
    if not feature_major:
        return outs
    return tuple((o[None] if o.ndim == 1 else o.T).contiguous() for o in outs)


def j2_radial_return_reference(eps, eps_p, p, elasticity, yield_stress, *,
                               n_iter, warm_start, reg, feature_major=True):
    """Plain PyTorch version of the full-tangent kernel (same contract, any
    hardening callable, any device)."""
    if feature_major:
        eps, eps_p, p = eps.T, eps_p.T, p[0]
    sig, nb, b2m, gamma, eps_p_new, p_new = _return_map(
        eps, eps_p, p, elasticity, yield_stress, n_iter, warm_start, reg
    )
    C = torch.as_tensor(tensors.isotropic_C(elasticity.E, elasticity.nu), dtype=eps.dtype, device=eps.device)
    K4 = torch.as_tensor(tensors.K4, dtype=eps.dtype, device=eps.device)
    Ct = (
        C[None]
        - b2m[:, None, None] * K4[None]
        - gamma[:, None, None] * nb[:, :, None] * nb[:, None, :]
    ).reshape(-1, 36)
    return _to_layout((sig, Ct, eps_p_new, p_new), feature_major)


def j2_radial_return_factored_reference(eps, eps_p, p, elasticity, yield_stress, *,
                                        n_iter, warm_start, reg, feature_major=True):
    """Plain PyTorch version of the factored-tangent kernel: ``(sig, fac,
    eps_p_new, p_new)`` with ``fac = [2 mu beta, gamma]`` as ``(2, n)``
    (feature-major) or ``(n, 2)``."""
    if feature_major:
        eps, eps_p, p = eps.T, eps_p.T, p[0]
    sig, _, b2m, gamma, eps_p_new, p_new = _return_map(
        eps, eps_p, p, elasticity, yield_stress, n_iter, warm_start, reg
    )
    fac = torch.stack([b2m, gamma], dim=1)
    return _to_layout((sig, fac, eps_p_new, p_new), feature_major)


def expand_factored_tangent(elasticity, sig, fac, feature_major=True):
    """The dense tangent ``Ct`` ((36, n) feature-major, else (n, 36)) from the
    factored form. ``nbar`` is recovered from the returned stress: the radial
    return keeps the deviatoric direction, so ``nbar = dev(sig) / q(sig)``
    (``1/q`` taken as 0 where ``q = 0``); on elastic points ``fac = 0`` and
    the direction does not matter. Plain PyTorch on any device: a validation
    helper, as in the JAX package."""
    if feature_major:
        sig, fac = sig.T, fac.T
    dtype, dev = sig.dtype, sig.device
    C = torch.as_tensor(tensors.isotropic_C(elasticity.E, elasticity.nu), dtype=dtype, device=dev)
    K4 = torch.as_tensor(tensors.K4, dtype=dtype, device=dev)
    s = tensors.dev(sig)
    q = torch.sqrt(1.5 * tensors.ddot(s, s))
    iq = torch.where(q > 0, 1.0 / torch.clamp(q, min=1e-30), torch.zeros_like(q))
    nb = s * iq[:, None]
    Ct = (
        C[None]
        - fac[:, 0, None, None] * K4[None]
        - fac[:, 1, None, None] * nb[:, :, None] * nb[:, None, :]
    ).reshape(-1, 36)
    return Ct.T.contiguous() if feature_major else Ct


SOURCE = "j2_radial_return.cu"
_FN = {
    (False, torch.float32): "j2_radial_return_f32",
    (False, torch.float64): "j2_radial_return_f64",
    (True, torch.float32): "j2_radial_return_factored_f32",
    (True, torch.float64): "j2_radial_return_factored_f64",
}


def _launch(what, factored, eps, eps_p, p, elasticity, yield_stress, n_iter,
            warm_start, reg, feature_major):
    """Check the CUDA tensors, allocate the outputs and launch one of the two
    kernels; raises on anything the kernel does not take or a failed launch."""
    if not eps.is_cuda:
        raise ValueError(f"{what}: unsupported device {eps.device}")
    law = kernel_law(yield_stress)
    if law is None:
        raise TypeError(
            f"{what}: {type(yield_stress).__name__} has no in-kernel "
            "form; give it a kernel_law() or run on the CPU"
        )
    dtype = eps.dtype
    if (factored, dtype) not in _FN:
        raise TypeError(f"{what}: unsupported dtype {dtype}")
    n = eps.shape[1] if feature_major else eps.shape[0]
    shapes = ((6, n), (6, n), (1, n)) if feature_major else ((n, 6), (n, 6), (n,))
    for t, shp in zip((eps, eps_p, p), shapes):
        if tuple(t.shape) != shp or t.dtype != dtype or t.device != eps.device:
            raise ValueError(
                f"{what}: expected {shp} {dtype} on {eps.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    width = 2 if factored else 36
    sig = torch.empty_like(eps)
    tangent = torch.empty((width, n) if feature_major else (n, width), dtype=dtype, device=eps.device)
    eps_p_new = torch.empty_like(eps_p)
    p_new = torch.empty_like(p)

    law_id, hardening = law
    h = list(hardening) + [0.0] * (4 - len(hardening))
    C = tensors.isotropic_C(elasticity.E, elasticity.nu)
    params = np.concatenate(
        [[float(elasticity.mu), float(elasticity.lmbda), *h, reg], C.ravel()]
    ).astype(np.float64)
    from .cuda_build import check, function

    vp = ctypes.c_void_p
    fn = function(SOURCE, _FN[(factored, dtype)],
                  [vp] * 7 + [ctypes.c_longlong, vp] + [ctypes.c_int] * 4 + [vp])
    with torch.cuda.device(eps.device):
        stream = torch.cuda.current_stream(eps.device).cuda_stream
        rc = fn(
            eps.data_ptr(), eps_p.data_ptr(), p.data_ptr(), sig.data_ptr(),
            tangent.data_ptr(), eps_p_new.data_ptr(), p_new.data_ptr(), n,
            params.ctypes.data, law_id, int(n_iter), int(bool(warm_start)),
            int(bool(feature_major)), stream,
        )
    check(rc, SOURCE, what)
    return sig, tangent, eps_p_new, p_new


def j2_radial_return(eps, eps_p, p, elasticity, yield_stress, *, n_iter,
                     warm_start, reg, feature_major=True):
    """Launch the full-tangent J2 kernel on CUDA tensors; plain version on CPU
    tensors.

    Returns ``(sig, Ct, eps_p_new, p_new)`` in the input layout. Raises for a
    CUDA tensor the kernel does not take (dtype, shape, contiguity, a
    hardening law without a closed form) or a failed launch.
    """
    if eps.device.type == "cpu":
        return j2_radial_return_reference(
            eps, eps_p, p, elasticity, yield_stress, n_iter=n_iter,
            warm_start=warm_start, reg=reg, feature_major=feature_major,
        )
    out = _launch("j2_radial_return", False, eps, eps_p, p, elasticity, yield_stress,
                  n_iter, warm_start, reg, feature_major)
    j2_radial_return.launches += 1
    return out


j2_radial_return.launches = 0


def j2_radial_return_factored(eps, eps_p, p, elasticity, yield_stress, *, n_iter,
                              warm_start, reg, feature_major=True):
    """Launch the factored-tangent J2 kernel on CUDA tensors; plain version on
    CPU tensors.

    Returns ``(sig, fac, eps_p_new, p_new)`` in the input layout, ``fac`` as
    ``(2, n)`` feature-major or ``(n, 2)``. Raises, never falls back, for a
    CUDA tensor the kernel does not take or a failed launch.
    """
    if eps.device.type == "cpu":
        return j2_radial_return_factored_reference(
            eps, eps_p, p, elasticity, yield_stress, n_iter=n_iter,
            warm_start=warm_start, reg=reg, feature_major=feature_major,
        )
    out = _launch("j2_radial_return_factored", True, eps, eps_p, p, elasticity,
                  yield_stress, n_iter, warm_start, reg, feature_major)
    j2_radial_return_factored.launches += 1
    return out


j2_radial_return_factored.launches = 0


def to_feature_major(eps, eps_p, p):
    """(n,6),(n,6),(n,) -> kernel layout (6,n),(6,n),(1,n), contiguous."""
    return eps.T.contiguous(), eps_p.T.contiguous(), p[None, :].contiguous()


def from_feature_major(sig_T, Ct_T, eps_p_T, p_row):
    """Kernel layout back to (n,6),(n,36),(n,6),(n,)."""
    return sig_T.T, Ct_T.T, eps_p_T.T, p_row[0]
