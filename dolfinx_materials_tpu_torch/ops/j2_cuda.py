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
or point-major ``(n, 6), (n, 6), (n,)`` as the FEM path holds them; each is
its own instantiation of the kernel template.

:class:`J2Launch` binds a kernel to a material and a contract once (packed
parameters, law id, entry points); the fast path holds one
(``ops/j2_fast.py``), and the two functions above build one per call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import tensors
from .cuda_build import check, function

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
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def pack_params(elasticity, hardening, reg):
    """The kernels' parameter block (float64): ``mu, lmbda, h0..h3, reg``,
    then the Mandel stiffness ``C`` row-major (36 values)."""
    h = list(hardening) + [0.0] * (4 - len(hardening))
    C = tensors.isotropic_C(elasticity.E, elasticity.nu)
    return np.concatenate(
        [[float(elasticity.mu), float(elasticity.lmbda), *h, reg], C.ravel()]
    ).astype(np.float64)


class J2Launch:
    """One of the two J2 kernels bound to an elasticity, a hardening law and
    a contract. The packed parameters, the law id and the entry point of each
    dtype are built once, so a call on the card is the checks, the output
    allocations and one ctypes launch on the current stream; on CPU tensors
    it runs the plain version.

    The parameters are read when the launch is built, as the JAX package's
    kernels read them when they are made: change them through
    ``Material.update_material_property`` (which drops the behavior's cached
    update, and this launch with it) or with new objects, not in place.
    """

    def __init__(self, elasticity, yield_stress, *, factored, n_iter, warm_start, reg):
        self.elasticity = elasticity
        self.yield_stress = yield_stress
        self.factored = bool(factored)
        self.contract = dict(n_iter=int(n_iter), warm_start=bool(warm_start), reg=float(reg))
        self.wrapper = j2_radial_return_factored if factored else j2_radial_return
        self.plain = j2_radial_return_factored_reference if factored else j2_radial_return_reference
        self.width = 2 if factored else 36
        law = kernel_law(yield_stress)
        # a law without a closed form: None, and the launch raises on the card
        self.law_id = None if law is None else int(law[0])
        self.params = None if law is None else pack_params(elasticity, law[1], reg)
        self._fns = {}

    def __call__(self, eps, eps_p, p, feature_major=True):
        """``(sig, tangent, eps_p_new, p_new)`` in the input layout: feature-major
        ``(6, n), (6, n), (1, n)`` or point-major ``(n, 6), (n, 6), (n,)``."""
        if eps.device.type == "cpu":
            return self.plain(eps, eps_p, p, self.elasticity, self.yield_stress,
                              feature_major=feature_major, **self.contract)
        return self._launch(eps, eps_p, p, bool(feature_major))

    def _launch(self, eps, eps_p, p, feature_major):
        """Check the CUDA tensors, allocate the outputs and launch the kernel
        once on the current device's current stream; raises on anything the
        kernel does not take or a failed launch."""
        what = self.wrapper.__name__
        if not eps.is_cuda:
            raise ValueError(f"{what}: unsupported device {eps.device}")
        if self.law_id is None:
            raise TypeError(
                f"{what}: {type(self.yield_stress).__name__} has no in-kernel "
                "form; give it a kernel_law() or run on the CPU"
            )
        dtype = eps.dtype
        fn = self._fns.get(dtype)
        if fn is None:
            if dtype not in _SUFFIX:
                raise TypeError(f"{what}: unsupported dtype {dtype}")
            name = f"{what}_{_SUFFIX[dtype]}"
            fn = self._fns[dtype] = (function(SOURCE, name, _ARGTYPES), self.params.ctypes.data)
        fn, params = fn
        device = eps.device
        n = eps.shape[1] if feature_major else eps.shape[0]
        s6, s1 = ((6, n), (1, n)) if feature_major else ((n, 6), (n,))
        # one expression: these checks are a fair share of a call's host time
        if (eps.shape != s6 or eps_p.shape != s6 or p.shape != s1 or eps_p.dtype != dtype
                or p.dtype != dtype or eps_p.device != device or p.device != device):
            raise ValueError(
                f"{what}: expected {s6}, {s6}, {s1} {dtype} on {device}, got "
                + ", ".join(f"{tuple(t.shape)} {t.dtype} on {t.device}" for t in (eps, eps_p, p))
            )
        if not (eps.is_contiguous() and eps_p.is_contiguous() and p.is_contiguous()):
            raise ValueError(f"{what}: inputs must be contiguous")
        dev = device.index
        if dev != torch.cuda.current_device():
            raise ValueError(f"{what}: inputs on {device}, not on the current CUDA device")
        sig = eps.new_empty(s6)
        tangent = eps.new_empty((self.width, n) if feature_major else (n, self.width))
        eps_p_new = eps.new_empty(s6)
        p_new = eps.new_empty(s1)
        c = self.contract
        # the current stream's raw handle, as in ops/banded_gather.py: a
        # torch.cuda.current_stream() Stream object costs more host time
        rc = fn(
            eps.data_ptr(), eps_p.data_ptr(), p.data_ptr(), sig.data_ptr(),
            tangent.data_ptr(), eps_p_new.data_ptr(), p_new.data_ptr(), n,
            params, self.law_id, c["n_iter"], c["warm_start"], feature_major,
            torch._C._cuda_getCurrentRawStream(dev),
        )
        check(rc, SOURCE, what)
        self.wrapper.launches += 1
        self.wrapper.f32_launches += dtype == torch.float32
        return sig, tangent, eps_p_new, p_new


def j2_radial_return(eps, eps_p, p, elasticity, yield_stress, *, n_iter,
                     warm_start, reg, feature_major=True):
    """Launch the full-tangent J2 kernel on CUDA tensors; plain version on CPU
    tensors. Builds its :class:`J2Launch` anew: a caller that updates the
    same material again holds one (``ops/j2_fast.py`` does).

    Returns ``(sig, Ct, eps_p_new, p_new)`` in the input layout. Raises for a
    CUDA tensor the kernel does not take (dtype, shape, contiguity, device, a
    hardening law without a closed form) or a failed launch.
    """
    launch = J2Launch(elasticity, yield_stress, factored=False, n_iter=n_iter,
                      warm_start=warm_start, reg=reg)
    return launch(eps, eps_p, p, feature_major)


j2_radial_return.launches = 0
j2_radial_return.f32_launches = 0  # the float32 share of ``launches``


def j2_radial_return_factored(eps, eps_p, p, elasticity, yield_stress, *, n_iter,
                              warm_start, reg, feature_major=True):
    """Launch the factored-tangent J2 kernel on CUDA tensors; plain version on
    CPU tensors (a fresh :class:`J2Launch`, as :func:`j2_radial_return`).

    Returns ``(sig, fac, eps_p_new, p_new)`` in the input layout, ``fac`` as
    ``(2, n)`` feature-major or ``(n, 2)``. Raises, never falls back, for a
    CUDA tensor the kernel does not take or a failed launch.
    """
    launch = J2Launch(elasticity, yield_stress, factored=True, n_iter=n_iter,
                      warm_start=warm_start, reg=reg)
    return launch(eps, eps_p, p, feature_major)


j2_radial_return_factored.launches = 0
j2_radial_return_factored.f32_launches = 0


def to_feature_major(eps, eps_p, p):
    """(n,6),(n,6),(n,) -> kernel layout (6,n),(6,n),(1,n), contiguous."""
    return eps.T.contiguous(), eps_p.T.contiguous(), p[None, :].contiguous()


def from_feature_major(sig_T, Ct_T, eps_p_T, p_row):
    """Kernel layout back to (n,6),(n,36),(n,6),(n,)."""
    return sig_T.T, Ct_T.T, eps_p_T.T, p_row[0]
