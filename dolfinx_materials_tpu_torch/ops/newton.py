"""Small-system Newton solvers with implicit-function-theorem derivatives.

Counterpart of dolfinx_materials_tpu/ops/newton.py. A constitutive update is
written for one Gauss point and batched by ``torch.func.vmap``; its tangent
comes from ``torch.func.jacfwd``. The local root solves inside it must
therefore (1) run a data-dependent loop although ``vmap`` forbids control
flow on batched tensors, and (2) give ``jacfwd`` the derivative of the root,
not of the iteration.

Design: each solver is a ``torch.autograd.Function`` (:class:`_Root`) with

- a hand-written ``vmap`` staticmethod that moves the batch dimension to the
  front and applies the Function again with one more leading batch axis, so
  the iteration itself always runs on plain batched tensors: a masked Newton
  loop with a per-point convergence test that works on the points still
  active and stops when none is left (``max_iter`` is a bound; points
  converge in a few steps, and elastic points in none);
- a ``jvp`` staticmethod that applies the implicit function theorem at the
  root: one linear solve ``dx = -J_x^{-1} (df/dargs . dargs)`` per tangent
  direction. The loop is never differentiated, so damping and projection
  have no effect on the consistent tangents.

- a ``backward`` for reverse mode (``torch.func.grad``, ``torch.autograd``):
  at the root it solves ``J_x^T lam = g`` per point and returns
  ``-lam^T dr/dargs`` through one ``torch.func.vjp`` of the residual.

A fixed-count loop on detached inputs followed by one differentiable Newton
step would carry the same derivative with less machinery, but it pays
``max_iter`` (50-80) residual and Jacobian evaluations for every point of
every call; the early exit is worth the Function. Nor can one
stop-gradient step after the root, ``x* - J_x^{-1} (r - r.detach())``,
replace ``jvp`` and ``backward``: the iteration still runs inside the
Function, where a tensor of an outer ``torch.func`` transform cannot be
read (torch fails an internal assert), so closed-over differentiated
tensors must become arguments all the same; and the step would pay a
Jacobian on every call, differentiated or not, and turn the root itself
into NaN where ``J_x`` is singular there.

Everything that varies per point must reach the residual through ``args``: the
iteration runs below the ``vmap`` level, where a batched tensor captured by
closure is out of reach. Python floats and plain constants may be closed
over. A closed-over tensor that a transform or autograd is differentiating (a
material parameter under calibration, ``calibration.py``) is converted into
an argument, as ``lax.custom_root`` closure-converts in the JAX package: the
solvers find such tensors in the residual's closure (cells, bound objects'
attributes, lists and dicts, at any depth), pass them to the Function as
extra ``args`` and swap them back into their slots while the residual runs,
so their derivatives go through the implicit function theorem too. A
differentiated tensor that cannot be swapped raises ``TypeError`` instead
of losing its derivative: one held in a tuple, which the walk finds, and
one the walk cannot reach (a module global, a class attribute), which one
residual evaluation at the first point, with grad enabled on detached
inputs, finds under ``torch.autograd``; under a ``torch.func`` transform
torch itself refuses to read such a tensor inside the Function.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, jvp, vjp, vmap


def _dense_solve(J, r):
    """Solve ``J dx = r`` for small dense ``J (..., n, n)``, ``r (..., n)``;
    a singular ``J`` gives non-finite values, which the callers' residual
    tests catch, instead of raising for the whole batch. ``J`` is cast to
    ``r``'s dtype: in float32, forward-mode derivatives of 0-d intermediates
    come back from ``torch.func`` as float64."""
    return torch.linalg.solve_ex(J.to(r.dtype), r.unsqueeze(-1), check_errors=False)[0].squeeze(-1)


def _differentiated(t):
    return torch._C._functorch.is_functorch_wrapped_tensor(t) or t.requires_grad


def _captured_slots(fn):
    """``(container, key)`` slots of the differentiated tensors that ``fn``
    reaches through its closure: closure cells, attributes of bound and
    closed-over objects, list items and dict values, at any depth (a
    residual's closure holds some 10-30 objects). A differentiated tensor
    held only in tuples has no slot to swap it in: ``TypeError``."""
    slots, seen, in_tuples = [], set(), []

    def visit(obj):
        if id(obj) in seen or isinstance(obj, (type, type(torch))):
            return
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            return
        if callable(obj) and hasattr(obj, "__func__"):  # bound method
            visit(obj.__self__)
            obj = obj.__func__
        items = [(cell, None, cell.cell_contents) for cell in getattr(obj, "__closure__", None) or ()
                 if _cell_filled(cell)]
        if isinstance(obj, dict):
            items += [(obj, k, v) for k, v in obj.items()]
        elif isinstance(obj, list):
            items += [(obj, i, v) for i, v in enumerate(obj)]
        elif isinstance(obj, tuple):
            items += [(None, None, v) for v in obj]
        elif hasattr(obj, "__dict__"):
            items += [(obj, ("attr", k), v) for k, v in vars(obj).items()]
        for box, key, v in items:
            if not isinstance(v, torch.Tensor):
                visit(v)
            elif _differentiated(v) and box is None:
                in_tuples.append(v)
            elif _differentiated(v):
                slots.append((box, key))

    visit(fn)
    swapped = {id(_slot_get(b, k)) for b, k in slots}
    if any(id(t) not in swapped for t in in_tuples):
        raise TypeError("a root's residual closes over a differentiated tensor held in a tuple; "
                        "pass it through args, or hold it in a list, a dict or an attribute")
    return slots


def _cell_filled(cell):
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


def _slot_get(box, key):
    if key is None:
        return box.cell_contents
    if isinstance(key, tuple):
        return getattr(box, key[1])
    return box[key]


def _slot_set(box, key, v):
    if key is None:
        box.cell_contents = v
    elif isinstance(key, tuple):
        setattr(box, key[1], v)
    else:
        box[key] = v


def _closure_converted(resid_fn, nargs, slots):
    """``resid_fn`` taking the captured tensors as trailing arguments: each
    call puts them into their slots for its duration."""

    def resid(x, *a):
        saved = [_slot_get(b, k) for b, k in slots]
        for (b, k), v in zip(slots, a[nargs:]):
            _slot_set(b, k, v)
        try:
            return resid_fn(x, *a[:nargs])
        finally:
            for (b, k), v in zip(slots, saved):
                _slot_set(b, k, v)

    return resid


def _check_no_stray_grad(spec, x, args):
    """One residual evaluation at the first point of the flat batch, on
    detached inputs with grad enabled: a result that requires grad read a
    tensor that ``torch.autograd`` differentiates and that the closure walk
    did not turn into an argument, so its derivative would be lost."""
    if not x.shape[0]:
        return
    with torch.enable_grad():
        r = spec.resid_fn(x[0].detach(), *(a[0].detach() for a in args))
    if r.requires_grad:
        raise TypeError("a root's residual reads a tensor that requires grad by a route the solver cannot "
                        "turn into an argument (a tuple, a module global, a class attribute); pass it "
                        "through args, or hold it in a closure cell, a list, a dict or an attribute")


class _Spec:
    """What one root solve is: the residual and the iteration's constants."""

    def __init__(self, resid_fn, scalar, max_iter, lower=None, max_backtracks=0):
        self.resid_fn = resid_fn
        self.scalar = scalar
        self.max_iter = max_iter
        self.lower = lower
        self.max_backtracks = max_backtracks


def _norm(r, scalar):
    return r.abs() if scalar else torch.linalg.norm(r, dim=-1)


def _iterate_scalar(spec, x, tol, args):
    """Masked scalar Newton on flat batches ``x (B,)``, ``args[k] (B, ...)``."""
    f = spec.resid_fn

    def value_and_slope(x_, *a):
        return jvp(lambda y: f(y, *a), (x_,), (torch.ones_like(x_),))

    r = vmap(f)(x, *args)
    active = torch.nonzero(~(r.abs() < tol)).reshape(-1)
    x = x.clone(memory_format=torch.contiguous_format)  # x0 may be an expanded view
    it = 0
    while active.numel() and it < spec.max_iter:
        xa = x[active]
        aa = [a[active] for a in args]
        ra, dra = vmap(value_and_slope)(xa, *aa)
        xn = xa - ra / dra.to(ra.dtype)
        if spec.lower is not None:
            xn = torch.clamp(xn, min=spec.lower)
        x[active] = xn
        rn = vmap(f)(xn, *aa)
        active = active[~(rn.abs() < tol[active])]
        it += 1
    return x


def _iterate_vector(spec, x, tol, args):
    """Masked damped Newton on flat batches ``x (B, n)``: full step, then
    halving while the residual norm does not decrease (or is not finite)."""
    f = spec.resid_fn

    def jac_and_value(x_, *a):
        def g(y):
            r = f(y, *a)
            return r, r

        return jacfwd(g, has_aux=True)(x_)

    def rnorm(x_, aa):
        return torch.linalg.norm(vmap(f)(x_, *aa), dim=-1)

    active = torch.nonzero(~(rnorm(x, args) < tol)).reshape(-1)
    x = x.clone(memory_format=torch.contiguous_format)  # x0 may be an expanded view
    it = 0
    while active.numel() and it < spec.max_iter:
        xa = x[active]
        aa = [a[active] for a in args]
        J, r = vmap(jac_and_value)(xa, *aa)
        dx = _dense_solve(J, r)
        r_norm = torch.linalg.norm(r, dim=-1)
        alpha = torch.ones_like(r_norm)
        rn = rnorm(xa - dx, aa)
        k = 0
        while k < spec.max_backtracks:
            bad = torch.nonzero(~torch.isfinite(rn) | (rn >= r_norm)).reshape(-1)
            if not bad.numel():
                break
            alpha[bad] = 0.5 * alpha[bad]
            rn[bad] = rnorm(xa[bad] - alpha[bad, None] * dx[bad], [a[bad] for a in aa])
            k += 1
        xn = xa - alpha[:, None] * dx
        x[active] = xn
        active = active[~(rnorm(xn, aa) < tol[active])]
        it += 1
    return x


class _Root(torch.autograd.Function):
    """``x`` with ``resid_fn(x, *args) = 0``; ``nbatch`` leading axes of every
    tensor argument are batch axes."""

    generate_vmap_rule = False

    @staticmethod
    def forward(spec, nbatch, x0, tol, *args):
        batch = x0.shape[:nbatch]
        flat = lambda t: t.reshape((-1,) + t.shape[nbatch:])  # noqa: E731
        x0, tol, args = flat(x0), flat(tol), [flat(a) for a in args]
        _check_no_stray_grad(spec, x0, args)
        iterate = _iterate_scalar if spec.scalar else _iterate_vector
        with torch.no_grad():
            x = iterate(spec, x0, tol, args)
        return x.reshape(batch + x.shape[1:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, nbatch, _, _, *args = inputs
        ctx.spec, ctx.nbatch, ctx.nargs = spec, nbatch, len(args)
        ctx.save_for_forward(output, *args)
        ctx.save_for_backward(output, *args)

    @staticmethod
    def vmap(info, in_dims, spec, nbatch, x0, tol, *args):
        def front(t, d):
            if d is None:
                return t.unsqueeze(0).expand((info.batch_size,) + tuple(t.shape))
            return t.movedim(d, 0)

        x0, tol, *args = (front(t, d) for t, d in zip((x0, tol, *args), in_dims[2:]))
        return _Root.apply(spec, nbatch + 1, x0, tol, *args), 0

    @staticmethod
    def jvp(ctx, _spec, _nbatch, _x0, _tol, *targs):
        spec = ctx.spec
        x, *args = ctx.saved_tensors
        # only floating arguments carry tangents (a bool mask does not)
        diff = [i for i, a in enumerate(args) if a.is_floating_point() and targs[i] is not None]
        if not diff:
            return torch.zeros_like(x)

        def point(x_, args_, tangents_):
            def of_args(*da):
                full = list(args_)
                for i, a in zip(diff, da):
                    full[i] = a
                return spec.resid_fn(x_, *full)

            _, fa = jvp(of_args, tuple(args_[i] for i in diff), tuple(tangents_))
            of_x = lambda y: spec.resid_fn(y, *args_)  # noqa: E731
            if spec.scalar:
                _, dr = jvp(of_x, (x_,), (torch.ones_like(x_),))
                return (-fa / dr).to(x_.dtype)
            return -_dense_solve(jacfwd(of_x)(x_), fa.to(x_.dtype))

        fn = point
        for _ in range(ctx.nbatch):
            fn = vmap(fn)
        return fn(x, tuple(args), tuple(targs[i] for i in diff))

    @staticmethod
    def backward(ctx, gx):
        """Reverse mode at the root: ``J_x^T lam = gx`` per point, then the
        cotangent ``-lam`` pulled back to the floating ``args`` through one
        ``vjp`` of the residual."""
        spec = ctx.spec
        x, *args = ctx.saved_tensors
        diff = [i for i, a in enumerate(args) if a.is_floating_point() and ctx.needs_input_grad[4 + i]]
        grads = [None] * len(args)
        if diff:

            def point(x_, args_, g_):
                of_x = lambda y: spec.resid_fn(y, *args_)  # noqa: E731
                if spec.scalar:
                    _, dr = jvp(of_x, (x_,), (torch.ones_like(x_),))
                    lam = g_ / dr.to(g_.dtype)
                else:
                    lam = _dense_solve(jacfwd(of_x)(x_).transpose(-1, -2), g_)

                def of_args(*da):
                    full = list(args_)
                    for i, a in zip(diff, da):
                        full[i] = a
                    return spec.resid_fn(x_, *full)

                _, pull = vjp(of_args, *(args_[i] for i in diff))
                return pull(-lam.to(x_.dtype))

            fn = point
            for _ in range(ctx.nbatch):
                fn = vmap(fn)
            for i, g in zip(diff, fn(x, tuple(args), gx)):
                grads[i] = g
        return (None, None, None, None, *grads)


def _solve(spec, x0, args, tol):
    x0 = torch.as_tensor(x0)
    like = dict(dtype=x0.dtype, device=x0.device)
    args = tuple(a if isinstance(a, torch.Tensor) else torch.as_tensor(a, **like) for a in args)
    tol = torch.as_tensor(tol, **like)
    slots = _captured_slots(spec.resid_fn)
    if slots:
        spec.resid_fn = _closure_converted(spec.resid_fn, len(args), slots)
        args = args + tuple(_slot_get(b, k) for b, k in slots)
    x = _Root.apply(spec, 0, x0, tol, *args)
    r = spec.resid_fn(x, *args)
    return x, _norm(r, spec.scalar) < tol


def newton_solve(resid_fn, x0, args=(), tol=1e-10, max_iter=50, max_backtracks=12):
    """Solve ``resid_fn(x, *args) = 0`` for a small dense ``x (n,)`` by damped
    Newton (backtracking on ``|r|``, which nearly piecewise-linear residuals
    such as conic yield surfaces need: full steps oscillate there).

    Differentiable with respect to ``args`` through the implicit function
    theorem; written for one point, to be batched by ``torch.func.vmap``.
    ``tol`` may be a per-point tensor. Returns ``(x, converged)``.
    """
    spec = _Spec(resid_fn, False, max_iter, max_backtracks=max_backtracks)
    return _solve(spec, x0, args, tol)


def scalar_newton_solve(resid_fn, x0, args=(), tol=1e-10, max_iter=50, lower=None):
    """Scalar Newton with implicit-function-theorem derivatives and an
    optional projection ``x >= lower`` (e.g. a plastic multiplier), applied
    inside the iteration only, so the fixed point stays the unconstrained
    root when the solve sits behind a yield check. Returns ``(x, converged)``.
    """
    spec = _Spec(resid_fn, True, max_iter, lower=lower)
    return _solve(spec, x0, args, tol)
