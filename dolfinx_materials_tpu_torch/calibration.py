"""Differentiable material parameters: calibration by gradient descent
through the constitutive update.

Counterpart of dolfinx_materials_tpu/calibration.py. A
``behavior_factory(params)`` builds the behavior from a dict of parameter
tensors inside the differentiated function, so every parameter is
differentiable through the update, including the local Newton solves:
``ops/newton.py``'s roots turn a closed-over parameter into an argument
and return its derivative through the implicit function theorem
(``_Root.backward``), never through the iterations.

``make_path_simulator`` drives a strain path through sequential updates (a
Python loop over the steps, ``torch.func.vmap`` over the points);
``fit_parameters`` wraps it in an optimizer loop, ``torch.optim.Adam`` by
default, with ``torch.func.grad`` of the loss.
"""

from __future__ import annotations

import torch
from torch.func import grad_and_value, vmap

from . import resolve_device


def make_path_simulator(behavior_factory, example_params, dt=0.0):
    """Returns ``simulate(params, grad_path) -> flux_path`` for ``grad_path``
    ``(nsteps, k)`` (one point) or ``(nsteps, npts, k)`` (vmapped over the
    points); sequential in the steps (the state carries the history)."""
    beh0 = behavior_factory(example_params)
    gname = next(iter(beh0.gradients))
    fname = next(iter(beh0.fluxes))

    def simulate(params, grad_path):
        beh = behavior_factory(params)

        def point_path(path_1pt):
            state = {k: torch.as_tensor(v, dtype=path_1pt.dtype, device=path_1pt.device)
                     for k, v in beh.init_state().items()}
            fluxes = []
            for g in path_1pt:
                flux, state = beh.constitutive_update({gname: g}, state, dt)
                fluxes.append(flux[fname])
            return torch.stack(fluxes)

        if grad_path.ndim == 3:
            return vmap(point_path, in_dims=1, out_dims=1)(grad_path)
        return point_path(grad_path)

    return simulate


def fit_parameters(behavior_factory, params0, grad_path, target_flux, steps=300, learning_rate=0.05,
                   optimizer=None, loss_fn=None, dt=0.0, device=None):
    """Calibrate behavior parameters to an observed flux (stress) history.

    ``params0``: dict of scalar or array parameters. ``grad_path`` /
    ``target_flux``: (nsteps, k) or (nsteps, npts, k). ``optimizer``: a
    factory ``params (list of tensors) -> torch.optim.Optimizer``; the
    default is ``torch.optim.Adam(params, lr=learning_rate)`` (optax's
    defaults). ``loss_fn(params)``, if given, replaces the normalized mean
    squared error. Runs in float64 on ``device`` (``cuda`` unless given).
    Returns ``(params_fit, loss_history)``, the parameters as tensors.

    ``dt`` matters for rate-dependent behaviors (Norton, crystal): at dt = 0
    they answer elastically, with zero parameter gradients. Parameterize
    parameters spanning decades by log-multipliers, and start yield
    parameters below the data's stress levels: a model elastic along the
    whole path has no gradient in them.
    """
    dev = resolve_device(device)
    like = dict(dtype=torch.float64, device=dev)
    params = {k: torch.as_tensor(v, **like).clone() for k, v in params0.items()}
    sim = make_path_simulator(behavior_factory, params, dt=dt)
    path = torch.as_tensor(grad_path, **like)
    target = torch.as_tensor(target_flux, **like)
    scale = torch.mean(target**2) + 1e-30

    if loss_fn is None:

        def loss_fn(params):
            return torch.mean((sim(params, path) - target) ** 2) / scale

    names = list(params)
    opt = (optimizer or (lambda ps: torch.optim.Adam(ps, lr=learning_rate)))([params[k] for k in names])
    value_grad = grad_and_value(loss_fn)
    history = []
    for _ in range(steps):
        g, loss = value_grad(params)
        for k in names:
            params[k].grad = g[k]
        opt.step()
        history.append(loss.detach())
    return params, [float(v) for v in torch.stack(history).cpu()]
