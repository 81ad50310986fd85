"""Neural-network surrogate constitutive models.

Counterpart of dolfinx_materials_tpu/models/nn.py. The MLP is a
``torch.nn.Module`` (``nn.Linear`` layers, ``tanh`` between them) evaluated
through ``torch.func.functional_call``, so ``Material``'s ``vmap(jacfwd)``
update gives the network's exact consistent tangent d(sigma)/d(eps).
``init_mlp_params`` draws the JAX package's weights bit for bit from the
same seed; ``state.from_reference_params`` carries a JAX parameter list
(``[{"W": (in, out), "b": (out,)}, ...]``) into the module's state.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .. import resolve_device
from ..state import from_reference_params
from .base import SmallStrainBehavior


def init_mlp_params(layers, seed=0, scale=None):
    """He-normal weights and zero biases from numpy's ``default_rng(seed)``,
    as a list of ``{"W": (fan_in, fan_out), "b": (fan_out,)}`` numpy arrays
    (the JAX package's draw, bit for bit)."""
    rng = np.random.default_rng(seed)
    params = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        s = scale or np.sqrt(2.0 / fan_in)
        W = rng.normal(size=(fan_in, fan_out)) * s
        b = np.zeros(fan_out)
        params.append({"W": W, "b": b})
    return params


class MLP(nn.Module):
    """``Linear -> activation -> ... -> Linear``."""

    def __init__(self, layers, activation=torch.tanh):
        super().__init__()
        self.linears = nn.ModuleList(nn.Linear(a, b, dtype=torch.float64) for a, b in zip(layers[:-1], layers[1:]))
        self.activation = activation

    def forward(self, x):
        for lin in self.linears[:-1]:
            x = self.activation(lin(x))
        return self.linears[-1](x)


def mlp_apply(params, x, activation=torch.tanh):
    """The MLP on a JAX-layout parameter list: ``x @ W + b`` per layer."""
    for layer in params[:-1]:
        x = activation(x @ layer["W"] + layer["b"])
    return x @ params[-1]["W"] + params[-1]["b"]


class NeuralBehavior(SmallStrainBehavior):
    """MLP surrogate sigma(eps): Mandel strain (6,) -> Mandel stress (6,).

    ``input_scale`` / ``output_scale`` normalize strain and stress
    magnitudes. ``params``: a JAX-layout parameter list (numpy or tensors);
    by default ``init_mlp_params(layers, seed)``. The weights live in
    ``self.module`` (an :class:`MLP`, float64 on the CPU until moved by
    ``fit`` or by the caller); the update reads them through
    ``functional_call`` in the dtype and on the device of its input.
    """

    def __init__(self, layers=(6, 64, 64, 6), params=None, activation=torch.tanh, input_scale=1e3,
                 output_scale=1e3, seed=0):
        params = params if params is not None else init_mlp_params(layers, seed)
        self.layers = tuple(int(np.shape(p["W"])[0]) for p in params) + (int(np.shape(params[-1]["W"])[1]),)
        self.module = MLP(self.layers, activation)
        self.module.load_state_dict(from_reference_params(params))
        self.activation = activation
        self.input_scale = input_scale
        self.output_scale = output_scale

    @property
    def params(self):
        """The weights as a JAX-layout list of numpy arrays."""
        return [{"W": lin.weight.detach().cpu().numpy().T.copy(), "b": lin.bias.detach().cpu().numpy().copy()}
                for lin in self.module.linears]

    def _weights(self, like):
        return {k: v.to(dtype=like.dtype, device=like.device) for k, v in self.module.state_dict().items()}

    def small_strain_update(self, eps, state, dt):
        sig = self.output_scale * functional_call(self.module, self._weights(eps), (self.input_scale * eps,))
        return sig, state

    def fit(self, eps_data, sig_data, steps=2000, learning_rate=1e-3, device=None):
        """Fit the surrogate to (strain, stress) data by full-batch Adam on
        the mean squared error of the scaled stresses; returns the loss
        history. ``torch.optim.Adam`` with optax's defaults (beta1 = 0.9,
        beta2 = 0.999, eps = 1e-8 outside the square root, bias
        correction), so a run follows the JAX package's ``optax.adam``.
        Runs on ``device`` (``cuda`` unless given); the weights stay there,
        in float64."""
        dev = resolve_device(device)
        self.module.to(dev)
        xs = self.input_scale * torch.as_tensor(np.asarray(eps_data), dtype=torch.float64, device=dev)
        ys = torch.as_tensor(np.asarray(sig_data), dtype=torch.float64, device=dev) / self.output_scale
        opt = torch.optim.Adam(self.module.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        losses = []
        for _ in range(steps):
            opt.zero_grad()
            loss = torch.mean((self.module(xs) - ys) ** 2)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return [float(v) for v in torch.stack(losses).cpu()]
