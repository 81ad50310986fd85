"""Hardening laws as programs (dolfinx_materials_tpu_torch/ops/law_program.py)
against the JAX package, on the CPU in float64.

- ``evaluate(trace_law(f), p)`` against ``jax.jvp`` of the same law written
  with ``jnp``, to 1e-14 relative over p in [0, 0.2] (0 included; no point
  on a clamp's bound, where the two packages split a tie differently);
- the plain return map driven by a program against the JAX Pallas kernel
  (interpret mode) run on the jnp law, to 1e-12 of each field's scale;
- laws that are not programs raise ``TypeError`` naming the operation.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.ops.pallas_j2 import make_j2_pallas_update  # noqa: E402

from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.ops import j2_cuda  # noqa: E402
from dolfinx_materials_tpu_torch.ops.law_program import (  # noqa: E402
    LAW_PROGRAM,
    MAX_INSTRUCTIONS,
    OPS,
    evaluate,
    trace_law,
)

torch.set_num_threads(1)
E, NU = 70e3, 0.3

# name -> (torch law, jnp law)
LAWS = {
    "tanh": (lambda p: 350.0 + 2e3 * p + 50.0 * torch.tanh(100.0 * p),
             lambda p: 350.0 + 2e3 * p + 50.0 * jnp.tanh(100.0 * p)),
    "voce": (tmodels.VoceHardening(350.0, 500.0, 1e3), jmodels.VoceHardening(350.0, 500.0, 1e3)),
    "swift": (tmodels.SwiftHardening(350.0, 2e-3, 0.2), jmodels.SwiftHardening(350.0, 2e-3, 0.2)),
    "ramberg_osgood": (tmodels.RambergOsgoodHardening(350.0, E, 2e-3, 5.0),
                       jmodels.RambergOsgoodHardening(350.0, E, 2e-3, 5.0)),
    "log1p_sqrt": (lambda p: 350.0 + 100.0 * torch.log1p(50.0 * p) + 200.0 * torch.sqrt(p + 1e-4),
                   lambda p: 350.0 + 100.0 * jnp.log1p(50.0 * p) + 200.0 * jnp.sqrt(p + 1e-4)),
}
P_GRID = np.concatenate([[0.0], np.geomspace(1e-9, 0.2, 63)])


@pytest.mark.parametrize("name", sorted(LAWS))
def test_program_matches_jax_jvp(name):
    tlaw, jlaw = LAWS[name]
    program = trace_law(tlaw)
    assert 0 < len(program.code) <= MAX_INSTRUCTIONS
    Y, dY = evaluate(program, torch.as_tensor(P_GRID, dtype=torch.float64))
    p = jnp.asarray(P_GRID)
    Yj, dYj = jax.jvp(jlaw, (p,), (jnp.ones_like(p),))
    for got, want, what in ((Y, Yj, "value"), (dY, dYj, "slope")):
        got, want = got.numpy(), np.asarray(want)
        err = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
        assert np.all((got == want) | (err <= 1e-14)), f"{what}: {err.max():.2e}"


def test_program_ties_follow_torch_jvp():
    """At a clamp's bound the slope passes, at a maximum/minimum tie half of
    it, abs has slope 0 at 0: torch.func.jvp's conventions."""
    laws = [
        lambda p: torch.clamp(p, min=0.5) * 3.0,
        lambda p: torch.clamp(p, max=0.5) * 3.0,
        lambda p: torch.maximum(p, torch.tensor(0.5)) * 3.0,
        lambda p: torch.minimum(p, torch.tensor(0.5)) * 3.0,
        lambda p: abs(p - 0.5) * 3.0,
    ]
    p = torch.tensor([0.25, 0.5, 0.75], dtype=torch.float64)
    for law in laws:
        Y, dY = evaluate(trace_law(law), p)
        Yt, dYt = torch.func.jvp(law, (p,), (torch.ones_like(p),))
        torch.testing.assert_close(Y, Yt, rtol=0, atol=0)
        torch.testing.assert_close(dY, dYt, rtol=0, atol=0)


def test_trace_records_each_operation_once():
    program = trace_law(LAWS["voce"][0])
    assert [OPS[ins[0]] for ins in program.code] == ["mul_c", "exp", "rsub_c", "mul_c", "add_c"]
    assert program.out == len(program.code)
    # a constant law and the identity are programs too
    assert evaluate(trace_law(lambda p: 350.0), torch.zeros(3, dtype=torch.float64))[1].abs().max() == 0
    assert trace_law(lambda p: p).out == 0


@pytest.mark.parametrize("name", ["tanh", "log1p_sqrt"])
def test_program_return_map_matches_pallas_interpret(name):
    """The plain return map driven by the program (what the kernel runs)
    against the JAX Pallas kernel on the jnp law, the Pallas contract."""
    tlaw, jlaw = LAWS[name]
    n = 512
    rng = np.random.default_rng(4)
    eps = rng.normal(size=(n, 6)) * np.geomspace(1e-4, 4e-2, n)[:, None]
    eps_p = 1e-3 * rng.normal(size=(n, 6))
    eps_p[:, :3] -= eps_p[:, :3].mean(axis=1, keepdims=True)
    p = 5e-3 * rng.random(n)
    fm = (eps.T.copy(), eps_p.T.copy(), p[None, :].copy())
    want = make_j2_pallas_update(jmodels.LinearElasticIsotropic(E, NU), jlaw, tile=128, interpret=True)(
        *(jnp.asarray(a) for a in fm))
    el = tmodels.LinearElasticIsotropic(E, NU)
    got = j2_cuda.j2_radial_return_reference(
        *(torch.as_tensor(a) for a in fm), el, trace_law(tlaw), **j2_cuda.PALLAS_CONTRACT)
    assert float((got[3] - torch.as_tensor(p)).max()) > 1e-3, "must exercise the plastic branch"
    for g, w, what in zip(got, want, ("stress", "tangent", "eps_p", "p")):
        w = np.asarray(w)
        scale = E if what == "tangent" else np.abs(w).max()
        err = np.abs(g.numpy() - w).max() / scale
        assert err <= 1e-12, f"{what}: {err:.2e}"
    # the CPU wrappers run the callable itself (torch.func.jvp): the same map
    cpu = j2_cuda.j2_radial_return(*(torch.as_tensor(a) for a in fm), el, tlaw, **j2_cuda.PALLAS_CONTRACT)
    for g, c in zip(got, cpu):
        torch.testing.assert_close(g, c, rtol=1e-12, atol=1e-12 * float(c.abs().max()))


def test_launch_packs_the_program():
    """A user law's launch carries LAW_PROGRAM and the packed program after
    the 43 values of the closed forms' block."""
    el = tmodels.LinearElasticIsotropic(E, NU)
    tlaw = LAWS["tanh"][0]
    for factored in (False, True):
        launch = j2_cuda.J2Launch(el, tlaw, factored=factored, **j2_cuda.J2_FAST_CONTRACT)
        program = trace_law(tlaw)
        assert launch.law_id == LAW_PROGRAM and launch.law_error is None
        n = len(program.code)
        assert launch.params.shape == (43 + 2 + 4 * n,)
        np.testing.assert_array_equal(launch.params[2:6], 0.0)
        assert launch.params[43] == n and launch.params[44] == program.out
        ins = launch.params[45:].reshape(n, 4)
        np.testing.assert_array_equal(ins, np.asarray(program.code, dtype=np.float64))
        np.testing.assert_array_equal(
            launch.params[:43], j2_cuda.pack_params(el, tmodels.LinearHardening(0.0, 0.0).kernel_law()[1],
                                                    j2_cuda.J2_FAST_CONTRACT["reg"])[:43])


def _long_law(p):
    for _ in range(MAX_INSTRUCTIONS + 1):
        p = p + 1.0
    return p


UNTRACEABLE = {
    "branch": (lambda p: 350.0 if p > 0.01 else 300.0, ">"),
    "where": (lambda p: torch.where(p > 0.01, p, 2 * p), ">"),
    "sin": (lambda p: 350.0 + torch.sin(p), "sin"),
    "pow_of_variables": (lambda p: 350.0 * (1.0 + p) ** p, r"\*\*"),
    "float": (lambda p: 350.0 + float(p), "float"),
    "too_long": (_long_law, "more than 64 instructions"),
}


@pytest.mark.parametrize("name", sorted(UNTRACEABLE))
def test_untraceable_law_raises_naming_the_operation(name):
    law, what = UNTRACEABLE[name]
    with pytest.raises(TypeError, match=what):
        trace_law(law)
    # the launch keeps the error for the card; the CPU plain version still
    # takes the callable where torch.func can differentiate it
    launch = j2_cuda.J2Launch(tmodels.LinearElasticIsotropic(E, NU), law, factored=False,
                              **j2_cuda.J2_FAST_CONTRACT)
    assert launch.law_id is None and isinstance(launch.law_error, TypeError)
