"""Does the composite's u depend on the precision of its tangent and CG when
the step is solved to rtol 1e-8? Both packages, on the CPU in float64.

The composite (Ogden matrix, SVK inclusions at E_pen = 1e12, P2 tets) at
cfg (1, 1, 2) and the options of ``tests/test_torch_composite.py`` (30 Newton
x 300 CG, rtol 1e-8, cg_rtol 1e-3, rigid-body coarse modes split by
material): its first load step from u = 0, solved twice by the fused step,
with ``precision="mixed"`` (f32 deformation-gradient tangents and CG on the
scaled operator, the demos' setting) and with ``precision="same"`` (all
f64). The load is u_x = 0.02 on the right face, the first step of
``chip_smoke.py``'s ``[ogden-cpu]`` composite solved to rtol 1e-8, where the
port's H100 run and its CPU run end 2.21e-5 of max |u| apart. Each
package's step is built from its own demo's ``build``; only ``precision``
differs.

At this contrast the relative residual does not bound u. In each package
the two solves end ~1e-5 of max |u| apart (JAX 1.80e-5, the port 1.25e-5),
far more than the 1e-8 they were asked for and of the order of the port's
card-against-CPU spread: a property of the problem that both packages
share, not a fault of the port.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu.fem.bc import combine_bcs as jcombine  # noqa: E402
from dolfinx_materials_tpu.parallel import device_mesh as jdevice_mesh  # noqa: E402
from dolfinx_materials_tpu.parallel import make_sharded_newton_step_general as jstep  # noqa: E402

from dolfinx_materials_tpu_torch.demos import composite_hyperelasticity  # noqa: E402
from dolfinx_materials_tpu_torch.fem.bc import combine_bcs  # noqa: E402
from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step_general  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
CFG, EXX = (1, 1, 2), 0.02
OPTS = dict(n_newton=30, n_cg=300, rtol=1e-8, cg_rtol=1e-3, coarse_modes="rbm", agg_split_materials=True,
            return_info=True)
PRECISIONS = ("mixed", "same")


def jax_first_step():
    """``{precision: (u, |R| / |R0|)}`` of the JAX demo's step."""
    spec = importlib.util.spec_from_file_location("composite_hyperelasticity_tpu",
                                                  REPO / "demos" / "composite_hyperelasticity_tpu.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    _, V, mats, _, bcs, bc_rx, prob = demo.build(CFG)
    bc_rx.set(EXX)
    mask, vals = (jnp.asarray(a) for a in jcombine(bcs, V.num_dofs))
    out = {}
    for precision in PRECISIONS:
        step, _ = jstep(prob, jdevice_mesh(1), precision=precision, **OPTS)
        st = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), m.data_manager.s0.internal) for m in mats]
        u, _, rn, rn0 = step(jnp.zeros(V.num_dofs, jnp.float64), st, mask, vals.astype(jnp.float64), 0.0)
        out[precision] = (np.asarray(u), float(rn) / float(rn0))
    return out


def port_first_step():
    """``{precision: (u, |R| / |R0|, Newton count)}`` of the port's step."""
    _, V, mats, _, bcs, bc_rx, prob = composite_hyperelasticity.build(CFG, device="cpu")
    bc_rx.set(EXX)
    mask, vals = combine_bcs(bcs, V.num_dofs)
    out = {}
    for precision in PRECISIONS:
        step, _ = make_sharded_newton_step_general(prob, device_mesh(1, devices=["cpu"]), precision=precision,
                                                   **OPTS)
        u, _, rn, rn0 = step(torch.zeros(V.num_dofs, dtype=torch.float64), [m.data_manager.s0.internal for m in mats],
                             mask, vals, 0.0)
        out[precision] = (u.numpy(), float(rn) / float(rn0), int(step.info["newton"]))
    return out


def spread(out):
    """max |u_mixed - u_same| over max |u_same|."""
    return np.abs(out["mixed"][0] - out["same"][0]).max() / np.abs(out["same"][0]).max()


def test_mixed_and_same_precision_spread_is_shared_by_both_packages():
    """Every solve meets rtol 1e-8; in each package the mixed and the f64
    solve end more than 1e-6 of max |u| apart (the line between a
    property of the problem and a fault of the port), and the port's spread
    is within a factor 10 of the JAX package's. The port's mixed and f64
    solves take the same Newton count."""
    jx, pt = jax_first_step(), port_first_step()
    for out in (jx, pt):
        for precision in PRECISIONS:
            assert out[precision][1] <= 1e-8, (precision, out[precision][1])
    assert pt["mixed"][2] == pt["same"][2]
    s_jax, s_port = spread(jx), spread(pt)
    assert s_jax > 1e-6 and s_port > 1e-6, (s_jax, s_port)
    assert 0.1 < s_port / s_jax < 10, (s_jax, s_port)
