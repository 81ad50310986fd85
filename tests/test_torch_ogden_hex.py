"""The port's P1-hex Ogden block in float32 (``demos.ogden_block``,
``make_sharded_newton_step`` on the 3D stencil) against the JAX package's
protocol of ``demos/ogden_block_tpu.py`` at N = 3, on the CPU."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import NonlinearMaterialProblem as JProblem  # noqa: E402
from dolfinx_materials_tpu.fem import Function as JFunction  # noqa: E402
from dolfinx_materials_tpu.fem.bc import combine_bcs as jcombine  # noqa: E402
from dolfinx_materials_tpu.parallel import device_mesh as jdevice_mesh  # noqa: E402
from dolfinx_materials_tpu.parallel import make_sharded_newton_step as jstep  # noqa: E402

from dolfinx_materials_tpu_torch.demos import ogden_block  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
N, STEPS = 3, 3


def jax_hex_steps(n_steps):
    """The first ``n_steps`` of the JAX demo's f32 hex protocol: its
    ``build``, fused step and loads, and the body of its ``run_10_steps``
    scan (secant predictor, explicit float32 whatever the x64 setting) as a
    Python loop."""
    spec = importlib.util.spec_from_file_location("ogden_block_tpu", REPO / "demos" / "ogden_block_tpu.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    mat, qmap, V, bcs, bc_top = demo.build(N, "hexahedron", 1)
    prob = JProblem(qmap, JFunction(V), bcs=bcs)
    step, _ = jstep(qmap, prob, jdevice_mesh(1), n_newton=20, n_cg=150, rtol=2e-5)
    mask = jnp.asarray(jcombine(bcs, V.num_dofs)[0])
    st = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), mat.data_manager.s0.internal)
    u = u_prev = jnp.zeros(V.num_dofs, jnp.float32)
    for ez in np.linspace(0, 0.2, 11)[1:n_steps + 1]:
        bc_top.set(-float(ez))
        vals = jnp.asarray(jcombine(bcs, V.num_dofs)[1], jnp.float32)
        un, st, rn = step(u + (u - u_prev), st, mask, vals, 0.0)
        assert np.isfinite(float(rn))
        u_prev, u = u, un
    return np.asarray(u)


def test_hex_p1_f32_protocol_matches_jax():
    """3 steps (to 6 % compression) of the N = 3 P1-hex block (27 hexes, 192
    dofs), float32, 20 Newton x 150 CG, rtol 2e-5: u in float32 to 1e-5 of
    its largest entry (the two packages' f32 runs differ by 2.1e-6, x64 off,
    and 1.4e-6, x64 on), every step of the port within 3e-3 of its entering
    residual (the f32 floor: steps end on the Newton budget)."""
    proto = ogden_block.make_protocol(N, "hexahedron", 1, "f32", device="cpu")
    assert proto["qmap"].domain._stencil is not None
    u, stats = ogden_block.run_steps(proto, STEPS)
    assert u.dtype == torch.float32
    rel = np.array([s["res"] / s["res0"] for s in stats])
    assert (rel <= 3e-3).all(), rel
    uj = jax_hex_steps(STEPS)
    assert uj.dtype == np.float32
    np.testing.assert_allclose(u.numpy(), uj, rtol=0, atol=1e-5 * np.abs(uj).max())
