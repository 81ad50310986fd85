"""Continuous L2 projections, the scalar integral and ``project_on`` of
dolfinx_materials_tpu_torch against the JAX package, on the CPU in float64:
``project_cg`` onto P1 and P2 with and without the Helmholtz filter (the
target domain on its stencil, gather-map or banded route), ``assemble_scalar``
and ``project_on`` with prefix collection, to 1e-10 of the field's scale."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import Material as JMaterial  # noqa: E402
from dolfinx_materials_tpu import QuadratureMap as JQuadratureMap  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu.fem import assembly as jasm  # noqa: E402
from dolfinx_materials_tpu.fem.forms import mandel_strain_2d as jstrain  # noqa: E402
from dolfinx_materials_tpu.models.base import SmallStrainBehavior as JBehavior  # noqa: E402
from dolfinx_materials_tpu.ops import tensors as jtensors  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch.fem import assembly as tasm  # noqa: E402
from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d as tstrain  # noqa: E402
from dolfinx_materials_tpu_torch.models.base import SmallStrainBehavior as TBehavior  # noqa: E402
from dolfinx_materials_tpu_torch.ops import tensors as ttensors  # noqa: E402

torch.set_num_threads(1)


def polar(x):
    r, th = x[:, 0], x[:, 1]
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=1)


# name -> mesh builder on a fem module
MESHES = {
    "quad": lambda f: f.create_rectangle((0, 0), (1, 2), (4, 6), "quad"),
    "triangle": lambda f: f.create_rectangle((0, 0), (1, 2), (3, 4), "triangle"),
    "annulus_curved": lambda f: f.curve_mesh(f.create_rectangle((1.0, 0.0), (2.0, np.pi / 2), (3, 4), "quad"), polar),
    # 32 x 32 P2 target: 9,216 element dofs, the banded take route
    "quad_banded": lambda f: f.create_rectangle((0, 0), (1, 1), (32, 32), "quad"),
}


def domains(name, quad_degree=4):
    jV = jfem.FunctionSpace(MESHES[name](jfem), 2, (2,))
    tV = tfem.FunctionSpace(MESHES[name](tfem), 2, (2,))
    return jasm.QuadratureDomain(jV, quad_degree), tasm.QuadratureDomain(tV, quad_degree, device="cpu")


def field(dom, k=3):
    x = dom.x_q.reshape(-1, dom.x_q.shape[-1]).numpy()
    cols = [np.sin(3 * x[:, 0]) * x[:, 1], x[:, 0] ** 2 - 0.5 * x[:, 1], np.cos(2 * x[:, 1]) + x[:, 0]]
    noise = 0.05 * np.random.default_rng(1).normal(size=(len(x), k))
    return np.stack(cols[:k], axis=1) + noise


def close(got, want, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{err:.2e}"


@pytest.mark.parametrize("smooth", [None, 0.1])
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("name", ["quad", "triangle", "annulus_curved"])
def test_project_cg_matches_jax(name, degree, smooth):
    jd, td = domains(name)
    vals = field(td)
    jspace, want = jasm.project_cg(jd, jnp.asarray(vals), degree=degree, smooth=smooth)
    tspace, got = tasm.project_cg(td, torch.as_tensor(vals), degree=degree, smooth=smooth)
    assert got.shape == (tspace.num_dofs, 3) == want.shape
    np.testing.assert_array_equal(tspace.node_coords, jspace.node_coords)
    close(got, want)


def test_project_cg_on_the_banded_route_matches_jax():
    jd, td = domains("quad_banded", quad_degree=2)
    vals = field(td, k=1)
    _, want = jasm.project_cg(jd, jnp.asarray(vals), degree=2)
    tspace, got = tasm.project_cg(td, torch.as_tensor(vals), degree=2)
    assert tasm.QuadratureDomain(tspace, 2, td.cells, device="cpu").banded_active
    close(got, want)


def test_project_cg_reproduces_a_linear_field():
    _, td = domains("triangle")
    x = td.x_q.reshape(-1, 2).numpy()
    vals = np.stack([1.0 + 2.0 * x[:, 0] - x[:, 1], 3.0 * x[:, 1]], axis=1)
    space, out = tasm.project_cg(td, vals, degree=1)
    xn = space.node_coords
    np.testing.assert_allclose(out, np.stack([1.0 + 2.0 * xn[:, 0] - xn[:, 1], 3.0 * xn[:, 1]], axis=1),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_assemble_scalar_matches_jax(name):
    jd, td = domains(name)
    vals = field(td, k=1)[:, 0]
    close(float(tasm.assemble_scalar(td, vals)), float(jasm.assemble_scalar(jd, jnp.asarray(vals))), tol=1e-13)
    close(float(tasm.assemble_scalar(td, 2.5)), float(jasm.assemble_scalar(jd, 2.5)), tol=1e-13)


def _flattened(base, tensors_mod, xp):
    """An elastic behavior with flattened scalar internal variables q0, q1,
    q2 and one more, ``other``."""

    class Flattened(base):
        def __init__(self):
            self.C = tensors_mod.isotropic_C(70e3, 0.3)

        def init_state(self):
            return {"q0": np.zeros(()), "q1": np.zeros(()), "q2": np.zeros(()), "other": np.zeros(())}

        def small_strain_update(self, eps, state, dt):
            sig = xp.asarray(self.C, dtype=eps.dtype) @ eps
            return sig, {"q0": eps[0], "q1": 2.0 * eps[0] + eps[1], "q2": 3.0 * eps[0] * eps[1], "other": eps[1]}

    return Flattened()


def _qmaps():
    rng = np.random.default_rng(2)
    jmat = JMaterial(_flattened(JBehavior, jtensors, jnp))
    tmat = tdm.Material(_flattened(TBehavior, ttensors, torch), device="cpu")
    jq = JQuadratureMap(jfem.FunctionSpace(MESHES["quad"](jfem), 1, (2,)), 2, jmat)
    tq = tdm.QuadratureMap(tfem.FunctionSpace(MESHES["quad"](tfem), 1, (2,)), 2, tmat)
    jq.register_gradient("Strain", jstrain())
    tq.register_gradient("Strain", tstrain())
    eps = 1e-3 * rng.normal(size=(tq.num_points, 6))
    jmat.integrate(jnp.asarray(eps))
    tmat.integrate(eps)
    return jq, tq


@pytest.mark.parametrize("kind", [("DG", 0), ("CG", 1), ("P", 2)])
def test_project_on_prefix_matches_jax(kind):
    jq, tq = _qmaps()
    for name, width in (("q", 3), ("other", 1), ("Stress", 6)):
        want, got = jq.project_on(name, kind), tq.project_on(name, kind)
        if kind[0] != "DG":
            want, got = want[1], got[1]
        assert isinstance(got, np.ndarray) and got.shape[-1] == width
        close(got, want)
    _, got = tq.project_on("q", ("CG", 1), smooth=0.2)
    _, want = jq.project_on("q", ("CG", 1), smooth=0.2)
    close(got, want)
    with pytest.raises(KeyError, match="nope"):
        tq.project_on("nope")
    with pytest.raises(NotImplementedError):
        tq.project_on("q", ("DG", 1))
