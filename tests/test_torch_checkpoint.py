"""The port's checkpoints (``dolfinx_materials_tpu_torch.checkpoint``): the
round trip inside the port, and files crossing between the two packages
(the same ``.npz`` keys), restored bitwise into s0 and s1, in float64 on
the CPU.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("dolfinx_materials_tpu")
import dolfinx_materials_tpu as jdm  # noqa: E402
from dolfinx_materials_tpu import checkpoint as jckpt  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.fem import forms as jforms  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import checkpoint as tckpt  # noqa: E402
from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.fem import forms as tforms  # noqa: E402

torch.set_num_threads(1)

PKGS = {
    "torch": (tdm, tfem, tmodels, tforms, dict(device="cpu")),
    "jax": (jdm, jfem, jmodels, jforms, {}),
}


def plate(which, n=3, exx=3 * 350.0 / 70e3):
    """A J2 plate (Voce hardening) pulled to ``exx`` (by default into the
    plastic range) by one solve: ``(qmap, u)`` with the committed state."""
    pkg, fem, m, forms, kw = PKGS[which]
    V = fem.FunctionSpace(fem.create_unit_square(n, n, "quad"), 1, (2,))
    mat = pkg.Material(m.vonMisesIsotropicHardening(m.LinearElasticIsotropic(70e3, 0.3),
                                                    m.VoceHardening(350.0, 500.0, 1e3)), **kw)
    q = pkg.QuadratureMap(V, 2, mat)
    q.register_gradient("Strain", forms.mandel_strain_2d())
    left = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0), 0)
    bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0), 1)
    right = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1), 0)
    u = fem.Function(V)
    prob = pkg.NonlinearMaterialProblem(q, u, bcs=[fem.DirichletBC(left, 0.0), fem.DirichletBC(bottom, 0.0),
                                                   fem.DirichletBC(right, exx)], options={"ksp_type": "lu"})
    assert prob.solve()[0]
    return q, u


def columns(qmap, buf):
    """Every array a checkpoint restores, as numpy, keyed as in the file."""
    s = getattr(qmap.material.data_manager, buf)
    out = {"__gradients__": np.asarray(s.gradients), "__fluxes__": np.asarray(s.fluxes)}
    out.update({f"isv::{k}": np.asarray(v) for k, v in s.internal.items()})
    return out


def assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_round_trip_inside_the_port(tmp_path):
    q, u = plate("torch")
    saved = columns(q, "s0")
    assert saved["isv::p"].max() > 0
    tckpt.save_state(tmp_path / "c.npz", q, extra={"u": u.x, "t": torch.tensor([0.5])})
    q2, _ = plate("torch", exx=1e-4)  # an elastic state to overwrite
    extra = tckpt.load_state(tmp_path / "c.npz", q2)
    for buf in ("s0", "s1"):
        assert_bitwise(columns(q2, buf), saved)
    np.testing.assert_array_equal(extra["u"], u.x)
    np.testing.assert_array_equal(extra["t"], [0.5])
    assert set(np.load(tmp_path / "c.npz").files) == {
        "__gradients__", "__fluxes__", "__cells__", "extra::u", "extra::t", *(f"isv::{k}" for k in
                                                                              q.material.data_manager.s0.internal)}


def test_mismatched_checkpoint_is_refused(tmp_path):
    q, _ = plate("torch")
    tckpt.save_state(tmp_path / "c.npz", q)
    q_other, _ = plate("torch", n=2)
    with pytest.raises(ValueError, match="Gauss points"):
        tckpt.load_state(tmp_path / "c.npz", q_other)
    data = dict(np.load(tmp_path / "c.npz"))
    data["isv::p"] = data["isv::p"][:, None, None]
    np.savez(tmp_path / "bad.npz", **data)
    with pytest.raises(ValueError, match="ISV 'p'"):
        tckpt.load_state(tmp_path / "bad.npz", q)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    """A file written by one package restores into the other with s0 and s1
    bitwise equal to the writer's s0, extras included; the two packages'
    own plastic states agree to 1e-8 as well."""
    reader = "torch" if writer == "jax" else "jax"
    q_w, u_w = plate(writer)
    assert np.asarray(q_w.material.data_manager.s0["p"]).max() > 0
    save, load = (jckpt.save_state, tckpt.load_state) if writer == "jax" else (tckpt.save_state, jckpt.load_state)
    save(tmp_path / "c.npz", q_w, extra={"u": u_w.x})
    q_r, u_r = plate(reader)
    own = columns(q_r, "s0")
    extra = load(tmp_path / "c.npz", q_r)
    written = columns(q_w, "s0")
    for buf in ("s0", "s1"):
        assert_bitwise(columns(q_r, buf), written)
    np.testing.assert_array_equal(extra["u"], u_w.x)
    for k, v in own.items():
        np.testing.assert_allclose(v, written[k], rtol=0, atol=1e-8 * max(np.abs(written[k]).max(), 1e-30))
