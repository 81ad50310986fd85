"""The port's constructors and planners default to the card: without
``device`` on a machine without one they raise ``resolve_device``'s
``RuntimeError`` and build nothing on the CPU; with ``device="cpu"`` they
build on the CPU the tensors the JAX package builds (its state managers,
quadrature domain and banded plans) or, for what has no JAX counterpart (the
fixed-order sum's CSR lists, the reference-array converters), the tensors
numpy gives."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu import state as jstate  # noqa: E402
from dolfinx_materials_tpu.fem.assembly import QuadratureDomain as JDomain  # noqa: E402
from dolfinx_materials_tpu.ops import banded_gather as jbg  # noqa: E402

from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch import state as tstate  # noqa: E402
from dolfinx_materials_tpu_torch.fem.assembly import QuadratureDomain as TDomain  # noqa: E402
from dolfinx_materials_tpu_torch.ops import banded_gather as bg  # noqa: E402

torch.set_num_threads(1)

NPTS = 11


def behaviors():
    el, law = (70e3, 0.3), (350.0, 500.0, 1e3)
    return (jmodels.vonMisesIsotropicHardening(jmodels.LinearElasticIsotropic(*el), jmodels.VoceHardening(*law)),
            tmodels.vonMisesIsotropicHardening(tmodels.LinearElasticIsotropic(*el), tmodels.VoceHardening(*law)))


def plate(fem):
    """A 16x32 P2 plate: its domain takes the banded route."""
    return fem.FunctionSpace(fem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "quad"), 2, (2,))


def same_state(t, j):
    np.testing.assert_array_equal(t.gradients.numpy(), np.asarray(j.gradients))
    np.testing.assert_array_equal(t.fluxes.numpy(), np.asarray(j.fluxes))
    assert set(t.internal) == set(j.internal)
    for k, v in t.internal.items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(j.internal[k]))


def check_state_manager(device):
    jbeh, tbeh = behaviors()
    t = tstate.MaterialStateManager(tbeh, NPTS, device=device)
    same_state(t, jstate.MaterialStateManager(jbeh, NPTS, jnp.float64))


def check_data_manager(device):
    jbeh, tbeh = behaviors()
    t, j = tstate.DataManager(tbeh, NPTS, device=device), jstate.DataManager(jbeh, NPTS, jnp.float64)
    same_state(t.s0, j.s0)
    same_state(t.s1, j.s1)


def reference_values():
    return np.random.default_rng(0).normal(size=(NPTS, 6))


def check_reference_array(device):
    a = reference_values()
    t = tstate.from_reference_array(a, device=device)
    assert t.device.type == "cpu" and t.dtype == torch.float64
    np.testing.assert_array_equal(t.numpy(), a)


def check_reference_state(device):
    a = {"p": reference_values()[:, 0], "eps_p": reference_values()}
    t = tstate.from_reference_state(a, device=device)
    assert set(t) == set(a)
    for k, v in t.items():
        assert v.device.type == "cpu" and v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), a[k])


def check_quadrature_domain(device):
    t, j = TDomain(plate(tfem), 4, device=device), JDomain(plate(jfem), 4)
    assert t.device.type == "cpu" and t.banded_active
    for name in ("dNdx", "wdetJ", "x_q", "dofmap"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), rtol=1e-14, atol=1e-14,
                                   err_msg=name)
    for key, plan in t._banded.items():
        assert plan is None or plan.base8.device.type == "cpu", key


def same_plan(t, j):
    for f in ("n_out", "n_src", "K", "C", "S", "ns", "R", "nrows", "sub", "frac_patched"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("base8", "rloc", "cloc", "nq", "patch_pos", "patch_idx"):
        assert getattr(t, f).device.type == "cpu"
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


def check_banded_take(device):
    V = plate(tfem)
    idx = V.dofmap.ravel()
    same_plan(bg.plan_banded_take(idx, V.num_dofs, chunk=2048, max_R=256, device=device),
              jbg.plan_banded_take(idx, V.num_dofs, chunk=2048, max_R=256))


def check_slotwise_assembly(device):
    V = plate(tfem)
    same_plan(bg.plan_slotwise_assembly(V.dofmap, V.num_dofs, chunk=1024, max_R=256, device=device),
              jbg.plan_slotwise_assembly(V.dofmap, V.num_dofs, chunk=1024, max_R=256))


def check_fixed_sum(device):
    rng = np.random.default_rng(1)
    target = rng.integers(0, 50, (40, 30))
    plan = bg.plan_fixed_sum(target, 60, device=device)
    flat = target.reshape(-1)
    assert plan.csr_ptr.device.type == "cpu" and plan.csr_ptr.dtype == torch.int32
    np.testing.assert_array_equal(plan.csr_ptr.numpy(), np.r_[0, np.cumsum(np.bincount(flat, minlength=60))])
    np.testing.assert_array_equal(plan.csr_idx.numpy(), np.argsort(flat, kind="stable"))
    vals = rng.standard_normal(flat.size)
    want = np.zeros(60)
    np.add.at(want, flat, vals)
    np.testing.assert_allclose(bg.fixed_sum(torch.as_tensor(vals), plan).numpy(), want, rtol=1e-14, atol=1e-14)


CASES = {
    "MaterialStateManager": check_state_manager,
    "DataManager": check_data_manager,
    "from_reference_array": check_reference_array,
    "from_reference_state": check_reference_state,
    "QuadratureDomain": check_quadrature_domain,
    "plan_banded_take": check_banded_take,
    "plan_slotwise_assembly": check_slotwise_assembly,
    "plan_fixed_sum": check_fixed_sum,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_defaults_to_the_card(name, monkeypatch):
    """Without ``device`` and without a card each raises resolve_device's
    RuntimeError; with ``device="cpu"`` each builds what it built before."""
    check = CASES[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        check(None)
    check("cpu")
