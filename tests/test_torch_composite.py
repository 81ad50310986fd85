"""The port's composite demo (``demos.composite_hyperelasticity``: Ogden
matrix, SVK inclusions at E_pen = 1e12, P2 tets, the mixed fused step with
rigid-body coarse modes split by material) against the JAX package's
``demos/composite_hyperelasticity_tpu.py``, in float64 on the CPU."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dolfinx_materials_tpu_torch.demos import composite_hyperelasticity  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent


def test_composite_protocol_matches_jax():
    """``run_10_steps`` of both packages at cfg (1, 1, 2) in 3 load steps to
    20 % stretch (480 tets, 3,111 dofs): every step's relative residual <=
    1e-8 in both, u to 1e-6 of its largest entry. The steps are solved to
    rtol 1e-8 (30 Newton x 300 CG, the protocol's cg_rtol 1e-3): at the
    protocol's rtol 1e-4 the two packages' steps end inside the tolerance
    at iterates 1.4e-3 apart, which says nothing of either."""
    opts = dict(n_newton=30, n_cg=300, rtol=1e-8, cg_rtol=1e-3, n_steps=3)
    u, _, stats = composite_hyperelasticity.run_10_steps((1, 1, 2), runs=1, device="cpu", **opts)
    rel = np.array([s["res"] / s["res0"] for s in stats])
    spec = importlib.util.spec_from_file_location("composite_hyperelasticity_tpu",
                                                  REPO / "demos" / "composite_hyperelasticity_tpu.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    uj, _, (rns, rn0s), _ = demo.run_10_steps(cfg=(1, 1, 2), quiet=True, **opts)
    assert (rel <= 1e-8).all(), rel
    assert (np.asarray(rns) / np.asarray(rn0s) <= 1e-8).all()
    uj = np.asarray(uj)
    np.testing.assert_allclose(u.numpy(), uj, rtol=0, atol=1e-6 * np.abs(uj).max())
