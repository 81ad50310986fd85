"""The port's banded take against the JAX package, in float64.

- the planners give the JAX planners' arrays on the 16x32 P2 plate's cell,
  fm and asm index sets;
- the plain take equals ``banded_take_xla`` and both interpret-mode Pallas
  kernels (rtol 1e-13: the sums differ only in order);
- slot-wise assembly equals scatter-add, with repeated patch positions.
"""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu.ops import banded_gather as jbg  # noqa: E402

from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch.fem.assembly import QuadratureDomain  # noqa: E402
from dolfinx_materials_tpu_torch.ops import banded_gather as bg  # noqa: E402

# one intra-op thread: the suite runs several pytest workers on one machine,
# and spinning thread pools in each of them starve one another
torch.set_num_threads(1)

RTOL = 1e-13


def plate_dofmap(pkg):
    mesh = pkg.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "quad")
    V = pkg.FunctionSpace(mesh, degree=2, shape=(2,))
    return np.asarray(V.dofmap), V.num_dofs


def index_sets():
    dm, ndofs = plate_dofmap(tfem)
    jdm_, jndofs = plate_dofmap(jfem)
    np.testing.assert_array_equal(dm, jdm_)
    assert ndofs == jndofs
    return dm, ndofs


def plan_pair(kind, chunk):
    dm, ndofs = index_sets()
    if kind == "asm":
        args = (dm, ndofs)
        return (bg.plan_slotwise_assembly(*args, chunk=chunk, max_R=256),
                jbg.plan_slotwise_assembly(*args, chunk=chunk, max_R=256))
    idx = dm.ravel() if kind == "cell" else dm.T.ravel()
    return (bg.plan_banded_take(idx, ndofs, chunk=chunk, max_R=256),
            jbg.plan_banded_take(idx, ndofs, chunk=chunk, max_R=256))


@pytest.mark.parametrize("kind,chunk", [("cell", 2048), ("fm", 2048), ("fm", 512), ("asm", 1024), ("asm", 256)])
def test_planners_match_jax(kind, chunk):
    tp, jp = plan_pair(kind, chunk)
    assert tp is not None and jp is not None
    for f in ("n_out", "n_src", "K", "C", "S", "ns", "R", "nrows", "sub", "frac_patched"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in ("base8", "rloc", "cloc", "nq", "patch_pos", "patch_idx"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    for t in (tp.base8, tp.rloc, tp.cloc, tp.nq):
        assert t.is_contiguous() and t.dtype == torch.int32


@pytest.mark.parametrize("kind,chunk", [("cell", 2048), ("fm", 2048), ("asm", 1024)])
def test_plain_take_matches_jax_kernels(kind, chunk):
    tp, jp = plan_pair(kind, chunk)
    table = np.random.default_rng(0).standard_normal(tp.n_src)
    got = bg.banded_take_reference(torch.as_tensor(table), tp).numpy()
    jt = jnp.asarray(table)
    for want in (
        jbg.banded_take_xla(jt, jp),
        jbg.make_banded_take(jp, jnp.float64, interpret=True)(jt),
        jbg.make_banded_take_vmem(jp, jnp.float64, interpret=True)(jt),
    ):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=RTOL * np.abs(got).max())


def overflow_plan():
    """Assembly plan of a P2 triangle plate where a vertex is slot i of one or
    two cells: a low ``k_quantile`` spills the second occurrences into the
    patch list, with repeated positions."""
    mesh = tfem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "triangle")
    V = tfem.FunctionSpace(mesh, degree=2, shape=(2,))
    plan = bg.plan_slotwise_assembly(V.dofmap, V.num_dofs, chunk=1024, max_R=256, k_quantile=0.01)
    return V.dofmap, V.num_dofs, plan


def test_slotwise_assembly_equals_scatter_add():
    """Assembly-as-gather over feature-major element values equals a
    scatter-add, including max-valence dofs whose overflow goes to patches
    with repeated positions (applied layer by layer, deterministically)."""
    dm, ndofs, plan = overflow_plan()
    pos = plan.patch_pos.numpy()
    assert len(pos) > len(np.unique(pos)), "the plan must carry repeated patch positions"
    for lpos, _ in plan.patch_layers:
        assert len(lpos) == len(torch.unique(lpos))
    vals = np.random.default_rng(1).standard_normal(dm.T.shape)  # (nd, ne)
    want = np.zeros(ndofs)
    np.add.at(want, dm.ravel(), vals.T.ravel())
    got = bg.banded_take_reference(torch.as_tensor(vals.ravel()), plan).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_domain_routes_through_the_banded_take():
    """A degree-2 plate keeps all three plans on the CPU too, and its
    gather/assembly/SpMV give the dofmap results."""
    mesh = tfem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "quad")
    V = tfem.FunctionSpace(mesh, degree=2, shape=(2,))
    dom = QuadratureDomain(V, 4)
    assert dom.banded_active and dom._banded["fm"] is not None
    assert {bg._best_take(p, torch.float64) for p in dom._banded.values()} == {bg.banded_take_windowed}
    rng = np.random.default_rng(2)
    u = torch.as_tensor(rng.standard_normal(V.num_dofs))
    torch.testing.assert_close(dom.gather(u), u[dom.dofmap], rtol=0, atol=0)
    Ke = torch.as_tensor(rng.standard_normal((dom.ne, dom.ndof_el, dom.ndof_el)))
    ye = torch.einsum("eij,ej->ei", Ke, u[dom.dofmap])
    want = torch.zeros(V.num_dofs, dtype=torch.float64).index_add_(0, dom.dofmap.reshape(-1), ye.reshape(-1))
    torch.testing.assert_close(dom.spmv(dom.spmv_prepare(Ke), u), want, rtol=RTOL, atol=RTOL * float(want.abs().max()))


def test_best_take_falls_back_to_streaming_for_wide_windows():
    tp, _ = plan_pair("fm", 2048)
    assert bg._best_take(tp, torch.float64) is bg.banded_take_windowed
    tp.max_nq = bg.SMEM_WINDOW_BYTES // (tp.sub * bg.LANE * 8) + 1
    assert bg._best_take(tp, torch.float64) is bg.banded_take_streaming
