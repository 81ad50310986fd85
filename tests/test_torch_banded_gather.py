"""The port's banded take against the JAX package, in float64.

- the planners give the JAX planners' arrays on the 16x32 P2 plate's cell,
  fm and asm index sets;
- the plain take equals ``banded_take_xla`` and both interpret-mode Pallas
  kernels (rtol 1e-13: the sums differ only in order);
- slot-wise assembly equals scatter-add, with repeated patch positions;
- the compact lists that the two CUDA kernels walk (sliced ELL and CSR) give
  the same take through their plain version, bitwise equal to each other,
  with each output's entries its kept layers plus its patches;
- kernel selection by ELL padding.
"""

import dataclasses

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


def plate_dofmap(pkg, cell_type="quad"):
    mesh = pkg.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), cell_type)
    V = pkg.FunctionSpace(mesh, degree=2, shape=(2,))
    return np.asarray(V.dofmap), V.num_dofs


def index_sets():
    dm, ndofs = plate_dofmap(tfem)
    jdm_, jndofs = plate_dofmap(jfem)
    np.testing.assert_array_equal(dm, jdm_)
    assert ndofs == jndofs
    return dm, ndofs


def plan_pair(kind, chunk):
    if kind == "asm_overflow":
        (dm, ndofs), (jdm_, _) = (plate_dofmap(pkg, "triangle") for pkg in (tfem, jfem))
        np.testing.assert_array_equal(dm, jdm_)
        args = dict(dofmap=dm, ndofs=ndofs, chunk=chunk, max_R=256, k_quantile=0.01)
        return bg.plan_slotwise_assembly(**args, device="cpu"), jbg.plan_slotwise_assembly(**args)
    dm, ndofs = index_sets()
    if kind == "asm":
        args = (dm, ndofs)
        return (bg.plan_slotwise_assembly(*args, chunk=chunk, max_R=256, device="cpu"),
                jbg.plan_slotwise_assembly(*args, chunk=chunk, max_R=256))
    idx = dm.ravel() if kind == "cell" else dm.T.ravel()
    return (bg.plan_banded_take(idx, ndofs, chunk=chunk, max_R=256, device="cpu"),
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
    plan = bg.plan_slotwise_assembly(V.dofmap, V.num_dofs, chunk=1024, max_R=256, k_quantile=0.01, device="cpu")
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


KINDS = [("cell", 2048), ("fm", 2048), ("asm", 1024), ("asm_overflow", 1024)]


@pytest.mark.parametrize("layout", ["ell", "csr"])
@pytest.mark.parametrize("kind,chunk", KINDS)
def test_compact_take_matches_reference_and_jax(kind, chunk, layout):
    """The kernels' compact lists, walked by their plain version, give the
    windowed take plus patches of the JAX package (asm_overflow: repeated
    patch positions)."""
    tp, jp = plan_pair(kind, chunk)
    table = np.random.default_rng(5).standard_normal(tp.n_src)
    got = bg.compact_take_reference(torch.as_tensor(table), tp, layout).numpy()
    for want in (bg.banded_take_reference(torch.as_tensor(table), tp).numpy(),
                 np.asarray(jbg.banded_take_xla(jnp.asarray(table), jp))):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("kind,chunk", KINDS)
def test_entry_counts_are_kept_layers_plus_patches(kind, chunk):
    """Each output's entries: its kept (slot, layer) pairs and its patches,
    the same in both layouts; the ELL tail of each row is -1."""
    tp, _ = plan_pair(kind, chunk)
    kept = (tp.rloc.reshape(tp.ns, tp.K, tp.C) >= 0).sum(dim=1).reshape(-1)[: tp.n_out]
    want = kept + torch.bincount(tp.patch_pos, minlength=tp.n_out)
    counts = tp.csr_ptr.diff()
    assert torch.equal(counts.long(), want)
    ell = tp.ell_idx.long()
    slices = -(-tp.n_out // bg.WARP)
    assert len(tp.ell_ptr) == slices + 1 and tp.ell_padding == len(ell) / len(tp.csr_idx)
    for s in range(slices):
        rows = ell[tp.ell_ptr[s]: tp.ell_ptr[s + 1]].reshape(-1, bg.WARP).T  # (WARP, width)
        n = counts[s * bg.WARP: (s + 1) * bg.WARP].long()
        live = torch.arange(rows.shape[1])[None, :] < torch.nn.functional.pad(n, (0, bg.WARP - len(n)))[:, None]
        assert bool((rows[live] >= 0).all()) and bool((rows[~live] == -1).all())
    for t in (tp.ell_ptr, tp.ell_idx, tp.csr_ptr, tp.csr_idx):
        assert t.dtype == torch.int32 and t.is_contiguous()


@pytest.mark.parametrize("kind,chunk", KINDS)
def test_ell_and_csr_are_bitwise_equal(kind, chunk):
    """Both layouts add each output's entries in one order."""
    tp, _ = plan_pair(kind, chunk)
    table = torch.as_tensor(np.random.default_rng(6).standard_normal(tp.n_src))
    assert torch.equal(bg.compact_take_reference(table, tp, "ell"), bg.compact_take_reference(table, tp, "csr"))


@pytest.fixture(scope="module")
def plate_domain():
    mesh = tfem.create_rectangle((0.0, 0.0), (1.0, 2.0), (16, 32), "quad")
    V = tfem.FunctionSpace(mesh, degree=2, shape=(2,))
    return V, QuadratureDomain(V, 4, device="cpu")


@pytest.mark.parametrize("key", ["cell", "fm", "asm"])
def test_domain_routes_through_the_banded_take(plate_domain, key):
    """A degree-2 plate keeps all three plans on the CPU too, the gathers
    pick the ELL kernel (one entry per output) and the assembly the CSR one
    (1.78 ELL slots per entry), and its gather (cell), SpMV (fm and asm) and
    assembly (asm) give the dofmap results."""
    V, dom = plate_domain
    assert dom.banded_active and dom._banded["fm"] is not None
    want = bg.banded_take_csr if key == "asm" else bg.banded_take_ell
    assert bg._best_take(dom._banded[key]) is want
    rng = np.random.default_rng(2)
    u = torch.as_tensor(rng.standard_normal(V.num_dofs))
    if key == "cell":
        torch.testing.assert_close(dom.gather(u), u[dom.dofmap], rtol=0, atol=0)
        return
    Ke = torch.as_tensor(rng.standard_normal((dom.ne, dom.ndof_el, dom.ndof_el)))
    ye = torch.einsum("eij,ej->ei", Ke, u[dom.dofmap])
    want = torch.zeros(V.num_dofs, dtype=torch.float64).index_add_(0, dom.dofmap.reshape(-1), ye.reshape(-1))
    got = dom.spmv(dom.spmv_prepare(Ke), u) if key == "fm" else dom.scatter_dofs(ye)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * float(want.abs().max()))


def skewed_plan():
    """One output of 16 entries among 255 of one: its ELL slice is 16 wide."""
    idx = np.full((256, 16), -1)
    idx[:, 0] = np.arange(256)
    idx[0, 1:] = np.arange(1, 16)
    return bg.plan_banded_take(idx, 256, chunk=256, max_R=256, device="cpu")


@pytest.mark.parametrize("kind,want", [
    ("fm", "banded_take_ell"), ("asm", "banded_take_csr"), ("asm_overflow", "banded_take_csr"),
    ("skewed", "banded_take_csr"),
])
def test_best_take_falls_back_to_csr_for_padded_plans(kind, want):
    tp = skewed_plan() if kind == "skewed" else plan_pair(kind, 1024)[0]
    assert (tp.ell_padding <= bg.ELL_MAX_PADDING) == (want == "banded_take_ell")
    assert bg._best_take(tp).__name__ == want


@pytest.mark.parametrize("wrapper", ["banded_take_ell", "banded_take_csr"])
def test_take_wrappers_launch_or_raise_off_cpu(wrapper):
    """A table that is not on the CPU never reaches the plain version: on a
    device other than CUDA the wrapper raises and launches nothing."""
    take = getattr(bg, wrapper)
    tp, _ = plan_pair("asm", 1024)
    before = take.launches
    with pytest.raises(ValueError, match="not on the current CUDA device"):
        take(torch.empty(tp.n_src, dtype=torch.float64, device="meta"), tp)
    with pytest.raises(TypeError, match="unsupported dtype"):
        take(torch.empty(tp.n_src, dtype=torch.int64, device="meta"), tp)
    assert take.launches == before


@pytest.mark.parametrize("kind", ["fm", "asm"])
def test_banded_take_dispatches_to_the_plain_version_on_the_cpu(kind):
    """The public dispatcher on a CPU table is the plain version, bitwise,
    for an ELL-routed and a CSR-routed plan; a plan on another device than
    the table raises and launches nothing."""
    tp, _ = plan_pair(kind, 1024)
    table = torch.as_tensor(np.random.default_rng(0).standard_normal(tp.n_src))
    assert torch.equal(bg.banded_take(table, tp), bg.banded_take_reference(table, tp))
    launches = bg.banded_take_ell.launches + bg.banded_take_csr.launches
    with pytest.raises(ValueError, match="plan on cpu, table on meta"):
        bg.banded_take(torch.empty(tp.n_src, dtype=torch.float64, device="meta"), tp)
    # the plan's device is that of its arrays (no data can be copied to meta)
    meta_plan = dataclasses.replace(tp, rloc=tp.rloc.to("meta"))
    with pytest.raises(ValueError, match="plan on meta, table on cpu"):
        bg.banded_take(table, meta_plan)
    assert bg.banded_take_ell.launches + bg.banded_take_csr.launches == launches
