"""The aggregate coarse correction's plan and plain versions
(``ops/coarse_correction.py``) on the CPU, float32 and float64:

- :func:`plan_aggregates` lists every dof in exactly one aggregate,
  ascending, in the aggregate of its node;
- the plain restriction and prolongation on those lists give the bits of the
  padded ``gather_map`` route the fused step ran before the kernels, with the
  mask, the scaling and the add to z;
- the wrappers take the plain version for CPU tensors and launch nothing.

The kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from dolfinx_materials_tpu_torch import fem
from dolfinx_materials_tpu_torch.ops import coarse_correction as cc
from dolfinx_materials_tpu_torch.ops.banded_gather import gather_map
from dolfinx_materials_tpu_torch.parallel.coarse import _coord_agg_modes

CASES = [("trans", False), ("rbm", False), ("trans", True)]


def p2_rectangle(n=(6, 10)):
    """A small P2 rectangle (spatially renumbered nodes, as the plate's)."""
    return fem.FunctionSpace(fem.create_rectangle((0.0, 0.0), (1.0, 2.0), n, "quad"), 2, (2,))


def aggregates(V, modes, labelled, pc_boxes=3):
    labels = None
    if labelled:  # two materials split by a line off the boxes' edges
        labels = (V.node_coords[:, 0] + 0.3 * V.node_coords[:, 1] > 0.7).astype(np.int64)
    return _coord_agg_modes(V, pc_boxes, modes=modes, labels=labels)


def operands(V, ncoarse, dtype, seed=0):
    """Seeded r, z, s_inv, a mask on about a fifth of the dofs and an SPD
    ``Ac_inv``, in ``dtype``."""
    rng = np.random.default_rng(seed)
    n = V.num_dofs
    G = rng.standard_normal((ncoarse, ncoarse))
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return dict(r=t(rng.standard_normal(n)), z=t(rng.standard_normal(n)), s_inv=t(rng.uniform(0.5, 2.0, n)),
                mask=torch.as_tensor(rng.random(n) < 0.2), Ac_inv=t(G @ G.T / ncoarse + np.eye(ncoarse)))


def gather_map_route(agg_np, W, nc, r, z, mask, s_inv, Ac_inv):
    """The fused step's coarse correction as it ran before the kernels:
    ``restrict_map`` from ``gather_map``, ``agg_node`` straight from the
    aggregates."""
    nmodes = W.shape[2]
    ncoarse = int(agg_np.max() + 1) * nmodes
    agg_node = torch.as_tensor(agg_np, dtype=torch.int64)
    restrict_target = agg_np[:, None].astype(np.int64) * nmodes + np.arange(nmodes)[None, :]
    restrict_map = torch.as_tensor(gather_map(restrict_target, ncoarse))
    zero = torch.zeros((), dtype=r.dtype)
    r0 = torch.where(mask, zero, r)
    if s_inv is not None:
        r0 = r0 * s_inv
    rn = r0.reshape(-1, nc)
    rc = torch.cat([(rn[:, :, None] * W).sum(dim=1).reshape(-1), r0.new_zeros(1)])[restrict_map].sum(dim=1)
    wc = Ac_inv @ rc
    corr = (W * wc.reshape(-1, W.shape[2])[agg_node][:, None, :]).sum(dim=2).reshape(-1)
    if s_inv is not None:
        corr = corr * s_inv
    return rc, z + torch.where(mask, zero, corr)


@pytest.mark.parametrize("modes,labelled", CASES)
def test_every_dof_in_exactly_one_aggregate_list(modes, labelled):
    V = p2_rectangle()
    ncoarse, agg_np, W_np = aggregates(V, modes, labelled)
    nc, nmodes = V.ncomp, W_np.shape[2]
    plan = cc.plan_aggregates(agg_np, nc, nmodes, device="cpu")
    ptr, dofs = plan.agg_ptr.numpy(), plan.agg_dofs.numpy()
    assert plan.agg_ptr.dtype == plan.agg_dofs.dtype == torch.int32
    assert plan.ncoarse == ncoarse and plan.ndofs == V.num_dofs and ptr[0] == 0 and ptr[-1] == V.num_dofs
    assert np.array_equal(np.sort(dofs), np.arange(V.num_dofs))  # each dof once
    for a in range(plan.nagg):
        lst = dofs[ptr[a]:ptr[a + 1]]
        assert len(lst) > 0 and np.all(np.diff(lst) > 0)
        assert np.all(agg_np[lst // nc] == a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("modes,labelled", CASES)
@pytest.mark.parametrize("scaled", [False, True])
def test_plain_csr_route_is_the_gather_map_route(dtype, modes, labelled, scaled):
    """Restriction, then prolongation with the mask, the scaling and the add
    to z: the plain versions on the plan's lists give the old route's bits."""
    V = p2_rectangle()
    ncoarse, agg_np, W_np = aggregates(V, modes, labelled)
    W = torch.as_tensor(W_np).to(dtype)
    ops = operands(V, ncoarse, dtype)
    s_inv = ops["s_inv"] if scaled else None
    plan = cc.plan_aggregates(agg_np, V.ncomp, W_np.shape[2], device="cpu")
    rc = cc.coarse_restrict(ops["r"], plan, W, ops["mask"], s_inv)
    z = cc.coarse_prolong(rc, ops["Ac_inv"], plan, W, ops["z"], ops["mask"], s_inv)
    rc_old, z_old = gather_map_route(agg_np, W, V.ncomp, ops["r"], ops["z"], ops["mask"], s_inv, ops["Ac_inv"])
    assert torch.equal(rc, rc_old) and torch.equal(z, z_old)
    assert rc.dtype == z.dtype == dtype


def test_unmasked_unscaled_prolongation_without_z():
    """The split-dof route's calls (no mask, no scaling, no z): the plain
    prolongation is ``P Ac_inv rc`` and leaves masked dofs alone."""
    V = p2_rectangle()
    ncoarse, agg_np, W_np = aggregates(V, "rbm", False)
    W = torch.as_tensor(W_np).double()
    ops = operands(V, ncoarse, torch.float64, seed=1)
    plan = cc.plan_aggregates(agg_np, V.ncomp, W_np.shape[2], device="cpu")
    rc = cc.coarse_restrict(ops["r"], plan, W)
    corr = cc.coarse_prolong(rc, ops["Ac_inv"], plan, W)
    P = np.zeros((V.num_dofs, ncoarse))  # the dense prolongation
    for n, a in enumerate(agg_np):
        P[n * V.ncomp:(n + 1) * V.ncomp, a * W_np.shape[2]:(a + 1) * W_np.shape[2]] = W_np[n]
    np.testing.assert_allclose(rc.numpy(), P.T @ ops["r"].numpy(), rtol=0, atol=1e-12 * np.abs(rc.numpy()).max())
    want = P @ (ops["Ac_inv"].numpy() @ rc.numpy())
    np.testing.assert_allclose(corr.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_cpu_wrappers_launch_nothing():
    V = p2_rectangle((4, 6))
    ncoarse, agg_np, W_np = aggregates(V, "trans", False)
    ops = operands(V, ncoarse, torch.float64)
    plan = cc.plan_aggregates(agg_np, V.ncomp, W_np.shape[2], device="cpu")
    before = (cc.coarse_restrict.launches, cc.coarse_prolong.launches)
    W = torch.as_tensor(W_np).double()
    cc.coarse_prolong(cc.coarse_restrict(ops["r"], plan, W, ops["mask"]), ops["Ac_inv"], plan, W, ops["z"])
    assert (cc.coarse_restrict.launches, cc.coarse_prolong.launches) == before


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="every aggregate needs a node"):
        cc.plan_aggregates([0, 2, 2], 2, 2, device="cpu")
    with pytest.raises(ValueError, match="1 to 6"):
        cc.plan_aggregates([0, 1, 1], 3, 7, device="cpu")
