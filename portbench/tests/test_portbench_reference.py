"""The plain references against cases they must get right on their own,
at small sizes."""

import numpy as np
import pytest
import torch
from conftest import SMALL

from portbench.core import Cell
from portbench.reference import j2

PLATE = dict(Cell("plate.fused-plastic").config, **SMALL["plate_j2_voce_p2q_128x256"])
POINTS = Cell("points.voce").config
E, NU = POINTS["E"], POINTS["nu"]
VOCE = "350.0 + (500.0 - 350.0) * (1.0 - exp(-1000.0 * p))"


def plate_module():
    return Cell("plate.fused-plastic").reference()


def strains(n, scale, seed=0):
    g = torch.Generator().manual_seed(seed)
    return scale * torch.randn(n, 6, generator=g, dtype=torch.float64)


def test_elastic_points_follow_hooke():
    eps = strains(64, 1e-4)
    zero = torch.zeros(64, 6, dtype=torch.float64)
    sig, Ct, eps_p, p = j2.return_map(eps, zero, torch.zeros(64, dtype=torch.float64), E, NU, j2.Hardening(POINTS))
    lam, mu = j2.moduli(E, NU)
    one = torch.tensor(j2.ONE, dtype=torch.float64)
    C = lam * torch.outer(one, one) + 2 * mu * torch.eye(6, dtype=torch.float64)
    assert torch.allclose(sig, eps @ C, rtol=1e-14, atol=0) and torch.allclose(Ct, C.expand(64, 6, 6))
    assert (p == 0).all() and (eps_p == 0).all()


def test_plastic_points_land_on_the_yield_surface():
    eps = strains(256, 2e-2, 1)
    zero = torch.zeros(256, 6, dtype=torch.float64)
    hard = j2.Hardening(POINTS)
    sig, Ct, eps_p, p = j2.return_map(eps, zero, torch.zeros(256, dtype=torch.float64), E, NU, hard)
    s = sig - sig[:, :3].mean(dim=1, keepdim=True) * torch.tensor(j2.ONE, dtype=torch.float64)
    q = torch.sqrt(1.5 * (s * s).sum(dim=1))
    assert (p > 0).all()
    assert torch.allclose(q, hard(p)[0], rtol=1e-12, atol=0)
    assert torch.allclose(eps_p[:, :3].sum(dim=1), torch.zeros(256, dtype=torch.float64), atol=1e-16)


@pytest.mark.parametrize("law", [None, VOCE, "350.0 + 2e3 * p + 50.0 * tanh(100.0 * p)"])
def test_tangent_is_the_derivative_of_the_return_map(law):
    n = 32
    eps = strains(n, 1e-2, 2)
    eps_p0 = 1e-3 * strains(n, 1.0, 3)
    eps_p0[:, :3] -= eps_p0[:, :3].mean(dim=1, keepdim=True)
    p0 = torch.full((n,), 2e-3, dtype=torch.float64)
    hard = j2.Hardening(POINTS, law)
    _, Ct, _, _ = j2.return_map(eps, eps_p0, p0, E, NU, hard)
    h = 1e-7
    for j in range(6):
        d = torch.zeros(6, dtype=torch.float64)
        d[j] = h
        up = j2.return_map(eps + d, eps_p0, p0, E, NU, hard)[0]
        dn = j2.return_map(eps - d, eps_p0, p0, E, NU, hard)[0]
        assert torch.allclose((up - dn) / (2 * h), Ct[:, :, j], rtol=0, atol=1e-6 * E)


def test_voce_as_text_is_voce_in_closed_form():
    eps = strains(128, 2e-2, 4)
    z6, z = torch.zeros(128, 6, dtype=torch.float64), torch.zeros(128, dtype=torch.float64)
    a = j2.return_map(eps, z6, z, E, NU, j2.Hardening(POINTS))
    b = j2.return_map(eps, z6, z, E, NU, j2.Hardening(POINTS, VOCE))
    for x, y in zip(a, b):
        assert torch.allclose(x, y, rtol=1e-13, atol=1e-13 * float(x.abs().max()))


def dense_stiffness(g, Ct):
    Ke = torch.einsum("qkd,cqkl,qle->cde", g.Bw, Ct.reshape(-1, 9, 6, 6), g.B)
    K = torch.zeros(g.ndofs, g.ndofs, dtype=torch.float64)
    idx = g.edofs
    K.index_put_((idx[:, :, None].expand_as(Ke), idx[:, None, :].expand_as(Ke)), Ke, accumulate=True)
    free = ~g.fixed
    K = K * free[:, None] * free[None, :]
    return K + torch.diag((~free).double())


def test_block_cholesky_solves_the_assembled_stiffness():
    ref = plate_module()
    g = ref.Grid(PLATE, "cpu", torch.float64)
    n = 9 * g.nx * g.ny
    hard = j2.Hardening(PLATE)
    eps = strains(n, 1e-2, 5)
    _, Ct, _, _ = j2.return_map(eps, torch.zeros(n, 6, dtype=torch.float64), torch.zeros(n, dtype=torch.float64),
                                E, NU, hard)
    b = torch.randn(g.ndofs, generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    b = torch.where(g.fixed, torch.zeros_like(b), b)
    x = g.solve(g.factor(Ct), b)
    K = dense_stiffness(g, Ct)
    assert torch.allclose(x, torch.linalg.solve(K, b), rtol=0, atol=1e-10 * float(x.abs().max()))


def test_a_linear_displacement_gives_its_strain_everywhere():
    ref = plate_module()
    g = ref.Grid(PLATE, "cpu", torch.float64)
    A = np.array([[1e-3, 2e-3], [-5e-4, 3e-3]])
    i, j = np.meshgrid(np.arange(g.NX), np.arange(g.NY), indexing="xy")
    X = np.stack([i.ravel() * g.hx / 2, j.ravel() * g.hy / 2], axis=1)
    u = torch.as_tensor((X @ A.T).reshape(-1))
    eps = g.strain(u)
    want = torch.tensor([A[0, 0], A[1, 1], 0.0, (A[0, 1] + A[1, 0]) / 2 ** 0.5, 0.0, 0.0], dtype=torch.float64)
    assert torch.allclose(eps, want.expand_as(eps), rtol=0, atol=1e-15)


def test_an_elastic_step_is_linear_in_its_load():
    ref = plate_module()
    (u1, p1), = ref.solve(PLATE, [1e-4], "cpu")
    (u2, p2), = ref.solve(PLATE, [2e-4], "cpu")
    assert (p1 == 0).all() and (p2 == 0).all()
    assert np.allclose(u2, 2 * u1, rtol=0, atol=1e-12 * np.abs(u2).max())


def test_the_plastic_program_converges_and_hardens():
    ref = plate_module()
    out = ref.solve(PLATE, [0.0035, 0.0035, 0.0035], "cpu")
    p_max = [p.max() for _, p in out]
    assert p_max[0] >= 0 and p_max[-1] > p_max[0] and p_max[-1] > 0


def test_orders_put_permuted_points_back():
    ref = plate_module()
    g = ref.Grid(PLATE, "cpu", torch.float64)
    i, j = np.meshgrid(np.arange(g.NX), np.arange(g.NY), indexing="xy")
    nodes = np.stack([i.ravel() * g.hx / 2, j.ravel() * g.hy / 2], axis=1)
    perm = np.random.default_rng(7).permutation(len(nodes))
    u_ref = np.arange(2 * len(nodes), dtype=float)
    u_prog = u_ref.reshape(-1, 2)[perm].reshape(-1)
    assert (u_prog[ref.dof_order(PLATE, nodes[perm])] == u_ref).all()
    gp = np.array([[(ci + ref.GAUSS[qi]) * g.hx, (cj + ref.GAUSS[qj]) * g.hy]
                   for cj in range(g.ny) for ci in range(g.nx) for qj in range(3) for qi in range(3)])
    perm = np.random.default_rng(8).permutation(len(gp))
    vals = np.arange(len(gp), dtype=float)
    assert (vals[perm][ref.point_order(PLATE, gp[perm])] == vals).all()
