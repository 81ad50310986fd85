"""The port's multi-rank layer (``parallel.multiprocess`` on
``torch.distributed``) on the CPU over gloo, against the JAX package's
N-device runs.

Each launch starts real processes through the port's ``multiprocess.launch``
(a ``file://`` store under the test's temporary directory, so parallel test
workers never race for a port), one rank a process, every rank on the CPU.
The ranks run this file as a script (its worker mode, at the bottom): the
batched constitutive update, the Voce plate of the JAX package's
``tests/_mp_worker.py`` in both dof layouts (through the port's
``demos/sharded_scaling.py`` worker functions), the blocked
thermo-mechanical step and the two-material and thermal problems with
``shard_dofs=True``; rank 0 writes the results. The JAX references run in
this process on the conftest's virtual devices.

The rule against JAX is the one the one-device fused step is held to
(``tests/test_torch_fused_step.py`` ``assert_same``): u and the plastic
strain to 1e-8 of their largest entry, equal Newton and CG counts, the
entering residual to 1e-12. Against the port's own one-device step (run
here, single-threaded as every rank is) the replicated-dof layout and the
blocked step are bitwise: the ranks sum element values, exactly, before one
full assembly.
"""

import argparse
import os
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from dolfinx_materials_tpu_torch.demos import sharded_scaling as demo  # noqa: E402
from dolfinx_materials_tpu_torch.parallel import multiprocess as mp  # noqa: E402

pytestmark = pytest.mark.mp
torch.set_num_threads(1)

E, NU, SIG0 = 70e3, 0.3, 350.0
RTOL = 1e-8
N_UPDATE = (64, 4096)
LAYOUTS = ("replicated", "sharded")
#: the plate of tests/_mp_worker.py: 5x5 P1 quads, Voce, u_x = 3 sig0 / E
PLATE = argparse.Namespace(N=5, hardening="voce", load=3.0, layouts=",".join(LAYOUTS), n_newton=12, n_cg=200,
                           banded=False, reps=0)
BLOCKED = argparse.Namespace(blocked="thermo", N=6, reps=0)
#: the JAX package's tests/test_sharding_general.py thermal problem
A_TH, B_TH, T0_TH, T1_TH = 0.0375, 2.165e-4, 300.0, 800.0


# ------------------------------------------------------------- the worker
def update_case(mesh, device):
    """The J2 material's batched update of seeded strains at each n of
    N_UPDATE over the mesh's ranks."""
    from dolfinx_materials_tpu_torch.parallel import make_sharded_constitutive_update

    out = {}
    for n in N_UPDATE:
        mat, *_ = demo.plate(1, "voce", device=device)
        mat.set_data_manager(n)
        eps = np.random.default_rng(0).normal(size=(n, 6)) * 2e-2
        flux, Ct, st = make_sharded_constitutive_update(mat, mesh)(eps, mat.data_manager.s0.internal, 0.0)
        out.update({f"flux_{n}": flux, f"Ct_{n}": Ct, f"p_{n}": st["p"]})
    return out


def mech_two_materials(device):
    """tests/test_sharding_general.py: a 5x5 plate, even cells linear
    hardening, odd cells Voce."""
    from dolfinx_materials_tpu_torch import Material, NonlinearMaterialProblem, QuadratureMap, fem, models
    from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d

    V = fem.FunctionSpace(fem.create_unit_square(5, 5, "quad"), 1, (2,))
    cells = np.arange(V.mesh.num_cells)
    mats, qmaps = [], []
    for sub, law in zip((cells[cells % 2 == 0], cells[cells % 2 == 1]),
                        (models.LinearHardening(SIG0, 1000.0), models.VoceHardening(SIG0, 500.0, 1e3))):
        m = Material(models.vonMisesIsotropicHardening(models.LinearElasticIsotropic(E, NU), law), device=device)
        q = QuadratureMap(V, 2, m, cells=sub)
        q.register_gradient("Strain", mandel_strain_2d())
        mats.append(m)
        qmaps.append(q)
    loc = fem.locate_dofs_geometrical
    bcs = [fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 0), 0), 0.0),
           fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 1], 0), 1), 0.0),
           fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 1), 0), 3 * SIG0 / E)]
    return mats, V, bcs, NonlinearMaterialProblem(qmaps, fem.Function(V), bcs=bcs)


def thermal(device):
    """tests/test_sharding_general.py: nonlinear conduction on a 10x3
    strip, the temperature an ESV of its own field, 300 / 800 at the ends."""
    from dolfinx_materials_tpu_torch import Material, NonlinearMaterialProblem, QuadratureMap, fem, models
    from dolfinx_materials_tpu_torch.fem.forms import scalar_gradient, scalar_value

    V = fem.FunctionSpace(fem.create_rectangle((0, 0), (1.0, 0.2), (10, 3), "quad"), 1, ())
    mat = Material(models.NonlinearHeatTransfer(A=A_TH, B=B_TH, dim=2), device=device)
    q = QuadratureMap(V, 2, mat)
    q.register_gradient("TemperatureGradient", scalar_gradient())
    q.register_external_state_variable("Temperature", scalar_value())
    bcs = [fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0)), T0_TH),
           fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1.0)), T1_TH)]
    T = fem.Function(V)
    T.x[:] = T0_TH
    prob = NonlinearMaterialProblem(q, T, bcs=bcs, residual_terms=[[("HeatFlux", scalar_gradient())]],
                                    options={"ksp_type": "lu", "atol": 1e-8})
    return mat, V, bcs, prob


def general_case(mesh, device):
    """The two-material plate in both layouts and the thermal strip with
    split dofs, through make_sharded_newton_step_general."""
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.parallel import make_sharded_newton_step_general

    out = {}
    for layout in LAYOUTS:
        mats, V, bcs, prob = mech_two_materials(device)
        step, pad = make_sharded_newton_step_general(prob, mesh, n_newton=14, n_cg=300,
                                                     shard_dofs=layout == "sharded")
        mask, vals = combine_bcs(bcs, V.num_dofs)
        u, st, rn = step(np.zeros(V.num_dofs), pad([m.data_manager.s0.internal for m in mats]), mask, vals, 0.0)
        out.update({f"mech_u_{layout}": u, f"mech_res_{layout}": rn.reshape(1)})
        out.update({f"mech_p{i}_{layout}": s["p"] for i, s in enumerate(st)})
    mat, V, bcs, prob = thermal(device)
    step, pad = make_sharded_newton_step_general(prob, mesh, n_newton=12, n_cg=200, shard_dofs=True)
    mask, vals = combine_bcs(bcs, V.num_dofs)
    u0 = np.full(V.num_dofs, T0_TH)
    u0[mask] = vals[mask]
    u, _, rn = step(u0, pad([mat.data_manager.s0.internal]), mask, vals, 0.0)
    out.update(thermal_T=u, thermal_res=rn.reshape(1))
    return out


def fefp_case(mesh, device):
    """tests/test_sharding.py's finite-strain plate (5x5 P1 quads, FeFp J2
    with Voce hardening, u_x = 2 sig0/E) through make_sharded_newton_step:
    u, p, |R| and the padded initial state's F_prev and be (25 cells split
    over 2 ranks pad to 26)."""
    from dolfinx_materials_tpu_torch import Material, NonlinearMaterialProblem, QuadratureMap, fem, models
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.fem.forms import deformation_gradient_2d
    from dolfinx_materials_tpu_torch.parallel import make_sharded_newton_step

    V = fem.FunctionSpace(fem.create_unit_square(5, 5, "quad"), 1, (2,))
    mat = Material(models.FeFpJ2Plasticity(models.LinearElasticIsotropic(E, NU), models.VoceHardening(SIG0, 500.0, 1e2)),
                   device=device)
    q = QuadratureMap(V, 2, mat)
    q.register_gradient("F", deformation_gradient_2d())
    loc = fem.locate_dofs_geometrical
    bcs = [fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 0), 0), 0.0),
           fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 1], 0), 1), 0.0),
           fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 1), 0), 2 * SIG0 / E)]
    prob = NonlinearMaterialProblem(q, fem.Function(V), bcs=bcs)
    step, pad_state = make_sharded_newton_step(q, prob, mesh, n_newton=14, n_cg=200)
    mask, vals = combine_bcs(bcs, V.num_dofs)
    st0 = pad_state(mat.data_manager.s0.internal)
    u, st, rn = step(np.zeros(V.num_dofs), st0, mask, vals, 0.0)
    return {"fefp_u": u, "fefp_p": st["p"].reshape(-1)[: q.num_points], "fefp_res": rn.reshape(1),
            "fefp_newton": np.asarray(step.info["newton"]), "fefp_F_prev0": st0["F_prev"], "fefp_be0": st0["be"]}


def worker(argv):
    """``OUT CASES pid nproc coordinator``: CASES a comma list of update,
    plate, plate22 (the plate on the (dcn, ici) = (2, 2) mesh), blocked,
    general and fefp; rank 0 writes every result to OUT."""
    from dolfinx_materials_tpu_torch.parallel import device_mesh

    out_file, cases, pid, nproc, coord = argv
    device = mp.initialize(int(pid), int(nproc), coord, device="cpu")
    mesh = device_mesh(int(nproc))
    out = {}
    for case in cases.split(","):
        if case == "update":
            out.update(update_case(mesh, device))
        elif case == "plate":
            out.update(demo.solve_plate(mesh, PLATE, device))
        elif case == "plate22":
            mesh22 = device_mesh((2, 2), ("dcn", "ici"))
            out.update({f"{k}_22": v for k, v in demo.solve_plate(mesh22, PLATE, device).items()})
        elif case == "blocked":
            out.update(demo.solve_blocked(mesh, BLOCKED, device))
        elif case == "general":
            out.update(general_case(mesh, device))
        elif case == "fefp":
            out.update(fefp_case(mesh, device))
    if int(pid) == 0:
        np.savez(out_file, **{k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in out.items()})
    mp.exit_worker()


# -------------------------------------------------------------- the runs
def launch(tmp, tag, nproc, cases):
    out = os.path.join(tmp, f"{tag}.npz")
    mp.launch([sys.executable, os.path.abspath(__file__), out, cases], nproc, timeout=300, cwd=REPO,
              coordinator=f"file://{os.path.join(tmp, tag + '.store')}")
    with np.load(out) as f:
        return dict(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_mp"))
    return {
        2: launch(tmp, "two", 2, "update,plate,blocked,general,fefp"),
        "2again": launch(tmp, "two_again", 2, "plate"),
        4: launch(tmp, "four", 4, "update,plate,plate22"),
        1: launch(tmp, "one", 1, "plate"),
    }


@pytest.fixture(scope="module")
def jax_plate():
    """The JAX step on the plate over 2 and 4 devices, both layouts:
    ``{(n, layout): (u, p, res0, (newton, cg))}``."""
    jnp = pytest.importorskip("jax.numpy")
    from dolfinx_materials_tpu import Material, NonlinearMaterialProblem, QuadratureMap, fem, models
    from dolfinx_materials_tpu.fem.bc import combine_bcs
    from dolfinx_materials_tpu.fem.forms import mandel_strain_2d
    from dolfinx_materials_tpu.parallel import device_mesh, make_sharded_newton_step_general

    out = {}
    for n in (2, 4):
        for layout in LAYOUTS:
            mat = Material(models.vonMisesIsotropicHardening(models.LinearElasticIsotropic(E, NU),
                                                             models.VoceHardening(SIG0, 500.0, 1e3)))
            V = fem.FunctionSpace(fem.create_unit_square(5, 5, "quad"), 1, (2,))
            q = QuadratureMap(V, 2, mat)
            q.register_gradient("Strain", mandel_strain_2d())
            loc = fem.locate_dofs_geometrical
            bcs = [fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 0), 0), 0.0),
                   fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 1], 0), 1), 0.0),
                   fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 1), 0), 3 * SIG0 / E)]
            prob = NonlinearMaterialProblem(q, fem.Function(V), bcs=bcs)
            # make_sharded_newton_step is this builder's one-map wrapper;
            # "stats" gives the Newton and CG counts
            step, pad = make_sharded_newton_step_general(prob, device_mesh(n), n_newton=12, n_cg=200,
                                                         shard_dofs=layout == "sharded", return_info="stats")
            mask, vals = combine_bcs(bcs, V.num_dofs)
            u, st, rn, rn0, (nn, ncg) = step(jnp.zeros(V.num_dofs), pad([mat.data_manager.s0.internal]),
                                             mask, vals, 0.0)
            out[(n, layout)] = (np.asarray(u), np.asarray(st[0]["p"]), float(rn0), (int(nn), int(ncg)))
    return out


def bitwise(a, b, keys):
    for k in keys:
        assert np.array_equal(a[k], b[k]), f"{k}: max |diff| {np.abs(a[k] - b[k]).max():.3e}"


def plate_keys(layout, suffix=""):
    return [f"{f}_{layout}{suffix}" for f in ("u", "p", "res", "newton", "cg")]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("nproc", [2, 4])
@pytest.mark.parametrize("n", N_UPDATE)
def test_constitutive_update_matches_jax(runs, nproc, n):
    """make_sharded_constitutive_update over 2 and 4 ranks against the JAX
    kernel on device_mesh(2|4, axis="pts"): flux, tangent and p."""
    jnp = pytest.importorskip("jax.numpy")
    from dolfinx_materials_tpu import Material, models
    from dolfinx_materials_tpu.parallel import device_mesh, make_sharded_constitutive_update

    mat = Material(models.vonMisesIsotropicHardening(models.LinearElasticIsotropic(E, NU),
                                                     models.VoceHardening(SIG0, 500.0, 1e3)))
    mat.set_data_manager(n)
    eps = np.random.default_rng(0).normal(size=(n, 6)) * 2e-2
    upd = make_sharded_constitutive_update(mat, device_mesh(nproc, axis="pts"), axis="pts")
    flux, Ct, st = upd(jnp.asarray(eps), mat.data_manager.s0.internal, 0.0)
    got = runs[nproc]
    for k, ref in (("flux", flux), ("Ct", Ct), ("p", st["p"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got[f"{k}_{n}"].reshape(ref.shape), ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("nproc", [2, 4])
def test_plate_matches_jax(runs, jax_plate, nproc, layout):
    """The fused step over 2 and 4 ranks against the JAX step over 2 and 4
    devices, in both dof layouts."""
    got = runs[nproc]
    u, p, res0, counts = jax_plate[(nproc, layout)]
    assert (int(got[f"newton_{layout}"]), int(got[f"cg_{layout}"])) == counts
    np.testing.assert_allclose(got[f"u_{layout}"], u, rtol=0, atol=RTOL * np.abs(u).max())
    np.testing.assert_allclose(got[f"p_{layout}"], p.reshape(-1), rtol=0, atol=RTOL * np.abs(p).max())
    np.testing.assert_allclose(float(got[f"res0_{layout}"]), res0, rtol=1e-12)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_axis_mesh_is_bitwise_one_axis(runs, layout):
    """Four ranks as (dcn, ici) = (2, 2) and as one axis: the same
    partition over the same group, the same bits."""
    bitwise(runs[4], {k.replace("_22", ""): v for k, v in runs[4].items() if k.endswith("_22")},
            plate_keys(layout))


@pytest.fixture(scope="module")
def one_device():
    """The plate on one device with no group, run here."""
    from dolfinx_materials_tpu_torch.parallel import device_mesh

    here = demo.solve_plate(device_mesh(1, devices=["cpu"]), PLATE, torch.device("cpu"))
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in here.items()}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_rank_group_is_bitwise_one_device(runs, one_device, layout):
    """One rank through the process group against the one-device step with
    no group."""
    bitwise(runs[1], one_device, plate_keys(layout))


@pytest.mark.parametrize("nproc", [2, 4])
def test_ranks_are_bitwise_one_device(runs, one_device, nproc):
    """With replicated dofs, 2 and 4 ranks give the one-device step's bits:
    each assembly sums the ranks' element values (exact) and runs in full."""
    bitwise(runs[nproc], one_device, plate_keys("replicated"))


def test_two_ranks_rerun_is_bitwise(runs):
    """A second launch of the two-rank plate gives the same bits."""
    for layout in LAYOUTS:
        bitwise(runs[2], runs["2again"], plate_keys(layout))


def test_solution_is_physical(runs):
    """The two-rank solve converged and went plastic."""
    r = runs[2]
    for layout in LAYOUTS:
        assert float(r[f"res_{layout}"][0]) < 1e-8 * E
        assert r[f"p_{layout}"].max() > 1e-4
        assert np.isfinite(r[f"u_{layout}"]).all()


def test_blocked_step_matches_one_rank_and_jax(runs):
    """The fused blocked step (the stiff thermo-mechanical coupling at
    N = 6) over two ranks: z, the states and the Newton and BiCGStab counts
    bitwise the port's one-device step's; against the JAX step on
    device_mesh(2) (run with the port's Newton count as its budget: it
    returns no count) z to 1e-8 of its largest entry; |R| below 1e-7 E."""
    jnp = pytest.importorskip("jax.numpy")
    from dolfinx_materials_tpu.parallel import device_mesh as jmesh
    from dolfinx_materials_tpu.parallel import make_sharded_blocked_step as jstep
    from dolfinx_materials_tpu.solvers import BlockedNonlinearProblem as JBlocked

    from dolfinx_materials_tpu_torch.parallel import device_mesh

    sys.path.insert(0, HERE)
    from test_blocked import build, couplings

    got = runs[2]
    one = demo.solve_blocked(device_mesh(1, devices=["cpu"]), BLOCKED, torch.device("cpu"))
    bitwise(got, {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in one.items()},
            ["z_blocked", "res_blocked", "newton_blocked", "bicgstab_blocked"])
    assert float(got["res_blocked"][0]) < 1e-7 * E

    heat, mech, qT, qu, T, u, _, _ = build(6)
    blocked = JBlocked([heat, mech], couplings(heat, mech, qT, qu))
    step, _ = jstep(blocked, jmesh(2), n_newton=int(got["newton_blocked"]), n_cg=400)
    mask, vals = blocked._masks()
    z0 = np.concatenate([T.x, u.x])
    z0[np.asarray(mask)] = np.asarray(vals)[np.asarray(mask)]
    zj, _, rj = step(jnp.asarray(z0), [qT.material.data_manager.s0.internal, qu.material.data_manager.s0.internal],
                     mask, vals, 0.0)
    zj = np.asarray(zj)
    np.testing.assert_allclose(got["z_blocked"], zj, rtol=0, atol=RTOL * np.abs(zj).max())
    assert float(rj) < 1e-7 * E


def test_shard_dofs_two_materials_and_thermal(runs):
    """tests/test_sharding_general.py's shard_dofs case at two ranks: the
    two-material plate's split-dof solution equals its replicated one, and
    the thermal strip's split-dof step meets the host LU solve."""
    r = runs[2]
    for layout in LAYOUTS:
        assert float(r[f"mech_res_{layout}"][0]) < 1e-8 * E
    np.testing.assert_allclose(r["mech_u_sharded"], r["mech_u_replicated"], rtol=1e-9, atol=1e-12)
    for i in (0, 1):
        np.testing.assert_allclose(r[f"mech_p{i}_sharded"], r[f"mech_p{i}_replicated"], rtol=1e-9, atol=1e-14)
    _, _, _, prob = thermal("cpu")
    assert prob.solve()[0]
    assert float(r["thermal_res"][0]) < 1e-8 * T1_TH
    np.testing.assert_allclose(r["thermal_T"], prob.u.x, rtol=1e-8, atol=1e-8)


def test_fefp_two_ranks_match_one_device(runs):
    """The FeFp plate over two ranks: its 25 cells pad to 26, and the
    padding cell's points start from the behavior's initial state (the
    identity for be and F_prev; zeros would turn into NaN through
    inv33(0)). u, p, |R| and the Newton count are bitwise the port's
    one-device step's; the residual is finite and below 1e-7 E, and the
    plate went plastic."""
    from dolfinx_materials_tpu_torch.ops import tensors
    from dolfinx_materials_tpu_torch.parallel import device_mesh

    got = runs[2]
    F_prev0, be0 = got["fefp_F_prev0"], got["fefp_be0"]
    assert F_prev0.shape[0] == 26 * 4 and be0.shape[0] == 26 * 4
    np.testing.assert_array_equal(F_prev0[-4:], np.broadcast_to(tensors.I9, (4, 9)))
    np.testing.assert_array_equal(be0[-4:], np.broadcast_to(tensors.I2, (4, 6)))
    one = fefp_case(device_mesh(1, devices=["cpu"]), torch.device("cpu"))
    one = {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in one.items()}
    bitwise(got, one, ["fefp_u", "fefp_p", "fefp_res", "fefp_newton"])
    assert np.isfinite(got["fefp_res"][0]) and float(got["fefp_res"][0]) < 1e-7 * E
    assert got["fefp_p"].max() > 1e-4


def launch_pair(tmp_path, rank0, timeout):
    """Two workers: rank 0 prints a line, writes a marker file and runs
    ``rank0``; rank 1 prints, waits (30 s at most) for the marker and exits
    3. Returns the launch's error text and the seconds it took."""
    marker = tmp_path / "rank0_printed"
    code = (f"import os, sys, time\n"
            f"print('rank', sys.argv[1], 'here')\n"
            f"if sys.argv[1] == '0':\n"
            f"    open({str(marker)!r}, 'w').close()\n"
            f"    {rank0}\n"
            f"else:\n"
            f"    t = time.time() + 30\n"
            f"    while not os.path.exists({str(marker)!r}) and time.time() < t:\n"
            f"        time.sleep(0.01)\n"
            f"    sys.exit(3)\n")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as err:
        mp.launch([sys.executable, "-c", code], 2, timeout=timeout, coordinator=f"file://{tmp_path / 'store'}")
    return str(err.value), time.perf_counter() - t0


def test_launch_raises_with_the_workers_output(tmp_path):
    """A worker that exits non-zero fails the launch; the error carries
    every worker's output."""
    msg, _ = launch_pair(tmp_path, "sys.exit(0)", timeout=60)
    assert "worker 1 (rc=3)" in msg and "rank 1 here" in msg and "rank 0 here" in msg


def test_launch_keeps_a_killed_workers_output(tmp_path, monkeypatch):
    """Rank 0 would sleep for 120 s after printing; rank 1's failure ends
    it within seconds, and the error still carries the line rank 0 printed
    before it was killed: launch makes every worker's output unbuffered,
    whatever the caller's environment says."""
    monkeypatch.delenv("PYTHONUNBUFFERED", raising=False)
    msg, seconds = launch_pair(tmp_path, "time.sleep(120)", timeout=300)
    assert seconds < 10, f"the launch took {seconds:.1f} s to raise"
    assert "worker 1 (rc=3)" in msg and "rank 0 here" in msg and "rank 1 here" in msg


def test_device_mesh_needs_a_group_and_initialize_a_card():
    """More than one device outside a process group raises, naming
    multiprocess.initialize; initialize never falls back to the CPU."""
    from dolfinx_materials_tpu_torch.parallel import device_mesh

    with pytest.raises(RuntimeError, match="multiprocess.initialize"):
        device_mesh(2)
    with pytest.raises(RuntimeError, match="multiprocess.initialize"):
        device_mesh((2, 2), ("dcn", "ici"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mp.initialize(0, 1, "127.0.0.1:1")


def test_initialize_refuses_more_nccl_ranks_than_cards(monkeypatch):
    """On a host that shows two cards, rank 2 of 3 NCCL ranks raises a
    ValueError naming the rank, the world size and the card count, before
    it selects a card or starts a process group; over gloo three ranks may
    share the two cards (rank 2 on cuda:0)."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(mp, "_LOCAL", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append(("init", backend)))
    with pytest.raises(ValueError, match=r"rank 2 of 3.*device_count\(\) is 2"):
        mp.initialize(2, 3, "127.0.0.1:1")
    with pytest.raises(ValueError, match="rank 2 of 3"):
        mp.initialize(2, 3, "127.0.0.1:1", backend="nccl")
    assert calls == [] and not dist.is_initialized()
    assert mp.initialize(2, 3, "127.0.0.1:1", backend="gloo", threads=None) == torch.device("cuda", 0)
    assert calls == [("set_device", "cuda:0"), ("init", "gloo")]


if __name__ == "__main__":
    worker(sys.argv[1:])
