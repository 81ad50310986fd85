"""The port's 3D Ogden benchmark slice against the JAX package, in float64 on
the CPU: the box and composite meshes, ``balance_cell_slots`` and
``reorder_mesh`` (equal arrays), the deformation-gradient forms (equal
values), the tet-P2 mixed-precision protocol of ``demos/ogden_block_tpu.py``
at N = 3 (per-step relative |R| <= 1e-4 in both, u to 1e-6), and the
composite against its host f64 solve to 1e-6, as
tests/test_composite_problem.py holds the JAX one."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu.fem import composite_mesh as jcomp  # noqa: E402
from dolfinx_materials_tpu.fem import forms as jforms  # noqa: E402
from dolfinx_materials_tpu.fem import mesh as jmesh  # noqa: E402
from dolfinx_materials_tpu.fem import reorder as jreorder  # noqa: E402
from dolfinx_materials_tpu.ops import banded_gather as jbg  # noqa: E402

from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch.demos import composite_hyperelasticity, ogden_block  # noqa: E402
from dolfinx_materials_tpu_torch.fem import forms as tforms  # noqa: E402
from dolfinx_materials_tpu_torch.ops import banded_gather as tbg  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent


def same_mesh(a, b):
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.cells, b.cells)
    assert a.cell_type == b.cell_type and a.grid == b.grid


@pytest.mark.parametrize("cell", ["hexahedron", "tetrahedron"])
def test_box_meshes_equal_jax(cell):
    same_mesh(tfem.create_unit_cube(3, 2, 4, cell), jmesh.create_unit_cube(3, 2, 4, cell))
    same_mesh(tfem.create_box((0.5, -1.0, 0.0), (2.0, 1.0, 0.3), (2, 3, 1), cell),
              jmesh.create_box((0.5, -1.0, 0.0), (2.0, 1.0, 0.3), (2, 3, 1), cell))
    m = tfem.create_unit_cube(2, 2, 2, cell)
    np.testing.assert_array_equal(m.cell_centers(), jmesh.create_unit_cube(2, 2, 2, cell).cell_centers())


@pytest.mark.parametrize("cfg", [(1, 1, 1), (1, 1, 2), (2, 1, 3)])
def test_inclusion_cube_and_its_reordering_equal_jax(cfg):
    (tm, tt), (jm, jt) = tfem.create_inclusion_cube(*cfg), jcomp.create_inclusion_cube(*cfg)
    same_mesh(tm, jm)
    np.testing.assert_array_equal(tt, jt)
    tr, jr = tfem.reorder_mesh(tm), jreorder.reorder_mesh(jm)
    same_mesh(tr, jr)
    for k in ("vertex_perm", "vertex_inverse", "cell_order"):
        np.testing.assert_array_equal(getattr(tr, k), getattr(jr, k))


def test_hexes_to_tets_and_balance_cell_slots_equal_jax():
    box = jmesh.create_unit_cube(3, 3, 2, "hexahedron")
    np.testing.assert_array_equal(tfem.composite_mesh.hexes_to_tets_minvertex(box.points, box.cells.astype(np.int64)),
                                  jcomp.hexes_to_tets_minvertex(box.points, box.cells.astype(np.int64)))
    rng = np.random.default_rng(0)
    for cell in ("tetrahedron", "hexahedron", "triangle"):
        cells = jmesh.create_unit_cube(4, 3, 3, cell).cells if cell != "triangle" else \
            jmesh.create_unit_square(9, 7, "triangle").cells
        cells = cells[rng.permutation(len(cells))]
        np.testing.assert_array_equal(tbg.balance_cell_slots(cells, cell), jbg.balance_cell_slots(cells, cell))


def test_structured_meshes_are_not_reordered():
    m = tfem.create_unit_cube(2, 2, 2, "hexahedron")
    assert tfem.reorder_mesh(m) is m


FORMS = ["deformation_gradient_2d", "deformation_gradient_3d", "deformation_gradient(2)", "deformation_gradient(3)",
         "mandel_strain(2)", "mandel_strain(3)", "scalar_gradient"]


@pytest.mark.parametrize("name", FORMS)
def test_forms_equal_jax(name):
    """The same Ctx through both packages' expressions: equal values, and the
    kinematics tag that ``precision="mixed"`` reads."""
    dim = 2 if ("2" in name or name == "scalar_gradient") else 3
    ncomp = 1 if name == "scalar_gradient" else dim
    rng = np.random.default_rng(1)
    u, g, x = rng.normal(size=ncomp), rng.normal(size=(ncomp, dim)), rng.normal(size=dim)
    call = name if "(" in name else name + "()"
    te = eval("tforms." + call)
    je = eval("jforms." + call)
    got = te(tforms.Ctx(torch.tensor(u), torch.tensor(g), torch.tensor(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(je(jforms.Ctx(jnp.asarray(u), jnp.asarray(g),
                                                                        jnp.asarray(x)))))
    assert te.kinematics == ("mandel" if name.startswith("mandel") else
                             "scalar" if name == "scalar_gradient" else "deformation_gradient")


def _jax_demo(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "demos" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tet_p2_mixed_protocol_matches_jax():
    """10 steps to 20 % compression of the N = 3 P2-tet block (162 tets,
    1,029 dofs), ``precision="mixed"``, P1 coarse space, rtol 1e-4, cg_rtol
    1e-3, secant predictor: every step's relative residual <= 1e-4 in both
    packages, u to 1e-6 of its largest entry."""
    u, _, stats = ogden_block.run_10_steps(3, "tetrahedron", 2, "mixed", runs=1, device="cpu",
                                           n_newton=20, n_cg=150)
    rel = np.array([s["res"] / s["res0"] for s in stats])
    uj, _, rns, rn0s = _jax_demo("ogden_block_tpu").run_10_steps(
        3, n_newton=20, n_cg=150, n_devices=1, cell_type="tetrahedron", degree=2, precision="mixed")
    assert (rel <= 1e-4).all(), rel
    assert (np.asarray(rns) / np.asarray(rn0s) <= 1e-4).all()
    uj = np.asarray(uj)
    np.testing.assert_allclose(u.numpy(), uj, rtol=0, atol=1e-6 * np.abs(uj).max())


def test_composite_fused_matches_host_f64():
    """3 load steps to 6 % strain on the cfg (1, 1, 2) composite (Ogden
    matrix, SVK inclusions at 1e12): the fused mixed step's u within 1e-6 of
    the host path's f64 LU solve."""
    assert composite_hyperelasticity.host_check(cfg=(1, 1, 2), n_steps=3, exx_max=0.06, device="cpu") < 1e-6


def test_lifted_first_step_reaches_the_protocols_solution():
    """``run_steps(lift_first=True)`` (the scaled card run's start) converges
    to the same 3-step solution as the protocol's secant start, to 1e-6,
    with the steps solved to rtol 1e-8 (at the protocol's 1e-4 two starts
    end at different iterates inside the tolerance)."""
    proto = ogden_block.make_protocol(3, "tetrahedron", 2, "mixed", device="cpu", n_newton=30, rtol=1e-8,
                                      cg_rtol=1e-5)
    u, stats = ogden_block.run_steps(proto, 3)
    u_l, stats_l = ogden_block.run_steps(proto, 3, lift_first=True)
    assert max(s["res"] / s["res0"] for s in stats + stats_l) <= 1e-8
    np.testing.assert_allclose(u_l.numpy(), u.numpy(), rtol=0, atol=1e-6 * float(u.abs().max()))
