"""The port's submeshes and interface laws (``fem/submesh.py``) and
``QuadratureDomain.make_B`` against the JAX package's, in float64 on the CPU.

Host tables (submesh vertices and cells, interface facets, facet dof ids)
must be equal, integers exactly and floats to 1e-14, on P1 and P2 quads and
P2 triangles; the interface residuals and the four coupling blocks of a
nonlinear traction law to 1e-12 of their scale, on seeded fields.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("dolfinx_materials_tpu")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu.fem import forms as jforms  # noqa: E402
from dolfinx_materials_tpu.fem.assembly import QuadratureDomain as JDomain  # noqa: E402

from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch.fem import forms as tforms  # noqa: E402
from dolfinx_materials_tpu_torch.fem.assembly import QuadratureDomain as TDomain  # noqa: E402

torch.set_num_threads(1)

LAYOUTS = {
    "p1_quad": ("quad", 1, (10, 5)),
    "p2_quad": ("quad", 2, (8, 4)),
    "p2_triangle": ("triangle", 2, (6, 3)),
}


def split(fem, cell, degree, n):
    """A 1 x 0.5 parent cut at x = 0.5 into two submeshes, each with a
    two-component space of ``degree``, and their interface domain."""
    parent = fem.create_rectangle((0, 0), (1.0, 0.5), n, cell)
    centers = parent.cell_centers()
    cells1 = np.nonzero(centers[:, 0] < 0.5)[0].astype(np.int32)
    cells2 = np.nonzero(centers[:, 0] > 0.5)[0].astype(np.int32)
    m1, vmap1 = fem.extract_submesh(parent, cells1)
    m2, vmap2 = fem.extract_submesh(parent, cells2)
    fvp = fem.interface_facets(parent, cells1, cells2)
    V1, V2 = fem.FunctionSpace(m1, degree, (2,)), fem.FunctionSpace(m2, degree, (2,))
    return dict(parent=parent, m1=m1, m2=m2, vmap1=vmap1, vmap2=vmap2, fvp=fvp, V1=V1, V2=V2,
                dom=fem.InterfaceDomain(V1, V2, fvp, vmap1, vmap2))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_submesh_and_interface_tables_match_jax(layout):
    t, j = split(tfem, *LAYOUTS[layout]), split(jfem, *LAYOUTS[layout])
    for k in ("vmap1", "vmap2", "fvp"):
        np.testing.assert_array_equal(t[k], np.asarray(j[k]))
    for k in ("m1", "m2"):
        np.testing.assert_array_equal(t[k].cells, j[k].cells)
        np.testing.assert_allclose(t[k].points, j[k].points, rtol=0, atol=1e-14)
        assert t[k].cell_type == j[k].cell_type
    for k in ("V1", "V2"):
        np.testing.assert_array_equal(t[k].dofmap, j[k].dofmap)
    dt, dj = t["dom"], j["dom"]
    assert (dt.num_facets, dt.nq, dt.nloc_f, dt.ncomp) == (dj.num_facets, dj.nq, dj.nloc_f, dj.ncomp)
    assert dt.num_facets == LAYOUTS[layout][2][1]
    for k in ("dofs1", "dofs2"):
        np.testing.assert_array_equal(getattr(dt, k), np.asarray(getattr(dj, k)))
    for k in ("w", "x_q", "N"):
        np.testing.assert_allclose(getattr(dt, k), np.asarray(getattr(dj, k)), rtol=0, atol=1e-14)
    # the facet dofs sit on the interface line x = 0.5, on both sides
    for V, d in ((t["V1"], dt.dofs1), (t["V2"], dt.dofs2)):
        np.testing.assert_allclose(V.dof_coords()[d.reshape(-1), 0], 0.5, rtol=0, atol=1e-14)


def test_non_conforming_interface_raises():
    """Side 2 shifted by 1e-6: both packages refuse to couple it."""
    for fem in (tfem, jfem):
        s = split(fem, "quad", 1, (6, 3))
        m2 = s["m2"]
        shifted = fem.Mesh(m2.points + np.array([0.0, 1e-6]), m2.cells, m2.cell_type)
        V2 = fem.FunctionSpace(shifted, 1, (2,))
        with pytest.raises(ValueError, match="not conforming"):
            fem.InterfaceDomain(s["V1"], V2, s["fvp"], s["vmap1"], s["vmap2"])


def cubic_law(xp):
    """A nonlinear traction-separation law: t = K [[u]] + c [[u]]^3."""
    K = xp.asarray([2e4, 5e3]) if xp is jnp else None

    def traction(jump):
        k = K if K is not None else torch.as_tensor([2e4, 5e3], dtype=jump.dtype, device=jump.device)
        return k * jump + 3e9 * jump ** 3

    return traction


@pytest.mark.parametrize("layout", ["p1_quad", "p2_quad"])
@pytest.mark.parametrize("law", ["elastic", "cubic"])
def test_interface_term_matches_jax(layout, law):
    """Residuals and the four facet blocks on seeded fields (jumps ~1e-3),
    to 1e-12 of their scale."""
    t, j = split(tfem, *LAYOUTS[layout]), split(jfem, *LAYOUTS[layout])
    rng = np.random.default_rng(11)
    u1 = 1e-3 * rng.standard_normal(t["V1"].num_dofs)
    u2 = 1e-3 * rng.standard_normal(t["V2"].num_dofs)
    laws = {"elastic": (tfem.elastic_interface(3e4), jfem.elastic_interface(3e4)),
            "cubic": (cubic_law(torch), cubic_law(jnp))}[law]
    it = tfem.InterfaceTerm(0, 1, t["dom"], laws[0])
    ij = jfem.InterfaceTerm(0, 1, j["dom"], laws[1])
    ut1, ut2 = torch.as_tensor(u1), torch.as_tensor(u2)
    uj1, uj2 = jnp.asarray(u1), jnp.asarray(u2)
    np.testing.assert_allclose(t["dom"].jump(ut1, ut2).numpy(), np.asarray(j["dom"].jump(uj1, uj2)),
                               rtol=0, atol=1e-15)
    n1, n2 = t["V1"].num_dofs, t["V2"].num_dofs
    for a, b in zip(it.residuals(ut1, ut2, n1, n2), ij.residuals(uj1, uj2, n1, n2)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12 * np.abs(b).max())
    for a, b in zip(it.matrices(ut1, ut2), ij.matrices(uj1, uj2)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12 * np.abs(b).max())
    for a, b in zip(it.scatter_dofs(), ij.scatter_dofs()):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("degree", [1, 2])
def test_make_B_matches_jax(degree):
    """d(expr)/d(u_e) per point on a cell subset, (ne, nq, size, ndof_el),
    for the Mandel strain and the deformation gradient, to 1e-12."""
    out = {}
    for name, fem, forms, Dom, xp, kw in (("torch", tfem, tforms, TDomain, torch, {"device": "cpu"}),
                                          ("jax", jfem, jforms, JDomain, jnp, {})):
        V = fem.FunctionSpace(fem.create_rectangle((0, 0), (1.0, 0.5), (6, 3), "quad"), degree, (2,))
        dom = Dom(V, 2 * degree, np.arange(0, 18, 2), **kw)
        u = xp.asarray(np.random.default_rng(3).standard_normal(V.num_dofs))
        out[name] = [np.asarray(dom.make_B(e)(u)) for e in (forms.mandel_strain_2d(), forms.deformation_gradient_2d())]
    for a, b in zip(out["torch"], out["jax"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())
