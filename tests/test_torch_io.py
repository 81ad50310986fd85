"""Field output and mesh input of dolfinx_materials_tpu_torch against the JAX
package, on the CPU: VTK, VTU, .pvd and XDMF files byte for byte the JAX
package's for the same mesh and data (the legacy VTK header's title line
names the package), tensor fields written as their numpy values, the VTU and
XDMF readers' round trips, and the gmsh reader (v2.2 and v4.1, with and
without ``reorder``) against the JAX one on the same .msh text."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu.fem import io as jio  # noqa: E402

from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch.fem import io as tio  # noqa: E402

torch.set_num_threads(1)

MESHES = {
    "quad": lambda f: f.create_rectangle((0, 0), (1, 2), (3, 4), "quad"),
    "triangle": lambda f: f.create_rectangle((0, 0), (1, 2), (2, 3), "triangle"),
    "tetrahedron": lambda f: f.create_box((0, 0, 0), (1, 1, 1), (2, 1, 1), "tetrahedron"),
    "hexahedron": lambda f: f.create_box((0, 0, 0), (1, 1, 2), (2, 1, 2), "hexahedron"),
}


def fields(mesh, seed=0):
    rng = np.random.default_rng(seed)
    nv, nc, d = mesh.num_vertices, mesh.num_cells, mesh.dim
    point = {"T": rng.normal(size=nv), "u": rng.normal(size=(nv, d)), "sig": rng.normal(size=(nv, 6))}
    cell = {"p": rng.random(nc), "f": rng.normal(size=(nc, 3)).astype(np.float32)}
    return point, cell


def as_tensors(data):
    return {k: torch.as_tensor(v) for k, v in data.items()}


def read(path):
    with open(path, "rb") as f:
        return f.read()


def same_but_title(a, b):
    la, lb = read(a).split(b"\n"), read(b).split(b"\n")
    assert la[1] == b"dolfinx_materials_tpu_torch" and lb[1] == b"dolfinx_materials_tpu"
    assert la[:1] + la[2:] == lb[:1] + lb[2:]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_vtk_and_vtu_match_jax(name, tmp_path):
    tm, jm = MESHES[name](tfem), MESHES[name](jfem)
    point, cell = fields(tm)
    tio.write_vtk(tmp_path / "t.vtk", tm, point_data=point, cell_data=cell)
    jio.write_vtk(tmp_path / "j.vtk", jm, point_data=point, cell_data=cell)
    same_but_title(tmp_path / "t.vtk", tmp_path / "j.vtk")
    # tensor fields write the same file as their numpy values
    tio.write_vtk(tmp_path / "tt.vtk", tm, point_data=as_tensors(point), cell_data=as_tensors(cell))
    assert read(tmp_path / "tt.vtk") == read(tmp_path / "t.vtk")

    tio.write_vtu(tmp_path / "t.vtu", tm, point_data=point, cell_data=cell)
    jio.write_vtu(tmp_path / "j.vtu", jm, point_data=point, cell_data=cell)
    assert read(tmp_path / "t.vtu") == read(tmp_path / "j.vtu")
    tio.write_vtu(tmp_path / "tt.vtu", tm, point_data=as_tensors(point), cell_data=as_tensors(cell))
    assert read(tmp_path / "tt.vtu") == read(tmp_path / "t.vtu")

    pts, cells, types, pdata, cdata = tio.read_vtu(tmp_path / "t.vtu")
    np.testing.assert_array_equal(pts[:, : tm.dim], tm.points)
    np.testing.assert_array_equal(cells, tm.cells)
    assert set(types.tolist()) == {tio._VTK_TYPE[tm.cell_type]}
    np.testing.assert_array_equal(pdata["T"], point["T"])
    np.testing.assert_array_equal(pdata["sig"], point["sig"])
    np.testing.assert_array_equal(pdata["u"][:, : tm.dim], point["u"])
    np.testing.assert_array_equal(cdata["p"], cell["p"])
    assert cdata["f"].dtype == np.float32
    np.testing.assert_array_equal(cdata["f"], cell["f"])


@pytest.mark.parametrize("fmt", ["vtk", "vtu"])
def test_time_series_matches_jax(fmt, tmp_path):
    tm, jm = MESHES["quad"](tfem), MESHES["quad"](jfem)
    tw = tio.TimeSeriesWriter(tmp_path / "t.pvd", tm, fmt=fmt)
    jw = jio.TimeSeriesWriter(tmp_path / "j.pvd", jm, fmt=fmt)
    for k, t in enumerate((0.0, 0.25, 1.0 / 3.0)):
        point, cell = fields(tm, seed=k)
        tw.write(t, point_data=as_tensors(point), cell_data=cell)
        jw.write(t, point_data=point, cell_data=cell)
        a, b = tmp_path / f"t_{k:04d}.{fmt}", tmp_path / f"j_{k:04d}.{fmt}"
        same_but_title(a, b) if fmt == "vtk" else (read(a) == read(b) or pytest.fail("vtu differs"))
    assert read(tmp_path / "t.pvd") == read(tmp_path / "j.pvd").replace(b'file="j_', b'file="t_')
    with pytest.raises(ValueError, match="fmt"):
        tio.TimeSeriesWriter(tmp_path / "bad.pvd", tm, fmt="xml")


def h5_equal(a, b):
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        names = []
        fa.visit(names.append)
        other = []
        fb.visit(other.append)
        assert names == other
        for n in names:
            if isinstance(fa[n], h5py.Dataset):
                np.testing.assert_array_equal(fa[n][()], fb[n][()])
                assert fa[n].dtype == fb[n].dtype


@pytest.mark.parametrize("name", ["triangle", "hexahedron"])
def test_xdmf_matches_jax(name, tmp_path):
    tm, jm = MESHES[name](tfem), MESHES[name](jfem)
    point, cell = fields(tm)
    tio.write_xdmf(tmp_path / "t.xdmf", tm, point_data=as_tensors(point), cell_data=cell)
    jio.write_xdmf(tmp_path / "j.xdmf", jm, point_data=point, cell_data=cell)
    assert read(tmp_path / "t.xdmf") == read(tmp_path / "j.xdmf").replace(b"j.h5:", b"t.h5:")
    h5_equal(tmp_path / "t.h5", tmp_path / "j.h5")
    pts, cells, ctype, snaps = tio.read_xdmf(tmp_path / "t.xdmf")
    np.testing.assert_array_equal(pts, tm.points)
    np.testing.assert_array_equal(cells, tm.cells)
    assert ctype == tm.cell_type and len(snaps) == 1 and snaps[0][0] is None
    np.testing.assert_array_equal(snaps[0][1]["T"].ravel(), point["T"])
    np.testing.assert_array_equal(snaps[0][2]["p"].ravel(), cell["p"])

    # a time series through the writer, read back by both readers
    with tio.XDMFWriter(tmp_path / "ts.xdmf", tm) as tw, jio.XDMFWriter(tmp_path / "js.xdmf", jm) as jw:
        for k, t in enumerate((0.0, 0.5)):
            point, cell = fields(tm, seed=k + 1)
            tw.write(t, point_data=as_tensors(point), cell_data=cell)
            jw.write(t, point_data=point, cell_data=cell)
    assert read(tmp_path / "ts.xdmf") == read(tmp_path / "js.xdmf").replace(b"js.h5:", b"ts.h5:")
    h5_equal(tmp_path / "ts.h5", tmp_path / "js.h5")
    tsnaps, jsnaps = tio.read_xdmf(tmp_path / "ts.xdmf")[3], jio.read_xdmf(tmp_path / "js.xdmf")[3]
    assert [s[0] for s in tsnaps] == [s[0] for s in jsnaps] == [0.0, 0.5]
    for (_, tp, tc), (_, jp, jc) in zip(tsnaps, jsnaps):
        for a, b in ((tp, jp), (tc, jc)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


MSH_V2 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
5
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
5 0.5 0.5 0
$EndNodes
$Elements
8
1 1 2 10 1 1 2
2 1 2 20 1 2 3
3 1 2 10 1 3 4
4 1 2 10 1 4 1
5 2 2 1 1 1 2 5
6 2 2 7 1 2 3 5
7 2 2 1 1 3 4 5
8 2 2 1 1 4 1 5
$EndElements
"""

# the same square in format 4.1: two surface entities (physical 1 and 7),
# a tagged boundary curve (physical 10) and an untagged one
MSH_V41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
0 2 2 0
1 0 0 0 1 0 0 1 10
2 1 0 0 1 1 0 0
1 0 0 0 1 1 0 1 1
2 0 0 0 1 1 0 1 7
$EndEntities
$Nodes
1 5 1 5
2 1 0 5
1
2
3
4
5
0 0 0
1 0 0
1 1 0
0 1 0
0.5 0.5 0
$EndNodes
$Elements
4 6 1 6
1 1 1 1
1 1 2
1 2 1 1
2 2 3
2 1 2 3
3 1 2 5
4 3 4 5
5 4 1 5
2 2 2 1
6 2 3 5
$EndElements
"""


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("version", ["2.2", "4.1"])
def test_read_msh_matches_jax(version, reorder, tmp_path):
    path = tmp_path / "square.msh"
    path.write_text(MSH_V2 if version == "2.2" else MSH_V41)
    tmesh, ttags, tgroups = tfem.read_msh(path, reorder=reorder)
    jmesh, jtags, jgroups = jfem.read_msh(path, reorder=reorder)
    assert tmesh.cell_type == jmesh.cell_type == "triangle" and tmesh.num_cells == 4
    np.testing.assert_array_equal(tmesh.points, jmesh.points)
    np.testing.assert_array_equal(tmesh.cells, jmesh.cells)
    np.testing.assert_array_equal(ttags, jtags)
    assert sorted(ttags.tolist()) == [1, 1, 1, 7]
    assert tgroups.keys() == jgroups.keys()
    for tag in tgroups:
        np.testing.assert_array_equal(tgroups[tag], jgroups[tag])
    # the unit square's area, on the read (and renumbered) mesh
    from dolfinx_materials_tpu_torch.fem.assembly import QuadratureDomain, assemble_scalar

    dom = QuadratureDomain(tfem.FunctionSpace(tmesh, 1, ()), 2, device="cpu")
    np.testing.assert_allclose(float(assemble_scalar(dom, 1.0)), 1.0, rtol=1e-12)


def test_read_msh_refuses_v40(tmp_path):
    path = tmp_path / "old.msh"
    path.write_text(MSH_V41.replace("4.1 0 8", "4 0 8"))
    with pytest.raises(ValueError, match="not supported"):
        tfem.read_msh(path)
