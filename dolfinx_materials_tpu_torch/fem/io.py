"""Field output: VTK, VTU and XDMF files, and readers for VTU and XDMF.

Dependency-free writers for the four cell types, loadable by ParaView, VisIt
and meshio, byte for byte the files of the JAX package's fem/io.py (but for
the legacy header's title line):

- ``write_vtk``: ASCII legacy .vtk (small meshes);
- ``write_vtu``/``read_vtu``: XML .vtu with raw appended binary data, the
  large-mesh format (8 bytes a float64 value and one XML header);
- ``TimeSeriesWriter(..., fmt="vtk"|"vtu")``: a .pvd time series;
- ``XDMFWriter``/``write_xdmf``/``read_xdmf``: XDMF v3 with HDF5 heavy data
  (``h5py``), the format dolfinx writes.

Field arrays may be numpy arrays or torch tensors on any device (copied to
the host as they are written).
"""

from __future__ import annotations

import numpy as np
import torch

_VTK_TYPE = {"triangle": 5, "quad": 9, "tetrahedron": 10, "hexahedron": 12}


def _host(arr):
    """A field as a numpy array (a tensor is copied off its device)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def write_vtk(path, mesh, point_data=None, cell_data=None):
    """point_data / cell_data: dict name -> (n, k) or (n,) arrays."""
    pts = np.asarray(mesh.points, dtype=float)
    if pts.shape[1] == 2:
        pts = np.hstack([pts, np.zeros((len(pts), 1))])
    cells = np.asarray(mesh.cells)
    nv = cells.shape[1]
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\ndolfinx_materials_tpu_torch\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(pts)} double\n")
        np.savetxt(f, pts, fmt="%.10g")
        f.write(f"CELLS {len(cells)} {len(cells) * (nv + 1)}\n")
        np.savetxt(
            f,
            np.hstack([np.full((len(cells), 1), nv, dtype=np.int64), cells]),
            fmt="%d",
        )
        f.write(f"CELL_TYPES {len(cells)}\n")
        np.savetxt(
            f, np.full(len(cells), _VTK_TYPE[mesh.cell_type], dtype=np.int64), fmt="%d"
        )

        def write_fields(fields, n):
            for name, arr in (fields or {}).items():
                arr = _host(arr).astype(float).reshape(n, -1)
                k = arr.shape[1]
                if k == 1:
                    f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    np.savetxt(f, arr, fmt="%.10g")
                else:
                    if k == 2:  # pad 2D vectors
                        arr = np.hstack([arr, np.zeros((n, 1))])
                        k = 3
                    if k == 3:
                        f.write(f"VECTORS {name} double\n")
                    else:
                        f.write(f"FIELD {name}_field 1\n{name} {k} {n} double\n")
                    np.savetxt(f, arr, fmt="%.10g")

        if point_data:
            f.write(f"POINT_DATA {len(pts)}\n")
            write_fields(point_data, len(pts))
        if cell_data:
            f.write(f"CELL_DATA {len(cells)}\n")
            write_fields(cell_data, len(cells))
    return path


_NP_TO_VTU = {
    np.dtype(np.float32): "Float32",
    np.dtype(np.float64): "Float64",
    np.dtype(np.int32): "Int32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.uint8): "UInt8",
}
_VTU_TO_NP = {v: k for k, v in _NP_TO_VTU.items()}


def write_vtu(path, mesh, point_data=None, cell_data=None):
    """Binary XML .vtu (raw appended data, UInt64 headers, little-endian).

    The large-mesh writer: each array is streamed as one raw binary block —
    a uint64 byte count followed by the C-order bytes — referenced by offset
    from the XML header (the standard VTK "appended/raw" encoding ParaView,
    VisIt and meshio all read). point_data / cell_data: dict name -> (n,) or
    (n, k) arrays; f32/f64 preserved as written.
    """
    pts = np.ascontiguousarray(np.asarray(mesh.points, dtype=np.float64))
    if pts.shape[1] == 2:
        pts = np.hstack([pts, np.zeros((len(pts), 1))])
    cells = np.ascontiguousarray(np.asarray(mesh.cells, dtype=np.int64))
    nc, nv = cells.shape
    blocks = []  # (bytes,) in append order

    def append(arr):
        arr = np.ascontiguousarray(arr)
        off = sum(8 + len(b) for b in blocks)
        blocks.append(arr.tobytes())
        return off

    def da(arr, name=None, ncomp=None):
        arr = np.asarray(arr)
        if arr.dtype not in _NP_TO_VTU:
            arr = arr.astype(np.float64)
        t = _NP_TO_VTU[arr.dtype]
        k = ncomp if ncomp is not None else (arr.shape[1] if arr.ndim > 1 else 1)
        nm = f' Name="{name}"' if name else ""
        return (
            f'<DataArray type="{t}"{nm} NumberOfComponents="{k}" '
            f'format="appended" offset="{append(arr)}"/>'
        )

    def fields(data, n):
        out = []
        for name, arr in (data or {}).items():
            arr = _host(arr)
            if arr.dtype not in _NP_TO_VTU:
                arr = arr.astype(np.float64)
            arr = arr.reshape(n, -1)
            if arr.shape[1] == 2:  # pad 2D vectors for ParaView glyphs
                arr = np.hstack([arr, np.zeros((n, 1), arr.dtype)])
            out.append("        " + da(arr, name=name))
        return out

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">',
        "  <UnstructuredGrid>",
        f'    <Piece NumberOfPoints="{len(pts)}" NumberOfCells="{nc}">',
        "      <Points>",
        "        " + da(pts, ncomp=3),
        "      </Points>",
        "      <Cells>",
        "        " + da(cells.reshape(-1), name="connectivity", ncomp=1),
        "        " + da(np.arange(1, nc + 1, dtype=np.int64) * nv,
                        name="offsets", ncomp=1),
        "        " + da(np.full(nc, _VTK_TYPE[mesh.cell_type], np.uint8),
                        name="types", ncomp=1),
        "      </Cells>",
    ]
    pd, cd = fields(point_data, len(pts)), fields(cell_data, nc)
    if pd:
        lines += ["      <PointData>"] + pd + ["      </PointData>"]
    if cd:
        lines += ["      <CellData>"] + cd + ["      </CellData>"]
    lines += [
        "    </Piece>",
        "  </UnstructuredGrid>",
        '  <AppendedData encoding="raw">',
        "_",
    ]
    with open(path, "wb") as f:
        f.write("\n".join(lines).encode())
        for b in blocks:
            f.write(np.uint64(len(b)).tobytes())
            f.write(b)
        f.write(b"\n  </AppendedData>\n</VTKFile>\n")
    return path


def read_vtu(path):
    """Read back a :func:`write_vtu` file (raw appended encoding only).

    Returns ``(points (np, 3), cells (nc, nv), cell_type_ids (nc,),
    point_data dict, cell_data dict)`` with dtypes as written. The verifier
    for large-mesh output — and a plain consumer for anyone post-processing
    without ParaView.
    """
    import re
    import xml.etree.ElementTree as ET

    raw = open(path, "rb").read()
    m = re.search(rb'<AppendedData encoding="raw">\s*_', raw)
    if m is None:
        raise ValueError(f"{path}: no raw appended data section")
    blob = raw[m.end():]
    header = raw[: m.start()].decode() + "<AppendedData/></VTKFile>"
    root = ET.fromstring(header)
    piece = root.find(".//Piece")

    def load(el, n_rows):
        off = int(el.get("offset"))
        dt = _VTU_TO_NP[el.get("type")]
        k = int(el.get("NumberOfComponents", "1"))
        (count,) = np.frombuffer(blob[off : off + 8], np.uint64)
        arr = np.frombuffer(blob[off + 8 : off + 8 + int(count)], dt)
        return arr.reshape(n_rows, k) if k > 1 else arr

    n_pts = int(piece.get("NumberOfPoints"))
    n_cells = int(piece.get("NumberOfCells"))
    pts = load(piece.find("Points/DataArray"), n_pts)
    conn = offs = types = None
    for el in piece.findall("Cells/DataArray"):
        if el.get("Name") == "connectivity":
            conn = load(el, 0 if n_cells == 0 else -1)
        elif el.get("Name") == "offsets":
            offs = load(el, -1)
        elif el.get("Name") == "types":
            types = load(el, -1)
    nv = int(offs[0]) if len(offs) else 0
    cells = conn.reshape(n_cells, nv) if n_cells else conn.reshape(0, 0)
    pdata = {
        el.get("Name"): load(el, n_pts)
        for el in piece.findall("PointData/DataArray")
    }
    cdata = {
        el.get("Name"): load(el, n_cells)
        for el in piece.findall("CellData/DataArray")
    }
    return pts, cells, types, pdata, cdata


class TimeSeriesWriter:
    """Multi-snapshot field output: one legacy .vtk (or, with ``fmt="vtu"``,
    raw-appended binary .vtu) file per step, ``<base>_0000.vtk`` ..., and a
    ParaView ``<base>.pvd`` collection index with their time stamps, which
    ParaView and VisIt load as a time series. ``writer.write(t,
    point_data=...)`` once per step.
    """

    def __init__(self, path, mesh, fmt="vtk"):
        import os

        path = os.fspath(path)
        self.base = path[:-4] if path.endswith(".pvd") else path
        self.mesh = mesh
        if fmt not in ("vtk", "vtu"):
            raise ValueError(f"fmt must be 'vtk' or 'vtu', got {fmt!r}")
        self.fmt = fmt  # "vtu" = raw-appended binary (the large-mesh format)
        self.steps = []  # (time, filename)
        self._dir = os.path.dirname(os.path.abspath(self.base))

    def write(self, t, point_data=None, cell_data=None):
        """Append one snapshot at time ``t``; rewrites the .pvd index."""
        import os

        fname = f"{self.base}_{len(self.steps):04d}.{self.fmt}"
        writer = write_vtu if self.fmt == "vtu" else write_vtk
        writer(fname, self.mesh, point_data=point_data, cell_data=cell_data)
        self.steps.append((float(t), os.path.basename(fname)))
        self._write_pvd()
        return fname

    def _write_pvd(self):
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="0.1">',
            "  <Collection>",
        ]
        for t, fn in self.steps:
            lines.append(
                f'    <DataSet timestep="{t:.12g}" group="" part="0" file="{fn}"/>'
            )
        lines += ["  </Collection>", "</VTKFile>", ""]
        with open(self.base + ".pvd", "w") as f:
            f.write("\n".join(lines))
        return self.base + ".pvd"


# XDMF (XML + HDF5 heavy data): the format of dolfinx.io.XDMFFile, which
# ParaView and dolfinx read directly.

_XDMF_TOPO = {
    "triangle": "Triangle",
    "quad": "Quadrilateral",
    "tetrahedron": "Tetrahedron",
    "hexahedron": "Hexahedron",
}


class XDMFWriter:
    """XDMF v3 time-series writer with HDF5 heavy data.

    The mesh is written once to ``<base>.h5:/Mesh``; each ``write(t, ...)``
    appends the fields under ``/Function/<name>/<step>`` and regenerates the
    ``.xdmf`` XML (a temporal Grid collection), so the file pair is readable
    after every step. Usable as a context manager; a single ``write`` with
    ``t=None`` produces a plain (non-temporal) grid, which is what
    :func:`write_xdmf` wraps.

    2-component vectors are padded to 3 (ParaView/XDMF convention, same as
    the VTK writers above); geometry keeps its native dimension via the
    ``XY``/``XYZ`` geometry types.
    """

    def __init__(self, path, mesh):
        import os

        import h5py

        path = os.fspath(path)
        self.base = path[:-5] if path.endswith(".xdmf") else path
        self.mesh = mesh
        self.steps = []  # (time or None, {name: (center, shape)})
        self._h5name = os.path.basename(self.base) + ".h5"
        self._h5 = h5py.File(self.base + ".h5", "w")
        pts = np.asarray(mesh.points, dtype=np.float64)
        cells = np.asarray(mesh.cells, dtype=np.int64)
        self._h5.create_dataset("Mesh/geometry", data=pts)
        self._h5.create_dataset("Mesh/topology", data=cells)
        self._npts, self._gdim = pts.shape
        self._ne = cells.shape[0]
        self._nv = cells.shape[1]

    # -- context manager ---------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write(self, t, point_data=None, cell_data=None):
        """Append one snapshot at time ``t`` (or ``t=None`` for a static
        grid); rewrites the .xdmf index."""
        step = len(self.steps)
        fields = {}
        for center, data, n in (
            ("Node", point_data, self._npts),
            ("Cell", cell_data, self._ne),
        ):
            for name, arr in (data or {}).items():
                arr = _host(arr).astype(np.float64).reshape(n, -1)
                if arr.shape[1] == 2:  # pad 2D vectors (XDMF convention)
                    arr = np.hstack([arr, np.zeros((n, 1))])
                self._h5.create_dataset(f"Function/{name}/{step}", data=arr)
                fields[name] = (center, arr.shape)
        self.steps.append((None if t is None else float(t), fields))
        self._h5.flush()
        self._write_xml()

    def close(self):
        self._write_xml()
        self._h5.close()

    # -- XML ---------------------------------------------------------------
    def _grid_xml(self, step, t, fields, indent="    "):
        topo = _XDMF_TOPO[self.mesh.cell_type]
        geo = "XY" if self._gdim == 2 else "XYZ"
        L = [f'{indent}<Grid Name="mesh" GridType="Uniform">']
        if t is not None:
            L.append(f'{indent}  <Time Value="{t:.12g}" />')
        L += [
            f'{indent}  <Topology TopologyType="{topo}" '
            f'NumberOfElements="{self._ne}">',
            f'{indent}    <DataItem Dimensions="{self._ne} {self._nv}" '
            f'NumberType="Int" Format="HDF">{self._h5name}:/Mesh/topology'
            "</DataItem>",
            f"{indent}  </Topology>",
            f'{indent}  <Geometry GeometryType="{geo}">',
            f'{indent}    <DataItem Dimensions="{self._npts} {self._gdim}" '
            f'Format="HDF">{self._h5name}:/Mesh/geometry</DataItem>',
            f"{indent}  </Geometry>",
        ]
        for name, (center, shape) in fields.items():
            k = shape[1]
            atype = (
                "Scalar" if k == 1 else "Vector" if k == 3 else "Matrix"
            )
            L += [
                f'{indent}  <Attribute Name="{name}" '
                f'AttributeType="{atype}" Center="{center}">',
                f'{indent}    <DataItem Dimensions="{shape[0]} {k}" '
                f'Format="HDF">{self._h5name}:/Function/{name}/{step}'
                "</DataItem>",
                f"{indent}  </Attribute>",
            ]
        L.append(f"{indent}</Grid>")
        return L

    def _write_xml(self):
        L = [
            '<?xml version="1.0"?>',
            '<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>',
            '<Xdmf Version="3.0">',
            "  <Domain>",
        ]
        temporal = len(self.steps) > 1 or (
            self.steps and self.steps[0][0] is not None
        )
        if temporal:
            L.append(
                '    <Grid Name="TimeSeries" GridType="Collection" '
                'CollectionType="Temporal">'
            )
            for step, (t, fields) in enumerate(self.steps):
                L += self._grid_xml(step, t if t is not None else float(step),
                                    fields, indent="      ")
            L.append("    </Grid>")
        elif self.steps:
            L += self._grid_xml(0, None, self.steps[0][1])
        L += ["  </Domain>", "</Xdmf>", ""]
        with open(self.base + ".xdmf", "w") as f:
            f.write("\n".join(L))


def write_xdmf(path, mesh, point_data=None, cell_data=None):
    """One-shot XDMF output (static grid). See :class:`XDMFWriter`."""
    with XDMFWriter(path, mesh) as w:
        w.write(None, point_data=point_data, cell_data=cell_data)


def read_xdmf(path):
    """Read back an XDMF file pair written by :class:`XDMFWriter` (or by
    dolfinx with the same Uniform/Temporal layout). Returns
    ``(points, cells, cell_type, snapshots)`` with ``snapshots`` a list of
    ``(time, point_data, cell_data)`` dicts."""
    import os
    import xml.etree.ElementTree as ET

    import h5py

    root = ET.parse(path).getroot()
    dirname = os.path.dirname(os.path.abspath(path))
    h5cache = {}

    def resolve(di_text):
        fname, key = di_text.strip().split(":", 1)
        fpath = os.path.join(dirname, fname)
        if fpath not in h5cache:
            h5cache[fpath] = h5py.File(fpath, "r")
        return np.asarray(h5cache[fpath][key])

    grids = root.findall(".//Grid[@GridType='Uniform']")
    topo_el = grids[0].find("Topology")
    cells = resolve(topo_el.find("DataItem").text).astype(np.int64)
    ttype = topo_el.get("TopologyType")
    cell_type = {v: k for k, v in _XDMF_TOPO.items()}[ttype]
    points = resolve(grids[0].find("Geometry/DataItem").text)
    snapshots = []
    for g in grids:
        tel = g.find("Time")
        t = float(tel.get("Value")) if tel is not None else None
        pdata, cdata = {}, {}
        for att in g.findall("Attribute"):
            arr = resolve(att.find("DataItem").text)
            (pdata if att.get("Center") == "Node" else cdata)[
                att.get("Name")
            ] = arr
        snapshots.append((t, pdata, cdata))
    for f in h5cache.values():
        f.close()
    return points, cells, cell_type, snapshots
