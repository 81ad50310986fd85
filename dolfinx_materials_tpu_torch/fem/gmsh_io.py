"""A gmsh .msh reader (ASCII v2.2 and v4.1) for unstructured meshes.

numpy only, no gmsh package: returns a :class:`~.mesh.Mesh` and its
physical tags, so meshes made by gmsh drive the same pipeline as the built-in
generators. Elements: tri3, quad4, tet4, hex8, and their boundary entities
(lines, triangles, quads) as tagged facet groups.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

_ELEM = {2: ("triangle", 3), 3: ("quad", 4), 4: ("tetrahedron", 4), 5: ("hexahedron", 8)}
_BOUNDARY = {1: ("line", 2), 2: ("triangle", 3), 3: ("quad", 4)}


def read_msh(path, cell_type=None, reorder=False):
    """Read a .msh file; returns (Mesh, cell_tags (ncells,), facet_groups).

    ``facet_groups``: dict physical_tag -> (nfacets, nfv) vertex arrays of
    lower-dimensional tagged entities (for BC selection). ``cell_type`` picks
    the volume element family when several are present.

    ``reorder=True`` applies the bandwidth-reducing renumbering of
    fem/reorder.py (the banded gather route's numbering) and remaps
    ``cell_tags`` and ``facet_groups`` with it, so selections by tag keep
    working on the renumbered mesh.
    """
    mesh, cell_tags, facet_groups = _read_msh_raw(path, cell_type)
    if reorder:
        from .reorder import reorder_mesh

        m2 = reorder_mesh(mesh)
        if getattr(m2, "reordered", False):
            cell_tags = np.asarray(cell_tags)[m2.cell_order]
            inv = m2.vertex_inverse
            facet_groups = {tag: inv[np.asarray(fv)].astype(np.int32) for tag, fv in facet_groups.items()}
            mesh = m2
    return mesh, cell_tags, facet_groups


def _read_msh_raw(path, cell_type=None):
    lines = open(path).read().splitlines()
    i = 0

    def section(name):
        nonlocal i
        while i < len(lines) and lines[i].strip() != f"${name}":
            i += 1
        if i >= len(lines):
            raise ValueError(f"section {name} not found")
        i += 1

    # version
    section("MeshFormat")
    version = float(lines[i].split()[0])
    i = 0

    if version < 4.0:
        return _read_v2(lines, cell_type)
    if version < 4.1:
        # v4.0 interleaves 'tag x y z' node lines and swaps the entity-block
        # header order vs v4.1 — fail cleanly instead of mis-parsing
        raise ValueError(
            f"MSH format {version} is not supported (use 2.2 or 4.1; "
            "re-export with gmsh -format msh41 or msh2)"
        )
    return _read_v4(lines, cell_type)


def _finish(points, node_ids, elems, cell_type):
    # compress node numbering
    ids = np.asarray(node_ids, dtype=np.int64)
    remap = {int(g): k for k, g in enumerate(ids)}
    pts = np.asarray(points, dtype=float)
    by_type: dict = {}
    tags_by_type: dict = {}
    for etype, tag, verts in elems:
        by_type.setdefault(etype, []).append([remap[v] for v in verts])
        tags_by_type.setdefault(etype, []).append(tag)

    vol_types = [t for t in by_type if t in ("triangle", "quad", "tetrahedron", "hexahedron")]
    dim = max(2 if t in ("triangle", "quad") else 3 for t in vol_types)
    vol_types = [
        t
        for t in vol_types
        if (dim == 2 and t in ("triangle", "quad"))
        or (dim == 3 and t in ("tetrahedron", "hexahedron"))
    ]
    if cell_type is None:
        cell_type = max(vol_types, key=lambda t: len(by_type[t]))
    cells = np.asarray(by_type[cell_type], dtype=np.int32)
    cell_tags = np.asarray(tags_by_type[cell_type], dtype=np.int32)
    if dim == 2:
        pts = pts[:, :2]
    mesh = Mesh(pts, cells, cell_type)

    facet_groups: dict = {}
    for t, lists in by_type.items():
        if t == cell_type or t in vol_types:
            continue
        for tag, verts in zip(tags_by_type[t], lists):
            facet_groups.setdefault(int(tag), []).append(verts)
    facet_groups = {
        k: np.asarray(v, dtype=np.int32) for k, v in facet_groups.items()
    }
    return mesh, cell_tags, facet_groups


def _read_v2(lines, cell_type):
    i = lines.index("$Nodes") + 1
    n_nodes = int(lines[i])
    node_ids, points = [], []
    for k in range(n_nodes):
        parts = lines[i + 1 + k].split()
        node_ids.append(int(parts[0]))
        points.append([float(x) for x in parts[1:4]])
    i = lines.index("$Elements") + 1
    n_el = int(lines[i])
    elems = []
    names = {**{k: v for k, v in _ELEM.items()}, 1: ("line", 2), 15: ("point", 1)}
    for k in range(n_el):
        parts = [int(x) for x in lines[i + 1 + k].split()]
        etype = parts[1]
        if etype not in names or names[etype][0] == "point":
            continue
        ntags = parts[2]
        tag = parts[3] if ntags > 0 else 0
        verts = parts[3 + ntags :]
        tname, nfv = names[etype]
        elems.append((tname, tag, verts[:nfv]))
    return _finish(points, node_ids, elems, cell_type)


def _read_v4(lines, cell_type):
    # entity -> physical tag map
    phys = {}
    if "$Entities" in lines:
        i = lines.index("$Entities") + 1
        np_, nc, ns, nv = [int(x) for x in lines[i].split()]
        i += 1
        for _ in range(np_):
            i += 1
        for dim_count, d in [(nc, 1), (ns, 2), (nv, 3)]:
            for _ in range(dim_count):
                parts = lines[i].split()
                tag = int(parts[0])
                nphys = int(parts[7])
                if nphys > 0:
                    phys[(d, tag)] = int(parts[8])
                i += 1

    i = lines.index("$Nodes") + 1
    nblocks, n_nodes = [int(x) for x in lines[i].split()[:2]]
    i += 1
    node_ids, points = [], []
    for _ in range(nblocks):
        _, _, _, nn = [int(x) for x in lines[i].split()]
        i += 1
        ids = [int(lines[i + k]) for k in range(nn)]
        i += nn
        for k in range(nn):
            points.append([float(x) for x in lines[i + k].split()[:3]])
        i += nn
        node_ids.extend(ids)

    i = lines.index("$Elements") + 1
    nblocks, _ = [int(x) for x in lines[i].split()[:2]]
    i += 1
    elems = []
    names = {**_ELEM, 1: ("line", 2), 15: ("point", 1)}
    for _ in range(nblocks):
        edim, etag, etype, ne = [int(x) for x in lines[i].split()]
        i += 1
        # untagged entities -> 0, matching the v2 reader; falling back to the
        # raw entity tag would silently merge with an unrelated PHYSICAL group
        # sharing the same integer
        tag = phys.get((edim, etag), 0)
        for k in range(ne):
            parts = [int(x) for x in lines[i + k].split()]
            if etype in names and names[etype][0] != "point":
                tname, nfv = names[etype]
                elems.append((tname, tag, parts[1 : 1 + nfv]))
        i += ne
    return _finish(points, node_ids, elems, cell_type)
