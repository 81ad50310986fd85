"""FEM layer: structured, curved and composite meshes, a gmsh reader,
Lagrange elements tabulated with torch.func, batched assembly and
matrix-free operators (host-built index sets, tensors on the domain's
device), facet and body loads, submeshes and interface laws, and
VTK/VTU/XDMF output."""

from .mesh import (  # noqa: F401
    Mesh,
    create_box,
    create_rectangle,
    create_unit_cube,
    create_unit_square,
    curve_mesh,
)
from .element import ReferenceElement, quadrature_rule  # noqa: F401
from .space import Function, FunctionSpace  # noqa: F401
from .bc import DirichletBC, locate_dofs_geometrical  # noqa: F401
from .facets import assemble_body_force, assemble_traction, boundary_facets  # noqa: F401
from .gmsh_io import read_msh  # noqa: F401
from .reorder import reorder_mesh  # noqa: F401
from .composite_mesh import create_inclusion_cube  # noqa: F401
from .io import (  # noqa: F401
    TimeSeriesWriter,
    XDMFWriter,
    read_vtu,
    read_xdmf,
    write_vtk,
    write_vtu,
    write_xdmf,
)
from .submesh import (  # noqa: F401
    InterfaceDomain,
    InterfaceTerm,
    elastic_interface,
    extract_submesh,
    interface_facets,
)
