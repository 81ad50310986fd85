"""FEM layer: structured and composite meshes, Lagrange elements tabulated
with torch.func, batched assembly and matrix-free operators (host-built index
sets, tensors on the domain's device)."""

from .mesh import Mesh, create_box, create_rectangle, create_unit_cube, create_unit_square  # noqa: F401
from .element import ReferenceElement, quadrature_rule  # noqa: F401
from .space import Function, FunctionSpace  # noqa: F401
from .bc import DirichletBC, locate_dofs_geometrical  # noqa: F401
from .reorder import reorder_mesh  # noqa: F401
from .composite_mesh import create_inclusion_cube  # noqa: F401
