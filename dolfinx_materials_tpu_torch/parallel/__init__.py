"""The fused Newton load step, on one card or over the ranks of a process
group, and its building blocks.

Counterpart of dolfinx_materials_tpu/parallel: where the JAX package shards
cells over a mesh of devices, the port runs on the card that holds the
problem (``device_mesh`` names it) or, inside a ``torch.distributed`` group
(``multiprocess``), splits the cells over the group's ranks, one device a
rank. ``make_sharded_blocked_step`` is the monolithic step of multi-field
problems (``solvers.BlockedNonlinearProblem``).
"""

from .blocked import make_sharded_blocked_step  # noqa: F401
from .sharding import (  # noqa: F401
    device_mesh,
    make_sharded_constitutive_update,
    make_sharded_newton_step,
    make_sharded_newton_step_general,
    pad_to_multiple,
)
