"""The fused Newton load step on one card, and its building blocks.

Counterpart of dolfinx_materials_tpu/parallel: where the JAX package shards
cells over a mesh of devices, the port runs on the one card that holds the
problem (``device_mesh`` names it; a mesh of more than one device is not
ported yet). ``make_sharded_blocked_step`` (the monolithic step of
multi-field problems) waits for the port of multi-field problems.
"""

from .sharding import (  # noqa: F401
    device_mesh,
    make_sharded_constitutive_update,
    make_sharded_newton_step,
    make_sharded_newton_step_general,
    pad_to_multiple,
)
