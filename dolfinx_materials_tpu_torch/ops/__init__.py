"""Tensor algebra, the J2 return map and the banded gather engine."""

from . import tensors  # noqa: F401
from .newton import newton_solve, scalar_newton_solve  # noqa: F401
