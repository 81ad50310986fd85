"""Constitutive model library: the J2 plasticity family of the first slice."""

from .base import Behavior, SmallStrainBehavior  # noqa: F401
from .elasticity import LinearElasticIsotropic  # noqa: F401
from .hardening import (  # noqa: F401
    LinearHardening,
    RambergOsgoodHardening,
    SwiftHardening,
    VoceHardening,
)
from .plasticity import vonMisesIsotropicHardening  # noqa: F401
