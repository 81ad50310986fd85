"""Constitutive model library: small-strain elasticity, plasticity,
viscoplasticity and viscoelasticity, with the hardening laws and the
plane-stress wrapper, and finite-strain hyperelasticity."""

from .base import Behavior, FiniteStrainBehavior, SmallStrainBehavior  # noqa: F401
from .conic import (  # noqa: F401
    HosfordPlasticity,
    L1RankinePlasticity,
    RankinePlasticity,
    l1_rankine_norm,
    rankine_norm,
)
from .elasticity import LinearElasticIsotropic, LinearElasticOrthotropic  # noqa: F401
from .hardening import (  # noqa: F401
    LinearHardening,
    RambergOsgoodHardening,
    SwiftHardening,
    VoceHardening,
)
from .hyperelasticity import HyperelasticBehavior, NeoHooke, Ogden, SaintVenantKirchhoff  # noqa: F401
from .hypotheses import PlaneStress  # noqa: F401
from .nonlinear_elasticity import RambergOsgoodNonLinearElasticity  # noqa: F401
from .plasticity import (  # noqa: F401
    GeneralIsotropicHardening,
    hosford_norm,
    vonMisesIsotropicHardening,
)
from .viscoelasticity import GeneralizedMaxwell, ZenerViscoelasticity  # noqa: F401
from .viscoplasticity import GeneralizedStandardMaterial, NortonViscoplasticity  # noqa: F401
