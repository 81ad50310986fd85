"""Constitutive model library: small-strain elasticity, plasticity,
viscoplasticity and viscoelasticity with the hardening laws and the
plane-stress wrapper; finite-strain hyperelasticity, FeFp plasticity and the
Hencky wrapper; crystal plasticity; thermal behaviors; exact conic
projections; and the neural-network surrogate."""

from .base import Behavior, FiniteStrainBehavior, SmallStrainBehavior  # noqa: F401
from .conic import (  # noqa: F401
    HosfordPlasticity,
    L1RankinePlasticity,
    RankinePlasticity,
    l1_rankine_norm,
    rankine_norm,
)
from .conic_exact import HosfordExact, L1RankineExact, PlaneStressVonMisesExact, RankineExact  # noqa: F401
from .crystal import (  # noqa: F401
    MericCailletaudCrystalPlasticity,
    cubic_elasticity_C,
    fcc_interaction_matrix,
    fcc_slip_systems,
)
from .elasticity import LinearElasticIsotropic, LinearElasticOrthotropic  # noqa: F401
from .hardening import (  # noqa: F401
    LinearHardening,
    RambergOsgoodHardening,
    SwiftHardening,
    VoceHardening,
)
from .finite_strain import FeFpJ2Plasticity, HenckyFiniteStrain  # noqa: F401
from .hyperelasticity import HyperelasticBehavior, NeoHooke, Ogden, SaintVenantKirchhoff  # noqa: F401
from .hypotheses import PlaneStress  # noqa: F401
from .nn import NeuralBehavior  # noqa: F401
from .nonlinear_elasticity import RambergOsgoodNonLinearElasticity  # noqa: F401
from .plasticity import (  # noqa: F401
    GeneralIsotropicHardening,
    hosford_norm,
    vonMisesIsotropicHardening,
)
from .thermal import (  # noqa: F401
    NonlinearHeatTransfer,
    PhaseChangeHeatTransfer,
    ThermoElasticIsotropic,
    ThermoMechanicalHeat,
)
from .viscoelasticity import GeneralizedMaxwell, ZenerViscoelasticity  # noqa: F401
from .viscoplasticity import GeneralizedStandardMaterial, NortonViscoplasticity  # noqa: F401
