"""dolfinx_materials_tpu_torch — the PyTorch/CUDA port of dolfinx_materials_tpu.

The same constitutive-material + FEM framework (batched J2 return mapping with
its consistent tangent, s0/s1 state, quadrature maps, matrix-free
Newton-Krylov) written in PyTorch, with the TPU package's Pallas kernels
replaced by CUDA kernels written for Hopper (``csrc/``). Every kernel has a
plain PyTorch version beside it; a wrapper takes the plain version only for
tensors on the CPU and launches its kernel (or raises) for CUDA tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# A reduced-precision Jacobian is inconsistent with the residual and stalls
# Newton (the JAX package pins its matmuls to full precision for the same
# reason). TF32 is off for matmuls and convolutions alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


class PerformanceWarning(UserWarning):
    """Category for warnings about a slower path taken on purpose (part of
    the public names shared with the JAX package)."""


def resolve_device(device=None) -> _torch.device:
    """The one place a device is chosen: ``None`` means ``cuda``.

    Raises if CUDA is asked for and absent; never drops quietly to the CPU.
    """
    dev = _torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "dolfinx_materials_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path"
        )
    return dev


from .material import Material  # noqa: E402,F401
from .state import DataManager, MaterialStateManager  # noqa: E402,F401
from .quadrature_map import QuadratureMap  # noqa: E402,F401
from .solvers import (  # noqa: E402,F401
    BlockedNonlinearProblem,
    NonlinearMaterialProblem,
    solve_adaptive,
    solve_coupled,
)
