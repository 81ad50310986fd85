"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each source is one shared library with a plain C interface, compiled for
Hopper (``sm_90a``) at first use into ``build/kernels/`` at the repository
root. The library name carries a hash of the source, so an edited kernel is
rebuilt and a stale one never loaded. A failed build raises; nothing falls
back.

    python -m dolfinx_materials_tpu_torch.ops.cuda_build   # build every kernel
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("j2_radial_return.cu", "banded_take.cu", "coarse_correction.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no multiply and add fused into one FMA. The compiler fuses by
# its own heuristics, which differ between instantiations of one template
# (register pressure), so the J2 kernel's two layouts would round one
# expression differently; unfused, each operation rounds as written, as in
# the plain PyTorch versions' separate operations
NVCC_FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BUILD_DIR = CSRC.parent.parent / "build" / "kernels"

_LOADED: dict = {}
_FUNCTIONS: dict = {}


def nvcc_path() -> str:
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(Path(os.environ[var]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "dolfinx_materials_tpu_torch cannot be built"
        )
    return found


def library_path(source: str) -> Path:
    digest = hashlib.sha1((CSRC / source).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _start(source: str):
    """Start nvcc for ``source`` unless its library exists; returns
    ``(Popen, tmp, out)`` or None."""
    out = library_path(source)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(source, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {source}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build_all(sources=SOURCES) -> dict:
    """Build every source at once (one nvcc each, all started together).
    Returns ``{source: compiler log}`` ('' for a library already built)."""
    started = {s: _start(s) for s in sources}
    return {s: (_finish(s, st) if st is not None else "") for s, st in started.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        started = _start(source)
        if started is not None:
            _finish(source, started)
        lib = ctypes.CDLL(str(library_path(source)))
        _LOADED[source] = lib
    return lib


def function(source: str, name: str, argtypes: list):
    """The C entry point ``name`` of ``source``'s library, typed once; every
    entry point returns a ``cudaError_t`` as int."""
    fn = _FUNCTIONS.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[(source, name)] = fn
    return fn


def check(rc: int, source: str, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        lib = load(source)
        lib.dxm_error_string.restype = ctypes.c_char_p
        msg = lib.dxm_error_string(ctypes.c_int(rc)).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


if __name__ == "__main__":
    t0 = time.perf_counter()
    logs = build_all()
    for src, log in logs.items():
        print(f"== {src} -> {library_path(src)}\n{log}", file=sys.stderr)
    print(f"built {len(logs)} kernels in {time.perf_counter() - t0:.1f}s")
