"""A/B of the port's J2 kernels on one card: the library built from the
current ``dolfinx_materials_tpu_torch/csrc/j2_radial_return.cu`` against one
built from another version of that source (same nvcc flags), on the four
closed-form hardening laws.

    git show REV:dolfinx_materials_tpu_torch/csrc/j2_radial_return.cu > build/ab/old.cu
    python tools/torch_j2_ab.py build/ab/old.cu

For every law, contract (Pallas, j2_fast), dtype, layout and tangent form it
checks that both libraries write the same bits at 2^21 points; then it times
both (CUDA-graph device ms a call) on the Voce rows in the order old, new,
new, old and prints each time with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from dolfinx_materials_tpu_torch.models import (  # noqa: E402
    LinearElasticIsotropic, LinearHardening, RambergOsgoodHardening, SwiftHardening, VoceHardening)
from dolfinx_materials_tpu_torch.ops import cuda_build, j2_cuda  # noqa: E402


def build(source: Path) -> ctypes.CDLL:
    out = Path("build/ab") / f"{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.ARCH_FLAGS, *cuda_build.NVCC_FLAGS, "-o", str(out), str(source)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out.resolve()))


def call(lib, launch, args, fm):
    """The launch's kernel from ``lib``, with the launch's packed parameters."""
    dtype = args[0].dtype
    name = f"{launch.wrapper.__name__}_{'f32' if dtype == torch.float32 else 'f64'}"
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = j2_cuda._ARGTYPES, ctypes.c_int
    eps, eps_p, p = args
    n = eps.shape[1] if fm else eps.shape[0]
    outs = [eps.new_empty(eps.shape), eps.new_empty((launch.width, n) if fm else (n, launch.width)),
            eps.new_empty(eps.shape), p.new_empty(p.shape)]
    c = launch.contract
    rc = fn(eps.data_ptr(), eps_p.data_ptr(), p.data_ptr(), *(o.data_ptr() for o in outs), n,
            launch.params.ctypes.data, launch.law_id, c["n_iter"], c["warm_start"], fm,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed ({rc})")
    return outs


def main(old_source):
    old = build(Path(old_source))
    new = build(cuda_build.CSRC / cuda_build.SOURCES[0])
    el = LinearElasticIsotropic(cs.E, cs.NU)
    laws = {"linear": LinearHardening(cs.SIG0, 2e3), "voce": VoceHardening(cs.SIG0, cs.SIGU, cs.B_VOCE),
            "swift": SwiftHardening(cs.SIG0, 2e-3, 0.2), "ramberg": RambergOsgoodHardening(cs.SIG0, cs.E, 2e-3, 5.0)}
    contracts = {"pallas": j2_cuda.PALLAS_CONTRACT, "j2_fast": j2_cuda.J2_FAST_CONTRACT}
    base = cs.j2_inputs(cs.J2_N, 0, "cuda")
    same = True
    times = []
    for dtype in (torch.float32, torch.float64):
        for lname, law in laws.items():
            layouts = {"feature": cs.feature_major(*base, dtype), "point": cs.point_major(*base, dtype)}
            for cname, c in contracts.items():
                for factored in (False, True):
                    launch = j2_cuda.J2Launch(el, law, factored=factored, **c)
                    for layout, args in layouts.items():
                        fm = layout == "feature"
                        a, b = call(old, launch, args, fm), call(new, launch, args, fm)
                        torch.cuda.synchronize()
                        equal = all(torch.equal(x, y) for x, y in zip(a, b))
                        same &= equal
                        row = f"{str(dtype)[6:]} {lname} {cname} {'factored' if factored else 'full'} {layout}"
                        if lname == "voce" and (cname, layout) in (("pallas", "feature"), ("j2_fast", "point")):
                            t = {}
                            for side in ("old", "new", "new", "old"):
                                lib = old if side == "old" else new
                                t.setdefault(side, []).append(
                                    cs.graph_ms(lambda: call(lib, launch, args, fm), n=cs.J2_GRAPH))
                            times.append(row)
                            print(f"[ab] {row}: bitwise {equal}, device ms old {t['old']} new {t['new']}", flush=True)
                        elif not equal:
                            print(f"[ab] {row}: bitwise False", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[ab] {smi}: every closed-form row bitwise equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
