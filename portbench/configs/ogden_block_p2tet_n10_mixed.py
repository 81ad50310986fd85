"""The program's Ogden block: the port's ``demos/ogden_block.py``
``make_protocol(N, "tetrahedron", 2, "mixed")`` (unit cube, 6 P2 tets a
cube, degree-4 quadrature, the MFront Ogden law in float64, bottom clamped,
top face pushed down in z) and its fused load step
(``parallel.make_sharded_newton_step_general``, ``precision="mixed"``, the
P2 -> P1 coarse space) on a one-card ``device_mesh``.

Where the step measures ``res0``: at the entering guess ``g_k`` (the
secant predictor with step k's boundary values), in float32: the mixed
step's warm-up evaluates the residual of ``g_k`` rounded to float32 before
its first Newton update, and its float64 polish stops at ``rtol`` times
that norm."""

from types import SimpleNamespace


def build(cfg, device):
    import torch

    from dolfinx_materials_tpu_torch.demos import ogden_block

    law = dict(mu=tuple(cfg["mu"]), alpha=tuple(cfg["alpha"]), K=cfg["K"])
    if law != ogden_block.OGDEN_PARAMS:
        raise ValueError(f"the configuration's law {law} is not the demo's {ogden_block.OGDEN_PARAMS}")
    if (cfg["cell"], cfg["degree"], cfg["quadrature_degree"], cfg["precision"]) != ("tetrahedron", 2, 4, "mixed"):
        raise ValueError("the configuration is not the demo's P2-tet mixed protocol")
    steps = int(cfg["steps"])
    if not 1 <= steps <= 10 or abs(cfg["strain"] / steps - 0.02) > 1e-12:
        raise ValueError("the demo's protocol loads 0.02 of compression a step, at most 10 steps")
    proto = ogden_block.make_protocol(int(cfg["N"]), "tetrahedron", 2, "mixed", device=device, **cfg["fused_step"])
    V, qmap, dev = proto["V"], proto["qmap"], proto["device"]
    return SimpleNamespace(
        step=proto["step"], state=proto["state"], dtype=proto["dtype"], ndofs=V.num_dofs,
        mask=torch.as_tensor(proto["mask"], device=dev),
        loads=[torch.as_tensor(v, dtype=proto["dtype"], device=dev) for v in proto["loads"][:steps]],
        material=qmap.material, rtol=float(cfg["fused_step"]["rtol"]), node_coords=V.node_coords,
        shapes=dict(n_points=qmap.domain.ne * qmap.domain.nq, dtype=cfg["dtype"]),
    )
