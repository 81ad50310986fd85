"""The program's material points: von Mises plasticity through
``Material.integrate`` (the whole-batch fast path, the full-tangent J2
kernel on the card), with the configuration's Voce hardening or a law given
as text, which the program traces into a law program."""

from portbench.laws import compile_law


def build(cfg, law_text, device):
    import torch

    import dolfinx_materials_tpu_torch as dm
    from dolfinx_materials_tpu_torch.models import LinearElasticIsotropic, VoceHardening, vonMisesIsotropicHardening

    law = VoceHardening(cfg["sig0"], cfg["sigu"], cfg["b"]) if law_text is None else compile_law(law_text)
    material = dm.Material(vonMisesIsotropicHardening(LinearElasticIsotropic(cfg["E"], cfg["nu"]), law),
                           dtype=getattr(torch, cfg["dtype"]), device=device)
    material.set_data_manager(cfg["n_points"])
    return material
