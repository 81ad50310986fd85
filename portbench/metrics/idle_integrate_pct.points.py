"""The device's idle that ``Material.integrate``'s host path owns, in % of
the profiled window: the gaps whose innermost host event is one of the
program's spans ``material: integrate``, ``material: store`` or ``<material>:
constitutive update``. Left out: the gaps inside them that a runtime call or
an operator owns."""

from portbench.program_registry import idle_owned_pct


def read(rec):
    t = rec.traced.trace if rec.traced else None
    update = [k for k in (t.gaps if t else ()) if k.endswith(": constitutive update")]
    return idle_owned_pct(rec, ["material: integrate", "material: store"] + update)
