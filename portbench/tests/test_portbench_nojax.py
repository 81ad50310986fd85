"""Neither JAX nor the JAX package may be loaded in a run: top-level module
names are compared whole, since the port's name begins with the JAX
package's."""

import subprocess
import sys

from conftest import ROOT

from portbench import core


def test_top_level_names_are_compared_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "dolfinx_materials_tpu",
            "dolfinx_materials_tpu.ops.pallas_j2", "dolfinx_materials_tpu_torch", "dolfinx_materials_tpu_torch.ops",
            "jaxtyping", "flaxen", "portbench.core"]
    assert core.forbidden_modules(dict.fromkeys(mods)) == [
        "dolfinx_materials_tpu", "dolfinx_materials_tpu.ops.pallas_j2", "flax.linen", "jax", "jax.numpy",
        "jaxlib.xla_client"]


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import core\n"
        "import portbench.control, portbench.laws, portbench.roofline, portbench.trace\n"
        "for name in ('plate.fused-plastic', 'points.voce'):\n"
        "    c = core.Cell(name)\n"
        "    c.driver(); c.builder(); c.reference()\n"
        "    [c.reader(m['name']) for k in ('end_to_end', 'per_layer') for m in c.metrics(k)]\n"
        "import dolfinx_materials_tpu_torch, dolfinx_materials_tpu_torch.parallel\n"
        "print(core.forbidden_modules())\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "dolfinx_materials_tpu" not in text and "jax" not in text, path
