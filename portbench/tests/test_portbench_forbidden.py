"""The check that no run loads JAX or the JAX package, and that the
reference loads nothing of the program."""

import subprocess
import sys

from portbench import harness


def test_top_level_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "repro", "repro.core.advisor", "repro_torch",
             "repro_torch.core", "jaxtyping", "reprolib", "numpy"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "repro",
        "repro.core.advisor"]


def test_the_port_passes_the_check():
    assert harness.forbidden_modules(["repro_torch.core.advisor",
                                      "portbench.harness"]) == []


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
         "for m in sys.modules}))"],
        capture_output=True, text=True, timeout=120,
        cwd=str(harness.ROOT), env={"PYTHONPATH": f"{harness.ROOT}"})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program():
    mods = _loaded_after("import portbench.reference.judge\n"
                         "import portbench.inputs.streamhls")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                       "torch"}


def test_the_harness_loads_no_jax():
    mods = _loaded_after(
        "import sys; sys.path.insert(0, 'src')\n"
        "import portbench.harness, portbench.closedloop, portbench.probe\n"
        "import repro_torch.core, repro_torch.core.campaign.scheduler")
    assert not mods & {"repro", "jax", "jaxlib", "flax"}
