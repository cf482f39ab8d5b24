"""The check that the run loaded neither JAX nor the JAX package."""
import subprocess
import sys

from conftest import ROOT

from msabench.run import forbidden_modules


def test_jax_package_fails_and_port_passes():
    assert forbidden_modules({"twilight_tpu.x": None}) == ["twilight_tpu.x"]
    assert forbidden_modules({"twilight_tpu_torch.x": None,
                              "twilight_tpu_torch": None}) == []
    assert forbidden_modules({"jax": None, "jaxlib.xla": None,
                              "flax.linen": None, "jaxtyping": None}) == [
        "flax.linen", "jax", "jaxlib.xla"]


def test_the_harness_imports_neither():
    code = ("import msabench.run, msabench.judge, msabench.reference, "
            "msabench.control, msabench.trace, msabench.seam, "
            "msabench.pipeline_ref, sys; "
            "from msabench.run import forbidden_modules as f; "
            "sys.exit(1 if f() else 0)")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode == 0
