"""Neither JAX nor the JAX package loads with the benchmark."""

import subprocess
import sys
from pathlib import Path

from portbench import imports

PKG = Path(__file__).resolve().parent.parent
REPO = PKG.parent


def test_top_level_names_are_compared_whole():
    assert imports.loaded_forbidden(["mies_tpu_torch", "mies_tpu_torch.ops",
                                     "jaxtyping", "numpy"]) == []
    assert imports.loaded_forbidden(["mies_tpu.ops", "jax._src",
                                     "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax._src", "jaxlib", "mies_tpu.ops"]


def test_no_source_of_the_benchmark_imports_jax():
    assert imports.forbidden_in_sources(PKG) == {}
    names = set().union(*(imports.imported_names(p)
                          for p in PKG.rglob("*.py")))
    assert "mies_tpu_torch" in names and "torch" in names


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys\n"
        "from portbench import harness, imports\n"
        "harness.run('ct_lowdose_nlm.archive', 3, 0.1, False, device='cpu',"
        " shrink={'slice': [32, 32], 'batch': 2, 'pool_bytes': 1})\n"
        "harness.run('xray_clahe.archive', 3, 0.1, False, device='cpu',"
        " shrink={'slice': [32, 32], 'batch': 2, 'pool_bytes': 1})\n"
        "print(imports.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
