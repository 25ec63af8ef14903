"""The port stands alone: importing `ssvio_tpu_torch` (every module) and
chip_smoke.py's module-level code needs neither jax, PyYAML nor the JAX
package. The machine with the GPU has none of them.

Runs in a fresh interpreter in which `jax`, `jaxlib`, `yaml` and
`ssvio_tpu` are blocked: any import of them raises ImportError.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, importlib.util, pkgutil, sys
for name in ("jax", "jaxlib", "yaml", "ssvio_tpu"):
    sys.modules[name] = None          # import of a None entry raises
import ssvio_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ssvio_tpu_torch.__path__,
                                              "ssvio_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in ("jax", "jaxlib", "yaml") or k == "ssvio_tpu"
    or k.startswith("ssvio_tpu."))]
print("MODULES", len(mods), "LOADED", loaded)
"""


def test_port_and_chip_smoke_import_without_jax_or_yaml():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("MODULES")][0]
    n_mods = int(line.split()[1])
    assert n_mods >= 15, line                   # every port module imported
    assert line.endswith("LOADED []"), line


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """With no CUDA device chip_smoke exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a GPU is present here")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
