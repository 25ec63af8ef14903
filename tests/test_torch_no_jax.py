"""The port stands alone: importing `ssvio_tpu_torch` (every module),
chip_smoke.py's module-level code and every script of the port
(scripts/torch_*.py, found by glob, so a new one is held too) needs
neither jax, PyYAML, OpenCV, matplotlib nor the JAX package, and neither
does building
the loop-closing System (the engine's descriptor branch, the LoopClosing
class, interop's loop_closing). The machine with the GPU has none of them.

Runs in a fresh interpreter in which `jax`, `jaxlib`, `yaml`, `cv2`,
`matplotlib` and `ssvio_tpu` are blocked: any import of them raises
ImportError.
"""

import glob
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = '("jax", "jaxlib", "yaml", "cv2", "matplotlib", "ssvio_tpu")'

_CHILD = r"""
import glob, importlib, importlib.util, os, pkgutil, sys
BLOCKED = %s
for name in BLOCKED:
    sys.modules[name] = None          # import of a None entry raises
import ssvio_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ssvio_tpu_torch.__path__,
                                              "ssvio_tpu_torch.")]
assert "ssvio_tpu_torch.graphs" in mods, mods     # the tracking graph
for m in mods:
    importlib.import_module(m)
scripts = sorted(glob.glob("scripts/torch_*.py"))
for path in ["chip_smoke.py"] + scripts:
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in BLOCKED[:-1] or k == "ssvio_tpu"
    or k.startswith("ssvio_tpu."))]
print("SCRIPTS", len(scripts))
print("MODULES", len(mods), "LOADED", loaded)
""" % BLOCKED


def test_port_and_chip_smoke_import_without_jax_or_yaml():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("MODULES")][0]
    n_mods = int(line.split()[1])
    assert n_mods >= 15, line                   # every port module imported
    assert line.endswith("LOADED []"), line
    n_scripts = len(glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))
    assert f"SCRIPTS {n_scripts}" in out.stdout and n_scripts >= 19


_CHILD_LOOP = r"""
import sys
BLOCKED = %s
for name in BLOCKED:
    sys.modules[name] = None
from ssvio_tpu_torch import interop, loopclosing
from ssvio_tpu_torch.config import Settings, bench_loop_settings
from ssvio_tpu_torch.system import System
s = bench_loop_settings()
s.max_keyframes_db = 4
sys_ = System(s, device="cpu")
lc = sys_.loopclosing
assert isinstance(lc, loopclosing.LoopClosing) and sys_._engine.loop_desc
assert s.loop_db_min_size == 24 and Settings().loop_closing_open
assert callable(interop.loop_closing) and callable(
    sys_.frontend.detect_features)
print("LOOP SYSTEM", lc.cap, lc.desc_db.shape[1])
""" % BLOCKED


def test_loop_closing_system_builds_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHILD_LOOP], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOOP SYSTEM 4 4096" in out.stdout, out.stdout


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """With no CUDA device chip_smoke exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a GPU is present here")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
