"""The port stands alone: it never imports the JAX package, nor the
packages the GPU machine need not have (pandas, cv2, scikit-learn,
safetensors, PIL), imports on a CPU-only machine without triton or nvcc, and
its chip smoke refuses to run without a GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "clip_for_dl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "clip_for_dl_tpu",
             "pandas", "cv2", "sklearn", "safetensors", "PIL")
SMOKE_OK_PREFIX = '{"ok": true'


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_forbidden_imports():
    """The scan is not vacuous: it flags both import forms, relative
    imports excepted."""
    src = ("import jax.numpy as jnp\nfrom clip_for_dl_tpu.ops import x\nfrom . import y\n"
           "import pandas as pd\nfrom sklearn.model_selection import train_test_split\n"
           "from PIL import Image\nimport cv2, safetensors.torch\n")
    tree = ast.parse(src)
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN] == [
        "jax.numpy", "pandas", "cv2", "safetensors.torch", "clip_for_dl_tpu.ops",
        "sklearn.model_selection", "PIL"]


_IMPORT_ALL = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("triton", "pandas", "cv2", "sklearn", "safetensors", "PIL"):
            raise ImportError(f"{name} is blocked in this check")
        return None

sys.meta_path.insert(0, Block())
import clip_for_dl_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from clip_for_dl_tpu_torch.ops import _build
assert _build._lib is None, "importing built the kernels"
print(len(names))
"""


def test_port_imports_on_cpu_without_triton_or_nvcc():
    """Every module imports with triton and the packages the GPU machine
    need not have blocked, and with no nvcc on the path."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME="",
               CUDA_PATH="", PYTHONPATH=f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_fast_without_gpu(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke would run for real")
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = REPO
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert SMOKE_OK_PREFIX not in out.stdout
