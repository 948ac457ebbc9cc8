"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU silently."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kpgnn_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "optax", "kpgnn_tpu")


def port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_or_jax_package():
    sources = port_sources()
    assert len(sources) > 20
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in imported_modules(p)
           if m.split(".")[0] in BANNED]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {BANNED!r}: sys.modules[m] = None\n"
        "import kpgnn_tpu_torch\n"
        "for info in pkgutil.walk_packages(kpgnn_tpu_torch.__path__,\n"
        "                                  'kpgnn_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_train_zinc_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from kpgnn_tpu_torch.scripts import train_zinc

    with pytest.raises(RuntimeError, match="--device cpu"):
        train_zinc.main(["--dataset_dir", str(tmp_path), "--save_dir",
                         str(tmp_path / "s"), "--backend", "pallas"])
    assert not (tmp_path / "s").exists()


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from kpgnn_tpu_torch.ops import cuda_lib

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cuda_lib, "NVCC_FALLBACK", "/nonexistent/nvcc")
    monkeypatch.setattr(cuda_lib, "BUILD_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.build("gather_segment_sum.cu")
    assert not any(tmp_path.iterdir())      # nothing half-built left
