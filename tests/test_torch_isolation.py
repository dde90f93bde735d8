"""The port stands alone: no JAX-side import, no silent CPU fallback, no
fallback when the kernel cannot be built."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.serving.server import build_server, env_config
from kubeflow_tpu_torch.utils.device import platform_device, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kubeflow_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kubeflow_tpu")


def _port_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_forbidden_imports():
    bad = []
    files = list(_port_files())
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name in _imported(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert bad == []


def test_package_imports_with_jax_unimportable():
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__")
        for p in _port_files() if p.startswith(PKG))
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load_library("flash_attention_fwd.cu")


def test_build_failure_shows_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(_build.KernelBuildError, match="no sm_90a here"):
        _build.build("flash_attention_fwd.cu")


def test_kernel_path_never_falls_back(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version."""
    q = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="not meta"):
        flash_attention(q, q, q)


def test_default_device_needs_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the no-CUDA rule cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("KFTPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        platform_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_server(env_config())
    monkeypatch.setenv("KFTPU_PLATFORM", "cpu")
    assert platform_device() == torch.device("cpu")
