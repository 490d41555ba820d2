"""Boundaries of the PyTorch/CUDA port.

* No module of ``paddle_tpu_torch`` — and not ``chip_smoke.py`` — imports
  ``jax`` or ``paddle_tpu`` (checked on the source, AST only).
* Every module of the package imports on a machine without CUDA, Triton
  or nvcc (kernels are built and Triton imported only at launch).
* Entry points run on ``cuda`` by default and raise without CUDA unless
  ``device="cpu"`` is passed; they never carry on on the CPU by themselves.
* A kernel wrapper given a tensor that is not on the CPU launches its
  kernel or raises: it never falls back to its plain version.
"""
import ast
import importlib
import os
import pkgutil

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build

# the module (the package re-exports the wrapper under the same name)
ln_mod = importlib.import_module("paddle_tpu_torch.ops.kernels.layer_norm")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_never_imports_jax_or_paddle_tpu(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue          # relative: inside the port itself
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), \
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {m}"


def test_every_port_module_imports_without_cuda():
    names = [m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, prefix="paddle_tpu_torch.")]
    assert "paddle_tpu_torch.serving.engine" in names
    for name in names:
        importlib.import_module(name)


def _tiny_weights():
    cfg = paddle_tpu_torch.gpt_tiny()
    m = paddle_tpu_torch.GPTForCausalLM(cfg, device="cpu")
    return {n: p.numpy() for n, p in m.named_parameters()}, cfg


@pytest.mark.parametrize("entry", ["resolve_device", "model", "convert",
                                   "kv_cache"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    from paddle_tpu_torch.serving import PagedKVCache
    weights, cfg = _tiny_weights()
    calls = {
        "resolve_device": lambda: paddle_tpu_torch.resolve_device(),
        "model": lambda: paddle_tpu_torch.GPTForCausalLM(cfg),
        "convert": lambda: paddle_tpu_torch.params_from_paddle_tpu(weights,
                                                                   cfg),
        "kv_cache": lambda: PagedKVCache(2, 8, 4, 4, 16),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    # the same entry point runs when the CPU is asked for
    assert paddle_tpu_torch.resolve_device("cpu").type == "cpu"


def test_engine_runs_where_the_model_lives():
    weights, cfg = _tiny_weights()
    model = paddle_tpu_torch.params_from_paddle_tpu(weights, cfg,
                                                    device="cpu")
    eng = paddle_tpu_torch.ServingEngine(model, page_size=4, num_pages=16,
                                         max_slots=2)
    assert eng.kv.k[0].device.type == "cpu"
    out = eng.generate([3, 1, 4, 1, 5], max_new_tokens=4)
    assert len(out) == 4 and all(0 <= t < cfg.vocab_size for t in out)


def test_wrappers_on_a_non_cpu_tensor_raise_instead_of_falling_back():
    """A ``meta`` tensor is neither the CPU (plain version) nor CUDA
    (kernel): the wrappers must refuse it, not compute it the plain way."""
    q = torch.empty(8, 4, 64, device="meta")
    pool = torch.empty(4, 4, 4, 64, device="meta")
    meta = [torch.zeros(2, dtype=torch.int32, device="meta")] * 3
    bt = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    before = K.launch_counts()
    with pytest.raises(ValueError, match="cuda"):
        K.ragged_paged_attention(q, pool, pool, *meta, bt)
    with pytest.raises(ValueError, match="cuda"):
        K.layer_norm(torch.empty(3, 64, device="meta"))
    assert K.launch_counts() == before


def test_cuda_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """The CUDA route builds from source with nvcc and raises when it is
    missing; there is no prebuilt or plain fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["ragged_paged_attention"])
    assert _build.sources() == ["ragged_paged_attention"]


def test_triton_route_raises_without_triton():
    try:
        import triton  # noqa: F401
        pytest.skip("triton is installed here")
    except ImportError:
        pass
    with pytest.raises(ImportError):
        ln_mod._triton_kernel()


def test_kernel_sources_carry_their_note():
    """Each kernel names the TPU kernel it replaces and what bounds it."""
    cu = open(os.path.join(PKG, "ops", "kernels", "csrc",
                           "ragged_paged_attention.cu")).read()
    assert "paddle_tpu/ops/pallas/ragged_attention.py:108" in cu
    assert "Bound: bytes" in cu
    lnsrc = open(ln_mod.__file__).read()
    assert "paddle_tpu/ops/pallas/layer_norm.py:39" in lnsrc
    assert "Bound: bytes" in lnsrc
