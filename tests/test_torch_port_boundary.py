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
import importlib.util
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
    out = [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                           "flash_variants.py",
                                           "paged_splits.py",
                                           "layer_overhead.py")]
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


def _saved_file(directory):
    path = os.path.join(directory, "w.pdparams")
    paddle_tpu_torch.save({"w": torch.ones(2)}, path)
    return path


def _tiny_weights():
    cfg = paddle_tpu_torch.gpt_tiny()
    m = paddle_tpu_torch.GPTForCausalLM(cfg, device="cpu")
    return paddle_tpu_torch.params_to_numpy(m), cfg


@pytest.mark.parametrize("entry", ["resolve_device", "model", "convert",
                                   "kv_cache", "train_model",
                                   "rms_norm_model", "dataloader", "load",
                                   "hapi_model"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, tmp_path):
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
        # the training entry point is the same model, built for training
        "train_model": lambda: paddle_tpu_torch.GPTForCausalLM(
            paddle_tpu_torch.gpt_1p3b(dropout=0.0)).train(),
        # the bucketed serving slice's model
        "rms_norm_model": lambda: paddle_tpu_torch.GPTForCausalLM(
            paddle_tpu_torch.gpt_1p3b(use_rms_norm=True, dropout=0.0)),
        # the high-level API's: batches land on cuda, loads go to cuda,
        # and Model.fit trains a model built on the default device
        "dataloader": lambda: paddle_tpu_torch.io.DataLoader(
            paddle_tpu_torch.io.TensorDataset([torch.zeros(4, 2)])),
        "load": lambda: paddle_tpu_torch.load(_saved_file(tmp_path)),
        "hapi_model": lambda: paddle_tpu_torch.Model(
            paddle_tpu_torch.LeNet()),
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
    x = torch.empty(1, 8, 2, 64, device="meta")
    rows = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        K.flash_fwd(x, x, x, 0.125, True)
    with pytest.raises(ValueError, match="cuda"):
        K.flash_bwd_dq(x, x, x, x, rows, rows, 0.125, True)
    with pytest.raises(ValueError, match="cuda"):
        K.flash_bwd_dkv(x, x, x, x, rows, rows, 0.125, True)
    w = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        K.fused_adamw([w], [w], [w], [w], [1e-3], 0.9, 0.999, 1e-8, [0.0],
                      [1.0], [1.0])
    assert K.launch_counts() == before


@pytest.mark.parametrize("wrapper", ["paged_attention", "rms_norm",
                                     "incubate.paged_attention",
                                     "incubate.fused_rms_norm"])
def test_slice3_wrappers_on_a_non_cpu_tensor_raise(wrapper):
    """The paged decode and RMSNorm wrappers, and the incubate entry points
    over them, refuse a tensor that is neither on the CPU nor on CUDA."""
    from paddle_tpu_torch import incubate
    q = torch.empty(2, 4, 64, device="meta")
    pool = torch.empty(4, 4, 4, 64, device="meta")
    bt = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    ctx = torch.zeros(2, dtype=torch.int32, device="meta")
    x, w = torch.empty(3, 64, device="meta"), torch.empty(64, device="meta")
    calls = {
        "paged_attention": lambda: K.paged_attention(q, pool, pool, bt, ctx),
        "rms_norm": lambda: K.rms_norm(x, w),
        "incubate.paged_attention": lambda: incubate.paged_attention(
            q, pool, pool, bt, ctx),
        "incubate.fused_rms_norm": lambda: incubate.fused_rms_norm(x, w),
    }
    before = K.launch_counts()
    with pytest.raises(ValueError, match="cuda"):
        calls[wrapper]()
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
    assert _build.sources() == ["flash_attention", "flash_attention_sm90",
                                "fused_adamw", "paged_attention",
                                "ragged_paged_attention"]


def test_triton_route_raises_without_triton():
    try:
        import triton  # noqa: F401
        pytest.skip("triton is installed here")
    except ImportError:
        pass
    with pytest.raises(ImportError):
        ln_mod._triton_kernel()


@pytest.mark.parametrize("source,replaces,bound", [
    ("csrc/ragged_paged_attention.cu", ["ragged_attention.py:108"], "bytes"),
    ("layer_norm.py", ["layer_norm.py:39"], "bytes"),
    ("csrc/flash_attention.cu", ["flash_attention.py:106",
                                 "flash_attention.py:262",
                                 "flash_attention.py:285"], "operations"),
    ("csrc/flash_attention_sm90.cu", ["flash_attention.py:106",
                                      "flash_attention.py:262",
                                      "flash_attention.py:285"], "bytes"),
    ("csrc/fused_adamw.cu", ["fused_adamw.py:60"], "bytes"),
    ("csrc/paged_attention.cu", ["paged_attention.py:175"], "bytes"),
    ("rms_norm.py", ["rms_norm.py:39"], "bytes"),
])
def test_kernel_sources_carry_their_note(source, replaces, bound):
    """Each kernel names the TPU kernel it replaces and what bounds it."""
    src = open(os.path.join(PKG, "ops", "kernels", source)).read()
    for r in replaces:
        assert f"paddle_tpu/ops/pallas/{r}" in src
    assert f"Bound: {bound}" in src


def _fused_qkv(b, s, h, d, dtype, offset=0):
    """q, k, v as views of one [B, S, 3*H*D (+ offset)] projection (the
    GPT's layout), starting ``offset`` elements into each row."""
    qkv = torch.randn(b, s, 3 * h * d + offset).to(dtype)
    return [qkv[..., offset + i * h * d:offset + (i + 1) * h * d]
            .reshape(b, s, h, d) for i in range(3)]


@pytest.mark.parametrize("case", ["fused_views", "unaligned_view",
                                  "head_major_view", "extent_one"])
def test_flash_host_preparation(case):
    """What the flash wrappers hand the kernels, on the host: fused-QKV
    views go as they are (no copy; their own batch, seq and head strides in
    the meta array), a view whose rows are not 16-byte aligned or whose
    strides do not grow head < seq < batch (the TMA map's dimension order)
    is re-laid out contiguous, and a dimension of extent 1 does not count
    against the order."""
    fa = importlib.import_module("paddle_tpu_torch.ops.kernels."
                                 "flash_attention")
    b, s, h, d = 2, 5, 3, 16
    if case == "fused_views":
        q, k, v = _fused_qkv(b, s, h, d, torch.bfloat16)
    elif case == "unaligned_view":
        q, k, v = _fused_qkv(b, s, h, d, torch.bfloat16, offset=1)
    elif case == "head_major_view":
        q, k, v = (torch.randn(b, h, s, d).to(torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
    else:
        # B = H = 1: a [1, S, 1, D] slice whose batch and head strides are
        # whatever the parent had
        q, k, v = (x[:1, :, 1:2] for x in _fused_qkv(b, s, h, d,
                                                      torch.float32))
    do = torch.randn(q.shape).to(q.dtype)
    (tq, tk, tv, tdo), meta = fa._prepare("flash_bwd_dkv", q, k, v, do)
    B, S, H, D = q.shape
    assert list(meta[:5]) == [B, H, S, S, D]
    in_place = case in ("fused_views", "extent_one")
    for x, t in ((q, tq), (k, tk), (v, tv)):
        assert (t.data_ptr() == x.data_ptr()) == in_place
        assert torch.equal(t, x)
        if not in_place:
            assert t.is_contiguous()
    assert tdo.data_ptr() == do.data_ptr()       # contiguous: as it is
    got = [tuple(meta[5 + 3 * i:8 + 3 * i]) for i in range(4)]
    want = [(t.stride(0), t.stride(1), t.stride(2))
            for t in (tq, tk, tv, tdo)]
    assert got == want
    if case == "fused_views":
        assert got[0] == (s * 3 * h * d, 3 * h * d, d)
    # on the CPU the wrappers run the plain versions and count nothing
    before = K.launch_counts()
    o, lse = K.flash_fwd(q, k, v, 0.25, True)
    delta = K.flash_delta(o, do)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse, delta, 0.25, True)
    assert K.launch_counts() == before
    ro, rl = K.flash_fwd_reference(*(x.transpose(1, 2).reshape(B * H, S, D)
                                     for x in (q, k, v)), 0.25, True)
    torch.testing.assert_close(o, ro.reshape(B, H, S, D).transpose(1, 2),
                               rtol=0, atol=0)
    assert dk.shape == dv.shape == k.shape


def _flash_variants():
    path = os.path.join(REPO, "flash_variants.py")
    spec = importlib.util.spec_from_file_location("flash_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VARIANTS


@pytest.mark.parametrize("name", ["as-committed", "tile-major-order",
                                  "no-kv-reloads", "no-exp",
                                  "no-ping-pong", "dkv-no-ping-pong",
                                  "dq-no-ping-pong"])
def test_flash_variant_edits_match_the_source(name):
    """Every variant ``flash_variants.py`` times on the card is a set of
    literal edits of the committed sources; each must match exactly once,
    so the variants stay the designs they are named for."""
    for fname, old, new in _flash_variants()[name]:
        src = open(os.path.join(PKG, "ops", "kernels", "csrc", fname)).read()
        assert src.count(old) == 1, (name, fname)
        assert old != new
