"""The port's tensor-parallel layers and tensor-parallel GPT against the JAX
package's, on the CPU.

Two ranks of the port (``tests/torch_tp_worker.py tp``, over gloo) run
at model-parallel degree 2, each holding its shard of the same whole
weights; the JAX package runs its layers at ``mp_degree`` 2 on its
8-device CPU mesh (GSPMD owns the whole weight), from those weights:

* ``tests/test_distributed.py:139-207``'s cases: column -> relu -> row
  (both the split and the gathered form), the vocab-parallel embedding
  and the parallel cross-entropy — forward outputs and every gradient,
  each rank's against its slice of JAX's;
* ``gpt_tiny(tensor_parallel=True)``: the gathered logits, the TP
  criterion's loss and every parameter's gradient (the rank's slice of
  JAX's, cut by the parameter's own ``tp_split``), with the head-coherent
  QKV split, and ``state_dict``'s local shapes (a deviation, ROADMAP
  Queue 3);

all in f32 within ``rtol 1e-4 / atol 1e-5``, the port's f32 tolerance
(the all-reduces add the two ranks' partial sums in another order than
one matmul does). The refusals: ``tp_overlap=True``, another rank's
``mp_rank`` and ``sequence_parallel=True``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import env as jax_env
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import topology as jax_topo
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as pt
from paddle_tpu_torch.models.gpt import qkv_columns

from test_torch_port_collective import finish_ranks, run_once, start_ranks

TOL = dict(rtol=1e-4, atol=1e-5)
MP = 2


def _jax_mp_init():
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": MP,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}
    jfleet.init(strategy=strategy)


def _T(a, grad=False):
    return paddle.to_tensor(np.asarray(a), stop_gradient=not grad)


def _np(t):
    return np.asarray(t._data)


def _jax_layers(inp):
    """JAX's mp layers on the inputs -> {key: array}, the port's keys."""
    want = {}
    for tag, gather in (("split", False), ("gathered", True)):
        col = jfleet.ColumnParallelLinear(16, 32, gather_output=gather)
        row = jfleet.RowParallelLinear(32, 16, input_is_parallel=not gather)
        col.weight.set_value(inp["w1"])
        col.bias.set_value(inp["b1"])
        row.weight.set_value(inp["w2"])
        row.bias.set_value(inp["b2"])
        x = _T(inp["x"], grad=True)
        y = row(JF.relu(col(x)))
        y.sum().backward()
        want[f"{tag}/out"] = _np(y)
        want[f"{tag}/x_grad"] = _np(x.grad)
        for name, lyr in (("col", col), ("row", row)):
            for pn, p in lyr.named_parameters():
                want[f"{tag}/{name}.{pn}.grad"] = _np(p.grad)
    emb = jfleet.VocabParallelEmbedding(64, 16)
    emb.weight.set_value(inp["emb"])
    e = emb(_T(inp["ids"]))
    (e * _T(inp["emb_w"])).sum().backward()
    want["emb/out"], want["emb/grad"] = _np(e), _np(emb.weight.grad)
    logits = _T(inp["logits"], grad=True)
    loss = jfleet.ParallelCrossEntropy()(logits, _T(inp["labels"]))
    loss.sum().backward()
    want["pce/loss"], want["pce/grad"] = _np(loss), _np(logits.grad)
    return want


def _jax_gpt():
    """JAX's ``gpt_tiny(tensor_parallel=True)``, biases and norms moved
    off their constant initial values -> (the model, its whole
    weights)."""
    paddle.seed(41)
    m = JaxGPT(jax_gpt_tiny(tensor_parallel=True))
    rng = np.random.RandomState(41)
    for name, p in m.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
        elif ".ln_" in name or "ln_f" in name:
            p._data = jnp.asarray(1 + 0.1 * rng.randn(*p.shape),
                                  jnp.float32)
    return m, {n: np.asarray(p._data) for n, p in m.state_dict().items()}


def _jax_gpt_step(m, inp):
    """The model's logits, TP criterion loss and gradients."""
    m.train()
    logits = m(_T(inp["ids_gpt"]))
    loss = JaxCriterion(m.config)(logits, _T(inp["labels_gpt"]))
    loss.backward()
    grads = {n: _np(p.grad) for n, p in m.named_parameters()}
    return _np(logits), float(_np(loss)), grads


def _run(root):
    """The port's ranks start as soon as their inputs are written; JAX's
    side runs meanwhile."""
    rng = np.random.RandomState(7)
    f = "float32"
    inp = {"w1": rng.randn(16, 32).astype(f), "b1": rng.randn(32).astype(f),
           "w2": rng.randn(32, 16).astype(f), "b2": rng.randn(16).astype(f),
           "x": rng.randn(4, 16).astype(f), "emb": rng.randn(64, 16).astype(f),
           "ids": rng.randint(0, 64, (4, 7)),
           "emb_w": rng.randn(4, 7, 16).astype(f),
           "logits": rng.randn(6, 16).astype(f),
           "labels": np.array([0, 15, 7, 8, -100, 3]),
           "ids_gpt": rng.randint(0, 256, (2, 16)),
           "labels_gpt": rng.randint(0, 256, (2, 16))}
    saved = (jax_env._initialized, jax_env._world_mesh, jax_topo._hcg,
             jfleet._fleet_initialized, jfleet._strategy)
    try:
        _jax_mp_init()
        model, weights = _jax_gpt()
        np.savez(os.path.join(root, "inputs.npz"), **inp)
        np.savez(os.path.join(root, "gpt.npz"), **weights)
        procs = start_ranks("tp", root, MP)
        want = _jax_layers(inp)
        logits, loss, grads = _jax_gpt_step(model, inp)
    finally:
        (jax_env._initialized, jax_env._world_mesh, jax_topo._hcg,
         jfleet._fleet_initialized, jfleet._strategy) = saved
    return inp, want, weights, logits, loss, grads, finish_ranks(procs, root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_once(tmp_path_factory, "tp", _run)


def _cut(full, dim, index):
    return np.take(full, index, axis=dim)


@pytest.mark.parametrize("tag", ["split", "gathered"])
def test_column_row_parallel_linear_forward_and_gradients(runs, tag):
    _, want, *_, ranks = runs
    for r, (out, _) in enumerate(ranks):
        for key in ("out", "x_grad", "row.bias.grad"):
            np.testing.assert_allclose(out[f"{tag}/{key}"],
                                       want[f"{tag}/{key}"], err_msg=key,
                                       **TOL)
        cols = np.arange(r * 16, (r + 1) * 16)
        np.testing.assert_allclose(
            out[f"{tag}/col.weight.grad"],
            _cut(want[f"{tag}/col.weight.grad"], 1, cols), **TOL)
        np.testing.assert_allclose(
            out[f"{tag}/col.bias.grad"],
            _cut(want[f"{tag}/col.bias.grad"], 0, cols), **TOL)
        np.testing.assert_allclose(
            out[f"{tag}/row.weight.grad"],
            _cut(want[f"{tag}/row.weight.grad"], 0, cols), **TOL)
        # each rank holds its shard, not the whole weight
        assert out[f"{tag}/col.weight"].shape == (16, 16)
        assert out[f"{tag}/row.weight"].shape == (16, 16)
        assert out[f"{tag}/row.bias"].shape == (16,)


def test_vocab_parallel_embedding(runs):
    _, want, *_, ranks = runs
    for r, (out, _) in enumerate(ranks):
        np.testing.assert_allclose(out["emb/out"], want["emb/out"], **TOL)
        np.testing.assert_allclose(out["emb/grad"],
                                   want["emb/grad"][r * 32:(r + 1) * 32],
                                   **TOL)


def test_parallel_cross_entropy(runs):
    """Each rank passes its class slice; the loss (an ignored label
    included) is JAX's, the gradient its slice of JAX's."""
    _, want, *_, ranks = runs
    for r, (out, _) in enumerate(ranks):
        np.testing.assert_allclose(out["pce/loss"], want["pce/loss"], **TOL)
        np.testing.assert_allclose(out["pce/grad"],
                                   want["pce/grad"][:, r * 8:(r + 1) * 8],
                                   **TOL)


def test_split_builds_the_tp_layer(runs):
    """``split(..., "linear", axis=1)`` is a gathered column-parallel
    linear: its output's shape and (random, one logical weight) values
    agree on both ranks."""
    inp, *_, ranks = runs
    a, b = ranks[0][0]["split"], ranks[1][0]["split"]
    assert a.shape == (4, 32)
    np.testing.assert_array_equal(a, b)


def test_qkv_split_is_head_coherent():
    """Rank ``r`` holds its query heads, its K heads and its V heads — a
    contiguous split of the fused columns would give rank 0 all of q."""
    H, KVH, Dh = 4, 2, 2
    got = [qkv_columns(H, KVH, Dh, r, 2).tolist() for r in range(2)]
    assert got[0] == [0, 1, 2, 3, 8, 9, 12, 13]
    assert got[1] == [4, 5, 6, 7, 10, 11, 14, 15]
    assert sorted(got[0] + got[1]) == list(range((H + 2 * KVH) * Dh))
    with pytest.raises(ValueError, match="not divisible"):
        qkv_columns(4, 1, 2, 0, 2)


def test_tp_gpt_logits_and_criterion(runs):
    """Every rank's gathered logits and the TP criterion's loss are JAX's
    TP model's."""
    _, _, _, logits, loss, _, ranks = runs
    for out, info in ranks:
        np.testing.assert_allclose(out["gpt/logits"], logits, **TOL)
        np.testing.assert_allclose(float(out["gpt/loss"]), loss, **TOL)
        # this rank's heads: 4 / 2 query, 4 / 2 KV
        assert info["mp"] == [2, 2, 2]


def test_tp_gpt_gradients_are_jaxs_slices(runs):
    _, _, weights, _, _, grads, ranks = runs
    cfg = pt.gpt_tiny(tensor_parallel=True)
    Dh = cfg.hidden_size // cfg.num_heads
    for r, (out, _) in enumerate(ranks):
        model_keys = [k[len("gpt/grad/"):] for k in out
                      if k.startswith("gpt/grad/")]
        assert sorted(model_keys) == sorted(grads)
        for name in model_keys:
            g, w = grads[name], weights[name]
            if name.endswith(("qkv_proj.weight", "qkv_proj.bias")):
                idx = qkv_columns(cfg.num_heads, cfg.num_kv_heads, Dh, r,
                                  MP).numpy()
                g, w = _cut(g, g.ndim - 1, idx), _cut(w, w.ndim - 1, idx)
            elif name.endswith(("fc1.weight", "fc1.bias")):
                n = g.shape[-1] // MP
                idx = np.arange(r * n, (r + 1) * n)
                g, w = _cut(g, g.ndim - 1, idx), _cut(w, w.ndim - 1, idx)
            elif name.endswith(("out_proj.weight", "fc2.weight",
                                "wte.weight")):
                n = g.shape[0] // MP
                g, w = g[r * n:(r + 1) * n], w[r * n:(r + 1) * n]
            np.testing.assert_array_equal(out[f"gpt/param/{name}"], w,
                                          err_msg=name)
            np.testing.assert_allclose(out[f"gpt/grad/{name}"], g,
                                       err_msg=name, **TOL)


def test_state_dict_holds_local_shapes(runs):
    """A deviation kept (ROADMAP Queue 3): each rank's ``state_dict`` holds
    its shards' shapes, where JAX's holds the whole arrays."""
    _, _, weights, *_, ranks = runs
    shapes = ranks[0][1]["local_shapes"]
    assert shapes["gpt.wte.weight"] == [128, 64]
    assert weights["gpt.wte.weight"].shape == (256, 64)
    assert shapes["gpt.h.0.attn.qkv_proj.weight"] == [64, 96]
    assert shapes["gpt.h.0.attn.out_proj.weight"] == [32, 64]
    assert shapes["gpt.h.0.attn.out_proj.bias"] == [64]
    assert shapes["gpt.h.0.mlp.fc1.weight"] == [64, 128]
    assert shapes["gpt.h.0.mlp.fc2.weight"] == [128, 64]
    assert shapes["gpt.wpe.weight"] == list(weights["gpt.wpe.weight"].shape)
    assert shapes == ranks[1][1]["local_shapes"]


def test_refusals(runs):
    refusals = runs[-1][0][1]["refusals"]
    assert refusals["tp_overlap"].startswith("NotImplementedError")
    assert "overlap.py" in refusals["tp_overlap"]
    assert refusals["mp_rank"].startswith("ValueError")
    assert "not the model's own" in refusals["mp_rank"]
    assert refusals["seq_parallel"].startswith("NotImplementedError")
    assert "item 8" in refusals["seq_parallel"]


def test_sequence_parallel_refused_in_process():
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        pt.GPTForCausalLM(pt.gpt_tiny(sequence_parallel=True), device="cpu")
