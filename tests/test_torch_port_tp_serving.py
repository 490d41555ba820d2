"""Tensor-parallel serving of the port against the JAX package's, on the
CPU.

Two ranks of the port (``tests/torch_tp_worker.py serving``, over gloo) at
model-parallel degree 2, against the JAX package on a 2-device ``model``
mesh of its CPU devices:

* the three sharded serving wrappers and ``sharded_flash_attention``,
  called with JAX's whole-head signature (``tests/test_serving.py:215``,
  ``tests/test_serving_parity.py:226,279``'s inputs): every rank's
  stitched output is JAX's (f32, ``rtol 1e-5 / atol 1e-6``, the plain
  kernels); each rank's ``local`` call on its contiguous head slice is
  its slice of that output, and a strided head slice of the pools is
  refused;
* the ragged and bucketed engines serving ``gpt_tiny(tensor_parallel=
  True)`` from JAX's ``gpt_tiny`` weights: every rank's greedy tokens
  equal JAX's engine's (``mesh=`` the 2-device mesh) on the same prompts;
* JAX's divisibility error, word for word;
* the eager-round accounting at mp 2 (no graph; every round eager), and
  ``start()`` refused;
* a desync (rank 1 submits one request more) that raises
  ``CollectiveDesyncError`` on both ranks, naming the round, and does not
  hang.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.pallas.flash_attention import \
    sharded_flash_attention as jax_sharded_flash
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import (sharded_paged_attention,
                                sharded_paged_prefill,
                                sharded_ragged_attention)

from test_torch_port_collective import finish_ranks, ref_attention, \
    run_once, start_ranks

TOL = dict(rtol=1e-5, atol=1e-6)
MP = 2
NEW = 6


def _inputs():
    f = "float32"
    out = {}
    # tests/test_serving.py:183 / :215 (MHA), test_serving_parity.py:226
    # (GQA 8 / 2)
    rng = np.random.RandomState(1)
    out.update({"pm/q": rng.randn(3, 4, 8).astype(f),
                "pm/kp": rng.randn(8, 4, 4, 8).astype(f),
                "pm/vp": rng.randn(8, 4, 4, 8).astype(f),
                "pm/bt": rng.randint(1, 8, size=(3, 4)).astype("int32"),
                "pm/lens": np.array([3, 7, 12], "int32")})
    rng = np.random.RandomState(7)
    out.update({"pd/q": rng.randn(3, 8, 8).astype(f),
                "pd/kp": rng.randn(8, 4, 2, 8).astype(f),
                "pd/vp": rng.randn(8, 4, 2, 8).astype(f),
                "pd/bt": rng.randint(1, 8, size=(3, 4)).astype("int32"),
                "pd/lens": np.array([3, 7, 12], "int32")})
    # a chunk step: two rows of 8-token chunks at 0 and 5, GQA 8 / 2
    rng = np.random.RandomState(11)
    out.update({"pf/q": rng.randn(2, 8, 8, 8).astype(f),
                "pf/kp": rng.randn(16, 4, 2, 8).astype(f),
                "pf/vp": rng.randn(16, 4, 2, 8).astype(f),
                "pf/bt": rng.randint(1, 16, size=(2, 4)).astype("int32"),
                "pf/start": np.array([0, 5], "int32"),
                "pf/lens": np.array([8, 3], "int32")})
    # test_serving_parity.py:279
    rng = np.random.RandomState(13)
    H, KVH, D, P, page, maxp, R, T = 8, 2, 8, 16, 4, 4, 3, 16
    out.update({"rg/q": rng.randn(T, H, D).astype(f),
                "rg/kp": rng.randn(P, page, KVH, D).astype(f),
                "rg/vp": rng.randn(P, page, KVH, D).astype(f),
                "rg/bt": rng.randint(1, P, size=(R, maxp)).astype("int32"),
                "rg/rs": np.array([0, 1, 6], np.int32),
                "rg/rl": np.array([1, 5, 3], np.int32),
                "rg/kl": np.array([7, 5, 9], np.int32)})
    rng = np.random.RandomState(17)
    for k in ("fq", "fk", "fv"):
        out[k] = rng.randn(2, 16, 4, 8).astype(f)
    return out


def _mesh():
    return Mesh(np.array(jax.devices()[:MP]), ("model",))


def _jax_engine_tokens(model, prompts, ragged):
    kw = dict(prefill_chunk=6, prefill_token_budget=12) if ragged else {}
    eng = JaxEngine(model, page_size=4, num_pages=64, max_slots=4,
                    attn_backend="xla", mesh=_mesh(), ragged=ragged, **kw)
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    eng.run_until_idle()
    return [r.result(10) for r in reqs]


def _run(root):
    inp = _inputs()
    np.savez(os.path.join(root, "inputs.npz"), **inp)
    # test_serving_parity.py's seeded model and ragged-vs-bucketed prompts
    paddle.seed(1234)
    model = JaxGPT(jax_gpt_tiny())
    model.eval()
    np.savez(os.path.join(root, "gpt.npz"),
             **{n: np.asarray(p._data) for n, p in
                model.state_dict().items()})
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (11, 12, 3, 9)]
    with open(os.path.join(root, "prompts.json"), "w") as f:
        json.dump(prompts, f)
    procs = start_ranks("serving", root, MP)
    jax_out = {tag: _jax_engine_tokens(model, prompts, ragged)
               for tag, ragged in (("ragged", True), ("bucketed", False))}
    with pytest.raises(ValueError) as err:
        JaxEngine(JaxGPT(jax_gpt_tiny(num_kv_heads=1)), mesh=_mesh(),
                  attn_backend="xla")
    jax_out["divisible"] = str(err.value)
    return inp, jax_out, finish_ranks(procs, root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_once(tmp_path_factory, "tp_serving", _run)


def _J(inp, prefix, keys):
    return [jnp.asarray(inp[f"{prefix}/{k}"]) for k in keys]


@pytest.mark.parametrize("case", ["pm", "pd"])
def test_sharded_paged_attention(runs, case):
    inp, _, ranks = runs
    want = np.asarray(sharded_paged_attention(_mesh())(
        *_J(inp, case, ("q", "kp", "vp", "bt", "lens"))))
    H = want.shape[1] // MP
    for r, (out, info) in enumerate(ranks):
        np.testing.assert_allclose(out[case], want, **TOL)
        np.testing.assert_allclose(out[f"{case}/local"],
                                   want[:, r * H:(r + 1) * H], **TOL)
        assert "strided view" in info[f"{case}/strided"]


def test_sharded_paged_prefill(runs):
    inp, _, ranks = runs
    want = np.asarray(sharded_paged_prefill(_mesh())(
        *_J(inp, "pf", ("q", "kp", "vp", "bt", "start", "lens"))))
    for out, _ in ranks:
        # rows past each chunk's length are padding the caller discards
        for b, n in enumerate(inp["pf/lens"]):
            np.testing.assert_allclose(out["prefill"][b, :n],
                                       want[b, :n], **TOL)


def test_sharded_ragged_attention(runs):
    inp, _, ranks = runs
    want = np.asarray(sharded_ragged_attention(_mesh())(
        *_J(inp, "rg", ("q", "kp", "vp", "rs", "rl", "kl", "bt"))))
    H = want.shape[1] // MP
    for r, (out, _) in enumerate(ranks):
        np.testing.assert_allclose(out["ragged"], want, **TOL)
        np.testing.assert_allclose(out["ragged/local"],
                                   want[:, r * H:(r + 1) * H], **TOL)


def test_sharded_flash_attention(runs):
    inp, _, ranks = runs
    mesh = Mesh(np.array(jax.devices()[:MP]).reshape(1, MP),
                ("data", "model"))
    want = np.asarray(jax_sharded_flash(mesh, impl=ref_attention)(
        *(jnp.asarray(inp[k]) for k in ("fq", "fk", "fv"))))
    for out, _ in ranks:
        np.testing.assert_allclose(out["flash"], want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("tag", ["ragged", "bucketed"])
def test_tp_engine_tokens_are_jaxs(runs, tag):
    _, jax_out, ranks = runs
    for _, info in ranks:
        assert info[f"{tag}/tokens"] == jax_out[tag]


@pytest.mark.parametrize("tag", ["ragged", "bucketed"])
def test_rounds_run_eagerly_at_mp_2(runs, tag):
    """A gloo collective cannot be captured: at mp 2 the engine (built
    with ``jit=True``) runs every round eagerly and holds no graph; its
    pools hold this rank's KV heads."""
    for _, info in runs[2]:
        st = info[f"{tag}/stats"]
        assert st["mp_degree"] == MP and st["jit"] is True
        assert st["graphs"] == 0
        launches = st["steps"] if tag == "ragged" else \
            sum(st["bucketed_launches"].values())
        assert st["eager_rounds"] == launches > 0
        assert st["num_kv_heads"] == jax_gpt_tiny().num_heads // MP


def test_divisibility_error_is_jaxs(runs):
    _, jax_out, ranks = runs
    for _, info in ranks:
        assert info["divisible"] == jax_out["divisible"]


def test_desync_raises_on_every_rank(runs):
    """Rank 1 submits one request more: both ranks raise at the first
    round's plan check, naming it, and both processes end."""
    for _, info in runs[2]:
        msg = info["desync"]
        assert msg is not None
        assert "collective desync at serving round 0" in msg
        assert "rank 1 diverged" in msg
        assert "lockstep" in info["start"]
