"""The port's ``DataParallel`` against the JAX package's, on the CPU.

Two CPU ranks of the port (``tests/torch_dp_worker.py``, over gloo, as
the launcher would start them) train ``gpt_tiny`` under
``DataParallel`` for 3 AdamW steps, each on its half of one global batch
of 8 sequences; the JAX package's ``DataParallel`` takes the same 3 steps
over the whole batch on its 8-device CPU mesh, from the same weights
(``tests/test_torch_port_train.py``'s perturbed ``gpt_tiny``, its
optimizer settings). The mean of the ranks' half-batch losses must match
JAX's loss and every final parameter JAX's, within that file's f32
tolerance (``rtol 1e-4 / atol 1e-5``); the two ranks' parameters must be
bit-equal (rank 1 starts from perturbed weights, which the wrap-time
broadcast from rank 0 replaces). The workers also check that
``Model.prepare`` at world 2 wraps the network and that its staged step
breaks to eager at the gloo all-reduce, with the ranks' fitted weights
bit-equal, and ``no_sync``'s skip-then-sync. In this process: the
gradient buckets are JAX's, and the unported options raise.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import env as jax_dist_env
from paddle_tpu.distributed import overlap as jax_overlap
from paddle_tpu.distributed.parallel import DataParallel as JaxDataParallel
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.distributed import env as port_env
from paddle_tpu_torch.distributed import parallel as port_parallel

RTOL, ATOL = 1e-4, 1e-5
LR, WD, EPS, STEPS, B, S = 1e-3, 0.1, 1e-6, 3, 8, 16
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_dp_worker.py")


def _exempt(name):
    return name.endswith("bias") or ".ln_" in name or ".ln_f." in name


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    """Both packages' parallel environments put back around each case
    (JAX's ``DataParallel`` initializes its env; ``Model.prepare`` reads
    it)."""
    monkeypatch.setattr(jax_dist_env, "_initialized", False)
    monkeypatch.setattr(jax_dist_env, "_world_mesh", None)
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    for var in ("PADDLE_TPU_DP_OVERLAP", "PADDLE_TPU_DP_QUANT",
                "PADDLE_TPU_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(port_env, "_initialized", False)
    yield


def _jax_model(seed):
    paddle.seed(seed)
    m = JaxGPT(jax_gpt_tiny())
    rng = np.random.RandomState(seed)
    for name, p in m.named_parameters():
        if name.endswith("bias"):
            p._data = jnp.asarray(0.05 * rng.randn(*p.shape), jnp.float32)
        elif ".ln_" in name or "ln_f" in name:
            p._data = jnp.asarray(1 + 0.1 * rng.randn(*p.shape),
                                  jnp.float32)
    return m


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's DataParallel over the whole batch, and the port's two ranks
    over their halves, from the same weights and batches."""
    root = str(tmp_path_factory.mktemp("dp"))
    jm = _jax_model(31)
    init = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    vocab = jax_gpt_tiny().vocab_size
    rng = np.random.RandomState(6)
    ids = rng.randint(0, vocab, size=(STEPS, B, S))
    labels = rng.randint(0, vocab, size=(STEPS, B, S))
    np.savez(os.path.join(root, "init.npz"), **init)
    np.savez(os.path.join(root, "batches.npz"), ids=ids, labels=labels)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_TPU_", "PADDLE_TRAINER"))}
    env.update(PYTHONPATH=REPO, PADDLE_TPU_NUM_PROCESSES="2",
               PADDLE_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, root],
        env=dict(env, PADDLE_TPU_PROCESS_ID=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]

    jax_dist_env._initialized = False
    jm.train()
    jdp = JaxDataParallel(jm)
    jdecay = {p.name for n, p in jm.named_parameters() if not _exempt(n)}
    jopt = paddle.optimizer.AdamW(
        learning_rate=LR, epsilon=EPS, parameters=jdp.parameters(),
        weight_decay=WD, apply_decay_param_fun=lambda n: n in jdecay)
    jcrit = JaxCriterion()
    jlosses = []
    for i in range(STEPS):
        loss = jcrit(jdp(Tensor(jnp.asarray(ids[i]))),
                     Tensor(jnp.asarray(labels[i])))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jlosses.append(float(np.asarray(loss._data)))
    jparams = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    jax_dist_env._initialized = False
    jax_dist_env._world_mesh = None

    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    ranks = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
             for r in range(2)]
    return jlosses, jparams, ranks


def test_two_ranks_match_jax_data_parallel(runs):
    jlosses, jparams, ranks = runs
    got = (ranks[0]["losses"] + ranks[1]["losses"]) / 2
    np.testing.assert_allclose(got, jlosses, rtol=RTOL, atol=ATOL)
    for name, want in jparams.items():
        np.testing.assert_allclose(ranks[0][f"gpt/{name}"], want,
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_replicas_end_bit_equal(runs):
    _, jparams, ranks = runs
    for name in jparams:
        assert np.array_equal(ranks[0][f"gpt/{name}"],
                              ranks[1][f"gpt/{name}"]), name
    # the half-batch losses differ: each rank really saw its own shard
    assert not np.array_equal(ranks[0]["losses"], ranks[1]["losses"])


def test_model_prepare_wraps_and_fit_breaks_to_eager(runs):
    ranks = runs[2]
    for r in ranks:
        assert bool(r["wrapped"])
        assert int(r["graph_breaks"]) == 1
    fit = [k for k in ranks[0] if k.startswith("fit/")]
    assert fit
    for k in fit:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k


def test_no_sync_skips_then_syncs_the_accumulated_sum(runs):
    ranks = runs[2]
    # inside no_sync the gradient stays this rank's own
    assert not np.array_equal(ranks[0]["nosync/local"],
                              ranks[1]["nosync/local"])
    # the next backward syncs the accumulated sums: the mean over ranks
    want = (ranks[0]["nosync/sum"] + ranks[1]["nosync/sum"]) / 2
    for r in ranks:
        np.testing.assert_allclose(r["nosync/synced"], want, rtol=1e-6,
                                   atol=1e-7)
    assert np.array_equal(ranks[0]["nosync/synced"],
                          ranks[1]["nosync/synced"])


def test_gradient_buckets_are_jaxs():
    """The port packs its all-reduce buckets as JAX's ``build_buckets``
    does (reverse order, the cap, the last bucket re-packed)."""
    jm = _jax_model(31)
    init = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = pt.params_from_paddle_tpu(init, pt.gpt_tiny(), device="cpu")
    jb = jax_overlap.build_buckets(jm.parameters(), comm_buffer_size=0.05,
                                   last_comm_buffer_size=0.01)
    tb = port_parallel._buckets(
        [p for p in tm.parameters() if p.requires_grad], 0.05, 0.01)
    assert [[tuple(p.shape) for p in b.params] for b in jb] == \
        [[tuple(p.shape) for p in b] for b in tb]
    assert len(tb) > 2


def test_one_process_wrap_is_the_layer():
    """At world 1 (no coordinator) the wrap syncs nothing: the forward is
    the layer's, and the state dict carries its names."""
    net = pt.nn.Linear(4, 2)
    dp = dist.DataParallel(net)
    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    x = torch.randn(3, 4)
    assert torch.equal(dp(x), net(x))
    assert list(dp.state_dict()) == list(net.state_dict())
    assert dp.parameters() == net.parameters()
    assert dp.scale_loss(x) is x
    assert port_parallel.shard_batch(np.ones((2, 3))).shape == (2, 3)


@pytest.mark.parametrize("kwargs, env, exc", [
    ({"comm_buffer_size": 0}, {}, ValueError),
    ({"last_comm_buffer_size": -1}, {}, ValueError),
    ({"comm_overlap": True}, {}, NotImplementedError),
    ({}, {"PADDLE_TPU_DP_OVERLAP": "1"}, NotImplementedError),
    ({"comm_quant": "int8"}, {}, NotImplementedError),
    ({}, {"PADDLE_TPU_DP_QUANT": "bf16"}, NotImplementedError),
], ids=["buffer", "last_buffer", "overlap", "overlap_env", "quant",
        "quant_env"])
def test_unported_options_raise(kwargs, env, exc, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(exc) as ei:
        dist.DataParallel(pt.nn.Linear(4, 2), **kwargs)
    if exc is NotImplementedError:
        assert "item 8" in str(ei.value)
    else:
        assert "must be > 0" in str(ei.value)
