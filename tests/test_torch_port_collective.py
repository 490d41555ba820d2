"""The port's eager collectives against the JAX package's, on the CPU.

JAX's collectives take one global array whose leading axis is the rank
axis; the port's take each rank's own tensor. Two jobs of the port's ranks
(``tests/torch_tp_worker.py collective``, over gloo, as the launcher
starts them) run every collective, stream and ``comm_extra`` op at world 2
and at world 4, rank ``i`` on the slice ``i`` of one numpy array made
from a seed; the JAX package runs the same op on the whole array over a
group of as many devices of its 8-device CPU mesh, and rank ``i``'s
result must equal JAX's result ``[i]`` (f32 ``rtol 1e-6 / atol 1e-6``;
the quantized all-reduces and the attention within ``1e-5``). The jobs
start once a test run, both at once (``run_once``: the xdist workers that
get this file's tests share one result).

The same jobs hold ``fleet.init``'s topology against JAX's
``CommunicateTopology`` (``tests/test_distributed.py:125``'s checks at a
(data 2, model 2) split of world 4), a ``new_group`` of the first and last
rank, ``world_mesh``, ``sharded_flash_attention`` over (data, model), and
that every op left a completed flight-recorder entry, a latency histogram
and a trace event (``observe_collective`` / ``collective_event``).
"""
import fcntl
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import comm_extra as jcx
from paddle_tpu.distributed import stream as jstream
from paddle_tpu.distributed.topology import CommunicateTopology
from paddle_tpu.ops.pallas.flash_attention import \
    sharded_flash_attention as jax_sharded_flash

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import collective as port_collective

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_tp_worker.py")
TOL = dict(rtol=1e-6, atol=1e-6)
WORLDS = (2, 4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(mode, root, world):
    """Start ``world`` ranks of the worker's ``mode`` over ``root`` (its
    ``inputs.npz`` written), as the launcher would start them -> the
    processes."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_TPU_", "PADDLE_TRAINER"))}
    env.update(PYTHONPATH=REPO, PADDLE_TPU_NUM_PROCESSES=str(world),
               PADDLE_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}")
    return [subprocess.Popen(
        [sys.executable, WORKER, mode, root],
        env=dict(env, PADDLE_TPU_PROCESS_ID=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish_ranks(procs, root, timeout=300):
    """Wait for the ranks -> each rank's (arrays, info)."""
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return [(dict(np.load(os.path.join(root, f"rank{r}.npz"))),
             json.load(open(os.path.join(root, f"rank{r}.json"))))
            for r in range(len(procs))]


def run_once(tmp_path_factory, name, compute):
    """``compute(directory)`` once a test run. Under xdist the workers that
    get a file's tests share one result: the first to ask computes it
    under a file lock in the run's shared temporary directory, the others
    wait for the lock and read it, so the ranks start once."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return compute(str(tmp_path_factory.mktemp(name)))
    base = tmp_path_factory.getbasetemp().parent / f"{name}-{uid}"
    base.mkdir(exist_ok=True)
    with open(base / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = base / "result.pkl"
        if not done.exists():
            work = base / "work"
            work.mkdir(exist_ok=True)
            result = compute(str(work))
            with open(done, "wb") as f:
                pickle.dump(result, f)
        with open(done, "rb") as f:
            return pickle.load(f)


def ref_attention(q, k, v, causal=True):
    """Plain causal attention on [B, S, H, D] jnp arrays (the JAX side's
    impl for its shard_map'd flash on the CPU mesh)."""
    d = q.shape[-1]
    s = jnp.einsum("bshd,bthd->bhst", q, k) / np.sqrt(d)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((q.shape[1], k.shape[1]), bool)),
                      s, -1e30)
    return jnp.einsum("bhst,bthd->bshd", jax.nn.softmax(s, -1), v)


def _inputs(world, seed):
    rng = np.random.RandomState(seed)
    n = world
    f = "float32"
    return {"ar": rng.randn(n, 3, 4).astype(f),
            "ag": rng.randn(n, 2, 3).astype(f),
            "rs": rng.randn(n, 2 * n, 3).astype(f),
            "a2a": rng.randn(n, n, 3).astype(f),
            "a2as": rng.randn(n, 2 * n).astype(f),
            "fq": rng.randn(4, 16, 4, 8).astype(f),
            "fk": rng.randn(4, 16, 4, 8).astype(f),
            "fv": rng.randn(4, 16, 4, 8).astype(f)}


def _run_jobs(base):
    started = {}
    for world in WORLDS:
        root = os.path.join(base, f"world{world}")
        os.makedirs(root, exist_ok=True)
        inp = _inputs(world, 10 + world)
        np.savez(os.path.join(root, "inputs.npz"), **inp)
        started[world] = (inp, root, start_ranks("collective", root, world))
    return {world: (inp, finish_ranks(procs, root))
            for world, (inp, root, procs) in started.items()}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both port jobs, started at once -> {world: (inputs, [(arrays,
    info) a rank])}."""
    return run_once(tmp_path_factory, "collective", _run_jobs)


def _jax_group(world):
    return jdist.new_group(list(range(world)))


def _T(a):
    return paddle.to_tensor(np.asarray(a))


def _np(t):
    return np.asarray(t._data)


def _each_rank(jobs, world, key, want):
    """Every rank's ``key`` against JAX's ``want[i]``."""
    for i, (out, _) in enumerate(jobs[world][1]):
        np.testing.assert_allclose(out[key], want[i], err_msg=f"{key} {i}",
                                   **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_all_reduce(jobs, world, op):
    x = jobs[world][0]["ar"]
    got = jdist.all_reduce(_T(x), op=op, group=_jax_group(world))
    _each_rank(jobs, world, f"all_reduce/{op}", _np(got))
    if op == "sum":
        sgot = jstream.all_reduce(_T(x), group=_jax_group(world))
        _each_rank(jobs, world, "stream/all_reduce", _np(sgot))


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather(jobs, world):
    x = jobs[world][0]["ag"]
    lst = []
    got = _np(jdist.all_gather(lst, _T(x), group=_jax_group(world)))
    listed = np.stack([_np(t) for t in lst])
    for key in ("all_gather", "all_gather/list", "stream/all_gather"):
        _each_rank(jobs, world, key, [got] * world)
    _each_rank(jobs, world, "all_gather/list", [listed] * world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ["sum", "max"])
def test_reduce_keeps_the_other_ranks_tensors(jobs, world, op):
    x = jobs[world][0]["ar"]
    got = _np(jdist.reduce(_T(x), dst=1, op=op, group=_jax_group(world)))
    _each_rank(jobs, world, f"reduce/{op}", got)
    if op == "sum":
        _each_rank(jobs, world, "stream/reduce", got)


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_and_scatter(jobs, world):
    inp = jobs[world][0]
    g = _jax_group(world)
    got = _np(jdist.broadcast(_T(inp["ar"]), src=1, group=g))
    _each_rank(jobs, world, "broadcast", got)
    _each_rank(jobs, world, "stream/broadcast", got)
    sc = jdist.scatter(_T(np.zeros_like(inp["ag"])),
                       tensor_list=[_T(a) for a in inp["ag"]], src=0,
                       group=g)
    _each_rank(jobs, world, "scatter", _np(sc))
    _each_rank(jobs, world, "stream/scatter", _np(sc))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", ["sum", "max", "avg"])
def test_reduce_scatter(jobs, world, op):
    """Rank ``i``'s payload is JAX's ``[i]``; the list form (this rank's
    chunks, one a rank) gives the same as the tensor form."""
    p = jobs[world][0]["rs"]
    out = _T(np.zeros((world, 2, 3), "float32"))
    got = _np(jdist.reduce_scatter(out, _T(p), op=op,
                                   group=_jax_group(world)))
    _each_rank(jobs, world, f"reduce_scatter/{op}", got)
    if op == "sum":
        _each_rank(jobs, world, "reduce_scatter/list", got)
        _each_rank(jobs, world, "stream/reduce_scatter", got)


@pytest.mark.parametrize("world", WORLDS)
def test_all_to_all_and_alltoall(jobs, world):
    a = jobs[world][0]["a2a"]
    lst = []
    got = _np(jdist.all_to_all(lst, [_T(r) for r in a],
                               group=_jax_group(world)))
    for key in ("all_to_all", "all_to_all/list", "alltoall",
                "stream/alltoall"):
        _each_rank(jobs, world, key, got)
    np.testing.assert_array_equal(np.stack([_np(t) for t in lst]), got)


@pytest.mark.parametrize("world", WORLDS)
def test_alltoall_single(jobs, world):
    x = jobs[world][0]["a2as"]
    out = _T(np.zeros_like(x))
    got = _np(jcx.alltoall_single(out, _T(x), group=_jax_group(world)))
    _each_rank(jobs, world, "alltoall_single", got)
    _each_rank(jobs, world, "stream/alltoall_single", got)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_reaches_the_destination(jobs, world):
    """Every rank's tensor reaches rank 0's list, as JAX's list (which its
    one controller fills everywhere); the other ranks' lists stay
    empty."""
    x = jobs[world][0]["ag"]
    lst = jcx.gather(_T(x), [], dst=0, group=_jax_group(world))
    want = np.stack([_np(t) for t in lst])
    ranks = jobs[world][1]
    for key in ("gather", "stream/gather"):
        np.testing.assert_allclose(ranks[0][0][key], want, **TOL)
    assert [info["gather_len"] for _, info in ranks] == \
        [world] + [0] * (world - 1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("qtype", ["int8", "bf16"])
def test_all_reduce_quantized(jobs, world, qtype):
    x = jobs[world][0]["ar"]
    want = _np(jdist.collective.all_reduce_quantized(
        _T(x), group=_jax_group(world), qtype=qtype))
    for i, (out, _) in enumerate(jobs[world][1]):
        np.testing.assert_allclose(out[f"quantized/{qtype}"], want[i],
                                   rtol=1e-5, atol=1e-5)
    # and it is the sum within the wire format's error
    np.testing.assert_allclose(want[0], x.sum(0), rtol=0,
                               atol=world * np.abs(x).max() / 100)


def test_quantize_int8_block_is_jaxs():
    x = np.random.RandomState(3).randn(5, 7).astype("float32") * 3
    jq, js = jdist.collective.quantize_int8_block(jnp.asarray(x))
    import torch
    q, s = port_collective.quantize_int8_block(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    zq, zs = port_collective.quantize_int8_block(torch.zeros(3))
    assert float(zs) == 1.0 and not zq.any()


@pytest.mark.parametrize("world", WORLDS)
def test_point_to_point(jobs, world):
    """Rank 0 sends to rank 1 (``send`` / ``recv``) and back (``isend`` /
    ``irecv``), plain and through ``stream``; JAX's one controller passes
    the tensor through its mailbox."""
    ag = jobs[world][0]["ag"]
    jcx.send(_T(ag[0]), dst=0)
    t = _T(np.zeros_like(ag[0]))
    jcx.recv(t, src=0)
    np.testing.assert_array_equal(_np(t), ag[0])
    ranks = jobs[world][1]
    for key in ("p2p", "stream/p2p"):
        np.testing.assert_array_equal(ranks[1][0][key], ag[0])
        np.testing.assert_array_equal(ranks[0][0][key], ag[1])


@pytest.mark.parametrize("world", WORLDS)
def test_object_collectives_and_env(jobs, world):
    for r, (_, info) in enumerate(jobs[world][1]):
        assert info["all_gather_object"] == [{"rank": i}
                                             for i in range(world)]
        assert info["broadcast_object_list"] == ["from 1"]
        assert info["scatter_object_list"] == [f"for {r}"]
        assert info["env"] == [r, world, world, "cpu", "gloo", True]
        assert info["group"] == [world, r, r, world]


@pytest.mark.parametrize("world", WORLDS)
def test_every_op_feeds_the_recorder_metrics_and_trace(jobs, world):
    want = {"all_reduce", "all_gather", "reduce", "broadcast", "scatter",
            "reduce_scatter", "all_to_all", "barrier", "gather",
            "alltoall_single", "send", "recv", "all_gather_object",
            "broadcast_object_list", "scatter_object_list",
            "all_reduce_quantized.int8", "all_reduce_quantized.bf16"}
    want |= {f"stream.{k}" for k in (
        "all_reduce", "all_gather", "broadcast", "reduce",
        "reduce_scatter", "scatter", "alltoall", "alltoall_single",
        "gather", "send", "recv")}
    for r, (_, info) in enumerate(jobs[world][1]):
        kinds = set(info["ring_kinds"])
        if r > 1:      # p2p runs between ranks 0 and 1
            want_r = want - {"send", "recv", "stream.send", "stream.recv"}
        else:
            want_r = want
        assert want_r <= kinds, sorted(want_r - kinds)
        assert info["ring_open"] == []
        assert want_r <= set(info["trace_collectives"])
        keys = info["metric_keys"]
        assert any(k.startswith("collective_latency_us{")
                   and "kind=all_reduce}" in k for k in keys), keys
        assert any(k.startswith("collective_bytes_total{")
                   for k in keys), keys


@pytest.mark.parametrize("world", WORLDS)
def test_fleet_init_topology_is_jaxs(jobs, world):
    """``fleet.init`` at (data world/2, model 2): the degrees, the mesh's
    named dims, the topology's tables (JAX's ``CommunicateTopology`` at
    the same dims) and each rank's coordinates; the model group's
    all-reduce sums its ranks."""
    dims = [world // 2, 1, 1, 1, 2]
    topo = CommunicateTopology(None, dims)
    for r, (_, info) in enumerate(jobs[world][1]):
        h = info["hcg"]
        assert (h["mp"], h["dp"], h["mesh_model"], h["topo_world"]) == \
            (2, world // 2, 2, world)
        assert h["mesh_names"] == ["data", "pipe", "sharding", "sep",
                                   "model"]
        assert h["comm_list"] == topo.get_comm_list("model")
        assert len(h["comm_list"]) == world // 2
        coord = topo.get_coord(r)
        assert (h["dp_rank"], h["stage"], h["mp_rank"]) == \
            (coord[0], coord[1], coord[4])
        group = topo.get_comm_list("model")[coord[0]]
        assert h["model_group_ranks"] == group
        assert h["model_group_sum"] == float(sum(group))
        assert h["is_initialized"] and h["same_group"]
        assert info["world_mesh"] == [["world"], world]
        if r in (0, world - 1):
            assert info["sub_group_sum"] == float(world + 1)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_flash_attention_over_data_and_model(jobs, world):
    """Batch over data (world / 2) and heads over model (2): every rank's
    stitched output is JAX's shard_map'd attention."""
    inp = jobs[world][0]
    devs = np.array(jax.devices()[:world]).reshape(world // 2, 2)
    mesh = Mesh(devs, ("data", "model"))
    fa = jax_sharded_flash(mesh, impl=ref_attention)
    want = np.asarray(fa(*(jnp.asarray(inp[k]) for k in ("fq", "fk", "fv"))))
    for out, _ in jobs[world][1]:
        np.testing.assert_allclose(out["sharded_flash"], want, rtol=1e-5,
                                   atol=1e-5)


def test_transport_rule_is_fixed_per_op():
    """gloo takes CUDA tensors for all_reduce and broadcast only: those
    two run on the tensor's device, reduce_scatter rides an all_reduce,
    every other op goes through the host."""
    assert port_collective.TRANSPORT == {
        "all_reduce": "device", "broadcast": "device",
        "reduce_scatter": "device (all_reduce)", "reduce": "host",
        "all_gather": "host", "scatter": "host", "all_to_all": "host",
        "barrier": "host"}
    for op in port_collective.TRANSPORT:
        assert f"``{op}``" in port_collective.__doc__


def test_parallel_mode_and_strategy_are_jaxs():
    for name in ("DATA_PARALLEL", "TENSOR_PARALLEL", "PIPELINE_PARALLEL",
                 "SHARDING_PARALLEL"):
        assert getattr(pt.distributed.ParallelMode, name) == \
            getattr(jdist.ParallelMode, name)
    js, ts = jdist.fleet.DistributedStrategy(), \
        pt.distributed.fleet.DistributedStrategy()
    assert vars(js) == vars(ts)
