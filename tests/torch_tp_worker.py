"""A JAX-free tensor-parallel worker for ``tests/test_torch_port_collective.py``,
``tests/test_torch_port_tp.py`` and ``tests/test_torch_port_tp_serving.py``:
one rank of a CPU job over gloo (``PADDLE_TPU_COORDINATOR`` /
``PADDLE_TPU_NUM_PROCESSES`` / ``PADDLE_TPU_PROCESS_ID``, as the launcher
sets them).

``python tests/torch_tp_worker.py <mode> <dir>`` reads ``<dir>/inputs.npz``
(numpy arrays the test made from a seed; rank ``i`` takes slice ``i`` of
the per-rank ones) and writes ``<dir>/rank<r>.npz`` (every result, by
name) and ``<dir>/rank<r>.json`` (flags, counts and messages). Modes:

* ``collective`` — every collective, stream and ``comm_extra`` op on this
  rank's slice; ``fleet.init``'s topology, ``new_group``, ``world_mesh``,
  ``sharded_flash_attention`` over a (data, model) mesh; the flight
  recorder's ring, metrics and trace events of the ops.
* ``tp`` — at model-parallel degree 2: the four mp layers' forward and
  gradients, ``gpt_tiny(tensor_parallel=True)``'s logits, criterion and
  gradients from JAX's weights, and the refusals.
* ``serving`` — at degree 2: the three sharded serving wrappers (whole
  and local calls, the strided pool), the ragged and bucketed engines'
  greedy tokens, their eager-round accounting, the divisibility error and
  a desync that must raise on every rank.
"""
import json
import os
import sys

import numpy as np
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import device
from paddle_tpu_torch.distributed import fleet, stream
from paddle_tpu_torch.distributed import flight_recorder as fr
from paddle_tpu_torch.observability import metrics, tracing


def _t(a):
    return torch.from_numpy(np.array(a))


def collective(inp, rank, world):
    out, info = {}, {}

    def mine(name):
        return _t(inp[name][rank])

    fr.enable(capacity=512)
    metrics.enable()
    tracing.start()
    g = dist.new_group(list(range(world)))
    info["group"] = [g.nranks, g.rank, dist.get_rank(g),
                     dist.get_world_size(g)]
    for op in ("sum", "max", "min", "prod", "avg"):
        t = mine("ar")
        dist.all_reduce(t, op=op, group=g)
        out[f"all_reduce/{op}"] = t.numpy()
    parts = []
    out["all_gather"] = dist.all_gather(parts, mine("ag"), group=g).numpy()
    out["all_gather/list"] = np.stack([p.numpy() for p in parts])
    for op in ("sum", "max"):
        t = mine("ar")
        dist.reduce(t, dst=1, op=op, group=g)
        out[f"reduce/{op}"] = t.numpy()
    t = mine("ar")
    dist.broadcast(t, src=1, group=g)
    out["broadcast"] = t.numpy()
    t = torch.zeros_like(mine("ag"))
    dist.scatter(t, [_t(x) for x in inp["ag"]] if rank == 0 else None,
                 src=0, group=g)
    out["scatter"] = t.numpy()
    payload = mine("rs")
    for op in ("sum", "max", "avg"):
        t = torch.zeros(payload.shape[0] // world, *payload.shape[1:])
        dist.reduce_scatter(t, payload, op=op, group=g)
        out[f"reduce_scatter/{op}"] = t.numpy()
    t = torch.zeros(payload.shape[0] // world, *payload.shape[1:])
    dist.reduce_scatter(t, list(payload.chunk(world)), group=g)
    out["reduce_scatter/list"] = t.numpy()
    got = []
    st = dist.all_to_all(got, list(mine("a2a").unbind(0)), group=g)
    out["all_to_all"] = st.numpy()
    out["all_to_all/list"] = np.stack([x.numpy() for x in got])
    for qt in ("int8", "bf16"):
        t = mine("ar")
        dist.collective.all_reduce_quantized(t, group=g, qtype=qt)
        out[f"quantized/{qt}"] = t.numpy()
    dist.barrier(g)

    # comm_extra
    gl = dist.gather(mine("ag"), [], dst=0, group=g)
    info["gather_len"] = len(gl)
    if gl:
        out["gather"] = np.stack([x.numpy() for x in gl])
    got = []
    out["alltoall"] = dist.alltoall(got, list(mine("a2a").unbind(0)),
                                    group=g).numpy()
    o = torch.zeros_like(mine("a2as"))
    dist.alltoall_single(o, mine("a2as"), group=g)
    out["alltoall_single"] = o.numpy()
    if rank == 0:
        dist.send(mine("ag"), dst=1)
        r = torch.zeros_like(mine("ag"))
        dist.irecv(r, src=1).wait()
        out["p2p"] = r.numpy()
    elif rank == 1:
        r = torch.zeros_like(mine("ag"))
        dist.recv(r, src=0)
        dist.isend(mine("ag"), dst=0).wait()
        out["p2p"] = r.numpy()
    objs = []
    dist.all_gather_object(objs, {"rank": rank}, group=g)
    info["all_gather_object"] = objs
    lst = [f"from {rank}"]
    dist.broadcast_object_list(lst, src=1, group=g)
    info["broadcast_object_list"] = lst
    so = []
    dist.scatter_object_list(so, [f"for {i}" for i in range(world)]
                             if rank == 0 else None, src=0, group=g)
    info["scatter_object_list"] = so
    dist.wait(mine("ag"))
    env = dist.ParallelEnv()
    info["env"] = [env.rank, env.world_size, env.nranks, env.device_type,
                   dist.get_backend(g), dist.is_available()]

    # stream variants: each through its base op, sync and async
    t = mine("ar")
    stream.all_reduce(t, group=g, sync_op=False).wait()
    out["stream/all_reduce"] = t.numpy()
    parts = []
    out["stream/all_gather"] = stream.all_gather(
        parts, mine("ag"), group=g).numpy()
    t = mine("ar")
    stream.broadcast(t, src=1, group=g, use_calc_stream=True)
    out["stream/broadcast"] = t.numpy()
    t = mine("ar")
    stream.reduce(t, dst=1, group=g)
    out["stream/reduce"] = t.numpy()
    t = torch.zeros(payload.shape[0] // world, *payload.shape[1:])
    stream.reduce_scatter(t, payload, group=g)
    out["stream/reduce_scatter"] = t.numpy()
    t = torch.zeros_like(mine("ag"))
    stream.scatter(t, [_t(x) for x in inp["ag"]] if rank == 0 else None,
                   src=0, group=g)
    out["stream/scatter"] = t.numpy()
    out["stream/alltoall"] = stream.alltoall(
        [], list(mine("a2a").unbind(0)), group=g).numpy()
    o = torch.zeros_like(mine("a2as"))
    stream.alltoall_single(o, mine("a2as"), group=g)
    out["stream/alltoall_single"] = o.numpy()
    gl = stream.gather(mine("ag"), [], dst=0, group=g)
    if gl:
        out["stream/gather"] = np.stack([x.numpy() for x in gl])
    if rank in (0, 1):
        r = torch.zeros_like(mine("ag"))
        if rank == 0:
            stream.send(mine("ag"), dst=1)
            stream.recv(r, src=1)
        else:
            stream.recv(r, src=0)
            stream.send(mine("ag"), dst=0)
        out["stream/p2p"] = r.numpy()

    # the flight recorder, the metrics and the trace saw the ops
    kinds = [e["kind"] for e in fr.get_recorder().entries()]
    info["ring_kinds"] = sorted(set(kinds))
    info["ring_open"] = [e["kind"] for e in fr.get_recorder().entries()
                         if e["status"] != "completed"]
    snap = metrics.get_registry().snapshot()
    info["metric_keys"] = sorted(
        k for part in ("counters", "histograms") for k in snap[part]
        if "collective" in k)
    info["trace_collectives"] = sorted({e["name"] for e in
                                        tracing.get_buffer().events
                                        if e.get("cat") == "collective"})
    fr.disable()
    metrics.disable()
    tracing._reset_state()

    # the world mesh and the hybrid topology (dp fills what mp leaves)
    wm = dist.world_mesh()
    info["world_mesh"] = [list(wm.mesh_dim_names), wm.size(0)]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world // 2, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    mg = hcg.get_model_parallel_group()
    t = torch.tensor([float(rank)])
    dist.all_reduce(t, group=mg)
    info["hcg"] = {
        "mp": hcg.get_model_parallel_world_size(),
        "dp": hcg.get_data_parallel_world_size(),
        "mp_rank": hcg.get_model_parallel_rank(),
        "dp_rank": hcg.get_data_parallel_rank(),
        "stage": hcg.get_stage_id(),
        "mesh_model": int(hcg.mesh.size(4)),
        "mesh_names": list(hcg.mesh.mesh_dim_names),
        "topo_world": hcg.topology.world_size(),
        "comm_list": hcg.topology.get_comm_list("model"),
        "model_group_ranks": mg.ranks,
        "model_group_sum": float(t),
        "is_initialized": fleet.is_initialized(),
        "same_group": hcg.get_model_parallel_group() is mg}
    # a group of the first and the last rank
    sub = dist.new_group([0, world - 1])
    if rank in (0, world - 1):
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t, group=sub)
        info["sub_group_sum"] = float(t)
    # flash split over (data, model): batch and heads
    fa = pt.ops.kernels.sharded_flash_attention(hcg.mesh)
    out["sharded_flash"] = fa(_t(inp["fq"]), _t(inp["fk"]),
                              _t(inp["fv"])).numpy()
    return out, info


def _copy_from(layer, arrays):
    """``layer``'s parameters from whole arrays, each cut to its shard."""
    pt.params_from_paddle_tpu(arrays, layer)


def tp(inp, rank, world):
    out, info = {}, {}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": world,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    # column -> relu -> row (test_distributed.py:139), both output forms
    for tag, gather in (("split", False), ("gathered", True)):
        col = fleet.ColumnParallelLinear(16, 32, gather_output=gather)
        row = fleet.RowParallelLinear(32, 16, input_is_parallel=not gather)
        _copy_from(col, {"weight": inp["w1"], "bias": inp["b1"]})
        _copy_from(row, {"weight": inp["w2"], "bias": inp["b2"]})
        x = _t(inp["x"]).requires_grad_(True)
        y = row(torch.relu(col(x)))
        y.sum().backward()
        out[f"{tag}/out"] = y.detach().numpy()
        out[f"{tag}/x_grad"] = x.grad.numpy()
        for name, lyr in (("col", col), ("row", row)):
            for pn, p in lyr.named_parameters():
                out[f"{tag}/{name}.{pn}"] = p.detach().numpy()
                out[f"{tag}/{name}.{pn}.grad"] = p.grad.numpy()
    emb = fleet.VocabParallelEmbedding(64, 16)
    _copy_from(emb, {"weight": inp["emb"]})
    e = emb(_t(inp["ids"]))
    (e * _t(inp["emb_w"])).sum().backward()
    out["emb/out"] = e.detach().numpy()
    out["emb/grad"] = emb.weight.grad.numpy()
    pce = fleet.ParallelCrossEntropy()
    per = inp["logits"].shape[1] // world
    lg = _t(inp["logits"][:, rank * per:(rank + 1) * per]).requires_grad_()
    loss = pce(lg, _t(inp["labels"]))
    loss.sum().backward()
    out["pce/loss"] = loss.detach().numpy()
    out["pce/grad"] = lg.grad.numpy()
    # split() builds a TP layer and applies it
    out["split"] = dist.split(_t(inp["x"]), (16, 32), "linear", axis=1,
                              gather_out=True).detach().numpy()

    # gpt_tiny(tensor_parallel=True) from JAX's weights
    weights = dict(np.load(os.path.join(ROOT, "gpt.npz")))
    cfg = pt.gpt_tiny(tensor_parallel=True)
    model = pt.params_from_paddle_tpu(weights, cfg, device="cpu")
    ids, labels = _t(inp["ids_gpt"]), _t(inp["labels_gpt"])
    model.train()
    logits = model(ids)
    loss = pt.GPTPretrainingCriterion(cfg)(logits, labels)
    loss.backward()
    out["gpt/logits"] = logits.detach().numpy()
    out["gpt/loss"] = loss.detach().numpy()
    sd = model.state_dict()
    info["local_shapes"] = {k: list(v.shape) for k, v in sd.items()}
    for n, p in model.named_parameters():
        out[f"gpt/param/{n}"] = p.detach().numpy()
        out[f"gpt/grad/{n}"] = p.grad.numpy()
    info["mp"] = [model.mp_degree, model.gpt.h[0].attn.num_heads,
                  model.gpt.h[0].attn.num_kv_heads]
    # the refusals
    msgs = {}
    for name, fn in (
            ("tp_overlap", lambda: fleet.ColumnParallelLinear(
                16, 32, tp_overlap=True)),
            ("mp_rank", lambda: pt.params_from_paddle_tpu(
                weights, model, mp_rank=1 - rank)),
            ("seq_parallel", lambda: pt.GPTForCausalLM(
                pt.gpt_tiny(sequence_parallel=True), device="cpu"))):
        try:
            fn()
            msgs[name] = None
        except (NotImplementedError, ValueError) as e:
            msgs[name] = f"{type(e).__name__}: {e}"
    info["refusals"] = msgs
    return out, info


def _engine_tokens(model, hcg, prompts, news, ragged, **kw):
    eng = pt.ServingEngine(model, page_size=4, num_pages=64, max_slots=4,
                           mesh=hcg.mesh, mesh_axis="model", ragged=ragged,
                           **kw)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    eng.run_until_idle()
    return [r.result(10) for r in reqs], eng.stats()


def serving(inp, rank, world):
    out, info = {}, {}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": world,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}
    hcg = fleet.init(is_collective=True, strategy=strategy)
    mesh = hcg.mesh
    S = pt.serving
    # the three wrappers, whole tensors (JAX's signature) and local slices
    for case in ("pm", "pd"):
        q, kp, vp, bt, lens = (_t(inp[f"{case}/{k}"]) for k in
                               ("q", "kp", "vp", "bt", "lens"))
        f = S.sharded_paged_attention(mesh)
        out[case] = f(q, kp, vp, bt, lens).numpy()
        H, KVH = q.shape[1] // world, kp.shape[2] // world
        qs, ks, vs = (q[:, rank * H:(rank + 1) * H],
                      kp[:, :, rank * KVH:(rank + 1) * KVH],
                      vp[:, :, rank * KVH:(rank + 1) * KVH])
        out[f"{case}/local"] = f.local(qs.contiguous(), ks.contiguous(),
                                       vs.contiguous(), bt, lens).numpy()
        try:   # a head slice of the whole pools is a strided view
            f.local(qs.contiguous(), ks, vs, bt, lens)
            info[f"{case}/strided"] = None
        except ValueError as e:
            info[f"{case}/strided"] = str(e)
    q, kp, vp, bt, st, ln = (_t(inp[f"pf/{k}"]) for k in
                             ("q", "kp", "vp", "bt", "start", "lens"))
    out["prefill"] = S.sharded_paged_prefill(mesh)(q, kp, vp, bt, st,
                                                   ln).numpy()
    args = [_t(inp[f"rg/{k}"]) for k in ("q", "kp", "vp", "rs", "rl", "kl",
                                          "bt")]
    f = S.sharded_ragged_attention(mesh)
    out["ragged"] = f(*args).numpy()
    H, KVH = args[0].shape[1] // world, args[1].shape[2] // world
    out["ragged/local"] = f.local(
        args[0][:, rank * H:(rank + 1) * H].contiguous(),
        args[1][:, :, rank * KVH:(rank + 1) * KVH].contiguous(),
        args[2][:, :, rank * KVH:(rank + 1) * KVH].contiguous(),
        *args[3:]).numpy()
    out["flash"] = pt.ops.kernels.sharded_flash_attention(mesh)(
        _t(inp["fq"]), _t(inp["fk"]), _t(inp["fv"])).numpy()

    # the engines at mp 2 over JAX's weights
    weights = dict(np.load(os.path.join(ROOT, "gpt.npz")))
    cfg = pt.gpt_tiny(tensor_parallel=True)
    model = pt.params_from_paddle_tpu(weights, cfg, device="cpu")
    prompts = [list(map(int, p)) for p in json.loads(
        open(os.path.join(ROOT, "prompts.json")).read())]
    news = [6] * len(prompts)
    for tag, ragged, kw in (("ragged", True, dict(prefill_chunk=6,
                                                   prefill_token_budget=12)),
                            ("bucketed", False, {})):
        toks, st = _engine_tokens(model, hcg, prompts, news, ragged, **kw)
        info[f"{tag}/tokens"] = toks
        info[f"{tag}/stats"] = {k: st[k] for k in (
            "mp_degree", "graphs", "eager_rounds", "steps", "jit",
            "distinct_programs", "num_kv_heads", "bucketed_launches")}
    # heads not divisible by the axis: JAX's message
    try:
        small = pt.GPTForCausalLM(pt.gpt_tiny(num_kv_heads=1), device="cpu")
        pt.ServingEngine(small, mesh=mesh, mesh_axis="model")
        info["divisible"] = None
    except ValueError as e:
        info["divisible"] = str(e)
    # a desync: rank 1 submits one request more
    eng = pt.ServingEngine(model, page_size=4, num_pages=64, max_slots=4,
                           mesh=mesh, mesh_axis="model")
    eng.submit(prompts[0], max_new_tokens=4)
    if rank == 1:
        eng.submit(prompts[1], max_new_tokens=4)
    try:
        eng.step()
        info["desync"] = None
    except fr.CollectiveDesyncError as e:
        info["desync"] = str(e)
    try:
        eng.start()
        info["start"] = None
    except RuntimeError as e:
        info["start"] = str(e)
    return out, info


ROOT = None


def main():
    global ROOT
    mode, ROOT = sys.argv[1], sys.argv[2]
    device.DEFAULT_DEVICE = "cpu"
    torch.manual_seed(0)
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    inp = dict(np.load(os.path.join(ROOT, "inputs.npz")))
    out, info = {"collective": collective, "tp": tp,
                 "serving": serving}[mode](inp, rank, world)
    np.savez(os.path.join(ROOT, f"rank{rank}.npz"), **out)
    with open(os.path.join(ROOT, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
