#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which either passes or ends the script with a non-zero
exit code:

1. **device** — ``nvidia-smi`` name and power limit, torch/CUDA versions;
   the CUDA kernels are built from ``paddle_tpu_torch/ops/kernels/csrc``
   with nvcc (one process per source, started together) and timed.
2. **kernel parity** — each hand-written kernel against its plain PyTorch
   version on the card: ragged paged attention on a mixed launch (decode
   rows, a whole-prompt prefill, a mid-page chunk continuation, an unused
   row, pad tokens; H=16, D=128, page 16; MHA and GQA KVH=4; f32 and bf16)
   and LayerNorm on ``[T, 2048]`` (f32 and bf16). Then a 2-layer f32 model
   at ``gpt_1p3b`` widths serves through the engine and is held against a
   dense causal forward written here in plain torch (greedy tokens equal,
   logits within 1e-3).
3. **serve** — ``gpt_1p3b`` in bf16 with random weights from a seed on
   ``ServingEngine(jit=True)`` (16 slots, page 16, 2048 pages, chunked
   prefill 256): ``warm_ragged()`` captures one CUDA graph per token pad
   (prints the graph count, the capture seconds and the device memory
   the captures reserved), then 36 requests under Poisson arrivals — 32
   of mixed length (16-512 prompt tokens) and 4 sharing a 128-token head
   so prefix hits run — 32 new tokens each, every round a replay.
   Launch counters are zeroed after ``warm_ragged()``, just before the
   load, and read just after; each served round must have launched the
   attention kernel once per layer and the LayerNorm kernel 2 x layers +
   1 times (a replay adds the launches its capture recorded). Prints
   tokens/s, TTFT/ITL p50/p99, rounds, distinct pads and peak KV
   occupancy. Then the largest mixed round and the widest decode round
   run again on the engine, replayed and eager, on the same inputs: the
   greedy tokens must be equal and the logits bit-equal.
4. **timing** — ragged attention held against its plain version at the
   serve phase's largest mixed and widest decode rounds on the served
   layer-0 pools (f32 within 1e-4, bf16 within 4e-3); then device time per
   call of each kernel at the serve phase's largest round, beside its
   bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, the
   larger), its plain version's time and,
   for LayerNorm, ``torch.nn.functional.layer_norm``'s time as
   ``library_ms`` (the port never calls it). Kernel times are device
   time from ``torch.profiler`` (CUDA events when the trace is empty).
   The ragged kernel's entry adds the widest decode round's time and
   bound as ``decode_ms`` and ``decode_bound_ms`` beside the mixed
   round's ``ms`` and ``bound_ms``; its ``max_abs_err`` is the larger of
   the two rounds' bf16 errors.
5. **profile** — a steady decode round of 16 rows on the host clock and
   under ``torch.profiler``: device busy share and device time by kernel
   family, for eager rounds (``jit=False``) and replays (``jit=True``) in
   turns (eager, replay, replay, eager), the host ms split into the
   scheduler and assembly, the program call (staging copy and replay, or
   the eager forward) and the wait on the fetch. A replayed round's trace
   must show the ragged attention and LayerNorm kernels.
6. **train-kernel parity** — the flash forward, dQ and dK/dV kernels
   against their plain versions at ``[2, S, 16, 128]`` (S = 1024 and the
   unaligned 1000, and in bf16 also 1 and 129, causal and not; the bf16
   forward, dQ and dK/dV are the Hopper kernels of
   ``csrc/flash_attention_sm90.cu``; f32 within 1e-4, bf16 within 2e-2
   elementwise, a few bf16 ulps at these magnitudes, and within 1e-2 in
   ``||got - plain|| / ||plain||``), q/k/v read as strided views of one
   fused projection; the autograd gradients of ``flash_attention_bshd``
   against autograd through the plain chain (f32, 1e-4); fused AdamW in
   one multi-tensor launch over mixed sizes with one bf16 tensor (f32
   within 1e-6, bf16 within one rounding).
7. **train parity** — a 2-layer f32 model at ``gpt_1p3b`` widths takes one
   step (B 2, S 512) through the kernels: its loss and every gradient are
   held against autograd through a dense plain forward written here, then
   its AdamW step against the plain update.
8. **train** — ``gpt_1p3b`` (24 layers), f32 master weights, ``auto_cast``
   O1 bf16, ``AdamW(1e-4)``, a fixed batch of B 8 x S 1024 from numpy
   seed 0: 2 warm-up steps, then 10 timed steps. The losses must be finite
   and fall; the counters, zeroed after warm-up, must read exactly 24
   launches of each flash kernel, one of AdamW and 49 of LayerNorm per
   step. Prints median step ms, tokens/s, ``gpt_train_step_mfu``
   (``bench.py:435`` FLOPs over step time over 989 TFLOP/s) and peak
   memory.
9. **train timing and profile** — one step under ``torch.profiler``
   (device time by family, the flash backward split into dQ and dK/dV;
   busy share); each new kernel held against its
   plain version at the slice's shapes (flash at ``[8, 1024, 16, 128]``
   bf16 causal with phase 6's limits; AdamW in one launch over the
   model's 292 tensors against the plain update of clones, within 1e-6),
   whose errors are the kernels' ``max_abs_err``; then device time per
   call of each beside its bound, its plain version's time and
   ``library_ms`` (``F.scaled_dot_product_attention`` forward,
   its backward for the two backward kernels, ``torch._fused_adamw_``;
   timed here only, never called by the port). The entries of the bf16
   forward, dQ and dK/dV kernels add their registers and spill bytes from the
   ``ptxas -v`` build log and their shared memory per block.
10. **bucketed parity** — once the training model is freed: the paged
    decode kernel against its plain version (H 16, D 128, page 16, MHA
    and GQA KVH 4, f32 within 1e-4, bf16 within 2e-2; contexts crossing
    pages and the full ``max_pages * page``, contexts one key either side
    of the split edges of the kernel's launch plan, tables padded with
    -1, a context-0 row that must be exactly zero), RMSNorm on ``[T, 2048]``
    (f32 and bf16, with and without bias); then a 2-layer f32
    ``gpt_1p3b(use_rms_norm=True)`` served through
    ``ServingEngine(ragged=False)``, unchunked (a prefix hit, a prompt in
    the 16-token seq bucket) and with ``prefill_chunk=16``, against the
    dense plain forward (greedy tokens equal, logits within 1e-3); the
    flash kernels at the smallest seq bucket, S = 16, and in bf16 at S = 1
    and 129.
11. **bucketed serve** — ``gpt_1p3b(use_rms_norm=True)`` bf16 (24 layers,
    random weights from seed 0) on ``ServingEngine(ragged=False)``: 16
    slots, page 16, 2048 pages, unchunked, so misses take the dense
    prefill (the flash forward kernel; the head on each row's last token)
    and prefix hits the chunk step; every round is a program
    (``jit=True``): a CUDA graph per (batch, seq) bucket of the prefill
    and of the chunk step, captured at the bucket's first round, and one
    of the decode step. A short ``generate`` captures the decode step and
    one prefill bucket, then phase 3's 36-request Poisson load runs twice,
    from phase 3's seed and from another (the second over the programs
    the first captured), counters zeroed just before each; launches must
    equal exactly 24 paged attention per decode step, 49 RMSNorm per
    forward (decode steps, dense prefills and chunk steps) and 24 flash
    forward per dense prefill, a capture's warm-up run counted as a
    round. Prints tokens/s, TTFT/ITL p50/p99 of both loads, rounds, peak
    KV occupancy, the graphs and the device memory they reserved; the
    widest decode step, the largest dense prefill and the largest chunk
    step replayed and eager (tokens equal, logits bit-equal); and a
    steady decode step profiled as in phase 5 (the paged decode kernel
    must show as its own family, and RMSNorm, in the replayed steps).
12. **bucketed timing** — paged attention at the serve's widest decode
    step on the served layer-0 pools (f32-upcast within 1e-4, bf16 within
    4e-3 against plain) and RMSNorm at [rows of the largest dense prefill,
    2048] bf16, each beside its bound, its plain version and, for
    RMSNorm, ``torch.nn.functional.rms_norm`` as ``library_ms``; the
    paged entry adds its build's registers and spills, its shared memory
    a block and split count, and a sweep at the engine's widths (16 rows
    x 128, 512 and 1024 keys, 1 row x 1024; each checked, timed, beside
    its bound and GB/s); the flash forward at the largest dense prefill's
    shape beside ``F.scaled_dot_product_attention``. (``paged_splits.py``
    times the paged kernel at other split counts.)

13. **O2 train** — ``gpt_1p3b`` (24 layers) built in f32 from seed 0 and
    decorated ``amp.decorate(level="O2", dtype="bfloat16")``: bf16
    parameters, ``AdamW(multi_precision=True)`` with f32 masters (the
    fused AdamW kernel's master mode), ``ClipGradByGlobalNorm(1.0)`` and
    ``LinearWarmup(CosineAnnealingDecay(1e-4, T_max=100), 4, 0, 1e-4)``
    stepped every step, under ``auto_cast`` O2 (the tied head a bf16
    product); phase 8's batch, 2 warm-up and 10 timed steps. The losses
    must be finite and fall, and the launches exact: per step the flash
    forward, dQ and dK/dV 24 times each, LayerNorm 49 and AdamW once.
    Prints step ms, tokens/s, ``gpt_train_step_mfu``, peak memory, one
    profiled step (families, busy share) and the losses. Then the same
    with ``recompute=True``: the flash forward 48 and LayerNorm 97 times
    a step, a lower peak, and losses within 1e-3 of the run without
    recompute.
14. **master mode and resume** — the fused AdamW kernel's master mode
    (f32 masters and moments, the bf16 parameters written in the same
    pass) and bf16-moment mode, each one launch over the O2 model's 292
    tensors, against the plain version (f32 within 1e-6, bf16 within one
    rounding, each parameter exactly its master rounded); both timed as
    one launch over a prebuilt table (CUDA events over back-to-back
    launches, the wrapper's host work and synchronous table copy left
    out) beside their bounds (28 and 14 bytes a parameter) and the f32
    mode on the same tensors, master mode also beside
    ``torch._fused_adamw_`` on the masters with upcast gradients plus
    ``torch._foreach_copy_`` into the parameters (each part printed);
    a resume at full width and 2 layers (2 steps, model, optimizer and
    scheduler saved to the host, 2 more, against a restore plus the same
    2: bit-equal); a ``GradScaler`` whose injected inf skips the step,
    leaves weights and masters alone and halves the scale.

15. **generate** — the flash forward at one query row (``Sk`` 1, 17,
    129, 383, 1000; f32 within 1e-4, bf16 with phase 6's limits) against
    its plain version, and timed at ``Sk = 383`` beside its bound and
    ``F.scaled_dot_product_attention``; then ``GPTForCausalLM.generate``
    on ``gpt_1p3b`` bf16 (24 layers, seed 0), batch 4, 128-token prompts,
    256 new tokens: greedy compiled twice (the step one CUDA graph,
    captured in the first call), the same static step eagerly (bit-equal
    to the replays), greedy eager over the dense cache (the flash forward
    at ``Sq = 1``) and sampled with ``top_k=50`` twice from one seed
    (equal). Launches exact (LayerNorm 49 a forward; the flash forward 24
    a dense-cache forward, none in the static step); every greedy token
    the argmax of a no-cache forward over its sequence within ``2e-2 +
    2e-2 |max|``, every sampled one within that of its step's top 50.
    Prints ms a step and tokens/s on the host clock and the capture
    seconds.

The lines before the last carry the ``{"kernels": [...]}`` JSON (all eight
kernels; the ``fused_adamw`` entry adds the master and bf16-moment modes'
numbers and phase 13's launches, and its ``max_abs_err`` is the largest of
its three modes'; the ``flash_fwd`` entry adds phase 15's ``sq1_*``
numbers and the dense-cache loop's launches, ``layer_norm`` the compiled
loop's) and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the repository beside it, the script exits
non-zero and prints no result.
"""
import ctypes
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores
SEED = 0


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def time_ms(fn, iters=20, warmup=3):
    """-> ``(ms, wall_ms, source)`` per call. ``ms`` is device time: the
    summed duration of every GPU kernel and copy the ``iters`` calls
    launched, from a ``torch.profiler`` trace, over ``iters`` (CUDA events
    around the loop when the trace holds no device events). ``wall_ms`` is
    CUDA-event time around the loop over ``iters``: it also counts the
    host's launch overhead whenever the host is slower than the card."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    wall_ms = a.elapsed_time(b) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in _device_events(prof))
    if dev_us <= 0:
        return wall_ms, wall_ms, "cuda events"
    return dev_us / 1e3 / iters, wall_ms, "profiler"


def check_close(name, got, want, rtol, atol, norm_tol=None):
    """Elementwise ``|got - want| <= atol + rtol |want|``; with
    ``norm_tol`` also ``||got - want|| / ||want|| <= norm_tol``, which
    catches a fault that moves every output by a few percent where an
    elementwise bound wide enough for bf16's worst element would not.
    ``||want||`` is floored at ``atol * sqrt(n)``: an output whose every
    element lies below ``atol`` (dK at S = 1, where dS is rounding noise
    around 0) is held by the elementwise bound. -> the max abs error."""
    err = (got.float() - want.float()).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    finite = bool(torch.isfinite(got.float()).all())
    norm = ""
    if norm_tol is not None:
        floor = atol * math.sqrt(max(err.numel(), 1))
        rel = float(err.norm() / want.float().norm().clamp_min(floor))
        ok = ok and rel <= norm_tol
        norm = f" rel_norm_err={rel:.3e} (tolerance {norm_tol:g})"
    log(f"  {name}: max_abs_err={max_abs:.3e} (tolerance atol={atol:g} "
        f"rtol={rtol:g}){norm} finite={finite} {'ok' if ok else 'MISMATCH'}")
    if not (ok and finite):
        fail(f"{name} disagrees with its plain version")
    return max_abs


# ------------------------------------------------------------ phase 2 data
def mixed_launch(H, KVH, D, dtype, page=16, num_pages=96, max_pages=64,
                 seed=0):
    """Two decode rows (contexts 300 and 17), a whole 40-token prefill, a
    chunk continuation at positions 37..65 (mid-page start, crosses
    pages), an unused row and 57 pad tokens: T = 128."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = 128
    q = torch.randn(T, H, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(num_pages, page, KVH, D, device="cuda",
                    generator=g).to(dtype)
    v = torch.randn(num_pages, page, KVH, D, device="cuda",
                    generator=g).to(dtype)
    perm = torch.randperm(num_pages - 1, device="cuda", generator=g) + 1
    bt = torch.zeros(5, max_pages, dtype=torch.int32, device="cuda")
    bt[0, :19] = perm[:19]
    bt[1, :2] = perm[19:21]
    bt[2, :3] = perm[21:24]
    bt[3, :5] = perm[24:29]
    rs = torch.tensor([0, 1, 2, 42, T], dtype=torch.int32, device="cuda")
    rl = torch.tensor([1, 1, 40, 29, 0], dtype=torch.int32, device="cuda")
    kl = torch.tensor([300, 17, 40, 66, 0], dtype=torch.int32,
                      device="cuda")
    return q, k, v, rs, rl, kl, bt


def dense_reference_logits(model, ids):
    """Plain causal forward of the port's GPT over ``ids`` (a list of S
    tokens, or a [B, S] tensor; no cache, no kernels, differentiable in
    the model's parameters; LayerNorm or RMSNorm as the config says): ->
    f32 logits [S, V] or [B, S, V]."""
    from paddle_tpu_torch.ops.kernels import (layer_norm_reference,
                                              rms_norm_reference)
    cfg, g = model.config, model.gpt

    def ln(x, w, b, eps):
        if cfg.use_rms_norm:
            return rms_norm_reference(x, w, None, eps)
        return layer_norm_reference(x, w, b, eps)

    H, KVH = cfg.num_heads, cfg.num_kv_heads
    D = cfg.hidden_size // H
    eps = cfg.layer_norm_epsilon
    dev = model.device
    idx = torch.as_tensor(ids, device=dev)
    one_row = idx.dim() == 1
    idx = idx[None] if one_row else idx
    B, S = idx.shape
    x = g.wte.weight[idx] + g.wpe.weight[torch.arange(S, device=dev)]
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    for blk in g.h:
        a = blk.attn
        h = ln(x, blk.ln_1.weight, getattr(blk.ln_1, "bias", None), eps)
        qkv = h @ a.qkv_proj.weight + a.qkv_proj.bias
        q = qkv[..., :H * D].reshape(B, S, H, D)
        k = qkv[..., H * D:(H + KVH) * D].reshape(B, S, KVH, D)
        v = qkv[..., (H + KVH) * D:].reshape(B, S, KVH, D)
        k = k.repeat_interleave(H // KVH, dim=2)
        v = v.repeat_interleave(H // KVH, dim=2)
        s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(D)
        p = torch.softmax(s.masked_fill(~causal, -1e30), dim=-1)
        o = torch.einsum("bhst,bthd->bshd", p, v).reshape(B, S, H * D)
        x = x + o @ a.out_proj.weight + a.out_proj.bias
        h = ln(x, blk.ln_2.weight, getattr(blk.ln_2, "bias", None), eps)
        f = torch.nn.functional.gelu(h @ blk.mlp.fc1.weight
                                     + blk.mlp.fc1.bias, approximate="tanh")
        x = x + f @ blk.mlp.fc2.weight + blk.mlp.fc2.bias
    x = ln(x, g.ln_f.weight, getattr(g.ln_f, "bias", None), eps)
    logits = (x @ g.wte.weight.t()).float()
    return logits[0] if one_row else logits


# ---------------------------------------------------------------- bounds
def attention_work(rs, rl, kl, bt, H, KVH, D, page, itemsize, row_meta=3):
    """Bytes the launch must move (q read, out written, the K and V of
    every key some row's context covers read once, ``row_meta`` int32 a
    row and the table entries the contexts cover) and the flops its data
    needs (QK and PV over each valid token's causal context)."""
    rs, rl, kl, bt = (np.asarray(a) for a in (rs, rl, kl, bt))
    T_valid = int(rl.sum())
    keys, entries, flops = {}, 0, 0   # page id -> keys of it read
    for r in range(len(rs)):
        if rl[r] <= 0:
            continue
        kv = int(kl[r])
        n = -(-kv // page)
        for i, p in enumerate(bt[r, :n].tolist()):
            keys[p] = max(keys.get(p, 0), min(page, kv - i * page))
        entries += n
        ctx = np.arange(kl[r] - rl[r], kl[r]) + 1
        flops += 4 * H * D * int(ctx.sum())
    kv_bytes = 2 * sum(keys.values()) * KVH * D * itemsize
    nbytes = 2 * T_valid * H * D * itemsize + kv_bytes \
        + 4 * (row_meta * len(rs) + entries)
    return nbytes, flops, T_valid


def bound(nbytes, flops, flops_per_s):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def kernel_family(name):
    """The family a device event's name belongs to in the profiles."""
    name = name.lower()
    return ("ragged_paged_attention" if "ragged_paged" in name else
            "paged_attention" if "paged_attention" in name else
            "layer_norm (triton)" if "layer_norm_fwd" in name else
            "rms_norm (triton)" if "rms_norm_fwd" in name else
            "matmul (cuBLAS)" if any(k in name for k in (
                "gemm", "gemv", "nvjet", "cutlass", "xmma")) else
            "copies" if "memcpy" in name or "memset" in name else
            "other elementwise/index")


def host_functions(eng, n_rounds, top=8):
    """``n_rounds`` more steps under ``cProfile`` -> the host functions
    with the most own time: ``(ms per round, calls per round, name)``
    (``cProfile`` slows Python, so read shares, not times)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n_rounds):
        eng.step()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:top]
    return [(tt * 1e3 / n_rounds, nc / n_rounds,
             f"{func} ({os.path.basename(path)}:{line})")
            for (path, line, func), (_, nc, tt, _, _) in rows]


def profile_decode_rounds(eng, vocab, n_rounds=20):
    """Where a steady decode round's time goes (either engine path, eager
    or replayed as ``eng``'s ``jit`` says): 16 requests with 200-token
    prompts are prefilled (no logit capture, as served), then
    ``n_rounds`` rounds in which every slot
    decodes are timed on the host clock (no profiler), again under
    ``torch.profiler``, and again under ``cProfile``. -> per-round host
    ms, device busy ms (union of the device intervals), device time by
    kernel family, the top kernels and copies, the host ms split into the
    program call and the wait on the fetch (the engine's
    ``round_host_s``) and the rest, and the top host functions."""
    from torch.profiler import ProfilerActivity, profile
    # as served: no test capture of every round's f32 logit rows (the
    # serve phases' checks turn it on), so each round fetches its tokens
    eng.capture_logits = None
    rng = np.random.RandomState(SEED + 10)
    reqs = [eng.submit(rng.randint(1, vocab, size=200).tolist(),
                       max_new_tokens=96) for _ in range(eng.max_slots)]
    while any(r.state != "active" or not r.generated for r in reqs):
        eng.step()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    host0 = dict(eng.stats()["round_host_s"])
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        eng.step()
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3 / n_rounds
    host1 = eng.stats()["round_host_s"]
    split = {k: (host1[k] - host0[k]) * 1e3 / n_rounds for k in host0}
    split["scheduler and assembly"] = round_ms - split["call"] \
        - split["wait"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_rounds):
            eng.step()
        torch.cuda.synchronize()
    families, names, spans = {}, {}, []
    for e in _device_events(prof):
        spans.append((e.time_range.start, e.time_range.end))
        fam = kernel_family(e.name)
        ms = e.time_range.elapsed_us() / 1e3 / n_rounds
        families[fam] = families.get(fam, 0.0) + ms
        names[e.name] = names.get(e.name, 0.0) + ms
    host = host_functions(eng, n_rounds)
    eng.run_until_idle()
    # busy = the union of device intervals: a synchronous copy's interval
    # can span the kernels it waits behind, so the sum double-counts
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    top += sorted((kv for kv in names.items() if kv not in top
                   and kernel_family(kv[0]) == "copies"),
                  key=lambda kv: -kv[1])
    return round_ms, busy_us / 1e3 / n_rounds, families, top, split, host


def report_round_profiles(tag, eng, vocab, families_needed, absent=(),
                          unit="round"):
    """Phase 5 / 11: :func:`profile_decode_rounds` for eager rounds and
    replays in turns (eager, replay, replay, eager) on ``eng``; fails if
    a trace holds no device events, lacks any of ``families_needed`` (for
    a replay: the trace cannot see the kernels inside the graph) or holds
    one of ``absent``."""
    for jit in (False, True, True, False):
        eng._jit = jit
        round_ms, busy_ms, families, top, split, host = \
            profile_decode_rounds(eng, vocab)
        mode = "replay (jit=True)" if jit else "eager (jit=False)"
        if busy_ms <= 0:
            fail(f"{tag}: the torch.profiler trace of the {mode} {unit}s "
                 f"held no device events")
        missing = [f for f in families_needed if families.get(f, 0) <= 0]
        if missing:
            fail(f"{tag}: " + ("the trace cannot see the kernels inside a "
                               "replay" if jit else "the eager trace lacks "
                               "the kernels") +
                 f": no {missing} among {sorted(families)}")
        if any(f in families for f in absent):
            fail(f"{tag}: {absent} in the trace ({sorted(families)}): a "
                 f"kernel's symbol is not in its own family")
        total_ms = sum(families.values())
        log(f"[{tag}] steady decode {unit}, 16 rows, {mode}: {round_ms:.3f} "
            f"ms on the host clock (scheduler and assembly "
            f"{split['scheduler and assembly']:.3f}, program call "
            f"{split['call']:.3f}, fetch wait {split['wait']:.3f}); device "
            f"busy {busy_ms:.3f} ms per {unit} (union of device intervals; "
            f"{total_ms:.3f} ms summed) = {100 * busy_ms / round_ms:.1f}% "
            f"busy, {100 - 100 * busy_ms / round_ms:.1f}% idle")
        for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            log(f"  {fam}: {ms:.4f} ms per {unit} "
                f"({100 * ms / total_ms:.1f}% of summed device time)")
        for name, ms in top:
            log(f"    {ms:.4f} ms per {unit}  {name[:110]}")
        log(f"  host functions by own time under cProfile, per {unit}:")
        for ms, calls, name in host:
            log(f"    {ms:.3f} ms ({calls:g} calls)  {name[:110]}")
    eng._jit = True


def reserved_bytes():
    """Device memory the caching allocator holds once its free cached
    blocks are released (graph pools stay reserved while their graphs
    live)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_stats()["reserved_bytes.all.current"]


def check_replay_matches_eager(tag, label, run, args):
    """One recorded round run again on its engine, replayed (``jit=True``)
    and eager (``jit=False``) on the same inputs: greedy tokens equal and
    logits bit-equal (the same kernels at the same shapes; the round's
    K/V writes are the same values, so the pools do not diverge)."""
    tok_r, rows_r = run(*args, need_rows=True, jit=True)
    tok_e, rows_e = run(*args, need_rows=True, jit=False)
    diff = float(np.abs(rows_r - rows_e).max())
    log(f"  {label} replayed vs eager: tokens "
        f"{'equal' if tok_r == tok_e else 'DIFFER'}, logits {rows_r.shape} "
        f"largest absolute difference {diff}")
    if tok_r != tok_e or diff != 0.0:
        fail(f"{tag}: the replayed {label} differs from the eager round "
             f"(tokens equal: {tok_r == tok_e}, logits by {diff})")


# ------------------------------------------------------------ train phases
def _bhsd(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _bshd(x, b, h):
    return x.reshape(b, h, -1, x.shape[-1]).transpose(1, 2)


def flash_inputs(B, S, H, D, dtype, seed):
    """q, k, v as views of one fused [B, S, 3*H*D] projection (the GPT's
    layout: strided, no copy), and dO."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * D, device="cuda", generator=g).to(dtype)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
               for i in range(3))
    do = torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
    return qkv, q, k, v, do


def flash_plain(q, k, v, do, scale, causal):
    """The three plain versions chained as the autograd Function chains the
    kernels: -> O, lse, delta, dQ, dK, dV (in [B, S, H, D] / [B, H, S])."""
    from paddle_tpu_torch.ops import kernels as K
    B, S, H, _ = q.shape
    ro, rl = K.flash_fwd_reference(_bhsd(q), _bhsd(k), _bhsd(v), scale,
                                   causal)
    ro = _bshd(ro, B, H)
    delta = K.flash_delta(ro, do)
    rl = rl.reshape(B, H, S)
    args = [_bhsd(x) for x in (q, k, v, do)] + [
        rl.reshape(B * H, S), delta.reshape(B * H, S), scale, causal]
    rq = _bshd(K.flash_bwd_dq_reference(*args), B, H)
    rk, rv = (_bshd(x, B, H) for x in K.flash_bwd_dkv_reference(*args))
    return ro, rl, delta, rq, rk, rv


# bf16 flash limits: elementwise 2e-2 (the causal rows with few keys
# carry |O| near 1, where a bf16 ulp is 8e-3), and the error's norm within
# 1e-2 of the plain output's
FLASH_BF16_TOL, FLASH_BF16_NORM_TOL = 2e-2, 1e-2


def check_flash(K, tag, q, k, v, do, scale, causal, tol, norm_tol):
    """The flash forward, dQ and dK/dV kernels against their plain
    versions on the same inputs (the backward kernels take the plain
    chain's lse and delta). -> max abs errors {kernel: err}."""
    ro, rl, delta, rq, rk, rv = flash_plain(q, k, v, do, scale, causal)
    o, lse = K.flash_fwd(q, k, v, scale, causal)
    dq = K.flash_bwd_dq(q, k, v, do, rl, delta, scale, causal)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, rl, delta, scale, causal)
    torch.cuda.synchronize()
    errs = {"flash_fwd": check_close(f"flash_fwd O {tag}", o, ro, tol, tol,
                                     norm_tol)}
    check_close(f"flash_fwd lse {tag}", lse, rl, 1e-4, 1e-4)
    errs["flash_bwd_dq"] = check_close(f"flash_bwd_dq {tag}", dq, rq, tol,
                                       tol, norm_tol)
    errs["flash_bwd_dkv"] = max(
        check_close(f"flash_bwd_dkv dK {tag}", dk, rk, tol, tol, norm_tol),
        check_close(f"flash_bwd_dkv dV {tag}", dv, rv, tol, tol, norm_tol))
    return errs


def train_kernel_parity(K):
    """Flash forward, dQ and dK/dV against their plain versions at
    [2, S, 16, 128], S in (1024, 1000), and in bf16 also 1 and 129 (one
    row; one past the new kernels' 128-row tiles), causal and not, f32 and
    bf16; the
    autograd gradients of ``flash_attention_bshd`` against autograd
    through the plain chain; fused AdamW multi-tensor against its plain
    version over mixed sizes."""
    for dt, tol, norm_tol in ((torch.float32, 1e-4, None),
                              (torch.bfloat16, FLASH_BF16_TOL,
                               FLASH_BF16_NORM_TOL)):
        for S in (1024, 1000) + ((1, 129) if dt == torch.bfloat16 else ()):
            for causal in (True, False):
                _, q, k, v, do = flash_inputs(2, S, 16, 128, dt, seed=S)
                tag = f"{str(dt)[6:]} S={S} {'causal' if causal else 'full'}"
                check_flash(K, tag, q, k, v, do, 1.0 / math.sqrt(128),
                            causal, tol, norm_tol)
    # the full autograd path (delta and both backward kernels) on the
    # strided views of one fused projection, f32
    qkv, q, k, v, do = flash_inputs(2, 1000, 16, 128, torch.float32, 7)
    qkv.requires_grad_(True)
    B, S, H, D = q.shape

    def split(t):
        return [t[..., i * H * D:(i + 1) * H * D].reshape(B, S, H, D)
                for i in range(3)]

    got = torch.autograd.grad((K.flash_attention_bshd(*split(qkv))
                               * do).sum(), qkv)[0]
    q, k, v = split(qkv)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    o = torch.einsum("bhqk,bkhd->bqhd",
                     sc.masked_fill(~causal, -1e30).softmax(-1), v)
    want = torch.autograd.grad((o * do).sum(), qkv)[0]
    check_close("flash_attention_bshd autograd d[qkv] vs plain chain "
                "(f32, S=1000)", got, want, 1e-4, 1e-4)
    del qkv, q, k, v, do, got, want, sc, o
    # fused AdamW: one multi-tensor launch, mixed sizes and one bf16 w
    g = torch.Generator(device="cuda").manual_seed(8)
    shapes = [(2048, 6144), (6144,), (3,), (50304, 2048), (1000, 33)]
    ws = [torch.randn(sh, device="cuda", generator=g) for sh in shapes]
    ws.append(torch.randn(777, device="cuda", generator=g).bfloat16())
    gs = [torch.randn(w.shape, device="cuda", generator=g) for w in ws]
    ms = [0.1 * torch.randn(w.shape, device="cuda", generator=g)
          for w in ws]
    vs = [torch.rand(w.shape, device="cuda", generator=g) for w in ws]
    n = len(ws)
    wds = [0.1 * (i % 2) for i in range(n)]
    c1, c2 = 1.0 / (1 - 0.9 ** 3), 1.0 / (1 - 0.95 ** 3)
    want = [K.fused_adamw_reference(w, gr, m, v, 1e-3, 0.9, 0.95, 1e-8, wd,
                                    c1, c2)
            for w, gr, m, v, wd in zip(ws, gs, ms, vs, wds)]
    K.fused_adamw(ws, gs, ms, vs, [1e-3] * n, 0.9, 0.95, 1e-8, wds,
                  [c1] * n, [c2] * n)
    torch.cuda.synchronize()
    for (w2, m2, v2), w, m, v in zip(want, ws, ms, vs):
        # f32: IEEE sqrt and division, FMA contraction: within 1e-6;
        # bf16 w: one bf16 rounding of the updated value
        wtol = 1e-6 if w.dtype == torch.float32 else 8e-3
        tag = f"{tuple(w.shape)} {str(w.dtype)[6:]}"
        check_close(f"fused_adamw w {tag}", w, w2, wtol, wtol)
        check_close(f"fused_adamw m {tag}", m, m2, 1e-6, 1e-6)
        check_close(f"fused_adamw v {tag}", v, v2, 1e-6, 1e-6)


def train_parity(pt, K):
    """A 2-layer f32 model at gpt_1p3b widths takes one AdamW step (B 2,
    S 512) through the kernels; its loss and every gradient are held
    against autograd through :func:`dense_reference_logits` over the same
    parameters, then the step against the plain AdamW update."""
    cfg = pt.gpt_1p3b(dropout=0.0)
    cfg.num_layers = 2
    model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED + 2)
    model.train()
    rng = np.random.RandomState(SEED + 2)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 512))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (2, 512))).cuda()
    params = list(model.parameters())
    names = [p.param_name for p in params]
    want_loss = torch.nn.functional.cross_entropy(
        dense_reference_logits(model, ids).reshape(-1, cfg.vocab_size),
        labels.reshape(-1))
    want_grads = torch.autograd.grad(want_loss, params)
    opt = pt.AdamW(learning_rate=1e-4, parameters=params)
    K.reset_launch_counts()
    loss = pt.GPTPretrainingCriterion(cfg)(model(ids), labels)
    loss.backward()
    torch.cuda.synchronize()
    launched = K.launch_counts()
    if min(launched["flash_fwd"], launched["flash_bwd_dq"],
           launched["flash_bwd_dkv"], launched["layer_norm"]) <= 0:
        fail(f"train parity: the step did not run the kernels {launched}")
    check_close("loss vs dense plain forward", loss.detach(),
                want_loss.detach(), 1e-5, 1e-5)
    worst = 0.0
    for name, p, wg in zip(names, params, want_grads):
        scale = float(wg.abs().max())
        err = (p.grad - wg).abs()
        ok = bool((err <= 1e-4 * scale + 1e-3 * wg.abs()).all())
        worst = max(worst, float(err.max()) / max(scale, 1e-30))
        if not ok or not bool(torch.isfinite(p.grad).all()):
            fail(f"train parity: grad of {name} disagrees (max abs err "
                 f"{float(err.max()):.3e}, max |grad| {scale:.3e})")
    log(f"  {len(params)} gradients within 1e-4 x max|grad| + 1e-3 x |grad| "
        f"of the plain chain's; worst max-err/max|grad| {worst:.3e}")
    before = [(p.detach().clone(), p.grad.clone()) for p in params]
    opt.step()
    torch.cuda.synchronize()
    if K.fused_adamw.launches != 1:
        fail(f"train parity: AdamW launched {K.fused_adamw.launches} "
             f"kernels for one step")
    worst = 0.0
    for name, p, (w0, g0) in zip(names, params, before):
        zero = torch.zeros_like(w0)
        w2, _, _ = K.fused_adamw_reference(w0, g0, zero, zero, 1e-4, 0.9,
                                           0.999, 1e-8, 0.01, 1 / (1 - 0.9),
                                           1 / (1 - 0.999))
        err = float((p.detach() - w2).abs().max())
        worst = max(worst, err)
        if err > 1e-6:
            fail(f"train parity: AdamW step of {name} off by {err:.3e}")
    log(f"  AdamW step (one launch over {len(params)} tensors) vs the plain "
        f"update: max abs err {worst:.3e} (tolerance 1e-6)")


def train_flops(n_params, B, S, L, h):
    """Model FLOPs of one step, the formula of ``bench.py:435``."""
    return 6 * n_params * B * S + 6 * L * B * S * S * h


def train_slice(pt, K, steps=10, warmup=2, B=8, S=1024):
    """gpt_1p3b, f32 master weights, auto_cast O1 bf16, AdamW(1e-4) on a
    fixed batch from numpy seed 0. -> the model, the optimizer, the step
    function and the timed steps' launch counts; fails unless the losses
    are finite and fall and the kernels launched exactly as the step
    prescribes."""
    cfg = pt.gpt_1p3b(dropout=0.0)
    t0 = time.perf_counter()
    model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED)
    model.train()
    crit = pt.GPTPretrainingCriterion(cfg)
    opt = pt.AdamW(learning_rate=1e-4, parameters=model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (B, S))).cuda()
    torch.cuda.synchronize()
    log(f"[train] gpt_1p3b f32 master weights, {n_params / 1e9:.4f} B "
        f"params, {len(list(model.parameters()))} tensors, built in "
        f"{time.perf_counter() - t0:.2f} s; B={B} S={S} "
        f"({B * S} tokens/step), auto_cast O1 bf16, AdamW(lr=1e-4)")

    def step():
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.item()

    losses, times = [], []
    for _ in range(warmup):
        losses.append(step())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses)
        + f" (first {warmup} are warm-up)")
    log("  step ms: " + " ".join(f"{x:.2f}" for x in times))
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train: losses not finite or not falling: {losses}")
    L = cfg.num_layers
    # per step: one flash forward and one dQ and one dK/dV launch per
    # layer, one AdamW launch (the multi-tensor kernel over all tensors),
    # two LayerNorms per layer plus ln_f (forward kernels; the backward
    # is plain torch); no ragged attention
    want = {name: 0 for name in launches}
    want.update({"layer_norm": steps * (2 * L + 1), "flash_fwd": steps * L,
                 "flash_bwd_dq": steps * L, "flash_bwd_dkv": steps * L,
                 "fused_adamw": steps})
    log(f"  launches over {steps} timed steps: {launches}")
    if launches != want:
        fail(f"train: kernel launches {launches} != {want}")
    med = float(np.median(times))
    flops = train_flops(n_params, B, S, L, cfg.hidden_size)
    summary = {"step_ms_median": med, "tokens_per_s": B * S / med * 1e3,
               "gpt_train_step_mfu": flops / (med / 1e3) / BF16_FLOPS_PER_S,
               "model_tflop_per_step": flops / 1e12,
               "max_memory_allocated_gb": peak / 1e9,
               "first_loss": losses[0], "last_loss": losses[-1]}
    log(f"  {json.dumps(summary)}")
    return model, opt, step, launches


def _busy_ms(spans):
    """The union of device intervals (a synchronous copy's interval can
    span the kernels it waits behind, so the sum double-counts)."""
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3


def profile_train_step(step):
    """One call of ``step`` (a training step, or phase 15's block of
    replays) under ``torch.profiler``: device time by kernel family, the
    union of device intervals and the call's host time. -> (host ms, busy
    ms, ms by family, the top kernels, device events)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families, names, spans = {}, {}, []
    for e in _device_events(prof):
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.lower()
        fam = ("flash forward" if "flash_fwd" in name else
               "flash backward dQ" if "flash_bwd_dq" in name else
               "flash backward dK/dV" if "flash_bwd_dkv" in name else
               "fused_adamw" if "fused_adamw" in name else
               "layer_norm (triton)" if "layer_norm_fwd" in name else
               "matmul (cuBLAS)" if any(k in name for k in (
                   "gemm", "gemv", "nvjet", "cutlass", "xmma")) else
               "copies" if "memcpy" in name or "memset" in name else
               "other elementwise/reduction")
        ms = e.time_range.elapsed_us() / 1e3
        families[fam] = families.get(fam, 0.0) + ms
        names[(fam, e.name)] = names.get((fam, e.name), 0.0) + ms
    ranked = sorted(names.items(), key=lambda kv: -kv[1])
    # the ten largest kernels, and the six largest of the catch-all family
    top = ranked[:10] + [kv for kv in ranked[10:] if kv[0][0].startswith(
        "other")][:6]
    return wall_ms, _busy_ms(spans), families, top, len(spans)


# the bf16 kernels of csrc/flash_attention_sm90.cu: mangled-name part of
# their D = 128 instantiation, and their index for the shared-memory query
SM90_KERNELS = {"flash_fwd": ("flash_fwd_sm90_kernelILi128E", 0),
                "flash_bwd_dkv": ("flash_bwd_dkv_sm90_kernelILi128E", 1),
                "flash_bwd_dq": ("flash_bwd_dq_sm90_kernelILi128E", 2)}


def ptxas_stats(lib, entry):
    """-> (registers, spill bytes stored and loaded) that ``ptxas -v``
    reported for the kernel whose mangled name holds ``entry``, from the
    build log ``build/<lib>.log``."""
    from paddle_tpu_torch.ops.kernels import _build
    with open(os.path.join(_build.BUILD_DIR, f"{lib}.log")) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            text = "\n".join(lines[i + 1:i + 6])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", text)
            if regs and spill:
                return (int(regs[1]), int(spill[1]) + int(spill[2]))
    fail(f"ptxas statistics of {entry} not found in {lib}.log")


def train_timing(K, model, opt, launches):
    """Each new kernel at the slice's shapes: held against its plain
    version on the same inputs (the flash kernels at [8, 1024, 16, 128]
    bf16 causal on views of one fused projection, AdamW over the model's
    whole parameter list), then its device time per call beside its
    bound, its plain version's time and one PyTorch call's
    (``library_ms``, timed here only). -> the kernels' JSON entries, with
    these comparisons' errors as ``max_abs_err``."""
    from paddle_tpu_torch.ops.kernels import _build
    B, S, H, D = 8, 1024, 16, 128
    scale = 1.0 / math.sqrt(D)
    _, q, k, v, do = flash_inputs(B, S, H, D, torch.bfloat16, seed=9)
    errs = check_flash(K, f"bf16 [{B}, {S}, {H}, {D}] causal (main path)",
                       q, k, v, do, scale, True, FLASH_BF16_TOL,
                       FLASH_BF16_NORM_TOL)
    torch.cuda.empty_cache()
    o, lse = K.flash_fwd(q, k, v, scale, True)
    delta = K.flash_delta(o, do)
    plain = {}
    plain["flash_fwd"] = lambda: K.flash_fwd_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), scale, True)
    bargs = lambda: [_bhsd(x) for x in (q, k, v, do)] + [  # noqa: E731
        lse.reshape(B * H, S), delta.reshape(B * H, S), scale, True]
    plain["flash_bwd_dq"] = lambda: K.flash_bwd_dq_reference(*bargs())
    plain["flash_bwd_dkv"] = lambda: K.flash_bwd_dkv_reference(*bargs())
    kern = {"flash_fwd": lambda: K.flash_fwd(q, k, v, scale, True),
            "flash_bwd_dq": lambda: K.flash_bwd_dq(q, k, v, do, lse, delta,
                                                   scale, True),
            "flash_bwd_dkv": lambda: K.flash_bwd_dkv(q, k, v, do, lse,
                                                     delta, scale, True)}
    # library: F.scaled_dot_product_attention forward, and its backward
    # for the two backward kernels together
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ot = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_fwd, _, _ = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    lib_bwd, _, _ = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    el = 2                                             # bf16
    act = B * S * H * D * el                           # one [B,S,H,D] tensor
    rows = B * H * S * 4                               # lse or delta, f32
    causal_pairs = B * H * S * (S + 1) // 2            # (q, k) pairs kept
    work = {"flash_fwd": (4 * act + rows, 4 * causal_pairs * D),
            "flash_bwd_dq": (5 * act + 2 * rows, 6 * causal_pairs * D),
            "flash_bwd_dkv": (6 * act + 2 * rows, 8 * causal_pairs * D)}
    entries = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        ms, wall, src = time_ms(kern[name])
        plain_ms, _, _ = time_ms(plain[name], iters=3, warmup=1)
        nbytes, flops = work[name]
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"[train timing] {name} [{B}, {S}, {H}, {D}] bf16 causal: "
            f"kernel {ms:.4f} ms ({src}; {wall:.4f} ms per call with "
            f"launch) plain {plain_ms:.4f} ms library {library[name]:.4f} "
            f"ms bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP) = {100 * b_ms / ms:.1f}% of bound")
        entry = {
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:"
                        + {"flash_fwd": "106", "flash_bwd_dq": "262",
                           "flash_bwd_dkv": "285"}[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library[name]}
        if name in SM90_KERNELS:
            # the bf16 kernels of the main path: their build's registers
            # and spills, and the shared memory a block launches with
            entry["source"] = ("paddle_tpu_torch/ops/kernels/csrc/"
                               "flash_attention_sm90.cu")
            regs, spill = ptxas_stats("flash_attention_sm90",
                                      SM90_KERNELS[name][0])
            smem = _build.load("flash_attention_sm90") \
                .flash_attention_sm90_smem_bytes(SM90_KERNELS[name][1], D)
            entry.update({"registers": regs, "spill_bytes": spill,
                          "smem_bytes": smem})
            log(f"  {name}: {regs} registers at launch (setmaxnreg 240 "
                f"consumer / 24 producer), {spill} spill bytes, {smem} "
                f"bytes of shared memory a block")
        entries.append(entry)
    del qt, kt, vt, ot, q, k, v, do, o, lse, delta
    # AdamW over the model's whole parameter list, as a step runs it
    params = list(model.parameters())
    n_t = len(params)
    gs = [torch.randn_like(p) * 1e-3 for p in params]
    ms_ = [opt._get_accumulator("moment1", p) for p in params]
    vs_ = [opt._get_accumulator("moment2", p) for p in params]
    c1, c2 = 1 / (1 - 0.9 ** 13), 1 / (1 - 0.999 ** 13)
    with torch.no_grad():
        ws = [p.detach() for p in params]
        # one launch over all the tensors against the plain update of
        # clones taken before it: f32 within 1e-6 (as in phase 6)
        before = [(w.clone(), m.clone(), v.clone())
                  for w, m, v in zip(ws, ms_, vs_)]
        K.fused_adamw(ws, gs, ms_, vs_, [1e-4] * n_t, 0.9, 0.999, 1e-8,
                      [0.01] * n_t, [c1] * n_t, [c2] * n_t)
        torch.cuda.synchronize()
        adam_err = {"w": 0.0, "m": 0.0, "v": 0.0}
        for i, ((w0, m0, v0), w, g, m, v) in enumerate(
                zip(before, ws, gs, ms_, vs_)):
            want = K.fused_adamw_reference(w0, g, m0, v0, 1e-4, 0.9, 0.999,
                                           1e-8, 0.01, c1, c2)
            for key, got, ref in zip("wmv", (w, m, v), want):
                err = (got - ref).abs()
                adam_err[key] = max(adam_err[key], float(err.max()))
                if not bool((err <= 1e-6 + 1e-6 * ref.abs()).all()):
                    fail(f"fused_adamw over the model's tensors: {key} of "
                         f"{params[i].param_name} off by "
                         f"{float(err.max()):.3e}")
        del before, want
        torch.cuda.empty_cache()
        log(f"  fused_adamw, one launch over {n_t} tensors "
            f"({sum(p.numel() for p in params) / 1e9:.4f} B params) vs the "
            f"plain update of clones: max abs err w {adam_err['w']:.3e} "
            f"m {adam_err['m']:.3e} v {adam_err['v']:.3e} (tolerance 1e-6 "
            f"+ 1e-6 x |plain|) ok")
        ms, wall, src = time_ms(lambda: K.fused_adamw(
            ws, gs, ms_, vs_, [1e-4] * n_t, 0.9, 0.999, 1e-8, [0.01] * n_t,
            [c1] * n_t, [c2] * n_t), iters=10)
        plain_ms, _, _ = time_ms(lambda: [K.fused_adamw_reference(
            w, g, m, v, 1e-4, 0.9, 0.999, 1e-8, 0.01, c1, c2)
            for w, g, m, v in zip(ws, gs, ms_, vs_)], iters=2, warmup=1)
        steps_t = [torch.tensor(13.0, device="cuda") for _ in params]
        lib_ms, _, _ = time_ms(lambda: torch._fused_adamw_(
            ws, gs, ms_, vs_, [], steps_t, lr=1e-4, beta1=0.9, beta2=0.999,
            weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
            iters=10)
    n = sum(p.numel() for p in params)
    nbytes = sum(w.numel() * (2 * w.element_size() + g.element_size() + 16)
                 for w, g in zip(ws, gs))
    b_ms, b_by = bound(nbytes, 12 * n, F32_FLOPS_PER_S)
    log(f"[train timing] fused_adamw over {len(params)} tensors, "
        f"{n / 1e9:.4f} B params: kernel {ms:.4f} ms ({src}; {wall:.4f} "
        f"ms per call with launch) plain {plain_ms:.4f} ms "
        f"torch._fused_adamw_ {lib_ms:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes / 1e9:.2f} GB) = {100 * b_ms / ms:.1f}% of bound")
    entries.append({
        "name": "fused_adamw", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/fused_adamw.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_adamw.py:60",
        "launches": launches["fused_adamw"],
        "max_abs_err": max(adam_err.values()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms})
    return entries


# --------------------------------------------------------- bucketed phases
def paged_split_edges(B, H, KVH, D, max_pages, page=16):
    """Contexts one key either side of the 16-key tile edges where a row's
    used splits change under the launch plan for B rows on this card (16 u
    - 1, 16 u, 16 u + 1 for u = n_split - 1, n_split, n_split + 1)."""
    import importlib
    pa = importlib.import_module(
        "paddle_tpu_torch.ops.kernels.paged_attention")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = pa.launch_plan(B, H, KVH, D, max_pages, page, sms)["n_split"]
    return [c for u in (n - 1, n, n + 1) for c in (16 * u - 1, 16 * u,
                                                   16 * u + 1)
            if 0 <= c <= max_pages * page]


def paged_decode_inputs(H, KVH, D, dtype, page=16, num_pages=96,
                        max_pages=64, seed=0):
    """Fifteen decode rows: contexts 300 (crosses 19 pages), 32 (ends on a
    page edge), the full ``max_pages * page``, 0 (must come out exactly
    zero), 1 and 17, then contexts either side of the split edges of the
    launch plan for 15 rows (padded with 1023 where the plan gives
    fewer); every table padded with -1 past its context."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ctx = [300, 32, max_pages * page, 0, 1, 17]
    ctx += (paged_split_edges(15, H, KVH, D, max_pages, page)
            + [1023] * 9)[:9]
    B = len(ctx)
    q = torch.randn(B, H, D, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(num_pages, page, KVH, D, device="cuda",
                        generator=g).to(dtype) for _ in range(2))
    bt = torch.full((B, max_pages), -1, dtype=torch.int32, device="cuda")
    for r, c in enumerate(ctx):
        n = -(-c // page)
        bt[r, :n] = (torch.randperm(num_pages - 1, device="cuda",
                                    generator=g) + 1)[:n]
    return (q, k, v, bt, torch.tensor(ctx, dtype=torch.int32,
                                      device="cuda"))


def bucketed_kernel_parity(K):
    """The paged decode kernel and the RMSNorm kernel against their plain
    versions: paged attention at H 16, D 128, page 16, MHA and GQA KVH 4,
    f32 within 1e-4 and bf16 within 2e-2; RMSNorm on [T, 2048], f32 within
    1e-4 and bf16 within 2e-2, with and without bias. Then the flash
    kernels at the dense prefill's smallest seq bucket, S = 16, on views
    of one fused projection, with phase 6's limits, and in bf16 at S = 1
    and 129."""
    log("[bucketed parity] paged_attention vs plain (H=16, D=128, page 16)")
    for kvh in (16, 4):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = paged_decode_inputs(16, kvh, 128, dt, seed=kvh)
            log(f"  contexts {args[4].tolist()}")
            got = K.paged_attention(*args)
            torch.cuda.synchronize()
            check_close(f"paged KVH={kvh} {str(dt)[6:]}", got,
                        K.paged_attention_reference(*args), tol, tol)
            if not bool((got[3] == 0).all()):
                fail("paged_attention: the context-0 row is not zero")
    log("[bucketed parity] rms_norm vs plain ([T, 2048])")
    t0 = time.perf_counter()
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        g = torch.Generator(device="cuda").manual_seed(4)
        x = (torch.randn(300, 2048, device="cuda", generator=g) * 2
             + 1).to(dt)
        w = (1 + 0.1 * torch.randn(2048, device="cuda", generator=g)).to(dt)
        b = (0.1 * torch.randn(2048, device="cuda", generator=g)).to(dt)
        for bias in (None, b):
            got = K.rms_norm(x, w, bias, 1e-5)
            torch.cuda.synchronize()
            check_close(f"rms_norm {str(dt)[6:]} "
                        f"{'with' if bias is not None else 'without'} bias",
                        got, K.rms_norm_reference(x, w, bias, 1e-5), tol,
                        tol)
    log(f"  (Triton compile + first launches {time.perf_counter() - t0:.2f}"
        " s)")
    log("[bucketed parity] flash kernels at the smallest seq bucket "
        "[4, 16, 16, 128] causal, and bf16 at S = 1 and 129")
    for dt, tol, norm_tol, S in (
            (torch.float32, 1e-4, None, 16),
            (torch.bfloat16, FLASH_BF16_TOL, FLASH_BF16_NORM_TOL, 16),
            (torch.bfloat16, FLASH_BF16_TOL, FLASH_BF16_NORM_TOL, 1),
            (torch.bfloat16, FLASH_BF16_TOL, FLASH_BF16_NORM_TOL, 129)):
        _, q, k, v, do = flash_inputs(4, S, 16, 128, dt, seed=16 + S)
        check_flash(K, f"{str(dt)[6:]} S={S} causal", q, k, v, do,
                    1.0 / math.sqrt(128), True, tol, norm_tol)


def bucketed_model_parity(pt):
    """A 2-layer f32 ``gpt_1p3b(use_rms_norm=True)`` served through the
    bucketed fallback, unchunked (a dense prefill, then a prefix hit whose
    tail takes the chunk step, then an 11-token prompt in the 16-token
    seq bucket) and with ``prefill_chunk=16``, held against
    :func:`dense_reference_logits`: greedy tokens equal, every decode
    step's logits within 1e-3."""
    cfg = pt.gpt_1p3b(use_rms_norm=True, dropout=0.0)
    cfg.num_layers = 2
    small = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=SEED + 3)
    rng = np.random.RandomState(SEED + 3)
    head = rng.randint(1, cfg.vocab_size, size=37).tolist()
    prompts = [head, head[:32] + rng.randint(1, cfg.vocab_size,
                                             size=9).tolist(),
               rng.randint(1, cfg.vocab_size, size=11).tolist()]
    for chunk in (None, 16):
        eng = pt.ServingEngine(small, page_size=16, num_pages=64,
                               max_slots=4, prefill_chunk=chunk,
                               ragged=False)
        worst = 0.0
        for prompt in prompts:
            eng.capture_logits = []
            new = eng.generate(prompt, max_new_tokens=8)
            with torch.no_grad():
                dense = dense_reference_logits(small, prompt + new)
            want = dense[len(prompt) - 1:].argmax(-1).tolist()
            if new != want[:8]:
                fail(f"bucketed engine (chunk {chunk}) tokens {new} != "
                     f"dense greedy {want[:8]}")
            for i, (slot_map, cap) in enumerate(eng.capture_logits):
                slot = next(iter(slot_map))
                err = (torch.from_numpy(cap[slot])
                       - dense[len(prompt) + i].cpu()).abs()
                worst = max(worst, float(err.max()))
                if not bool((err <= 1e-3 + 1e-3 * dense[len(prompt) + i]
                             .cpu().abs()).all()):
                    fail(f"bucketed engine (chunk {chunk}) decode step {i} "
                         f"logits off by {float(err.max()):.3e}")
        st = eng.stats()
        launched = st["bucketed_launches"]
        if st["prefix_hits"] < 1 or launched["chunk"] < 1 or (
                chunk is None and launched["prefill"] < 1):
            fail(f"bucketed parity (chunk {chunk}): the paths did not run "
                 f"({launched}, {st['prefix_hits']} prefix hits)")
        log(f"  prefill_chunk={chunk}: greedy tokens equal for the three "
            f"prompts (prefix hits {st['prefix_hits']}, prefill shapes "
            f"{st['prefill_shapes']}, launches "
            f"{launched}); max decode logit err {worst:.3e} (tolerance "
            f"1e-3 + 1e-3 x |plain|)")
    del eng, small


def bucketed_load(K, eng, rec, seed, label):
    """Phase 3's 36-request Poisson load (32 mixed-length prompts and 4
    sharing a 128-token head, from ``seed``) on the bucketed engine,
    counters zeroed just before and read just after. The dense prefill and
    chunk programs of buckets the load meets first are captured in it (a
    warm-up run, then the replay), so the expected launches count those
    warm-ups too. -> (the load's summary, the launches, the rounds by
    kind, the captures by kind)."""
    from paddle_tpu_torch.serving import (make_mixed_length_prompts,
                                          make_shared_prefix_prompts,
                                          run_poisson_load)
    cfg = eng.cfg
    mixed, news = make_mixed_length_prompts(
        32, (16, 512), cfg.vocab_size, decode_heavy=0.5,
        max_new_tokens=(32, 32), seed=seed)
    shared = make_shared_prefix_prompts(4, (16, 64), cfg.vocab_size, 128,
                                        seed=seed + 1)
    prompts = [shared[0]] + mixed + shared[1:]
    news = [32] + news + [32] * 3
    rec["n"] = {"decode": 0, "prefill": 0, "chunk": 0}
    before = eng.stats()
    programs = set(eng._programs)
    cap_s = before["graph_capture_s"]
    K.reset_launch_counts()
    eng.start()
    try:
        res = run_poisson_load(eng, qps=16.0, prompts=prompts,
                               max_new_tokens=news, seed=seed,
                               timeout=600.0)
    finally:
        eng.stop()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    st = eng.stats()
    n = rec["n"]
    caps = {k: 0 for k in n}
    for key in eng._programs - programs:
        caps[key[0]] += 1
    log(f"  {label}: {json.dumps(res)}")
    log(f"  {label}: rounds={st['steps'] - before['steps']} decode_steps="
        f"{n['decode']} dense_prefills={n['prefill']} chunk_steps="
        f"{n['chunk']} programs captured in the load {caps} in "
        f"{st['graph_capture_s'] - cap_s:.3f} s (graphs now "
        f"{st['graphs']}) prefill_shapes={st['prefill_shapes']} "
        f"chunk_shapes={st['chunk_shapes']} kv_occupancy_peak_pct="
        f"{st['kv_occupancy_peak_pct']} prefix_hits="
        f"{st['prefix_hits'] - before['prefix_hits']} prefix_hit_tokens="
        f"{st['prefix_hit_tokens'] - before['prefix_hit_tokens']} "
        f"evictions={st['evictions']}")
    log(f"  {label}: launches {launches}")
    if res["requests_ok"] != len(prompts) or res["requests_failed"]:
        fail(f"bucketed serve ({label}): {res['requests_failed']} "
             f"request(s) failed")
    if res["tokens"] != sum(news):
        fail(f"bucketed serve ({label}): {res['tokens']} tokens generated, "
             f"{sum(news)} asked")
    if st["prefix_hits"] - before["prefix_hits"] < 1:
        fail(f"bucketed serve ({label}): no prefix-cache hit ran")
    counted = {k: st["bucketed_launches"][k] - before["bucketed_launches"][k]
               for k in n}
    if counted != n:
        fail(f"bucketed serve ({label}): engine counted {counted}, the "
             f"recorder {n}")
    if st["graphs"] != st["distinct_programs"]:
        fail(f"bucketed serve ({label}): {st['graphs']} graphs for "
             f"{st['distinct_programs']} programs")
    # every round, replayed or the warm-up before a capture: a decode step
    # runs each layer's paged attention once; every forward (decode, dense
    # prefill, chunk) two RMSNorms per layer plus ln_f; a dense prefill
    # each layer's flash forward
    L = cfg.num_layers
    runs = {k: n[k] + caps[k] for k in n}
    want = {name: 0 for name in launches}
    want.update({"paged_attention": runs["decode"] * L,
                 "rms_norm": sum(runs.values()) * (2 * L + 1),
                 "flash_fwd": runs["prefill"] * L})
    if n["decode"] <= 0 or n["prefill"] <= 0 or n["chunk"] <= 0 \
            or launches != want:
        fail(f"bucketed serve ({label}): kernel launches {launches} != "
             f"{want} expected from {n} rounds and {caps} warm-ups")
    return res, launches, n, caps


def bucketed_serve(pt, K):
    """``gpt_1p3b(use_rms_norm=True)`` bf16 (24 layers, hidden 2048, random
    weights from seed 0) on ``ServingEngine(ragged=False)``: 16 slots,
    page 16, 2048 pages, unchunked, every round a program (``jit=True``).
    A short ``generate`` captures the decode step and one prefill bucket,
    then phase 3's load runs twice (:func:`bucketed_load`): first from
    phase 3's seed, capturing the buckets it meets, then from another seed
    over the programs captured so far. Then the widest decode step, the
    largest dense prefill and the largest chunk step run again replayed
    and eager. -> the engine, the model, the recorded rounds and the
    first load's launches."""
    cfg = pt.gpt_1p3b(use_rms_norm=True, dropout=0.0)
    t0 = time.perf_counter()
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    log(f"[bucketed serve] gpt_1p3b(use_rms_norm=True) bf16 built in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params)")
    mem0 = reserved_bytes()
    eng = pt.ServingEngine(model, page_size=16, num_pages=2048,
                           max_slots=16, prefill_chunk=None, ragged=False,
                           jit=True)
    mem_kv = reserved_bytes()
    rec = {"decode": None, "prefill": None, "chunk": None,
           "n": {"decode": 0, "prefill": 0, "chunk": 0}}
    fns = {name: getattr(eng, f"_{name}_fn")
           for name in ("decode", "prefill", "chunk")}

    def recording(name):
        def run(*args, **kw):
            rec["n"][name] += 1
            if name == "decode":
                rows = int((args[2][:, 0] > 0).sum())
                if rec["decode"] is None or rows > rec["decode"][0]:
                    rec["decode"] = (rows, args)
            else:
                cells = args[0].size
                if rec[name] is None or cells > rec[name][0]:
                    rec[name] = (cells, args)
            return fns[name](*args, **kw)
        return run

    for name in fns:
        setattr(eng, f"_{name}_fn", recording(name))
    t0 = time.perf_counter()
    eng.generate(list(range(1, 21)), max_new_tokens=2)
    torch.cuda.synchronize()
    warm = eng.stats()
    log(f"  warm-up generate (Triton compile, first launches, the captures "
        f"of the decode step and the (1, 32) prefill) "
        f"{time.perf_counter() - t0:.2f} s: {warm['graphs']} graph(s), "
        f"captured in {warm['graph_capture_s']:.3f} s")
    if warm["graphs"] != 2 or warm["distinct_programs"] != 2:
        fail(f"bucketed serve: {warm['graphs']} graphs for "
             f"{warm['distinct_programs']} programs after the warm-up, 2 "
             f"(the decode step, one prefill bucket) expected")
    res, launches, n, _ = bucketed_load(K, eng, rec, SEED, "load 1")
    res2, _, _, _ = bucketed_load(K, eng, rec, SEED + 20, "load 2")
    st = eng.stats()
    log(f"  TTFT p50/p99 {res['ttft_ms_p50']} / {res['ttft_ms_p99']} ms "
        f"(load 1, its buckets' captures inside), {res2['ttft_ms_p50']} / "
        f"{res2['ttft_ms_p99']} ms (load 2); tokens/s "
        f"{res['tokens_per_sec']} / {res2['tokens_per_sec']}; with an eager "
        f"prefill and chunk step this load's TTFT p50 was 21-25 ms "
        f"(PERF.md)")
    log(f"  {st['graphs']} graphs ({st['distinct_programs']} programs: "
        f"{sorted(eng._programs)}) captured in "
        f"{st['graph_capture_s']:.3f} s; device memory reserved: KV pools "
        f"and the engine's buffers {mem_kv - mem0} bytes, the graphs' "
        f"shared pool and static buffers {reserved_bytes() - mem_kv} bytes")
    eng.capture_logits = []
    check = eng.generate(list(range(1, 65)), max_new_tokens=4)
    cap = eng.capture_logits[-1][1]
    if cap.shape != (16, cfg.vocab_size) or not np.isfinite(cap).all() \
            or not all(0 <= t < cfg.vocab_size for t in check):
        fail("bucketed serve: decode logits not finite / of the wrong shape")
    log(f"  decode logits finite, shape {cap.shape}")
    for name in fns:
        setattr(eng, f"_{name}_fn", fns[name])
    check_replay_matches_eager("bucketed serve", "widest decode step",
                               eng._decode_fn, rec["decode"][1])
    # the largest dense prefill with an all-zero table: its K/V goes to
    # the scrap page, so no request's pages are touched
    ids, lens, bt = rec["prefill"][1]
    check_replay_matches_eager("bucketed serve", "largest dense prefill",
                               eng._prefill_fn, (ids, lens, 0 * bt))
    check_replay_matches_eager("bucketed serve", "largest chunk step",
                               eng._chunk_fn, rec["chunk"][1])
    return eng, model, rec, launches


# the paged decode kernel's main-path instantiation (bf16, D 128, one
# query head a block): mangled-name part for ptxas_stats
PAGED_MAIN = "paged_attention_kernelI13__nv_bfloat16Li128ELi1E"


def paged_sweep(K, H, KVH, D, page, max_pages, num_pages=2048):
    """The paged decode kernel at the engine's widths in bf16 over fresh
    random pools: 16 rows at contexts 128, 512 and 1024, and one row of
    1024 keys (where split-K matters most); each held against its plain
    version (within 4e-3) and timed beside its byte bound. -> a list of
    points."""
    g = torch.Generator(device="cuda").manual_seed(8)
    k, v = (torch.randn(num_pages, page, KVH, D, device="cuda",
                        generator=g).to(torch.bfloat16) for _ in range(2))
    points = []
    for rows, c in ((16, 128), (16, 512), (16, 1024), (1, 1024)):
        q = torch.randn(rows, H, D, device="cuda", generator=g).to(
            torch.bfloat16)
        n = -(-c // page)
        perm = (torch.randperm(num_pages - 1, device="cuda", generator=g)
                + 1).int()
        bt = perm[:rows * n].reshape(rows, n)
        bt = torch.cat([bt, torch.full((rows, max_pages - n), -1,
                                       dtype=torch.int32, device="cuda")],
                       1).contiguous()
        ctx = torch.full((rows,), c, dtype=torch.int32, device="cuda")
        args = (q, k, v, bt, ctx)
        check_close(f"paged bf16 sweep {rows} rows x {c} keys",
                    K.paged_attention(*args),
                    K.paged_attention_reference(*args), 4e-3, 4e-3)
        ms, wall, src = time_ms(lambda: K.paged_attention(*args))
        nbytes, flops, _ = attention_work(
            np.arange(rows), np.ones(rows, np.int64), np.full(rows, c),
            bt.cpu().numpy(), H, KVH, D, page, 2, row_meta=1)
        b_ms, _ = bound(nbytes, flops, BF16_FLOPS_PER_S)
        pt = {"rows": rows, "context": c, "ms": ms, "bound_ms": b_ms,
              "pct_of_bound": 100 * b_ms / ms,
              "gb_per_s": nbytes / ms / 1e6}
        log(f"[bucketed timing] paged_attention sweep {rows} rows x {c} "
            f"keys: {ms:.4f} ms ({src}; {wall:.4f} ms per call with launch)"
            f" bound {b_ms:.4f} ms ({nbytes / 1e6:.2f} MB) = "
            f"{pt['pct_of_bound']:.1f}% of bound, {pt['gb_per_s']:.1f} GB/s")
        points.append(pt)
    return points


def bucketed_timing(K, eng, model, rec, launches):
    """Both new kernels at the bucketed serve's shapes: paged attention at
    its widest decode step on the served layer-0 pools (f32-upcast within
    1e-4, bf16 within 4e-3 against plain), RMSNorm at [rows of the largest
    dense prefill, 2048] bf16 with the served ln_1 weight; each timed
    beside its bound, its plain version and, for RMSNorm,
    ``torch.nn.functional.rms_norm`` (timed here only). Then the flash
    forward at the largest dense prefill's shape, held against its plain
    version and timed beside ``F.scaled_dot_product_attention``. -> the
    kernels' JSON entries."""
    cfg = model.config
    H, KVH, D, page = cfg.num_heads, cfg.num_kv_heads, 128, 16
    rows, (tokens, positions, bt) = rec["decode"]
    B = tokens.shape[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(B, H, D, device="cuda", generator=g).to(torch.bfloat16)
    bt_d = torch.from_numpy(bt.astype(np.int32)).cuda()
    ctx = torch.from_numpy((positions + 1).astype(np.int32)).cuda()
    args = (q, eng.kv.k[0], eng.kv.v[0], bt_d, ctx)
    args32 = (q.float(), eng.kv.k[0].float(), eng.kv.v[0].float(), bt_d,
              ctx)
    check_close(f"paged f32 at the widest decode step ({rows} rows)",
                K.paged_attention(*args32),
                K.paged_attention_reference(*args32), 1e-4, 1e-4)
    del args32
    err = check_close(f"paged bf16 at the widest decode step ({rows} rows)",
                      K.paged_attention(*args),
                      K.paged_attention_reference(*args), 4e-3, 4e-3)
    ms, wall, src = time_ms(lambda: K.paged_attention(*args))
    plain_ms, _, _ = time_ms(lambda: K.paged_attention_reference(*args),
                             iters=5)
    ctx_np = positions + 1
    nbytes, flops, _ = attention_work(np.arange(B), np.ones(B, np.int64),
                                      ctx_np, bt, H, KVH, D, page, 2,
                                      row_meta=1)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    log(f"[bucketed timing] paged_attention widest decode step: B={B} "
        f"rows={rows} contexts {int(ctx_np.min())}-{int(ctx_np.max())} "
        f"kernel {ms:.4f} ms ({src}; {wall:.4f} ms per call with launch) "
        f"plain {plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP)")
    # the build's registers and spills of the main path's instantiation
    # (bf16, D 128, one query head a block) and the shared memory a block
    # of this launch takes
    import importlib
    pa = importlib.import_module(
        "paddle_tpu_torch.ops.kernels.paged_attention")
    from paddle_tpu_torch.ops.kernels import _build
    regs, spill = ptxas_stats("paged_attention", PAGED_MAIN)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_pages = bt.shape[1]
    n_split = pa.launch_plan(B, H, KVH, D, max_pages, page, sms)["n_split"]
    smem_fn = _build.load("paged_attention").paged_attention_smem_bytes
    smem_fn.argtypes = [ctypes.c_int] * 7
    smem_fn.restype = ctypes.c_longlong
    smem = smem_fn(H, KVH, D, max_pages, page, n_split, 1)
    log(f"  paged_attention: {regs} registers, {spill} spill bytes, {smem} "
        f"bytes of dynamic shared memory a block, {n_split} splits a (row, "
        f"KV head) = {100 * b_ms / ms:.1f}% of bound, "
        f"{nbytes / ms / 1e6:.1f} GB/s")
    entries = [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:175",
        "launches": launches["paged_attention"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "registers": regs, "spill_bytes": spill,
        "smem_bytes": smem, "n_split": n_split,
        "sweep": paged_sweep(K, H, KVH, D, page, max_pages)}]
    del args, q
    nb, sb = rec["prefill"][1][0].shape
    R = nb * sb
    eps = cfg.layer_norm_epsilon
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(R, 2048, device="cuda", generator=g).to(torch.bfloat16)
    w = model.gpt.h[0].ln_1.weight.detach()
    err = check_close(f"rms_norm at [{R}, 2048] bf16", K.rms_norm(x, w, None,
                                                                  eps),
                      K.rms_norm_reference(x, w, None, eps), 2e-2, 2e-2)
    ms, wall, src = time_ms(lambda: K.rms_norm(x, w, None, eps))
    plain_ms, _, _ = time_ms(lambda: K.rms_norm_reference(x, w, None, eps))
    lib_ms, lib_wall, _ = time_ms(lambda: torch.nn.functional.rms_norm(
        x, (2048,), w, eps))
    b_ms, b_by = bound(2 * x.numel() * 2 + 2048 * 2, 4 * x.numel(),
                       F32_FLOPS_PER_S)
    log(f"[bucketed timing] rms_norm [{R}, 2048] bf16 (the largest dense "
        f"prefill, [{nb}, {sb}]): kernel {ms:.4f} ms ({src}; {wall:.4f} ms "
        f"per call with launch) plain {plain_ms:.4f} ms F.rms_norm "
        f"{lib_ms:.4f} ms ({lib_wall:.4f} ms per call) bound {b_ms:.4f} ms "
        f"({b_by})")
    # the flash forward as the bucketed serve runs it: one dense prefill
    # at the largest shape it launched (bf16 causal, q/k/v views of one
    # fused projection), beside F.scaled_dot_product_attention
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    scale = 1.0 / math.sqrt(D)
    _, q, k, v, _ = flash_inputs(nb, sb, H, D, torch.bfloat16, seed=7)
    o, lse = K.flash_fwd(q, k, v, scale, True)
    ro, rl = K.flash_fwd_reference(_bhsd(q), _bhsd(k), _bhsd(v), scale, True)
    check_close(f"flash_fwd O at the largest dense prefill [{nb}, {sb}]", o,
                _bshd(ro, nb, H), FLASH_BF16_TOL, FLASH_BF16_TOL,
                FLASH_BF16_NORM_TOL)
    check_close(f"flash_fwd lse at the largest dense prefill [{nb}, {sb}]",
                lse, rl.reshape(nb, H, sb), 1e-4, 1e-4)
    fl_ms, fl_wall, src = time_ms(lambda: K.flash_fwd(q, k, v, scale, True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_ms, _, _ = time_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True))
    log(f"[bucketed timing] flash_fwd at the largest dense prefill [{nb}, "
        f"{sb}, {H}, {D}] bf16 causal: kernel {fl_ms:.4f} ms ({src}; "
        f"{fl_wall:.4f} ms per call with launch) "
        f"F.scaled_dot_product_attention {sdpa_ms:.4f} ms")
    entries.append({
        "name": "rms_norm", "route": "triton",
        "source": "paddle_tpu_torch/ops/kernels/rms_norm.py",
        "replaces": "paddle_tpu/ops/pallas/rms_norm.py:39",
        "launches": launches["rms_norm"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms})
    return entries


# ------------------------------------------------------------ O2 phases
def o2_model(pt, cfg, seed=SEED):
    """``cfg`` built in f32 from ``seed``, with the O2 pretraining run's
    optimizer: AdamW with master weights, a global-norm clip at 1.0 and
    ``LinearWarmup(CosineAnnealingDecay(1e-4, T_max=100), 4, 0, 1e-4)``,
    decorated O2 bf16 (``bench.py:690-720`` plus the schedule and clip).
    -> (model, optimizer, scheduler)"""
    lr = pt.optimizer.lr
    model = pt.GPTForCausalLM(cfg, dtype=torch.float32, seed=seed).train()
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=100), 4,
                            0.0, 1e-4)
    opt = pt.AdamW(learning_rate=sched, parameters=model.parameters(),
                   multi_precision=True,
                   grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    model, opt = pt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model, opt, sched


def o2_step_fn(pt, model, opt, sched, ids, labels):
    crit = pt.GPTPretrainingCriterion(model.config)

    def step():
        with pt.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.item()
    return step


def o2_train_slice(pt, K, recompute, steps=10, warmup=2, B=8, S=1024):
    """gpt_1p3b trained O2 (:func:`o2_model`) on phase 8's fixed batch:
    ``warmup`` steps, then ``steps`` timed ones. Fails unless the losses
    are finite and fall and the kernels launched exactly as the step
    prescribes. -> (model, optimizer, scheduler, losses, summary, the
    timed steps' launch counts)"""
    cfg = pt.gpt_1p3b(dropout=0.0, recompute=recompute)
    t0 = time.perf_counter()
    model, opt, sched = o2_model(pt, cfg)
    dev = model.device
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(SEED)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).to(dev)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (B, S))).to(dev)
    step = o2_step_fn(pt, model, opt, sched, ids, labels)
    torch.cuda.synchronize()
    tag = "recompute" if recompute else "no recompute"
    log(f"[o2 train] gpt_1p3b {tag}: {n_params / 1e9:.4f} B params in "
        f"bf16 ({len(list(model.parameters()))} tensors) with f32 masters,"
        f" built and decorated in {time.perf_counter() - t0:.2f} s; B={B} "
        f"S={S}; auto_cast O2 bf16, AdamW(multi_precision) with "
        f"ClipGradByGlobalNorm(1.0), LinearWarmup(CosineAnnealingDecay)")
    losses, times, lrs = [], [], []
    for _ in range(warmup):
        losses.append(step())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    for _ in range(steps):
        lrs.append(opt.get_lr())
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses)
        + f" (first {warmup} are warm-up)")
    log("  lr: " + " ".join(f"{x:.3e}" for x in lrs))
    log("  step ms: " + " ".join(f"{x:.2f}" for x in times))
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"o2 train ({tag}): losses not finite or not falling: "
             f"{losses}")
    L = cfg.num_layers
    # per step: the flash forward once a layer (twice with recompute: the
    # replay runs it again), dQ and dK/dV once a layer, LayerNorm twice a
    # layer plus ln_f (again twice a layer in the replay), AdamW once
    fwd = 2 * L if recompute else L
    want = {name: 0 for name in launches}
    want.update({"layer_norm": steps * (2 * fwd + 1),
                 "flash_fwd": steps * fwd, "flash_bwd_dq": steps * L,
                 "flash_bwd_dkv": steps * L, "fused_adamw": steps})
    log(f"  launches over {steps} timed steps: {launches}")
    if launches != want:
        fail(f"o2 train ({tag}): kernel launches {launches} != {want}")
    wall_ms, busy_ms, families, top, _ = profile_train_step(step)
    total_ms = sum(families.values())
    log(f"  one step under torch.profiler: {wall_ms:.2f} ms host, device "
        f"busy {busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% busy")
    for fam, fam_ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"    {fam}: {fam_ms:.3f} ms ({100 * fam_ms / total_ms:.1f}%)")
    for (fam, name), k_ms in top[:8]:
        log(f"      {k_ms:.3f} ms  [{fam}] {name[:90]}")
    med = float(np.median(times))
    flops = train_flops(n_params, B, S, L, cfg.hidden_size)
    summary = {"recompute": recompute, "step_ms_median": med,
               "step_ms_min": min(times), "step_ms_max": max(times),
               "tokens_per_s": B * S / med * 1e3,
               "gpt_train_step_mfu": flops / (med / 1e3) / BF16_FLOPS_PER_S,
               "max_memory_allocated_gb": peak / 1e9,
               "device_busy_pct": 100 * busy_ms / wall_ms,
               "first_loss": losses[0], "last_loss": losses[-1]}
    log(f"  {json.dumps(summary)}")
    return model, opt, sched, losses, summary, launches


def o2_train(pt, K):
    """Phase 13: the O2 run without recompute, then with it (the first
    model freed before the second is built). The recompute run must show
    a lower peak and the same losses within 1e-3 (the kernels are the
    same; only the summation order of a nondeterministic reduction could
    move them). -> (the recompute run's model, optimizer, the two
    summaries, the recompute run's launches)"""
    model, opt, sched, plain, s_plain, _ = o2_train_slice(pt, K, False)
    del model, opt, sched
    gc.collect()
    torch.cuda.empty_cache()
    model, opt, sched, remat, s_remat, launches = o2_train_slice(pt, K,
                                                                 True)
    diff = max(abs(a - b) for a, b in zip(plain, remat))
    log(f"[o2 train] recompute vs not: losses differ by at most "
        f"{diff:.3e} (tolerance 1e-3); peak "
        f"{s_remat['max_memory_allocated_gb']:.2f} GB against "
        f"{s_plain['max_memory_allocated_gb']:.2f} GB; step "
        f"{s_remat['step_ms_median']:.2f} ms against "
        f"{s_plain['step_ms_median']:.2f} ms")
    if diff > 1e-3:
        fail(f"o2 train: recompute's losses {remat} differ from {plain}")
    if s_remat["max_memory_allocated_gb"] >= \
            s_plain["max_memory_allocated_gb"]:
        fail("o2 train: recompute did not lower the peak memory")
    return model, opt, (s_plain, s_remat), launches


def check_update(K, before, gs, after, c1, c2, rtol, what):
    """Each tensor's ``(w, m, v)`` in ``after`` against the plain update
    of its clones in ``before`` (one tensor at a time, so the plain
    results never all live at once), within ``1e-6 + rtol |plain|``.
    -> the max abs error"""
    worst = 0.0
    for i, ((w0, m0, v0), gr) in enumerate(zip(before, gs)):
        want = K.fused_adamw_reference(w0, gr, m0, v0, 1e-4, 0.9, 0.999,
                                       1e-8, 0.01, c1, c2)
        for key, got, ref in zip("wmv", [x[i] for x in after], want):
            err = (got.float() - ref.float()).abs()
            worst = max(worst, float(err.max()))
            if got.dtype != ref.dtype or not bool(
                    (err <= 1e-6 + rtol * ref.float().abs()).all()):
                fail(f"{what}: {key} of tensor {i} off by "
                     f"{float(err.max()):.3e}")
    return worst


def launch_ms(args, iters=10, warmup=2):
    """Device ms of one fused AdamW launch over ``args`` (the wrapper's
    arguments, ``params`` last): the table is built once, then CUDA
    events bracket ``iters`` launches issued back to back, so the
    wrapper's host work and its synchronous table copy, which hold the
    card idle between calls, are left out."""
    FA = importlib.import_module("paddle_tpu_torch.ops.kernels.fused_adamw")
    ws, gs, ms, vs, lr, b1, b2, eps, wd, bc1, bc2, params = args
    fn, chunk = FA._kernel()
    n = len(ws)
    plan = FA._table(ws, gs, ms, vs, params or [None] * n, lr, wd, bc1,
                     bc2, chunk)
    for _ in range(warmup):
        FA._launch(fn, plan, b1, b2, eps)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        FA._launch(fn, plan, b1, b2, eps)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def master_mode_timing(K, model, opt):
    """Phase 14 (kernel): master mode and bf16-moment mode over the
    model's tensors, each one launch, against the plain version on clones
    (f32 within 1e-6 + 1e-6 |plain|, bf16 within one rounding, the bf16
    parameter exactly its new master rounded); then both timed beside
    their bounds (28 and 14 bytes a parameter over 3.35 TB/s) and master
    mode beside ``torch._fused_adamw_`` on the f32 masters with the
    gradients upcast plus ``torch._foreach_copy_`` into the bf16
    parameters (timed here only). -> a dict of the numbers for the
    ``fused_adamw`` entry"""
    params = list(model.parameters())
    n_t, n = len(params), sum(p.numel() for p in params)
    g = torch.Generator(device=params[0].device).manual_seed(11)
    gs = [(1e-3 * torch.randn(p.shape, device=p.device, generator=g))
          .bfloat16() for p in params]
    ws = [opt._master_of(p) for p in params]
    ms_ = [opt._get_accumulator("moment1", p) for p in params]
    vs_ = [opt._get_accumulator("moment2", p) for p in params]
    c1, c2 = 1 / (1 - 0.9 ** 23), 1 / (1 - 0.999 ** 23)
    args = lambda w, m, v, ps: (  # noqa: E731
        w, gs, m, v, [1e-4] * n_t, 0.9, 0.999, 1e-8, [0.01] * n_t,
        [c1] * n_t, [c2] * n_t, ps)
    out = {}
    with torch.no_grad():
        before = [(w.clone(), m.clone(), v.clone())
                  for w, m, v in zip(ws, ms_, vs_)]
        K.fused_adamw(*args(ws, ms_, vs_, params))
        torch.cuda.synchronize()
        err = check_update(K, before, gs, (ws, ms_, vs_), c1, c2, 1e-6,
                           "fused_adamw master mode")
        del before
        for p, w in zip(params, ws):
            if not torch.equal(p, w.bfloat16()):
                fail(f"fused_adamw master mode: {p.param_name} is not its "
                     f"master rounded to bf16")
        out["master_max_abs_err"] = err
        log(f"  master mode, one launch over {n_t} tensors ({n / 1e9:.4f} "
            f"B params): w, m, v within 1e-6 + 1e-6 |plain| (max abs err "
            f"{err:.3e}); every bf16 parameter equals its new master "
            f"rounded to nearest even")
        # bf16 moments: bf16 w, g, m, v (O2 without master weights)
        wb = [p.detach().clone() for p in params]
        mb = [m.bfloat16() for m in ms_]
        vb = [v.bfloat16() for v in vs_]
        before = [(w.clone(), m.clone(), v.clone())
                  for w, m, v in zip(wb, mb, vb)]
        K.fused_adamw(*args(wb, mb, vb, None))
        torch.cuda.synchronize()
        # one bf16 rounding of values the kernel and the plain version may
        # round from f32 results that differ in the last bit (FMA)
        err_b = check_update(K, before, gs, (wb, mb, vb), c1, c2, 8e-3,
                             "fused_adamw bf16 moments")
        del before
        out["bf16_moment_max_abs_err"] = err_b
        log(f"  bf16-moment mode, one launch over {n_t} tensors: w, m, v "
            f"within one bf16 rounding (8e-3 |plain|; max abs err "
            f"{err_b:.3e})")
        torch.cuda.empty_cache()
        ms, wall, src = time_ms(lambda: K.fused_adamw(
            *args(ws, ms_, vs_, params)), iters=10)
        plain_ms, _, _ = time_ms(lambda: [K.fused_adamw_reference(
            w, gr, m, v, 1e-4, 0.9, 0.999, 1e-8, 0.01, c1, c2)
            for w, gr, m, v in zip(ws, gs, ms_, vs_)], iters=2, warmup=1)
        ms_b, _, _ = time_ms(lambda: K.fused_adamw(*args(wb, mb, vb, None)),
                             iters=10)
        g32 = [x.float() for x in gs]
        # the same launches with the table built once (device time alone),
        # and the O1 mode (f32 w and g) on the same tensors beside them
        ev = {"master": launch_ms(args(ws, ms_, vs_, params)),
              "bf16_moment": launch_ms(args(wb, mb, vb, None)),
              "f32": launch_ms((ws, g32) + args(ws, ms_, vs_, None)[2:])}
        del wb, mb, vb
        steps_t = [torch.tensor(23.0, device=p.device) for p in params]
        lib_adam, _, _ = time_ms(lambda: torch._fused_adamw_(
            ws, g32, ms_, vs_, [], steps_t, lr=1e-4, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False), iters=10)
        pdata = [p.detach() for p in params]
        lib_copy, _, _ = time_ms(lambda: torch._foreach_copy_(pdata, ws),
                                 iters=10)
        del g32
    b_ms, b_by = bound(28 * n, 12 * n, F32_FLOPS_PER_S)
    bb_ms, bb_by = bound(14 * n, 12 * n, F32_FLOPS_PER_S)
    # the kernel's time is the launch over a prebuilt table: the
    # profiler's sum over the wrapper's calls (``ms``, ``ms_b``) read 20%
    # low in these modes (two of ten launches missing from its trace)
    log(f"[o2 timing] fused_adamw master mode over {n_t} tensors: kernel "
        f"{ev['master']:.4f} ms (one launch over a prebuilt table, CUDA "
        f"events over back-to-back launches) = "
        f"{100 * b_ms / ev['master']:.1f}% of bound {b_ms:.4f} ms ({b_by}: "
        f"28 B/param, {28 * n / 1e9:.2f} GB); the wrapper {wall:.4f} ms a "
        f"call with its host work (profiler device sum {ms:.4f} ms, {src});"
        f" plain {plain_ms:.4f} ms; library torch._fused_adamw_ "
        f"{lib_adam:.4f} ms + torch._foreach_copy_ {lib_copy:.4f} ms = "
        f"{lib_adam + lib_copy:.4f} ms")
    log(f"[o2 timing] fused_adamw bf16-moment mode: kernel "
        f"{ev['bf16_moment']:.4f} ms (prebuilt table) = "
        f"{100 * bb_ms / ev['bf16_moment']:.1f}% of bound {bb_ms:.4f} ms "
        f"({bb_by}: 14 B/param; profiler device sum {ms_b:.4f} ms); f32 w "
        f"and g, phase 9's mode, on the same tensors: {ev['f32']:.4f} ms "
        f"(prebuilt table) = {100 * b_ms / ev['f32']:.1f}% of bound")
    out.update({"master_ms": ev["master"], "master_wrapper_ms": wall,
                "master_plain_ms": plain_ms, "master_bound_ms": b_ms,
                "master_library_ms": lib_adam + lib_copy,
                "master_library_fused_adamw_ms": lib_adam,
                "master_library_foreach_copy_ms": lib_copy,
                "bf16_moment_ms": ev["bf16_moment"],
                "bf16_moment_bound_ms": bb_ms, "f32_launch_ms": ev["f32"]})
    return out


def resume_and_scaler_check(pt, K, layers=2, B=2, S=512):
    """Phase 14 (state): at full width and ``layers`` layers, train 2 O2
    steps, save model, optimizer and scheduler to the host, train 2 more;
    a fresh model and optimizer restored from the saved state and trained
    the same 2 steps must hold bit-equal weights, masters and moments.
    Then ``GradScaler``: an inf injected into one gradient must skip the
    step (weights, masters and step counts untouched) and halve the
    scale, and the next step must update."""
    cfg = pt.gpt_1p3b(dropout=0.0)
    cfg.num_layers = layers
    rng = np.random.RandomState(SEED + 3)
    batches = [tuple(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                  (B, S))) for _ in range(2))
               for _ in range(4)]

    def run(model, opt, sched, bs):
        dev = model.device
        for ids, labels in bs:
            o2_step_fn(pt, model, opt, sched, ids.to(dev),
                       labels.to(dev))()

    model, opt, sched = o2_model(pt, cfg, seed=SEED + 3)
    run(model, opt, sched, batches[:2])
    saved_w = {n: p.detach().cpu().clone()
               for n, p in model.named_parameters()}
    saved_opt = pt.opt_state_to_numpy(opt.state_dict())
    run(model, opt, sched, batches[2:])
    model2, opt2, sched2 = o2_model(pt, cfg, seed=SEED + 4)
    with torch.no_grad():
        for n, p in model2.named_parameters():
            p.copy_(saved_w[n])
    opt2.set_state_dict(saved_opt)
    run(model2, opt2, sched2, batches[2:])
    torch.cuda.synchronize()
    worst = {"weights": 0.0, "masters": 0.0, "moments": 0.0}
    for (n, p), p2 in zip(model.named_parameters(), model2.parameters()):
        pairs = [("weights", p, p2),
                 ("masters", opt._master_weights[p],
                  opt2._master_weights[p2])]
        pairs += [("moments", opt._accumulators[a][p],
                   opt2._accumulators[a][p2])
                  for a in ("moment1", "moment2")]
        for key, a, b in pairs:
            worst[key] = max(worst[key], float((a.float() - b.float())
                                               .abs().max().detach()))
        if opt._accumulators["beta_pow"][p] != \
                opt2._accumulators["beta_pow"][p2]:
            fail(f"resume: step count of {n} differs")
    if sched.last_epoch != sched2.last_epoch or \
            opt._global_step != opt2._global_step:
        fail("resume: scheduler or global step differs")
    log(f"[resume] 2 + 2 O2 steps against a host save after 2, restored "
        f"and stepped 2 ({layers} layers at gpt_1p3b widths, B={B} S={S}): "
        f"max abs difference {worst}")
    if any(worst.values()):
        fail(f"resume: the restored run differs from the continuous one "
             f"{worst}")
    log("  bit-equal: weights, f32 masters, moments, step counts, "
        "schedule")
    del model2, opt2, sched2, saved_w, saved_opt
    # GradScaler: an inf skips the step and halves the scale
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    crit = pt.GPTPretrainingCriterion(cfg)
    dev = model.device
    ids, labels = (x.to(dev) for x in batches[0])
    params = list(model.parameters())
    for inject in (True, False):
        with pt.auto_cast(level="O2", dtype="bfloat16"):
            loss = crit(model(ids), labels)
        scaler.scale(loss).backward()
        if inject:
            params[4].grad.view(-1)[7] = float("inf")
        snap = [(p.detach().clone(), opt._master_weights[p].clone())
                for p in params]
        steps_before = opt._global_step
        scale_before = scaler._scale
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        torch.cuda.synchronize()
        same = all(torch.equal(p, w) and torch.equal(opt._master_weights[p],
                                                     mw)
                   for p, (w, mw) in zip(params, snap))
        if inject and not (same and opt._global_step == steps_before
                           and scaler._scale == scale_before / 2):
            fail(f"GradScaler: an inf gradient did not skip the step "
                 f"(weights untouched {same}, scale {scaler._scale})")
        if not inject and same:
            fail("GradScaler: a finite step left the weights unchanged")
        log(f"[scaler] {'inf injected' if inject else 'finite'}: step "
            f"{'skipped' if same else 'taken'}, scale {scale_before:g} -> "
            f"{scaler._scale:g}")
    del model, opt, sched, snap


# ------------------------------------------------------- generate phase
def flash_decode_parity(K, B=4, H=16, D=128):
    """The flash forward at one query row over ``Sk`` keys, the eager
    ``generate``'s dense-cache step (not causal), against its plain
    version: ``Sk`` in 1, 17, 129, 383 (the generate phase's last step)
    and 1000; q a row of one fused projection, k and v contiguous as the
    concatenated cache; f32 within 1e-4, bf16 within phase 6's limits.
    Then the kernel at ``Sk = 383`` bf16 timed beside its bound, its plain
    version and ``F.scaled_dot_product_attention``. -> the JSON keys it
    adds to the flash forward's entry."""
    scale = 1.0 / math.sqrt(D)
    worst = 0.0
    for dt, tol, norm_tol in ((torch.float32, 1e-4, None),
                              (torch.bfloat16, FLASH_BF16_TOL,
                               FLASH_BF16_NORM_TOL)):
        for sk in (1, 17, 129, 383, 1000):
            g = torch.Generator(device="cuda").manual_seed(sk)
            qkv = torch.randn(B, 1, 3 * H * D, device="cuda",
                              generator=g).to(dt)
            q = qkv[..., :H * D].reshape(B, 1, H, D)
            k, v = (torch.randn(B, sk, H, D, device="cuda",
                                generator=g).to(dt) for _ in range(2))
            o, lse = K.flash_fwd(q, k, v, scale, False)
            ro, rl = K.flash_fwd_reference(_bhsd(q), _bhsd(k), _bhsd(v),
                                           scale, False)
            tag = f"Sq=1 Sk={sk} {str(dt)[6:]}"
            err = check_close(f"flash_fwd O {tag}", o, _bshd(ro, B, H), tol,
                              tol, norm_tol)
            check_close(f"flash_fwd lse {tag}", lse, rl.reshape(B, H, 1),
                        1e-4, 1e-4)
            if dt == torch.bfloat16:
                worst = max(worst, err)
    kc, vc = k[:, :383].contiguous(), v[:, :383].contiguous()
    ms, wall, src = time_ms(lambda: K.flash_fwd(q, kc, vc, scale, False))
    plain_ms, _, _ = time_ms(lambda: K.flash_fwd_reference(
        _bhsd(q), _bhsd(kc), _bhsd(vc), scale, False))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
    lib_ms, _, _ = time_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(qt, kt, vt))
    # q, k, v read once, O written, lse written; QK^T and PV
    nbytes = 2 * B * H * D * (2 + 2 * 383) + 4 * B * H
    b_ms, b_by = bound(nbytes, 4 * B * H * 383 * D, BF16_FLOPS_PER_S)
    log(f"[generate timing] flash_fwd at Sq=1 Sk=383 [{B}, 1, {H}, {D}] bf16: "
        f"kernel {ms:.4f} ms ({src}; {wall:.4f} ms per call with launch) "
        f"plain {plain_ms:.4f} ms F.scaled_dot_product_attention "
        f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.2f} MB)")
    return {"sq1_max_abs_err": worst, "sq1_ms": ms, "sq1_plain_ms": plain_ms,
            "sq1_bound_ms": b_ms, "sq1_bound_by": b_by,
            "sq1_library_ms": lib_ms}


def teacher_forced(model, out, P, top_k=None, rtol=2e-2, atol=2e-2):
    """Every token of ``out`` after the prompt against the logits of one
    no-cache forward over ``out`` (the flash forward, causal): greedy
    (``top_k`` None) when its logit is the row's largest, or below it by
    at most ``atol + rtol * |largest|`` (bf16 logits of two differently
    rounded paths); sampled with ``top_k`` when its logit is at least the
    k-th largest less that margin. -> (tokens at or above the reference
    logit, tokens, the largest shortfall, whether every token passes)."""
    with torch.no_grad():
        logits = model(out[:, :-1])[:, P - 1:].float()
    chosen = logits.gather(-1, out[:, P:, None])[..., 0]
    if top_k is None:
        ref = logits.max(dim=-1).values
    else:
        ref = logits.topk(top_k, dim=-1).values[..., -1]
    short = ref - chosen
    ok = short <= atol + rtol * ref.abs()
    return int((short <= 0).sum()), short.numel(), float(short.max()), \
        bool(ok.all())


def generate_phase(pt, K, B=4, P=128, N=256):
    """``GPTForCausalLM.generate`` on ``gpt_1p3b`` bf16 (24 layers, random
    weights from seed 0), batch 4, 128-token prompts from seed 0, 256 new
    tokens: greedy compiled (twice: the first call captures the step's
    graph after one eager warm-up step, the second only replays), the
    same static step run eagerly (bit-equal to the replays), greedy eager
    over the dense cache (the flash forward at Sq = 1, counted) and
    sampled with ``top_k=50`` (twice from one generator seed: equal).
    Every greedy token passes the teacher-forced check of
    :func:`teacher_forced`, every sampled one is among its step's 50
    largest; the launches are exact. Prints ms a step and tokens/s on the
    host clock. -> the JSON keys the phase adds to the layer_norm and
    flash forward entries."""
    from paddle_tpu_torch.models.generate import generate_compiled
    cfg = pt.gpt_1p3b(dropout=0.0)
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    ids = torch.from_numpy(np.random.RandomState(SEED).randint(
        1, cfg.vocab_size, (B, P))).to(model.device)
    L = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def timed(label, fn, want):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in K.launch_counts().items() if v}
        log(f"[generate] {label}: {wall:.3f} s, {wall * 1e3 / N:.3f} ms a "
            f"step, {B * N / wall:.1f} tokens/s (batch {B}, {N} steps); "
            f"launches {launches}")
        if launches != want:
            fail(f"generate {label}: launches {launches} != {want}")
        if out.shape != (B, P + N) or not bool((out[:, :P] == ids).all()):
            fail(f"generate {label}: output {tuple(out.shape)} does not "
                 f"extend the prompt to [{B}, {P + N}]")
        return out, wall

    # the compiled step: prefill, then N - 1 steps, one LayerNorm a
    # layer twice plus ln_f each
    want = {"layer_norm": (2 * L + 1) * N}
    progs = model.decode_programs
    first, _ = timed("greedy compiled, first call", lambda: model.generate(
        ids, max_new_tokens=N, temperature=0.0), want)
    log(f"  {progs.graphs} graph captured in {progs.capture_s:.3f} s")
    comp, comp_s = timed("greedy compiled, replays", lambda: model.generate(
        ids, max_new_tokens=N, temperature=0.0), want)
    static, _ = timed("greedy static step, eager", lambda: generate_compiled(
        model, ids, N, None, replay=False), want)
    if progs.graphs != 1 or not (torch.equal(first, comp)
                                 and torch.equal(comp, static)):
        fail(f"generate: {progs.graphs} graphs; the replayed steps equal "
             f"the eager static step: {torch.equal(comp, static)}, the two "
             f"compiled calls: {torch.equal(first, comp)}")
    log("  the replayed steps' tokens equal the eager static step's")
    # 16 replays of the step under the profiler: where its device time
    # goes
    dec = next(iter(progs._decoders.values()))
    dec.prefill(ids, -1)
    wall_ms, busy_ms, families, top, events = profile_train_step(
        lambda: [dec.captured.replay() for _ in range(16)])
    log(f"[generate profile] 16 replayed steps: {wall_ms / 16:.3f} ms a step "
        f"on the host clock, device busy {busy_ms / 16:.3f} ms a step "
        f"({100 * busy_ms / wall_ms:.1f}%), {events / 16:g} device "
        f"kernels a step")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms / 16:.4f} ms a step")
    for (fam, name), ms in top[:10]:
        log(f"    {ms / 16:.4f} ms a step  [{fam}] {name[:100]}")
    # the dense cache: N + 1 forwards (the loop's last one is not read);
    # twice, as the first call also grows the allocator's cache
    for run in ("first call", "second call"):
        dense, dense_s = timed(
            f"greedy eager, dense cache, {run}", lambda: model.generate(
                ids, max_new_tokens=N, temperature=0.0, compiled=False),
            {"flash_fwd": L * (N + 1),
             "layer_norm": (2 * L + 1) * (N + 1)})
    flash_launches = L * (N + 1)
    same = int((dense[:, P:] == comp[:, P:]).all(dim=0).long().cumprod(
        0).sum())
    log(f"  the dense and the static path agree on their first {same} of "
        f"{N} steps in every row (bf16: each path is held to itself)")
    for label, out in (("compiled", comp), ("dense cache", dense)):
        exact, n, short, ok = teacher_forced(model, out, P)
        log(f"  teacher-forced, greedy {label}: {exact} of {n} tokens the "
            f"exact argmax of a no-cache forward, the largest shortfall "
            f"{short:.4f} (tolerance 2e-2 + 2e-2 x |max|)")
        if not ok:
            fail(f"generate: a greedy {label} token is not the argmax of "
                 f"the no-cache forward within bf16 tolerance")
    draws = []
    for _ in range(2):
        gen = torch.Generator(device=model.device).manual_seed(SEED)
        out, samp_s = timed(
            "sampled, top_k 50", lambda: model.generate(
                ids, max_new_tokens=N, temperature=1.0, top_k=50,
                generator=gen),
            {"flash_fwd": L * (N + 1), "layer_norm": (2 * L + 1) * (N + 1)})
        draws.append(out)
    exact, n, short, ok = teacher_forced(model, draws[0], P, top_k=50)
    log(f"  sampled: the two draws from one seed equal: "
        f"{torch.equal(*draws)}; {n} tokens, the largest shortfall below "
        f"the 50th logit {short:.4f}")
    if not (ok and torch.equal(*draws)):
        fail("generate: sampling not reproducible or outside the top 50")
    mem = torch.cuda.max_memory_allocated()
    log(f"  ms a step: compiled {comp_s * 1e3 / N:.3f}, dense cache "
        f"{dense_s * 1e3 / N:.3f}, sampled {samp_s * 1e3 / N:.3f}; "
        f"peak memory {mem / 1e9:.2f} GB")
    del model
    return {"generate_launches": flash_launches}, \
        {"generate_launches": want["layer_norm"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script drives the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.ops import kernels as K
        from paddle_tpu_torch.ops.kernels import _build
        from paddle_tpu_torch.serving import (make_mixed_length_prompts,
                                              make_shared_prefix_prompts,
                                              run_poisson_load)
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    # ------------------------------------------------------ phase 1: build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] nvcc {_build.NVCC_FLAGS}: {sorted(libs)} in "
        f"{build_s:.2f} s")
    for name in libs:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # ---------------------------------------------- phase 2: kernel parity
    log("[parity] ragged_paged_attention vs plain (H=16, D=128, page 16)")
    for kvh in (16, 4):
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = mixed_launch(16, kvh, 128, dt, seed=kvh)
            got = K.ragged_paged_attention(*args)
            torch.cuda.synchronize()
            want = K.ragged_paged_attention_reference(*args)
            check_close(f"ragged KVH={kvh} {str(dt)[6:]}", got, want, tol,
                        tol)
            if not bool((got[71:] == 0).all()):
                fail("pad tokens of the ragged launch are not zero")
    log("[parity] layer_norm vs plain ([T, 2048])")
    t0 = time.perf_counter()
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        g = torch.Generator(device="cuda").manual_seed(1)
        x = (torch.randn(300, 2048, device="cuda", generator=g) * 2 + 1).to(dt)
        w = (1 + 0.1 * torch.randn(2048, device="cuda", generator=g)).to(dt)
        b = (0.1 * torch.randn(2048, device="cuda", generator=g)).to(dt)
        got = K.layer_norm(x, w, b)
        torch.cuda.synchronize()
        check_close(f"layer_norm {str(dt)[6:]}", got,
                    K.layer_norm_reference(x, w, b), tol, tol)
    log(f"  (Triton compile + first launches {time.perf_counter() - t0:.2f}"
        " s)")

    log("[parity] 2-layer f32 model at gpt_1p3b widths: engine vs dense "
        "plain forward")
    small_cfg = pt.gpt_1p3b(dropout=0.0)
    small_cfg.num_layers = 2
    small = pt.GPTForCausalLM(small_cfg, dtype=torch.float32, seed=SEED + 1)
    eng = pt.ServingEngine(small, page_size=16, num_pages=64, max_slots=4,
                           prefill_chunk=16)
    eng.capture_logits = []
    prompt = np.random.RandomState(SEED).randint(1, 50304, size=37).tolist()
    new = eng.generate(prompt, max_new_tokens=8)
    ids = prompt + new
    with torch.no_grad():
        dense = dense_reference_logits(small, ids)
    want = dense[len(prompt) - 1:].argmax(-1).tolist()
    if new != want[:8]:
        fail(f"engine tokens {new} != dense greedy {want[:8]}")
    worst = 0.0
    for i, (slot_map, cap) in enumerate(eng.capture_logits):
        slot = next(iter(slot_map))
        worst = max(worst, check_close(
            f"decode round {i} logits", torch.from_numpy(cap[slot]),
            dense[len(prompt) + i].cpu(), 1e-3, 1e-3))
    log(f"  greedy tokens equal over {len(new)} steps; "
        f"max logit err {worst:.3e}")
    del eng, small
    torch.cuda.empty_cache()

    # ---------------------------------------------------- phase 3: serve
    cfg = pt.gpt_1p3b(dropout=0.0)
    t0 = time.perf_counter()
    model = pt.GPTForCausalLM(cfg, dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    log(f"[serve] gpt_1p3b bf16 built in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params)")
    eng = pt.ServingEngine(model, page_size=16, num_pages=2048,
                           max_slots=16, prefill_chunk=256, jit=True)
    log(f"  KV pools {eng.kv.nbytes() / 1e9:.2f} GB "
        f"({eng.kv.num_pages} pages of 16 tokens)")
    rounds = {"mixed": None, "decode": None, "launched": 0}
    run_round = eng._ragged_fn

    def recording_round(tokens, rs, rl, kl, bt, **kw):
        rounds["launched"] += 1
        n_valid, n_rows = int(rl.sum()), int((rl > 0).sum())
        if rounds["mixed"] is None or n_valid > rounds["mixed"][0]:
            rounds["mixed"] = (n_valid, (tokens, rs, rl, kl, bt))
        if bool((rl <= 1).all()) and (rounds["decode"] is None
                                     or n_rows > rounds["decode"][0]):
            rounds["decode"] = (n_rows, (tokens, rs, rl, kl, bt))
        return run_round(tokens, rs, rl, kl, bt, **kw)

    eng._ragged_fn = recording_round
    mixed, news = make_mixed_length_prompts(
        32, (16, 512), cfg.vocab_size, decode_heavy=0.5,
        max_new_tokens=(32, 32), seed=SEED)
    shared = make_shared_prefix_prompts(4, (16, 64), cfg.vocab_size, 128,
                                        seed=SEED + 1)
    prompts = [shared[0]] + mixed + shared[1:]
    news = [32] + news + [32] * 3
    mem0 = reserved_bytes()
    t0 = time.perf_counter()
    pads = eng.warm_ragged()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = eng.stats()
    log(f"  warm_ragged: {warm['graphs']} graphs (one per token pad "
        f"{pads}) captured in {warm['graph_capture_s']:.3f} s of "
        f"{warm_s:.3f} s; {reserved_bytes() - mem0} bytes of device memory "
        f"reserved by the captures (their shared graph pool and static "
        f"buffers)")
    if warm["graphs"] != len(pads):
        fail(f"serve: {warm['graphs']} graphs for {len(pads)} token pads")
    rounds["launched"] = 0
    K.reset_launch_counts()
    eng.start()
    try:
        res = run_poisson_load(eng, qps=16.0, prompts=prompts,
                               max_new_tokens=news, seed=SEED,
                               timeout=600.0)
    finally:
        eng.stop()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    served_rounds = rounds["launched"]
    st = eng.stats()
    log(f"  warm_ragged pads {pads} in {warm_s:.2f} s")
    log(f"  {json.dumps(res)}")
    log(f"  rounds={st['steps']} distinct_pads={len(st['ragged_token_pads'])}"
        f" {st['ragged_token_pads']} kv_occupancy_peak_pct="
        f"{st['kv_occupancy_peak_pct']} prefix_hits={st['prefix_hits']} "
        f"prefix_hit_tokens={st['prefix_hit_tokens']} "
        f"evictions={st['evictions']}")
    log(f"  launches during the serve phase: {launches} over "
        f"{served_rounds} launched rounds")
    if res["requests_ok"] != len(prompts) or res["requests_failed"]:
        fail(f"serve: {res['requests_failed']} request(s) failed")
    if res["tokens"] != sum(news):
        fail(f"serve: {res['tokens']} tokens generated, {sum(news)} asked")
    if st["prefix_hits"] < 1:
        fail("serve: no prefix-cache hit ran")
    # every served round runs each layer's attention and its two
    # LayerNorms, plus the final LayerNorm, through the kernels
    L = cfg.num_layers
    want = {name: 0 for name in launches}      # no training kernel runs
    want.update({"ragged_paged_attention": served_rounds * L,
                 "layer_norm": served_rounds * (2 * L + 1)})
    if served_rounds <= 0 or launches != want:
        fail(f"serve: kernel launches {launches} != {want} expected from "
             f"{served_rounds} rounds of {L} layers")
    eng.capture_logits = []
    check = eng.generate(prompts[1][:64], max_new_tokens=4)
    cap = eng.capture_logits[-1][1]
    if cap.shape != (16, cfg.vocab_size) or not np.isfinite(cap).all() \
            or not all(0 <= t < cfg.vocab_size for t in check):
        fail("serve: decode logits not finite / of the wrong shape")
    log(f"  decode logits finite, shape {cap.shape}")
    if eng.stats()["graphs"] != len(pads):
        fail("serve: a token pad outside warm_ragged's was captured mid-run")
    for label, key in (("largest mixed round", "mixed"),
                       ("widest decode round", "decode")):
        check_replay_matches_eager("serve", label, run_round,
                                   rounds[key][1])

    # --------------------------------------------------- phase 4: timing
    H, KVH, D, page = cfg.num_heads, cfg.num_kv_heads, 128, 16
    kernels = []
    for label, key in (("largest mixed round", "mixed"),
                       ("widest decode round", "decode")):
        tokens, rs, rl, kl, bt = rounds[key][1]
        T = tokens.shape[0]
        g = torch.Generator(device="cuda").manual_seed(2)
        q = torch.randn(T, H, D, device="cuda", generator=g).to(
            torch.bfloat16)
        meta = [torch.from_numpy(a.astype(np.int32)).cuda()
                for a in (rs, rl, kl, bt)]
        args = (q, eng.kv.k[0], eng.kv.v[0], *meta)
        # f32 first (q and the served layer-0 pools upcast): a skipped page
        # or a cut context shows far above 1e-4; then bf16 as served, within
        # a few bf16 roundings of the output
        args32 = (q.float(), eng.kv.k[0].float(), eng.kv.v[0].float(),
                  *meta)
        check_close(f"ragged f32 at {label} (T={T})",
                    K.ragged_paged_attention(*args32),
                    K.ragged_paged_attention_reference(*args32), 1e-4, 1e-4)
        del args32
        err = check_close(f"ragged bf16 at {label} (T={T})",
                          K.ragged_paged_attention(*args),
                          K.ragged_paged_attention_reference(*args),
                          4e-3, 4e-3)
        ms, wall, src = time_ms(lambda: K.ragged_paged_attention(*args))
        plain_ms, _, _ = time_ms(
            lambda: K.ragged_paged_attention_reference(*args), iters=5)
        nbytes, flops, t_valid = attention_work(rs, rl, kl, bt, H, KVH, D,
                                                page, 2)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"[timing] ragged_paged_attention {label}: T={T} "
            f"valid={t_valid} rows={int((rl > 0).sum())} kernel {ms:.4f} ms"
            f" ({src}; {wall:.4f} ms per call with launch) plain "
            f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}: "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
        if key == "mixed":
            ragged = {
                "name": "ragged_paged_attention", "route": "cuda",
                "source": "paddle_tpu_torch/ops/kernels/csrc/"
                          "ragged_paged_attention.cu",
                "replaces": "paddle_tpu/ops/pallas/ragged_attention.py:108",
                "launches": launches["ragged_paged_attention"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            kernels.append(ragged)
            ln_rows = T
        else:
            # the widest decode round beside the mixed one
            ragged.update({"decode_ms": ms, "decode_bound_ms": b_ms,
                           "max_abs_err": max(ragged["max_abs_err"], err)})
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(ln_rows, 2048, device="cuda", generator=g).to(
        torch.bfloat16)
    blk = model.gpt.h[0].ln_1
    w, b = blk.weight.detach(), blk.bias.detach()
    err = check_close(f"layer_norm at [{ln_rows}, 2048] bf16",
                      K.layer_norm(x, w, b),
                      K.layer_norm_reference(x, w, b), 2e-2, 2e-2)
    ms, wall, src = time_ms(lambda: K.layer_norm(x, w, b))
    plain_ms, _, _ = time_ms(lambda: K.layer_norm_reference(x, w, b))
    lib_ms, lib_wall, _ = time_ms(lambda: torch.nn.functional.layer_norm(
        x, (2048,), w, b, 1e-5))
    b_ms, b_by = bound(2 * x.numel() * 2 + 2 * 2048 * 2, 8 * x.numel(),
                       F32_FLOPS_PER_S)
    log(f"[timing] layer_norm [{ln_rows}, 2048] bf16: kernel {ms:.4f} ms "
        f"({src}; {wall:.4f} ms per call with launch) plain {plain_ms:.4f} "
        f"ms F.layer_norm {lib_ms:.4f} ms ({lib_wall:.4f} ms per call) "
        f"bound {b_ms:.4f} ms ({b_by})")
    kernels.append({
        "name": "layer_norm", "route": "triton",
        "source": "paddle_tpu_torch/ops/kernels/layer_norm.py",
        "replaces": "paddle_tpu/ops/pallas/layer_norm.py:39",
        "launches": launches["layer_norm"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms})

    # ------------------------------------- phase 5: where the time goes
    report_round_profiles("profile", eng, cfg.vocab_size,
                          ("ragged_paged_attention", "layer_norm (triton)"))
    eng.close()
    del eng, model, run_round, args, blk, w, b
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------- phase 6: train-kernel parity
    log("[train parity] flash forward / dQ / dK/dV vs plain at "
        "[2, S, 16, 128] (f32 within 1e-4, bf16 within 2e-2 and a relative "
        "norm error within 1e-2), autograd, fused AdamW multi-tensor")
    train_kernel_parity(K)
    torch.cuda.empty_cache()

    # ------------------------------- phase 7: 2-layer train-step parity
    log("[train parity] 2-layer f32 model at gpt_1p3b widths, one step "
        "(B=2, S=512) vs autograd through a dense plain forward")
    train_parity(pt, K)
    torch.cuda.empty_cache()

    # ------------------------------------------------- phase 8: train
    t_model, t_opt, t_step, t_launches = train_slice(pt, K)

    # ------------------------------- phase 9: train timing and profile
    wall_ms, busy_ms, families, top, _ = profile_train_step(t_step)
    total_ms = sum(families.values())
    log(f"[train profile] one step under torch.profiler: {wall_ms:.2f} ms "
        f"on the host clock; device busy {busy_ms:.2f} ms (union of device "
        f"intervals; {total_ms:.2f} ms summed) = "
        f"{100 * busy_ms / wall_ms:.1f}% busy")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.3f} ms per step "
            f"({100 * ms / total_ms:.1f}% of summed device time)")
    for (fam, name), ms in top:
        log(f"    {ms:.3f} ms per step  [{fam}] {name[:100]}")
    log("[train timing] the new kernels at the slice's shapes, held "
        "against their plain versions, then timed")
    kernels += train_timing(K, t_model, t_opt, t_launches)
    del t_model, t_opt, t_step
    torch.cuda.empty_cache()

    # ---------------------------------------- phase 10: bucketed parity
    bucketed_kernel_parity(K)
    log("[bucketed parity] 2-layer f32 gpt_1p3b(use_rms_norm=True) through "
        "ServingEngine(ragged=False) vs dense plain forward")
    bucketed_model_parity(pt)
    torch.cuda.empty_cache()

    # ------------------------------------------ phase 11: bucketed serve
    b_eng, b_model, rec, b_launches = bucketed_serve(pt, K)
    report_round_profiles("bucketed profile", b_eng,
                          b_model.config.vocab_size,
                          ("paged_attention", "rms_norm (triton)"),
                          absent=("ragged_paged_attention",), unit="step")

    # ----------------------------------------- phase 12: bucketed timing
    kernels += bucketed_timing(K, b_eng, b_model, rec, b_launches)
    b_eng.close()
    del b_eng, b_model, rec
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------ phase 13: O2 train
    o_model, o_opt, _, o_launches = o2_train(pt, K)

    # --------------------------- phase 14: master-mode kernel and resume
    log("[o2 timing] fused_adamw master and bf16-moment modes over the "
        "model's tensors, held against the plain version, then timed")
    adam_o2 = master_mode_timing(K, o_model, o_opt)
    del o_model, o_opt
    gc.collect()
    torch.cuda.empty_cache()
    resume_and_scaler_check(pt, K)
    # ------------------------------------------------ phase 15: generate
    log("[generate parity] flash_fwd at one query row (the dense-cache "
        "step) vs plain")
    flash_sq1 = flash_decode_parity(K)
    flash_gen, ln_gen = generate_phase(pt, K)
    gc.collect()
    torch.cuda.empty_cache()
    flash = next(e for e in kernels if e["name"] == "flash_fwd")
    flash.update(flash_sq1)
    flash.update(flash_gen)
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               flash_sq1["sq1_max_abs_err"])
    next(e for e in kernels if e["name"] == "layer_norm").update(ln_gen)

    adam = next(e for e in kernels if e["name"] == "fused_adamw")
    adam.update(adam_o2)
    adam["o2_launches"] = o_launches["fused_adamw"]
    adam["max_abs_err"] = max(adam["max_abs_err"],
                              adam_o2["master_max_abs_err"],
                              adam_o2["bf16_moment_max_abs_err"])

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
