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
   ``ServingEngine`` (16 slots, page 16, 2048 pages, chunked prefill 256):
   ``warm_ragged()``, then 36 requests under Poisson arrivals — 32 of
   mixed length (16-512 prompt tokens) and 4 sharing a 128-token head so
   prefix hits run — 32 new tokens each. Launch counters are zeroed
   after ``warm_ragged()``, just before the load, and read just after;
   each served round must have launched the attention kernel once per
   layer and the LayerNorm kernel 2 x layers + 1 times. Prints tokens/s,
   TTFT/ITL p50/p99, rounds, distinct pads and peak KV occupancy.
4. **timing** — ragged attention held against its plain version at the
   serve phase's largest mixed and widest decode rounds on the served
   layer-0 pools (f32 within 1e-4, bf16 within 4e-3); then device time per
   call of each kernel at the serve phase's largest round, beside its
   bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, the
   larger), its plain version's time and,
   for LayerNorm, ``torch.nn.functional.layer_norm``'s time as
   ``library_ms`` (the port never calls it). Kernel times are device
   time from ``torch.profiler`` (CUDA events when the trace is empty).
5. **profile** — a steady decode round of 16 rows on the host clock and
   under ``torch.profiler``: device busy share and device time by kernel
   family.

The lines before the last carry the ``{"kernels": [...]}`` JSON and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the repository beside it, the script exits
non-zero and prints no result.
"""
import json
import math
import os
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


def check_close(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    finite = bool(torch.isfinite(got.float()).all())
    log(f"  {name}: max_abs_err={max_abs:.3e} (tolerance atol={atol:g} "
        f"rtol={rtol:g}) finite={finite} {'ok' if ok else 'MISMATCH'}")
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
    """Plain causal forward of the port's GPT over ``ids`` (no cache, no
    kernels): -> logits [S, V] in f32."""
    from paddle_tpu_torch.ops.kernels import layer_norm_reference as ln
    cfg, g = model.config, model.gpt
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    D = cfg.hidden_size // H
    eps = cfg.layer_norm_epsilon
    S, dev = len(ids), model.device
    idx = torch.tensor(ids, device=dev)
    x = g.wte.weight[idx] + g.wpe.weight[torch.arange(S, device=dev)]
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    for blk in g.h:
        a = blk.attn
        h = ln(x, blk.ln_1.weight, blk.ln_1.bias, eps)
        qkv = h @ a.qkv_proj.weight + a.qkv_proj.bias
        q = qkv[:, :H * D].reshape(S, H, D)
        k = qkv[:, H * D:(H + KVH) * D].reshape(S, KVH, D)
        v = qkv[:, (H + KVH) * D:].reshape(S, KVH, D)
        k = k.repeat_interleave(H // KVH, dim=1)
        v = v.repeat_interleave(H // KVH, dim=1)
        s = torch.einsum("shd,thd->hst", q, k) / math.sqrt(D)
        p = torch.softmax(s.masked_fill(~causal, -1e30), dim=-1)
        o = torch.einsum("hst,thd->shd", p, v).reshape(S, H * D)
        x = x + o @ a.out_proj.weight + a.out_proj.bias
        h = ln(x, blk.ln_2.weight, blk.ln_2.bias, eps)
        f = torch.nn.functional.gelu(h @ blk.mlp.fc1.weight
                                     + blk.mlp.fc1.bias, approximate="tanh")
        x = x + f @ blk.mlp.fc2.weight + blk.mlp.fc2.bias
    x = ln(x, g.ln_f.weight, g.ln_f.bias, eps)
    return (x @ g.wte.weight.t()).float()


# ---------------------------------------------------------------- bounds
def attention_work(rs, rl, kl, bt, H, KVH, D, page, itemsize):
    """Bytes the launch must move (q read, out written, each distinct KV
    page of every row's context read once, metadata) and the flops its
    data needs (QK and PV over each valid token's causal context)."""
    rs, rl, kl, bt = (np.asarray(a) for a in (rs, rl, kl, bt))
    T_valid = int(rl.sum())
    pages, flops = set(), 0
    for r in range(len(rs)):
        if rl[r] <= 0:
            continue
        pages.update(int(p) for p in bt[r, :-(-int(kl[r]) // page)])
        ctx = np.arange(kl[r] - rl[r], kl[r]) + 1
        flops += 4 * H * D * int(ctx.sum())
    kv_bytes = 2 * len(pages) * page * KVH * D * itemsize
    nbytes = 2 * T_valid * H * D * itemsize + kv_bytes \
        + 4 * (3 * len(rs) + bt.size)
    return nbytes, flops, T_valid


def bound(nbytes, flops, flops_per_s):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def profile_decode_rounds(eng, vocab, n_rounds=20):
    """Where a steady decode round's time goes: 16 requests with 200-token
    prompts are prefilled, then ``n_rounds`` rounds in which every slot
    decodes are timed on the host clock (no profiler), and again under
    ``torch.profiler``. -> per-round host ms, device busy ms (union of the
    device intervals), device time by kernel family and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(SEED + 10)
    reqs = [eng.submit(rng.randint(1, vocab, size=200).tolist(),
                       max_new_tokens=64) for _ in range(eng.max_slots)]
    while any(r.state != "active" or not r.generated for r in reqs):
        eng.step()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        eng.step()
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3 / n_rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_rounds):
            eng.step()
        torch.cuda.synchronize()
    families, names, spans = {}, {}, []
    for e in _device_events(prof):
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.lower()
        fam = ("ragged_paged_attention" if "ragged_paged" in name else
               "layer_norm (triton)" if "layer_norm_fwd" in name else
               "matmul (cuBLAS)" if any(k in name for k in (
                   "gemm", "gemv", "nvjet", "cutlass", "xmma")) else
               "copies" if "memcpy" in name or "memset" in name else
               "other elementwise/index")
        ms = e.time_range.elapsed_us() / 1e3 / n_rounds
        families[fam] = families.get(fam, 0.0) + ms
        names[e.name] = names.get(e.name, 0.0) + ms
    eng.run_until_idle()
    # busy = the union of device intervals: a synchronous copy's interval
    # can span the kernels it waits behind, so the sum double-counts
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return round_ms, busy_us / 1e3 / n_rounds, families, top


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
                           max_slots=16, prefill_chunk=256)
    log(f"  KV pools {eng.kv.nbytes() / 1e9:.2f} GB "
        f"({eng.kv.num_pages} pages of 16 tokens)")
    rounds = {"mixed": None, "decode": None, "launched": 0}
    run_round = eng._ragged_fn

    def recording_round(tokens, rs, rl, kl, bt):
        rounds["launched"] += 1
        n_valid, n_rows = int(rl.sum()), int((rl > 0).sum())
        if rounds["mixed"] is None or n_valid > rounds["mixed"][0]:
            rounds["mixed"] = (n_valid, (tokens, rs, rl, kl, bt))
        if bool((rl <= 1).all()) and (rounds["decode"] is None
                                     or n_rows > rounds["decode"][0]):
            rounds["decode"] = (n_rows, (tokens, rs, rl, kl, bt))
        return run_round(tokens, rs, rl, kl, bt)

    eng._ragged_fn = recording_round
    mixed, news = make_mixed_length_prompts(
        32, (16, 512), cfg.vocab_size, decode_heavy=0.5,
        max_new_tokens=(32, 32), seed=SEED)
    shared = make_shared_prefix_prompts(4, (16, 64), cfg.vocab_size, 128,
                                        seed=SEED + 1)
    prompts = [shared[0]] + mixed + shared[1:]
    news = [32] + news + [32] * 3
    t0 = time.perf_counter()
    pads = eng.warm_ragged()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
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
    want = {"ragged_paged_attention": served_rounds * L,
            "layer_norm": served_rounds * (2 * L + 1)}
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
            kernels.append({
                "name": "ragged_paged_attention", "route": "cuda",
                "source": "paddle_tpu_torch/ops/kernels/csrc/"
                          "ragged_paged_attention.cu",
                "replaces": "paddle_tpu/ops/pallas/ragged_attention.py:108",
                "launches": launches["ragged_paged_attention"],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
            ln_rows = T
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(ln_rows, 2048, device="cuda", generator=g).to(
        torch.bfloat16)
    blk = model.gpt.h[0].ln_1
    w, b = blk.weight, blk.bias
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
    round_ms, busy_ms, families, top = profile_decode_rounds(
        eng, cfg.vocab_size)
    if busy_ms <= 0:
        fail("profile: the torch.profiler trace held no device events")
    total_ms = sum(families.values())
    log(f"[profile] steady decode round, 16 rows: {round_ms:.3f} ms on the "
        f"host clock; device busy {busy_ms:.3f} ms per round (union of "
        f"device intervals; {total_ms:.3f} ms summed) = "
        f"{100 * busy_ms / round_ms:.1f}% busy, "
        f"{100 - 100 * busy_ms / round_ms:.1f}% idle")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.4f} ms per round "
            f"({100 * ms / total_ms:.1f}% of summed device time)")
    for name, ms in top:
        log(f"    {ms:.4f} ms per round  {name[:110]}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
