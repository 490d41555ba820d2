"""Poisson open-loop load generator — the serving yardstick harness.

A copy of ``paddle_tpu/serving/load.py`` (host-side numpy). Open loop:
arrivals follow a seeded Poisson process regardless of how fast the engine
drains them, so tail latency is not hidden by self-throttling. Drives a
running :class:`~.engine.ServingEngine`, then reduces per-request
timestamps into tokens/s + TTFT + inter-token tail numbers.
"""
from __future__ import annotations

import time

import numpy as np

__all__ = ["run_poisson_load", "summarize_requests",
           "make_shared_prefix_prompts", "make_mixed_length_prompts",
           "make_session_prompts"]


def _pct(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if values else None


def summarize_requests(requests, wall_s, by_engine=False):
    """Reduce finished requests -> one summary dict (times in ms).

    ``by_engine=True`` adds per-engine rows (requests that carry an
    ``engine_id``, as fleet-routed :class:`~.fleet.router.FleetRequest`\\ s
    do), so a fleet run shows where the load landed."""
    ok = [r for r in requests if r.error is None and r.t_done is not None]
    # never-finished requests (result() deadline hit, engine wedged) are
    # failures — without this a hung run reads as healthy
    failed = [r for r in requests if r.error is not None
              or r.t_done is None]
    tokens = sum(len(r.generated) for r in ok)
    ttft = [r.ttft_s() * 1e3 for r in ok if r.ttft_s() is not None]
    itl = [dt * 1e3 for r in ok for dt in r.inter_token_s()]
    e2e = [(r.t_done - r.t_submit) * 1e3 for r in ok]
    qwait = [r.queue_wait_s * 1e3 for r in ok]
    out = {
        "requests_ok": len(ok),
        "requests_failed": len(failed),
        "tokens": tokens,
        "wall_s": round(wall_s, 3),
        "tokens_per_sec": round(tokens / wall_s, 2) if wall_s > 0 else 0.0,
        "qps_completed": round(len(ok) / wall_s, 2) if wall_s > 0 else 0.0,
        "ttft_ms_p50": _pct(ttft, 50),
        "ttft_ms_p99": _pct(ttft, 99),
        "itl_ms_p50": _pct(itl, 50),
        "itl_ms_p99": _pct(itl, 99),
        "e2e_ms_p50": _pct(e2e, 50),
        "e2e_ms_p99": _pct(e2e, 99),
        "queue_wait_ms_p50": _pct(qwait, 50),
        "queue_wait_ms_p99": _pct(qwait, 99),
        "evictions": sum(r.evictions for r in requests),
        "requests_evicted": sum(1 for r in requests if r.evictions > 0),
    }
    for k, v in list(out.items()):
        if isinstance(v, float) and k.endswith(("p50", "p99")):
            out[k] = round(v, 2)
    if by_engine:
        groups = {}
        for r in requests:
            eid = getattr(r, "engine_id", None)
            groups.setdefault(eid if eid is not None else "?",
                              []).append(r)
        rows = {}
        for eid, reqs in sorted(groups.items()):
            g_ok = [r for r in reqs if r.error is None
                    and r.t_done is not None]
            g_ttft = [r.ttft_s() * 1e3 for r in g_ok
                      if r.ttft_s() is not None]
            g_itl = [dt * 1e3 for r in g_ok for dt in r.inter_token_s()]
            rows[eid] = {
                "requests_ok": len(g_ok),
                "requests_failed": len(reqs) - len(g_ok),
                "tokens": sum(len(r.generated) for r in g_ok),
                "ttft_ms_p99": _pct(g_ttft, 99),
                "itl_ms_p99": _pct(g_itl, 99),
                "redispatches": sum(getattr(r, "redispatches", 0)
                                    for r in reqs),
                "migrations": sum(getattr(r, "migrations", 0)
                                  for r in reqs),
            }
        out["by_engine"] = rows
    return out


def make_shared_prefix_prompts(n_requests, prompt_len, vocab,
                               shared_prefix, seed=0):
    """ONE common system-prompt head of ``shared_prefix`` tokens (drawn
    once from the seed) followed by a per-request random tail of length in
    ``prompt_len`` — the mix that drives a prefix cache. Deterministic per
    seed."""
    rng = np.random.RandomState(seed)
    head = rng.randint(1, vocab, size=int(shared_prefix)).tolist()
    lo, hi = prompt_len
    return [head + rng.randint(1, vocab,
                               size=rng.randint(lo, hi + 1)).tolist()
            for _ in range(n_requests)]


def make_mixed_length_prompts(n_requests, prompt_len, vocab,
                              decode_heavy=0.5, max_new_tokens=(4, 24),
                              seed=0):
    """The ragged stress workload: prompt lengths drawn **log-uniform**
    over ``prompt_len=(lo, hi)`` (most prompts short, a long tail), with a
    ``decode_heavy``-probability knob: a decode-heavy request keeps its
    prompt at the short end (capped at the geometric midpoint) and
    generates ``max_new_tokens[1]`` tokens; a prefill-heavy request keeps
    its log-uniform length and generates ``max_new_tokens[0]``.
    Deterministic per seed. -> ``(prompts, max_new_tokens_per_request)``."""
    rng = np.random.RandomState(seed)
    lo, hi = int(prompt_len[0]), int(prompt_len[1])
    if not 1 <= lo <= hi:
        raise ValueError(f"prompt_len {prompt_len!r} must be 1 <= lo <= hi")
    mid = int(np.sqrt(lo * hi))
    n_lo, n_hi = int(max_new_tokens[0]), int(max_new_tokens[1])
    prompts, news = [], []
    for _ in range(int(n_requests)):
        ln = int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
        ln = min(max(ln, lo), hi)
        if rng.rand() < decode_heavy:
            ln, new = min(ln, max(mid, lo)), n_hi
        else:
            new = n_lo
        prompts.append(rng.randint(1, vocab, size=ln).tolist())
        news.append(new)
    return prompts, news


def make_session_prompts(n_sessions, requests_per_session, head_len,
                         tail_len, vocab, seed=0, interleave=True):
    """The fleet workload (``paddle_tpu/serving/load.py:146``):
    ``n_sessions`` sessions, each with its own ``head_len``-token head
    shared by that session's ``requests_per_session`` requests (random
    tails of a length in ``tail_len``), arrivals interleaved round-robin
    across sessions, so affinity has to hold mid-stream and a session
    spilling to a second engine shares its prefix across engines. The
    same prompts as JAX's for a seed. -> ``(prompts, session_ids)``."""
    rng = np.random.RandomState(seed)
    lo, hi = tail_len
    heads = [rng.randint(1, vocab, size=int(head_len)).tolist()
             for _ in range(int(n_sessions))]
    per = [[heads[s] + rng.randint(
        1, vocab, size=rng.randint(lo, hi + 1)).tolist()
        for _ in range(int(requests_per_session))]
        for s in range(int(n_sessions))]
    if interleave:
        prompts = [per[s][r] for r in range(int(requests_per_session))
                   for s in range(int(n_sessions))]
        sids = [s for _ in range(int(requests_per_session))
                for s in range(int(n_sessions))]
    else:
        prompts = [p for sess in per for p in sess]
        sids = [s for s in range(int(n_sessions))
                for _ in range(int(requests_per_session))]
    return prompts, sids


def run_poisson_load(engine, n_requests=32, qps=10.0, prompt_len=(8, 24),
                     max_new_tokens=12, eos_token_id=None, seed=0,
                     timeout=300.0, shared_prefix=None, prompts=None,
                     by_engine=False):
    """Submit ``n_requests`` at Poisson arrivals of rate ``qps`` (prompts
    uniform-random token ids of uniform-random length in ``prompt_len``),
    wait for completion, -> summary dict. The engine must be ``start()``ed
    (open loop: submission never waits on decode). A started
    :class:`~.fleet.router.FleetRouter` is driven the same way, through
    its ``cfg`` and ``submit``.

    ``shared_prefix=N`` switches to the shared-system-prompt workload:
    every prompt is one common ``N``-token head plus the random tail
    (:func:`make_shared_prefix_prompts`); ``prompt_len`` then sizes the
    tail. ``by_engine`` adds :func:`summarize_requests`' per-engine rows.

    ``prompts=`` overrides generation entirely (a pre-built workload such
    as :func:`make_mixed_length_prompts`); ``max_new_tokens`` may then be a
    per-request sequence of the same length."""
    rng = np.random.RandomState(seed)
    vocab = engine.cfg.vocab_size
    lo, hi = prompt_len
    if prompts is not None:
        n_requests = len(prompts)
    gaps = rng.exponential(1.0 / qps, size=n_requests)
    if prompts is None and shared_prefix:
        prompts = make_shared_prefix_prompts(
            n_requests, prompt_len, vocab, shared_prefix, seed=seed)
    per_req_new = max_new_tokens if hasattr(max_new_tokens, "__len__") \
        else [max_new_tokens] * n_requests
    if len(per_req_new) != n_requests:
        raise ValueError(
            f"max_new_tokens sequence has {len(per_req_new)} entries for "
            f"{n_requests} requests")
    requests = []
    t_start = time.perf_counter()
    for i in range(n_requests):
        target = t_start + float(gaps[:i + 1].sum())
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        prompt = prompts[i] if prompts is not None else \
            rng.randint(1, vocab, size=rng.randint(lo, hi + 1)).tolist()
        req = engine.submit(list(prompt),
                            max_new_tokens=int(per_req_new[i]),
                            eos_token_id=eos_token_id, timeout=timeout)
        requests.append(req)
    deadline = time.perf_counter() + timeout
    for req in requests:
        left = max(0.1, deadline - time.perf_counter())
        try:
            req.result(timeout=left)
        except Exception:
            pass  # summarized as failed below
    wall_s = time.perf_counter() - t_start
    out = summarize_requests(requests, wall_s, by_engine=by_engine)
    out["qps_offered"] = float(qps)
    out["n_requests"] = int(n_requests)
    return out
