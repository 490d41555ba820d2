#!/usr/bin/env python3
"""Time the paged decode kernel at every split count on one NVIDIA GPU.

    python3 paged_splits.py

``paddle_tpu_torch/ops/kernels/paged_attention.launch_plan`` picks the
split count of a launch from host integers alone (rows, KV heads, table
width, SM count), so one count serves every mix of contexts at a shape.
This script shows what that costs: at the serving engine's widths
(gpt_1p3b: H = KVH = 16, D 128, bf16, pages of 16, tables of 64 pages,
a pool of 2048 pages) it launches the kernel through
``paged_attention.launch_kernel`` with split counts 1 to 32 (and the
plan's own) on decode steps of 16 rows with random contexts (24-282, the
range of ``chip_smoke.py``'s widest bucketed step, and 43-489), 16 rows
of equal contexts 128, 512 and 1024, 4 rows of 512 and one row of 1024.
Each launch is first held against the plain version (within 4e-3); then
each (input, split count) is timed twice, the counts in rising order and
then in falling order, as ``chip_smoke.py`` times kernels (device time
per call). It prints the card, a table of the two times per count with
the plan's pick (*) and the fastest count (<) marked, and a JSON line of
all times. Needs CUDA and nvcc.
"""
import importlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32)
H = KVH = 16
D, PAGE, MAX_PAGES, NUM_PAGES = 128, 16, 64, 2048


def contexts():
    """name -> the decode step's contexts, from seed 0."""
    rng = np.random.RandomState(0)
    return {"16 rows 24-282": rng.randint(24, 283, size=16).tolist(),
            "16 rows 43-489": rng.randint(43, 490, size=16).tolist(),
            "16 x 128": [128] * 16, "16 x 512": [512] * 16,
            "16 x 1024": [1024] * 16, "4 x 512": [512] * 4,
            "1 x 1024": [1024]}


def inputs(ctx, k, v, g):
    """q, pools, tables of distinct random pages (-1 past each context),
    contexts."""
    B = len(ctx)
    q = torch.randn(B, H, D, device="cuda", generator=g).bfloat16()
    bt = torch.full((B, MAX_PAGES), -1, dtype=torch.int32, device="cuda")
    perm = torch.randperm(NUM_PAGES - 1, device="cuda",
                          generator=g).int() + 1
    used = 0
    for r, c in enumerate(ctx):
        n = -(-c // PAGE)
        bt[r, :n] = perm[used:used + n]
        used += n
    return q, k, v, bt, torch.tensor(ctx, dtype=torch.int32, device="cuda")


def main():
    if not torch.cuda.is_available():
        sys.exit("paged_splits.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    pa = importlib.import_module(
        "paddle_tpu_torch.ops.kernels.paged_attention")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    k, v = (torch.randn(NUM_PAGES, PAGE, KVH, D, device="cuda",
                        generator=g).bfloat16() for _ in range(2))
    steps = {name: inputs(ctx, k, v, g) for name, ctx in contexts().items()}
    plans = {name: pa.launch_plan(args[0].shape[0], H, KVH, D, MAX_PAGES,
                                  PAGE, sms)["n_split"]
             for name, args in steps.items()}
    counts = {name: sorted(set(SPLITS) | {plans[name]}) for name in steps}
    scale = 1.0 / math.sqrt(D)
    for name, args in steps.items():
        want = pa.paged_attention_reference(*args)
        for ns in counts[name]:
            got = pa.launch_kernel(*args, scale, n_split=ns)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= 4e-3:
                sys.exit(f"{name} at {ns} splits: max_abs_err {err}")
    times = {}
    for rising in (True, False):
        for name, args in steps.items():
            for ns in sorted(counts[name], reverse=not rising):
                ms, _, _ = cs.time_ms(
                    lambda: pa.launch_kernel(*args, scale, n_split=ns),
                    iters=30)
                times.setdefault(name, {}).setdefault(ns, []).append(ms)
    rows = []
    for name in steps:
        plan, ts = plans[name], times[name]
        best = min(ts, key=lambda ns: min(ts[ns]))
        cells = " ".join(
            f"{ns}{'*' if ns == plan else ''}{'<' if ns == best else ''}:"
            f"{ts[ns][0]:.4f}/{ts[ns][1]:.4f}" for ns in counts[name])
        over = 100 * (min(ts[plan]) / min(ts[best]) - 1)
        print(f"{name}: plan {plan} splits, fastest {best} "
              f"(plan +{over:.1f}%) | ms rising/falling: {cells}")
        rows.append({"input": name, "contexts": contexts()[name],
                     "plan_n_split": plan, "fastest_n_split": best,
                     "ms": {str(ns): ts[ns] for ns in counts[name]}})
    print(json.dumps({"card": card, "sms": sms, "points": rows}))


if __name__ == "__main__":
    main()
