#!/usr/bin/env python3
"""Host cost of the port's layers on one GPU, for one checkout of the
package at a time, so two commits can be compared inside one call:

    python3 layer_overhead.py [TREE ...]

Each TREE (default: this directory) is a checkout holding
``paddle_tpu_torch``; each runs in its own process, in the order given
(parent, change, change, parent compares two commits in turns). A
process times, on the card, the eager steps that stay host-bound:

* phase 18's LeNet step (f32, B 64 x 1 x 28 x 28 from numpy seed 0,
  ``Adam(1e-3)``): 5 warm-up and 30 timed steps;
* 24b's BERT-base step (``BertForSequenceClassification(bert_base(
  dropout=0.0))``, B 32 x S 128, O1 bf16, ``AdamW(2e-5,
  weight_decay=0.01)``): 2 warm-up and 10 timed steps;
* ``pt.nn.Linear(768, 768)`` on [32, 128, 768] bf16 without gradients:
  host us a call, the median of 5 loops of 500.

Steps end in ``float(loss)``; times are the host clock's medians. Each
process prints one JSON line; the last line gathers them. Only APIs that
every ported slice since PR 11 has are used, so older checkouts run too.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def measure(tree):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    if not pt.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"paddle_tpu_torch imported from {pt.__file__}, "
                         f"not from {tree}")
    F = pt.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}

    def timed(step, warmup, steps):
        for _ in range(warmup):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(64, 1, 28, 28).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 10, 64)).cuda()
    net = pt.LeNet(seed=0)
    opt = pt.Adam(1e-3, parameters=net.parameters())

    def lenet_step():
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    out["lenet_eager_ms"] = timed(lenet_step, 5, 30)
    del net, opt
    ids = torch.from_numpy(rng.randint(1, 30522, (32, 128))).cuda()
    labels = torch.from_numpy(rng.randint(0, 2, 32)).cuda()
    bert = pt.BertForSequenceClassification(pt.bert_base(dropout=0.0),
                                            num_classes=2, seed=0)
    bopt = pt.AdamW(2e-5, parameters=bert.parameters(), weight_decay=0.01)

    def bert_step():
        with pt.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(bert(ids), labels)
        loss.backward()
        bopt.step()
        bopt.clear_grad()
        return float(loss.detach())

    out["bert_eager_ms"] = timed(bert_step, 2, 10)
    del bert, bopt
    # .cuda(): a checkout from before nn.Layer put a layer built without
    # a device on the CPU
    lin = pt.nn.Linear(768, 768, dtype=torch.bfloat16).cuda()
    xb = torch.randn(32, 128, 768, device="cuda", dtype=torch.bfloat16)
    us = []
    with torch.no_grad():
        for _ in range(5):
            for _ in range(20):
                lin(xb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                lin(xb)
            us.append((time.perf_counter() - t0) * 1e6 / 500)
            torch.cuda.synchronize()
    out["linear_call_us"] = float(np.median(us))
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("layer_overhead: needs a CUDA device", file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in sys.argv[1:]] or [HERE]
    rows = []
    for tree in trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", tree], capture_output=True,
                             text=True, cwd=tree)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode:
            print(res.stdout, file=sys.stderr)
            return res.returncode
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"runs": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
