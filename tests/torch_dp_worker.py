"""A JAX-free data-parallel worker for ``tests/test_torch_port_dp.py``:
one rank of a CPU job over gloo (``PADDLE_TPU_COORDINATOR`` /
``PADDLE_TPU_NUM_PROCESSES`` / ``PADDLE_TPU_PROCESS_ID``, as the launcher
sets them).

``python tests/torch_dp_worker.py <dir>`` reads ``<dir>/init.npz`` (a
``gpt_tiny``'s weights by structured name) and ``<dir>/batches.npz``
(``ids`` and ``labels`` of shape [steps, global batch, S]), and:

1. builds the port's ``gpt_tiny`` from the weights (rank 1 first adds
   noise, which the wrap-time broadcast from rank 0 must undo), wraps it
   in ``DataParallel`` and takes one AdamW step a batch on its half of
   the global batch, as ``tests/test_torch_port_train.py`` steps it
   (``weight_decay`` 0.1, biases and norms exempt, ``epsilon`` 1e-6);
2. trains a small MLP through ``Model.fit`` under ``Model.prepare``'s
   wrap (the staged step breaks to eager at the gloo all-reduce) on the
   ranks' shards of one dataset;
3. accumulates two micro-batches, the first under ``no_sync``.

Writes ``<dir>/rank<r>.npz``: the GPT's final parameters, its per-step
local losses (``losses``), the fit network's parameters (``fit/...``)
and flags (``wrapped``, ``graph_breaks``), and the ``no_sync`` case's
gradients (``nosync/local`` after the first micro-batch, ``nosync/
synced`` after the second, ``nosync/sum`` the sum of this rank's two
local gradients).
"""
import os
import sys

import numpy as np
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import device

LR, WD, EPS = 1e-3, 0.1, 1e-6


def _exempt(name):
    return name.endswith("bias") or ".ln_" in name or ".ln_f." in name


def gpt_steps(root, rank, world):
    init = dict(np.load(os.path.join(root, "init.npz")))
    data = np.load(os.path.join(root, "batches.npz"))
    ids, labels = data["ids"], data["labels"]
    if rank:
        rng = np.random.RandomState(rank)
        init = {k: v + 0.01 * rng.randn(*v.shape).astype(v.dtype)
                for k, v in init.items()}
    cfg = pt.gpt_tiny()
    net = pt.params_from_paddle_tpu(init, cfg, device="cpu")
    net.train()
    dp = dist.DataParallel(net)
    opt = pt.AdamW(learning_rate=LR, epsilon=EPS,
                   parameters=dp.parameters(), weight_decay=WD,
                   apply_decay_param_fun=lambda n: not _exempt(n))
    crit = pt.GPTPretrainingCriterion(cfg)
    half = ids.shape[1] // world
    losses = []
    for i in range(ids.shape[0]):
        sl = slice(rank * half, (rank + 1) * half)
        loss = crit(dp(torch.from_numpy(ids[i, sl])),
                    torch.from_numpy(labels[i, sl]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.item()))
    out = {f"gpt/{k}": v for k, v in pt.params_to_numpy(net).items()}
    out["losses"] = np.asarray(losses)
    return out


def fit_steps():
    x = np.random.RandomState(3).randn(32, 8).astype("float32")
    y = x @ np.random.RandomState(4).randn(8, 2).astype("float32")

    class DS(pt.io.Dataset):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return len(x)

    pt.seed(1 + dist.get_rank())  # rank-dependent init: the wrap syncs it
    net = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                           pt.nn.Linear(16, 2))
    model = pt.Model(net)
    model.prepare(pt.AdamW(1e-2, parameters=net.parameters()),
                  pt.nn.MSELoss())
    model.fit(DS(), batch_size=4, epochs=1, shuffle=False, verbose=0)
    out = {f"fit/{k}": v.detach().numpy().copy()
           for k, v in net.state_dict().items()}
    out["wrapped"] = np.asarray(isinstance(model.network,
                                           dist.DataParallel))
    out["graph_breaks"] = np.asarray(
        model._step_fn.stats()["graph_breaks"])
    return out


def no_sync_steps(rank):
    pt.seed(5)
    net = pt.nn.Linear(6, 3)
    dp = dist.DataParallel(net)
    rng = np.random.RandomState(10 + rank)
    xs = [torch.from_numpy(rng.randn(4, 6).astype("float32"))
          for _ in range(2)]
    with dp.no_sync():
        dp(xs[0]).pow(2).mean().backward()
    local = net.weight.grad.clone()
    dp(xs[1]).pow(2).mean().backward()
    synced = net.weight.grad.clone()
    # this rank's own sum, recomputed without any sync
    w = net.weight.detach().clone().requires_grad_(True)
    b = net.bias.detach().clone()
    sum(((x @ w + b).pow(2).mean() for x in xs)).backward()
    return {"nosync/local": local.numpy(), "nosync/synced": synced.numpy(),
            "nosync/sum": w.grad.numpy()}


def main():
    torch.set_num_threads(1)
    device.DEFAULT_DEVICE = "cpu"
    root = sys.argv[1]
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = gpt_steps(root, rank, world)
    out.update(fit_steps())
    out.update(no_sync_steps(rank))
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
