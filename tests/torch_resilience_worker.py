"""A JAX-free training worker for the port's launcher tests.

A tiny MLP (with dropout, so the RNG state is part of what a resume must
restore) trained by ``Model.fit`` on the CPU with a checkpoint lineage,
async snapshots and the integrity guard. Prints one ``LOSS <global
step> <loss>`` line a step; ``fit`` prints the ``FRESH`` / ``RESUMED`` /
``PREEMPT_SAVED`` markers. Environment:

* ``PTT_CKPT_DIR`` — the lineage root (required);
* ``PTT_PREEMPT_AT`` — send this process SIGTERM as global step N
  begins (the loop saves and exits 75 at the next batch boundary);
* ``PTT_STEP_SLEEP`` — seconds to sleep after every step (a slow peer);
* ``PTT_CKPT_PER_RANK`` — give each launcher rank a lineage of its own
  under the root;
* ``PTT_SYNC_SNAPSHOTS`` — interval snapshots written synchronously (an
  async snapshot that a ``torn_write`` tears is never committed, so only
  a torn sync snapshot is one the lineage must reject by its CRC);
* ``PADDLE_TPU_FAULTS`` / ``PADDLE_TPU_FAULT_LEDGER`` — fault injection,
  as the launcher forwards them.

Run it directly, or under ``python -m paddle_tpu_torch.distributed.launch``.
"""
import os
import signal
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import device

N, B, EPOCHS = 24, 4, 2           # 6 steps an epoch, 12 in all


def dataset():
    x = np.random.RandomState(42).randn(N, 16).astype("float32")
    y = x @ np.random.RandomState(7).randn(16, 4).astype("float32")

    class DS(pt.io.Dataset):
        def __getitem__(self, i):
            return x[i], y[i]

        def __len__(self):
            return N

    return DS()


def build():
    pt.seed(0)
    net = pt.nn.Sequential(pt.nn.Linear(16, 32), pt.nn.ReLU(),
                           pt.nn.Dropout(0.25), pt.nn.Linear(32, 4))
    model = pt.Model(net)
    model.prepare(pt.AdamW(1e-2, parameters=net.parameters()),
                  pt.nn.MSELoss())
    return model


class Markers(pt.hapi.callbacks.Callback):
    def __init__(self, steps_per_epoch, preempt_at=None, sleep=0.0):
        self.per = steps_per_epoch
        self.preempt_at = preempt_at
        self.sleep = sleep
        self.epoch = 0
        self.losses = {}

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_batch_begin(self, step, logs=None):
        if self.preempt_at is not None and \
                self.epoch * self.per + step == self.preempt_at:
            os.kill(os.getpid(), signal.SIGTERM)

    def on_train_batch_end(self, step, logs=None):
        g = self.epoch * self.per + step
        self.losses[g] = logs["loss"]
        print(f"LOSS {g} {logs['loss']!r}", flush=True)
        if self.sleep:
            time.sleep(self.sleep)


def train(ckpt_dir, preempt_at=None, sleep=0.0, num_iters=None,
          async_snapshot=True):
    """-> {global step: loss} of this incarnation."""
    model = build()
    rec = Markers(N // B, preempt_at, sleep)
    model.fit(dataset(), batch_size=B, epochs=EPOCHS, verbose=0,
              shuffle=True, lineage=ckpt_dir, snapshot_interval=2,
              async_snapshot=async_snapshot, integrity=True,
              loss_fetch_every=1,
              callbacks=[rec], num_iters=num_iters)
    return rec.losses


def main():
    torch.set_num_threads(1)
    device.DEFAULT_DEVICE = "cpu"
    at = os.environ.get("PTT_PREEMPT_AT")
    root = os.environ["PTT_CKPT_DIR"]
    if os.environ.get("PTT_CKPT_PER_RANK"):
        root = os.path.join(
            root, f"rank{os.environ.get('PADDLE_TPU_PROCESS_ID', '0')}")
    train(root, None if at is None else int(at),
          float(os.environ.get("PTT_STEP_SLEEP", "0")),
          async_snapshot=not os.environ.get("PTT_SYNC_SNAPSHOTS"))
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
