"""A JAX-free elastic chaos worker for the port's launcher tests: the twin
of ``tests/workers/elastic_worker.py``, with the same markers and knobs.

Trains a deterministic Linear regression through ``pt.Model.fit`` with a
``CheckpointLineage`` on the CPU under the elastic launcher (``--np
min:max`` or ``--nnodes min:max``): every incarnation reads its world
size from the env (``init_parallel_env`` over gloo; ``Model.prepare``
wraps the network in ``DataParallel`` at world > 1), restores the newest
verified snapshot (epoch/step/optimizer/RNG), and skips the batches the
previous incarnation already consumed. A self-SIGKILL knob models
losing a host mid-run.

Markers on stdout (one per line, parsed by the tests):
    WORLD <n>                      world size this incarnation trains at
    RESUMED epoch=E step=S global_step=G   (from ResumableTraining)
    FRESH                          no usable snapshot
    BATCH <epoch> <step> <executed> <stamp>  one executed batch
    SELF_SIGKILL <stamp> / NODE_CRASH <stamp>
    DONE <executed>                clean finish

Env knobs: PADDLE_TPU_CKPT_DIR (required), PADDLE_TPU_FT_STORE_PORT
(commit-barrier TCPStore, multi-process only), PADDLE_TPU_FT_EPOCHS /
PADDLE_TPU_FT_BATCHES (loop shape), PADDLE_TPU_ELASTIC_KILL="rank:step"
(SIGKILL self on that rank after that many executed batches, first
incarnation only), PADDLE_TPU_NODE_CRASH="node_id:step:rc[:from_round]"
(on that node, exit rc after that many executed batches in every
incarnation >= from_round), PADDLE_TPU_FT_INTERVAL (snapshot every N
steps), PADDLE_TPU_FT_ASYNC=1 (overlapped snapshots).
"""
import os
import signal
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import device
from paddle_tpu_torch.distributed import fault


class _Markers(pt.hapi.callbacks.Callback):
    """One BATCH marker per executed batch, and the self-SIGKILL / node
    crash knobs."""

    def __init__(self, rank, incarnation):
        self.rank = rank
        self.incarnation = incarnation
        self.executed = 0
        kill = os.environ.get("PADDLE_TPU_ELASTIC_KILL", "")
        self.kill_rank = self.kill_after = None
        if kill:
            r, n = kill.split(":")
            self.kill_rank, self.kill_after = int(r), int(n)
        crash = os.environ.get("PADDLE_TPU_NODE_CRASH", "")
        self.crash_node = self.crash_after = self.crash_rc = None
        self.crash_from = 0
        if crash:
            parts = crash.split(":")
            self.crash_node, self.crash_after, self.crash_rc = \
                parts[0], int(parts[1]), int(parts[2])
            if len(parts) > 3:
                self.crash_from = int(parts[3])
        self.epoch = 0

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        self.executed += 1
        print(f"BATCH {self.epoch} {step} {self.executed} "
              f"{time.time():.6f}", flush=True)
        if (self.incarnation == 0 and self.kill_rank == self.rank
                and self.executed == self.kill_after):
            print(f"SELF_SIGKILL {time.time():.6f}", flush=True)
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        if (self.crash_node is not None
                and self.incarnation >= self.crash_from
                and os.environ.get("PADDLE_TPU_NODE_ID") == self.crash_node
                and self.executed == self.crash_after):
            print(f"NODE_CRASH {time.time():.6f}", flush=True)
            sys.stdout.flush()
            os._exit(self.crash_rc)


def main():
    torch.set_num_threads(1)
    device.DEFAULT_DEVICE = "cpu"
    dist.init_parallel_env()
    world, rank = dist.get_world_size(), dist.get_rank()
    incarnation = int(os.environ.get("PADDLE_TPU_RESTART_NUM", "0"))
    print(f"WORLD {world}", flush=True)

    store = None
    port = os.environ.get("PADDLE_TPU_FT_STORE_PORT")
    if port and world > 1:
        store = dist.TCPStore("127.0.0.1", int(port), is_master=(rank == 0),
                              world_size=world, timeout=120)
    lineage = fault.CheckpointLineage(os.environ["PADDLE_TPU_CKPT_DIR"],
                                      store=store, world_size=world,
                                      rank=rank)

    epochs = int(os.environ.get("PADDLE_TPU_FT_EPOCHS", "2"))
    n_batches = int(os.environ.get("PADDLE_TPU_FT_BATCHES", "8"))
    interval = int(os.environ.get("PADDLE_TPU_FT_INTERVAL", "1"))

    pt.seed(0)
    X = np.random.RandomState(42).randn(n_batches * 4, 16).astype("float32")
    Y = X @ np.random.RandomState(7).randn(16, 4).astype("float32")

    class DS(pt.io.Dataset):
        def __getitem__(self, i):
            return X[i], Y[i]

        def __len__(self):
            return len(X)

    net = pt.nn.Linear(16, 4)
    model = pt.Model(net)
    opt = pt.optimizer.Adam(learning_rate=1e-2,
                            parameters=net.parameters())
    model.prepare(optimizer=opt, loss=pt.nn.MSELoss())

    cb = _Markers(rank, incarnation)
    model.fit(DS(), batch_size=4, epochs=epochs, shuffle=False, verbose=0,
              callbacks=[cb], lineage=lineage, snapshot_interval=interval,
              async_snapshot=os.environ.get("PADDLE_TPU_FT_ASYNC") == "1")
    print(f"DONE {cb.executed}", flush=True)
    sys.exit(0)


if __name__ == "__main__":
    main()
