"""Resumable-training glue: trainer loops × verified checkpoint lineage,
the port's copy of ``paddle_tpu/distributed/resumable.py``.

Reference capability: fleet's checkpoint auto-recovery around trainer
loops (the elastic manager relaunches a job; something must put the
trainer back where it was). :class:`ResumableTraining` is that something
for ``hapi.Model.fit`` and bare worker loops:

- composes ONE state dict out of model params, optimizer accumulators
  (materialized up front so a pre-step resume still restores them; the
  fused AdamW's m, v, f32 masters and bf16 moments, and the scheduler,
  in the JAX ``state_dict`` format), the RNG state and the loop progress
  (epoch / step-in-epoch / global step). The RNG state is every torch
  generator a step draws from — the framework generators of
  ``core/random.py``, torch's default CPU and CUDA generators, and the
  generators the network's layers hold (a seeded model's dropout) — in
  place of the JAX key. A CUDA generator captured into a step's graph
  advances its Philox offset at each replay, host-side, so its restored
  state puts the next replay at the offset the uninterrupted run had
  there; the snapshot keeps the states as bytes under ``"rng"``
  (``["torch", [[name, bytes], ...]]``), which a JAX snapshot's key
  does not match, so resuming a JAX run leaves the port's generators as
  they are;
- restores it from the newest verified snapshot on (re)start
  (``CheckpointLineage.load_latest``) so a relaunched worker — crash,
  preemption or elastic scale event — continues at the exact batch it
  left, and the resumed epoch skips the already-consumed prefix instead
  of double-counting it;
- snapshots on a step interval, optionally OVERLAPPED with training
  (``async_snapshot``: serialization, IO and the commit barrier run on
  the save handle's completion thread, ``checkpoint.AsyncSaveHandle``);
- converts SIGTERM into a synchronized *sync* save + ``EXIT_PREEMPT``
  (75) at the next batch boundary, which the launcher resumes for free.

Exact batch-skip resume assumes the dataloader order is deterministic
across incarnations (``shuffle=False`` or a seeded/epoch-keyed shuffle) —
the RNG state is restored before any batch is drawn to help with that.
Across an elastic WORLD-SIZE change a sharded sampler repartitions the
dataset, so the skip stays positionally exact (right epoch/step) but not
sample-exact; the restore logs ``RESUMED_RESHARDED`` when that happens.
"""
from __future__ import annotations

import os
import sys

from . import flight_recorder as _fr
from .fault import (CheckpointLineage, exit_preempted,
                    install_preemption_handler, preempted)

__all__ = ["ResumableTraining", "rng_state", "set_rng_state"]


def _generators(network):
    """``[(name, torch.Generator)]`` of every generator a training step
    may draw from (module docstring), each once, in a fixed order."""
    import torch
    from ..core import random as prandom
    out, seen = [], set()

    def add(name, g):
        if isinstance(g, torch.Generator) and id(g) not in seen:
            seen.add(id(g))
            out.append((name, g))
    for key in sorted(prandom._generators):
        add(f"framework:{key}", prandom._generators[key])
    add("default:cpu", torch.default_generator)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i, g in enumerate(torch.cuda.default_generators):
            add(f"default:cuda:{i}", g)
    if network is not None:
        for mname, m in network.named_modules():
            for attr, v in sorted(vars(m).items()):
                add(f"module:{mname}.{attr}", v)
    return out


def rng_state(network=None):
    """The port's RNG state for a snapshot: ``["torch", [[name, state
    bytes], ...]]`` (module docstring)."""
    return ["torch", [[name, bytes(g.get_state().numpy())]
                      for name, g in _generators(network)]]


def set_rng_state(state, network=None):
    """Put back an :func:`rng_state`; a state the port did not write (a
    JAX key) is left alone."""
    import torch
    if not (isinstance(state, (list, tuple)) and len(state) == 2
            and state[0] == "torch"):
        print("[resumable] the snapshot's RNG state is not the port's "
              "(a JAX key?): generators left as they are",
              file=sys.stderr, flush=True)
        return
    saved = dict(state[1])
    for name, g in _generators(network):
        b = saved.get(name)
        if b is not None:
            g.set_state(torch.frombuffer(bytearray(b), dtype=torch.uint8))


class ResumableTraining:
    """Drive one training loop's checkpoint/restore/preemption lifecycle.

    Usage (what ``Model.fit`` does)::

        rt = ResumableTraining(lineage, network=net, optimizer=opt,
                               interval=50, async_snapshot=True)
        rt.restore()                      # -> None or restored step
        for epoch in range(rt.epoch, epochs):
            for step, batch in enumerate(loader):
                if rt.skip_batch(epoch, step):
                    continue              # consumed before the restart
                rt.poll_preempt(epoch, step)   # SIGTERM -> save + exit 75
                train(batch)
                rt.step_done(epoch, step)      # interval snapshot
            rt.epoch_done(epoch)               # epoch-boundary snapshot
        rt.finalize()                          # drain overlapped save
    """

    def __init__(self, lineage, network=None, optimizer=None, interval=None,
                 async_snapshot=False, extra_state=None, verbose=True):
        # verbose=True by default on purpose: RESUMED/FRESH/PREEMPT_SAVED
        # are state-transition markers the chaos harness and operators
        # grep worker logs for — they print even when the loop itself is
        # quiet (pass verbose=False to silence)
        if isinstance(lineage, (str, os.PathLike)):
            lineage = CheckpointLineage(str(lineage))
        self.lineage = lineage
        self.network = network
        self.optimizer = optimizer
        self.interval = int(interval) if interval else None
        self.async_snapshot = bool(async_snapshot)
        self.extra_state = dict(extra_state or {})
        self.verbose = verbose
        self.epoch = 0
        self.step_in_epoch = 0
        self.global_step = 0
        self._last_saved_step = None
        # Batch windows the integrity guard condemned: {(epoch, first,
        # last)} — skipped on replay AND persisted in snapshot metadata
        # so a later preemption-resume honors them.
        self.skip_windows: set = set()

    # -- state composition --
    def state(self, epoch, step_in_epoch, global_step):
        """The composite trainer state for one snapshot: the (epoch,
        step_in_epoch) pair is the RESUME point — the first batch the
        restored loop should run, not the last one it finished."""
        state = {"epoch": int(epoch),
                 "step_in_epoch": int(step_in_epoch),
                 "global_step": int(global_step),
                 "world_size": int(getattr(self.lineage, "world_size", 1)
                                   or 1),
                 "rng": rng_state(self.network)}
        # Versioned skip-window metadata, inserted BEFORE model/opt on
        # purpose: load_state_dict fills the target in key order and
        # raises KeyError for target keys an OLD snapshot lacks — these
        # two fire that KeyError before any tensor is restored in place,
        # so the back-compat retry in restore() starts from clean state.
        state["skip_windows_v"] = 1
        state["skip_windows"] = [list(w) for w in sorted(self.skip_windows)]
        if self.network is not None:
            state["model"] = self.network.state_dict()
        if self.optimizer is not None:
            state["opt"] = self.optimizer.state_dict()
        state.update(self.extra_state)
        return state

    def restore(self):
        """Load the newest verified snapshot (None = fresh start) and
        arm the SIGTERM handler. Restores model (in place), optimizer
        accumulators, RNG and loop progress."""
        if self.optimizer is not None \
                and hasattr(self.optimizer, "materialize"):
            # lazy accumulators must exist BEFORE the load, or a resume
            # that restarts ahead of the first step drops them silently
            self.optimizer.materialize()
        target = self.state(0, 0, 0)
        try:
            restored = self.lineage.load_latest(target)
        except KeyError as e:
            if "skip_windows" not in str(e):
                raise
            # Back-compat: a pre-integrity snapshot has no skip_windows
            # metadata — retry against a target without the two fields
            # (old snapshots load with an empty set).
            target = self.state(0, 0, 0)
            target.pop("skip_windows", None)
            target.pop("skip_windows_v", None)
            restored = self.lineage.load_latest(target)
        if restored is not None:
            if self.network is not None:
                self.network.set_state_dict(target["model"])
            if self.optimizer is not None and "opt" in target:
                self.optimizer.set_state_dict(target["opt"])
            if target.get("rng") is not None:
                set_rng_state(target["rng"], self.network)
            self.epoch = int(target["epoch"])
            self.step_in_epoch = int(target["step_in_epoch"])
            self.global_step = int(target["global_step"])
            self._last_saved_step = self.global_step
            # UNION-merge, not assign: rewind() registers its window
            # before calling restore(), and the snapshot being restored
            # predates that window — overwriting would lose it.
            self.skip_windows |= {(int(e), int(a), int(b)) for e, a, b in
                                  (target.get("skip_windows") or [])}
            old_world = int(target.get("world_size", 0) or 0)
            new_world = int(getattr(self.lineage, "world_size", 1) or 1)
            # ring marker: a post-mortem spanning the relaunch shows the
            # exact step (and world change) this incarnation re-entered at
            _fr.note_resume(self.global_step, old_world or None, new_world)
            if old_world and old_world != new_world:
                # elastic scale event: a sharded sampler repartitions the
                # dataset by world size, so the positional batch-prefix
                # skip resumes at the right (epoch, step) but over a
                # DIFFERENT sample partition — sample-exact resume holds
                # only within an unchanged world
                nid = os.environ.get("PADDLE_TPU_NODE_ID")
                self._log(f"RESUMED_RESHARDED world={old_world}->"
                          f"{new_world} (partition changed; batch skip "
                          "is positional, not sample-exact)"
                          + (f" node={nid}" if nid else ""))
            for k in self.extra_state:
                self.extra_state[k] = target[k]
            self._log(f"RESUMED epoch={self.epoch} "
                      f"step={self.step_in_epoch} "
                      f"global_step={self.global_step}")
        else:
            self._log("FRESH")
        install_preemption_handler()  # flag-only: loop polls poll_preempt
        return restored

    # -- loop hooks --
    def skip_batch(self, epoch, step_in_epoch) -> bool:
        """True for batches the pre-restart incarnation already consumed
        (the resumed epoch must not double-count its prefix) — or that
        fall in a condemned skip window (the integrity guard's rewind
        replay must excise the anomalous batches, and so must any later
        preemption-resume that re-walks the same epoch)."""
        if epoch == self.epoch and step_in_epoch < self.step_in_epoch:
            return True
        for e, a, b in self.skip_windows:
            if e == epoch and a <= step_in_epoch <= b:
                return True
        return False

    def add_skip_window(self, epoch, first_step, last_step):
        """Condemn the batch window [first_step, last_step] of ``epoch``
        (inclusive; persisted with the next snapshot)."""
        self.skip_windows.add((int(epoch), int(first_step), int(last_step)))

    def rewind(self, skip_window=None):
        """In-process rewind to the newest verified snapshot, optionally
        condemning a batch window first. Returns the restored global
        step; the caller restarts its epoch loop from this object's
        epoch/step_in_epoch state. The new window rides the NEXT snapshot
        (interval/epoch/preempt) — restore() union-merges, so it survives
        the state overwrite here."""
        if skip_window is not None:
            self.add_skip_window(*skip_window)
        restored = self.restore()
        if restored is None:
            raise RuntimeError(
                "rewind requested but the lineage holds no verified "
                "snapshot to restore (call ensure_baseline() before "
                "the first step)")
        self._log(f"REWOUND global_step={self.global_step} "
                  f"skip_windows={sorted(self.skip_windows)}")
        return self.global_step

    def ensure_baseline(self):
        """Guarantee at least one snapshot exists — the guard's rewind
        target when an anomaly trips before the first interval save.
        No-op once anything has been saved or restored."""
        if self._last_saved_step is None:
            self._save(self.epoch, self.step_in_epoch, sync=True)

    def poll_preempt(self, epoch, step_in_epoch):
        """At a batch boundary: if SIGTERM arrived, synchronously save a
        snapshot resuming AT this batch and exit ``EXIT_PREEMPT`` (the
        launcher relaunches without consuming its restart budget)."""
        if not preempted():
            return
        self._log(f"PREEMPT_SAVED {self.global_step}")
        exit_preempted(lambda: self._save(epoch, step_in_epoch, sync=True))

    def step_done(self, epoch, step_in_epoch, defer_to_epoch=False,
                  suspect=False):
        """One batch finished: bump counters; snapshot on the interval
        (resume point = the NEXT batch). Returns True if it saved.

        ``defer_to_epoch``: the loop knows this was the epoch's LAST
        batch — suppress the interval snapshot and let ``epoch_done``
        write the boundary one instead. An interval snapshot here would
        create a resume point AFTER the last batch but BEFORE the
        epoch-end processing (callbacks/eval), which a resume would then
        silently skip; ``epoch_done`` runs after those hooks, so its
        snapshot is the hook-exact boundary.

        ``suspect``: the integrity guard flagged this step's loss as
        anomalous — the parameters may already be corrupted, so the
        interval snapshot is suppressed. Snapshotting a suspect step
        would make the guard's own rewind target the corruption it is
        trying to escape."""
        self.global_step += 1
        # pin the flight recorder's step number so hang/desync post-
        # mortems name the exact trainer step, not a heartbeat estimate
        _fr.note_step(self.global_step)
        if self.interval and self.global_step % self.interval == 0 \
                and not defer_to_epoch and not suspect:
            self._save(epoch, step_in_epoch + 1)
            return True
        return False

    def epoch_done(self, epoch):
        """Epoch boundary: snapshot resuming at the next epoch's start
        (skipped when the interval save already covered this step)."""
        if self._last_saved_step != self.global_step:
            self._save(epoch + 1, 0)

    def finalize(self):
        """Drain an in-flight overlapped snapshot (durability + commit)."""
        self.lineage.wait()

    # -- internals --
    def _save(self, epoch, step_in_epoch, sync=False):
        self.lineage.save(
            self.state(epoch, step_in_epoch, self.global_step),
            step=self.global_step,
            async_save=self.async_snapshot and not sync)
        self._last_saved_step = self.global_step

    def _log(self, msg):
        if self.verbose:
            print(msg, file=sys.stdout, flush=True)
