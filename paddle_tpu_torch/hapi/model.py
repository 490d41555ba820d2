"""hapi.Model — Keras-style fit/evaluate/predict, after
``paddle_tpu/hapi/model.py:26-530`` (reference: python/paddle/hapi/
model.py:1054 Model, fit at :1756, dynamic adapter at :821).

The train step is ``jit.to_static(train_step, capture=(network,
optimizer))``, as in JAX (``:59-80``): one CUDA graph a step replaying
the hand kernels (its first call an eager warm-up, its second the
capture), staged under ``auto_cast(level, "bfloat16")`` when
``amp_configs`` asks for AMP. A new input shape is a new static key and
a new capture, as a new shape is a recompile in JAX: give ``fit`` sizes
that leave no partial last batch, or a ``DataLoader(drop_last=True)``.

The blocking device->host loss fetches go through one funnel,
:meth:`Model._fetch_scalar` for one loss and :meth:`Model._fetch_scalars`
for a batch (stacked on the device, one sync), on the JAX cadence: with
no metrics attached ``fit`` keeps each step's loss as a lazy device
scalar and fetches every ``loss_fetch_every`` steps and once an epoch.

``fit(lineage=...)`` makes the loop resumable and ``fit(integrity=...)``
arms the training integrity guard, as in JAX (``:232-301``; the
``distributed.resumable`` and ``distributed.integrity`` modules).
``prepare`` in an initialized parallel env of more than one rank wraps
the network in :class:`~..distributed.parallel.DataParallel`, as JAX's
does (``:52-56``): its gradient sync is a gloo all-reduce on the host,
which breaks the staged step into the eager fallback (see
``distributed/parallel.py``). The integrity guard's gradient
fingerprints, which need JAX's bucketed data-parallel scheduler
(ROADMAP Queue 1 item 8), degrade to the health gates as JAX's do
without one. ``fit``'s and
``evaluate``'s ``num_workers`` is ignored, as in JAX (``:201-227``), and so
is ``fit``'s ``drop_last``: pass a :class:`~..io.DataLoader` with workers
or ``drop_last=True``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..io import DataLoader, Dataset
from ..jit.api import to_static
from ..observability import telemetry as _telemetry
from ..observability import tracing as _tracing

__all__ = ["Model"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _set_state_dict(net, state):
    """JAX ``Layer.set_state_dict``: copy every entry whose name the
    network has into its parameter or buffer (in the target's dtype and
    device); names either side lacks are skipped, a shape mismatch
    raises."""
    with torch.no_grad():
        for name, target in net.state_dict(keep_vars=True).items():
            if name not in state:
                continue
            src = torch.as_tensor(state[name])
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"state_dict['{name}'] has shape {list(src.shape)} "
                    f"but expects {list(target.shape)}")
            target.copy_(src)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = list(inputs) if inputs is not None else None
        self._labels = list(labels) if labels is not None else None
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._step_fn = None
        self._amp_level = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """Reference: Model.prepare (hapi/model.py:2006) — including the
        distributed adapter (:821): when the parallel env is initialized
        with more than one rank, the network is wrapped in DataParallel
        so fit() trains data-parallel; amp_configs ('O1'/'O2' or
        {'level': ...}) stages the train step under auto_cast in
        bfloat16."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)
        self._amp_level = None
        if amp_configs is not None:
            if isinstance(amp_configs, str):
                self._amp_level = amp_configs
            elif isinstance(amp_configs, dict):
                self._amp_level = amp_configs.get("level", "O1")
        from ..distributed import env as _denv
        from ..distributed.parallel import DataParallel
        if _denv.is_initialized() and _denv.get_world_size() > 1 and \
                not isinstance(self.network, DataParallel):
            self.network = DataParallel(self.network)
        self._step_fn = None

    def _device(self):
        p = next(iter(self.network.parameters()), None)
        return p.device if p is not None else None

    # ---- single-batch entry points (reference: train_batch/eval_batch) ----
    def _build_step(self):
        net, loss_fn, opt = self.network, self._loss, self._optimizer
        amp_level = self._amp_level

        def train_step(x, y):
            if amp_level:
                from ..amp import auto_cast
                with auto_cast(level=amp_level, dtype="bfloat16"):
                    out = net(x)
                    loss = loss_fn(out, y)
            else:
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss, out

        self._step_fn = to_static(train_step, capture=(net, opt))
        return self._step_fn

    def train_batch(self, inputs, labels=None, update=True, sync=True):
        """One train step. ``sync=False`` (the fit loop's fast path, only
        taken when no user metrics are attached) returns the loss as a LAZY
        scalar tensor without the blocking device->host fetch, so the fit
        loop amortizes that fetch over ``loss_fetch_every`` steps."""
        x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        y = labels[0] if isinstance(labels, (list, tuple)) else labels
        if not update:
            # gradient accumulation: eager fwd/bwd without the staged update
            with _tracing.span("fwd"):
                out = self.network(x)
                loss = self._loss(out, y)
            with _tracing.span("bwd"):
                loss.backward()
        else:
            step = self._step_fn or self._build_step()
            loss, out = step(x, y)
        if not sync and not self._metrics:
            return loss
        # the fetch below is where the host really waits for the card:
        # telemetry splits it out as sync time
        _telemetry.mark_sync_begin()
        metrics = [self._fetch_scalar(loss)]
        for m in self._metrics:
            self._update_metric(m, out, y)
        return metrics[0] if len(metrics) == 1 else metrics

    # the ONE funnel for blocking loss fetches — the bounded-host-sync
    # regression test counts calls here, so a reintroduced per-step fetch
    # fails structurally instead of by wall clock
    @staticmethod
    def _fetch_scalar(loss):
        return float(loss.item())

    @staticmethod
    def _fetch_scalars(losses):
        """Fetch a batch of pending scalar losses with ONE host sync."""
        if not losses:
            return []
        vals = torch.stack([ls.detach().reshape(()).float()
                            for ls in losses]).cpu()
        return [float(v) for v in vals.tolist()]

    @classmethod
    def _resolve_losses(cls, losses):
        """Turn a mixed float/lazy-tensor loss list into floats — the
        tensors (steps between amortized fetches) resolve in one sync."""
        idx = [i for i, ls in enumerate(losses)
               if isinstance(ls, torch.Tensor)]
        if not idx:
            return losses
        vals = cls._fetch_scalars([losses[i] for i in idx])
        out = list(losses)
        for i, v in zip(idx, vals):
            out[i] = v
        return out

    @staticmethod
    def _update_metric(m, out, y):
        res = m.compute(out, y)
        if isinstance(res, tuple):
            m.update(*res)
        else:
            m.update(res)

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        y = labels[0] if isinstance(labels, (list, tuple)) else labels
        out = self.network(x)
        loss = self._loss(out, y) if self._loss else None
        for m in self._metrics:
            self._update_metric(m, out, y)
        return float(loss.item()) if loss is not None else None

    @torch.no_grad()
    def predict_batch(self, inputs):
        x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        return self.network(x)

    # ---- loops ----
    def _loader(self, data, batch_size, shuffle, epoch_keyed=False):
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            from ..distributed import env as _denv
            if _denv.is_initialized() and _denv.get_world_size() > 1:
                # one process a rank: each loads its own shard
                # (reference: fit's DistributedBatchSampler path)
                from ..io import DistributedBatchSampler
                sampler = DistributedBatchSampler(
                    data, batch_size=batch_size, shuffle=shuffle)
                return DataLoader(data, batch_sampler=sampler,
                                  places=self._device())
            if epoch_keyed and shuffle:
                # resumable fit: the plain RandomSampler draws from the
                # numpy global RNG, which snapshots do not capture — a
                # resumed incarnation would iterate a DIFFERENT
                # permutation and skip the wrong batches. The sharded
                # sampler at nranks=1 shuffles epoch-keyed
                # (RandomState(epoch)), identical across incarnations.
                from ..io import DistributedBatchSampler
                sampler = DistributedBatchSampler(
                    data, batch_size=batch_size, num_replicas=1, rank=0,
                    shuffle=True)
                return DataLoader(data, batch_sampler=sampler,
                                  places=self._device())
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              places=self._device())
        raise TypeError(f"expected Dataset or DataLoader, got {type(data)}")

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            num_iters=None, lineage=None, snapshot_interval=None,
            async_snapshot=False, loss_fetch_every=None, integrity=None):
        """Reference: Model.fit (hapi/model.py:1756).

        ``loss_fetch_every`` amortizes the blocking device->host loss
        fetch: with no user metrics attached the loop keeps the loss as a
        lazy device scalar and fetches every N steps (default: each
        attached ProgBarLogger's log_freq, else 50) plus once per epoch,
        so the staged train step streams back-to-back instead of the host
        draining the card every step. Pass ``1`` to restore the strict
        per-step fetch. Per-step ``logs["loss"]`` holds the most recently
        fetched value between fetches; epoch means and ``history`` are
        exact either way.

        ``lineage`` (a ``distributed.fault.CheckpointLineage`` or a root
        directory path) makes the loop RESUMABLE: on entry the newest
        verified snapshot restores model/optimizer/RNG and the exact
        epoch+batch position (already-consumed batches of the resumed
        epoch are skipped, never double-counted), snapshots land every
        ``snapshot_interval`` steps and at every epoch boundary
        (``async_snapshot=True`` overlaps the device-to-host copy,
        serialization, IO and the commit with training), and SIGTERM
        converts into a synchronized save + exit 75 which the launcher
        resumes without consuming its restart budget. When
        ``train_data`` is a Dataset the loop makes the iteration order
        deterministic itself (an epoch-keyed shuffle, identical across
        incarnations); a user-supplied DataLoader must provide that
        determinism for exact batch-skip resume (shuffle=False or a
        seeded/epoch-keyed shuffle).

        ``integrity`` (True / a dict of ``TrainingGuard`` knobs / a
        guard instance) arms the training integrity guard
        (``distributed.integrity``): per-step loss health gates
        (median+MAD z-score with NaN/Inf folded in) and automatic
        rewind-and-skip through ``lineage`` on a sustained anomaly. The
        guard needs the host loss value every step, so it forces the
        blocking fetch the amortized cadence otherwise avoids — a
        documented cost of ``integrity=``; with it unset (the default)
        the loop is structurally unchanged."""
        from .callbacks import ProgBarLogger
        cbs = _as_list(callbacks)
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs.append(ProgBarLogger(log_freq, verbose))
        # per-step telemetry (PADDLE_TPU_METRICS=1): step-time breakdown,
        # tokens/sec and MFU into the metrics registry; attach a
        # TelemetryCallback yourself to override flops/tokens
        tm = next((c for c in cbs
                   if isinstance(c, _telemetry.TelemetryCallback)), None)
        if tm is None:
            tm = _telemetry.maybe_telemetry_callback()
            if tm is not None:
                cbs.append(tm)
        for c in cbs:
            c.set_model(self)
        loader = self._loader(train_data, batch_size, shuffle,
                              epoch_keyed=lineage is not None)
        rt = None
        if lineage is not None:
            from ..distributed.resumable import ResumableTraining
            rt = ResumableTraining(
                lineage, network=self.network, optimizer=self._optimizer,
                interval=snapshot_interval, async_snapshot=async_snapshot)
            rt.restore()
        guard = None
        if integrity is not None and integrity is not False:
            from ..distributed.integrity import make_guard
            guard = make_guard(integrity)
            guard.attach_fingerprints(self.network)
            if rt is not None:
                # a rewind target must exist even if an anomaly trips
                # before the first interval snapshot
                rt.ensure_baseline()
        history = {"loss": []}
        # amortized loss-fetch cadence: align with the tightest progress
        # logger so every PRINTED loss is fresh, never force a per-step
        # device drain just to fill a logs dict nobody reads
        if loss_fetch_every is None:
            freqs = [c.log_freq for c in cbs
                     if isinstance(c, ProgBarLogger) and c.verbose]
            loss_fetch_every = min(freqs) if freqs else 50
        loss_fetch_every = max(1, int(loss_fetch_every))
        lazy_loss = not self._metrics
        for c in cbs:
            c.on_train_begin()
        it = rt.global_step if rt is not None else 0
        done = False
        try:
            # explicit epoch cursor (not a range): the integrity guard's
            # rewind restores rt to an earlier epoch/step and the loop
            # must re-enter there to replay with the window skipped
            epoch = rt.epoch if rt is not None else 0
            rewound = False
            suspect = False    # guard flagged the latest step
            while epoch < epochs:
                if done:
                    break
                self.network.train()
                sampler = getattr(loader, "batch_sampler", None)
                if hasattr(sampler, "set_epoch"):
                    # per-epoch reshuffle (reference set_epoch idiom) — and
                    # the key a resumed incarnation replays the same
                    # permutation from
                    sampler.set_epoch(epoch)
                for c in cbs:
                    c.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                epoch_losses = []
                shown_loss = None  # most recently FETCHED loss float
                suspect = False
                for step, batch in enumerate(loader):
                    if rt is not None and rt.skip_batch(epoch, step):
                        continue  # consumed before the restart
                    if num_iters is not None and it >= num_iters:
                        done = True
                        break
                    if rt is not None:
                        rt.poll_preempt(epoch, step)
                    x, y = batch[0], batch[1]
                    if guard is not None:
                        y = guard.maybe_poison(y)
                    if tm is not None:
                        tm.batch_ready(x)  # data wait ends here
                    for c in cbs:
                        c.on_train_batch_begin(step)
                    loss = self.train_batch(x, y, sync=not lazy_loss)
                    if guard is not None and isinstance(loss, torch.Tensor):
                        # the health gate scores every step's HOST value:
                        # integrity= pays the per-step fetch (documented
                        # cost), through the one counted funnel
                        _telemetry.mark_sync_begin()
                        loss = self._fetch_scalar(loss)
                        shown_loss = loss
                    if isinstance(loss, torch.Tensor):
                        # lazy loss: fetch on the cadence, keep the card's
                        # queue full in between. shown_loss None means no
                        # fetch has happened yet THIS epoch (e.g. a
                        # mid-epoch resume skipped past step 0): fetch so
                        # callbacks never see logs={"loss": None}
                        if step % loss_fetch_every == 0 or \
                                shown_loss is None:
                            _telemetry.mark_sync_begin()
                            loss = self._fetch_scalar(loss)
                            shown_loss = loss
                    else:
                        shown_loss = loss
                    if guard is not None:
                        verdict = guard.observe_loss(loss, epoch, step, it)
                        if verdict == "rewind":
                            guard.rewind(rt, epoch, step)
                            it = rt.global_step
                            rewound = True
                            break
                        suspect = verdict is not None
                    epoch_losses.append(loss)
                    logs = {"loss": shown_loss}
                    for m in self._metrics:
                        logs[m.name()] = m.accumulate()
                    for c in cbs:
                        c.on_train_batch_end(step, logs)
                    it += 1
                    if rt is not None:
                        try:
                            last = step + 1 == len(loader)
                        except TypeError:  # unsized iterable loader
                            last = False
                        rt.step_done(epoch, step, defer_to_epoch=last,
                                     suspect=suspect)
                        if tm is not None:
                            # a sync interval snapshot must not read as
                            # data wait in the next step's split
                            tm.note_pause()
                if rewound:
                    rewound = False
                    epoch = rt.epoch
                    continue  # replay from the restored snapshot state
                if not epoch_losses:
                    if rt is not None and epoch == rt.epoch \
                            and rt.step_in_epoch > 0:
                        epoch += 1
                        continue  # resumed exactly at this epoch's end
                    break
                epoch_losses = self._resolve_losses(epoch_losses)
                logs = {"loss": float(np.mean(epoch_losses))}
                for m in self._metrics:
                    logs[m.name()] = m.accumulate()
                history["loss"].append(logs["loss"])
                if eval_data is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                              verbose=0)
                    logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
                    for c in cbs:
                        c.on_eval_end(eval_logs)
                for c in cbs:
                    c.on_epoch_end(epoch, logs)
                if save_dir and (epoch + 1) % save_freq == 0:
                    self.save(f"{save_dir}/{epoch}")
                if rt is not None and not done and not suspect:
                    # a num_iters cut mid-epoch must NOT snapshot the epoch
                    # as complete — resuming would silently skip its tail;
                    # a guard-suspect tail must not snapshot possibly-
                    # corrupted parameters as the boundary either
                    rt.epoch_done(epoch)
                if any(getattr(c, "stop_training", False) for c in cbs):
                    break
                epoch += 1
        except BaseException:
            if rt is not None:
                # drain the in-flight overlapped snapshot so the error
                # path still leaves a complete, committed last snapshot
                try:
                    rt.finalize()
                except Exception:
                    pass  # never mask the training error
            raise
        finally:
            if tm is not None:
                # the error path must clear the module-global telemetry
                # clock and flush the last window too (idempotent: the
                # success path's on_train_end below becomes a no-op)
                try:
                    tm.on_train_end()
                except Exception:
                    pass
        for c in cbs:
            c.on_train_end()
        if rt is not None:
            rt.finalize()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        self.network.eval()
        loader = self._loader(eval_data, batch_size, False)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            loss = self.eval_batch(batch[0], batch[1])
            if loss is not None:
                losses.append(loss)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        self.network.train()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        self.network.eval()
        loader = self._loader(test_data, batch_size, False)
        outs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            out = self.predict_batch(x).detach().cpu()
            if out.dtype == torch.bfloat16:
                out = out.float()
            outs.append(out.numpy())
        self.network.train()
        if stack_outputs:
            return [np.concatenate(outs, axis=0)]
        return outs

    # ---- persistence ----
    def save(self, path, training=True):
        """``path + ".pdparams"`` (the network's parameters and buffers)
        and ``path + ".pdopt"`` (the optimizer's state) in the JAX
        package's format; ``training=False`` exports the network for
        inference through ``jit.save`` with the model's ``inputs`` specs
        (``paddle_tpu/hapi/model.py:502-507``)."""
        if not training:
            from ..jit.save_load import save as _jit_save
            _jit_save(self.network, path, input_spec=self._inputs)
            return
        from ..framework import save as _save
        _save(self.network.state_dict(keep_vars=True), path + ".pdparams")
        if self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False,
             name_map=None):
        """Load what :meth:`save` wrote, or what the JAX package's
        ``Model.save`` wrote: the parameters by their structured names
        (which the port keeps), the optimizer's state by the port's
        parameter names or, with ``name_map`` (the JAX model's
        ``{p.name: structured name}``), by the JAX ones through
        :func:`~..convert.opt_state_from_paddle_tpu`."""
        from ..framework import load as _load
        dev = self._device()
        _set_state_dict(self.network,
                        _load(path + ".pdparams", device=dev or "cpu"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            if name_map is not None:
                from ..convert import opt_state_from_paddle_tpu
                state = opt_state_from_paddle_tpu(
                    _load(path + ".pdopt", return_numpy=True), name_map)
            else:
                state = _load(path + ".pdopt", device=dev or "cpu")
            self._optimizer.set_state_dict(state)

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        """Reference: hapi/model.py Model.summary -> model_summary.summary."""
        from .summary import summary as _summary
        if input_size is None and self._inputs:
            input_size = [tuple(s.shape) for s in self._inputs]
        return _summary(self.network, input_size, dtypes=dtype)
