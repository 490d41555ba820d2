"""hapi callbacks, after ``paddle_tpu/hapi/callbacks.py`` (reference:
python/paddle/hapi/callbacks.py). :class:`LRScheduler` steps the
optimizer's scheduler outside the staged train step; the step's replays
read the new lr from the optimizer's static buffers."""
from __future__ import annotations

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "ReduceLROnPlateau"]


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class ProgBarLogger(Callback):
    """Reference: hapi/callbacks.py ProgBarLogger — plus throughput: every
    log line carries ``ips`` (steps/sec) and the smoothed step time from
    the telemetry clock (an EMA over batch-end intervals), not just the
    loss."""

    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose
        from ..observability.telemetry import EMATimer
        self._timer = EMATimer()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        # eval/checkpoint pauses at epoch boundaries are not step time
        self._timer.reset()

    def on_train_batch_end(self, step, logs=None):
        _, ema = self._timer.tick()
        if self.verbose and step % self.log_freq == 0:
            shown = dict(logs or {})
            if ema:
                shown["step_ms"] = ema * 1e3
                shown["ips"] = 1.0 / ema
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                               else f"{k}: {v}"
                               for k, v in shown.items())
            print(f"epoch {self.epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                               else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"epoch {epoch} done: {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="min", patience=0, min_delta=0,
                 baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.stop_training = False

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        better = self.best is None or (
            cur < self.best - self.min_delta if self.mode == "min"
            else cur > self.best + self.min_delta)
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        lr = getattr(self.model._optimizer, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


class ReduceLROnPlateau(Callback):
    """Reference: hapi/callbacks.py ReduceLROnPlateau — shrink the optimizer
    lr when the monitored metric stops improving."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, mode="min",
                 min_delta=1e-4, cooldown=0, min_lr=0.0, verbose=1):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.verbose = verbose
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._better(cur):
            self.best = cur
            self.wait = 0
            return
        if self.cooldown_counter > 0:
            # cooldown suppresses wait accrual entirely (Keras/reference)
            self.cooldown_counter -= 1
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                lr = opt.get_lr()
                new_lr = max(lr * self.factor, self.min_lr)
                if new_lr < lr:
                    opt.set_lr(new_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {lr:.2e} -> "
                              f"{new_lr:.2e}")
            self.cooldown_counter = self.cooldown
            self.wait = 0
