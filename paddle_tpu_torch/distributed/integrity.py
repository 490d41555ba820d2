"""Training integrity guard — SDC/loss-spike detection, rank blame, and
automatic rewind-and-skip: the port's copy of
``paddle_tpu/distributed/integrity.py`` (the same verdicts, z-scores,
markers and knobs). The port has no bucketed data-parallel gradient
scheduler yet (it comes with parallel training), so
:meth:`TrainingGuard.attach_fingerprints` degrades to the health gates
as the JAX guard does without one; :class:`GradFingerprints` itself is
here, summarizing a torch payload.

Every robustness layer so far protects the control plane or a side
workload; the training step itself was trusted blindly — a silent-data-
corruption'd gradient on one rank, a loss spike, or a poisoned batch
converges the model to garbage with exit code 0. This module closes that
gap with three cooperating mechanisms, all opt-in through the ``fit``
loops' ``integrity=`` knob (off = one truthiness check per step,
structurally zero overhead — tested like the flight recorder's disabled
path):

1. **Per-step health gates** (:class:`MADWindow` inside
   :class:`TrainingGuard`): the loss stream is scored against a robust
   rolling window (median + MAD z-score with a warmup grace). NaN/Inf
   verdicts fold in as immediate ``nonfinite`` anomalies that bypass the
   warmup. Anomalies are ring-marked, counted
   (``train_anomalies_total{kind}``) and the latest z-score is published
   as the ``integrity_last_z`` gauge.

2. **Cross-rank gradient fingerprints** (:class:`GradFingerprints`):
   under eager DP with the bucketed scheduler, each rank publishes a
   per-bucket summary (L2 norm + CRC32 of a strided sample) of the
   PRE-collective flat payload over the ``PADDLE_TPU_FR_STORE``
   side channel. Publication piggybacks on ``BucketedGradSync._fire``
   (after the async collective dispatches, so the host CRC overlaps the
   in-flight all-reduce), and verification happens at backward end
   AFTER every task is awaited but BEFORE any leaf writeback — a
   mismatch therefore discards the step on every rank while parameters
   are still synced. The majority vote mirrors the desync rule
   (injection-marked groups can never win a tie; remaining ties break
   toward the lowest rank), the blamed rank takes a
   ``QuarantineList`` strike (the elastic module's), and
   the fit loop redoes the step from the synced state.

3. **Automatic rewind-and-skip**: a sustained anomaly (``rewind_after``
   consecutive trips) restores the newest
   :class:`~.resumable.ResumableTraining` snapshot
   in-process, re-derives the deterministic shuffle, and replays with
   the offending batch window skipped. Skip windows persist in snapshot
   metadata (versioned, back-compat — see resumable.py) so a later
   preemption-resume honors them. The budget is ``max_rewinds``;
   exhaustion raises :class:`IntegrityError`, which the module's
   excepthook maps to ``EXIT_INTEGRITY`` so the launcher post-mortem
   names the guard verdict instead of a generic crash (and does NOT
   restart: a relaunch resumes the same snapshot and re-trips).

Fault injection: ``grad_bitflip@grad_fingerprint`` perturbs the blamed
rank's HOST sample copy right before summarizing (the SDC model: one
rank differs pre-collective where fingerprints must agree — the device
payload is intact, so the redone step reaches exact clean-twin parity);
``loss_spike@batch`` makes the guarded fit loop scale one batch's labels
so the corruption is real and the rewind replay must excise it.
"""
from __future__ import annotations

import json
import os
import sys
import time
import zlib

import numpy as np

from . import fault as _fault
from . import flight_recorder as _fr
from ..observability import metrics as _metrics

__all__ = [
    "IntegrityError", "GradFingerprintMismatch", "MADWindow",
    "verify_fingerprints", "GradFingerprints", "TrainingGuard",
    "make_guard",
]


class IntegrityError(RuntimeError):
    """The guard's terminal verdict: the anomaly survived the in-process
    rewind-and-skip budget (or a mismatched step survived ``max_redos``).
    Uncaught, the module excepthook turns it into ``EXIT_INTEGRITY``."""


class GradFingerprintMismatch(RuntimeError):
    """Pre-collective bucket fingerprints disagreed across ranks: one
    rank's gradient payload differs where replicated math must agree —
    the bit-flip/SDC signature. Raised at backward end BEFORE any leaf
    writeback, so parameters are still the synced pre-step values and
    the step can simply be redone."""

    def __init__(self, msg, blamed=(), bucket=None, round_=None,
                 fingerprints=None):
        super().__init__(msg)
        self.blamed = list(blamed)
        self.bucket = bucket
        self.round = round_
        self.fingerprints = dict(fingerprints or {})


_hook_installed = [False]


def _install_integrity_excepthook():
    """An uncaught IntegrityError becomes the distinct ``EXIT_INTEGRITY``
    exit code so the launcher can name the guard verdict (same pattern
    as the flight recorder's desync hook)."""
    if _hook_installed[0]:
        return
    _hook_installed[0] = True
    prev = sys.excepthook

    def hook(tp, val, tb):
        if isinstance(tp, type) and issubclass(tp, IntegrityError):
            try:
                prev(tp, val, tb)
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(_fault.EXIT_INTEGRITY)
        prev(tp, val, tb)

    sys.excepthook = hook


# ----------------------------------------------------------- health gate

class MADWindow:
    """Robust rolling anomaly score: median + MAD z-score over the last
    ``window`` accepted values, with a ``warmup`` grace (the first steps
    of training legitimately move fast — no verdicts until the window
    has something to stand on). Tripped values are NOT folded into the
    window: a spike must not drag the baseline toward itself, or a
    sustained spike would self-normalize before the rewind threshold."""

    def __init__(self, window=32, z_threshold=8.0, warmup=8):
        self.window = int(window)
        self.z_threshold = float(z_threshold)
        self.warmup = int(warmup)
        self._vals: list[float] = []
        self._seen = 0
        self.last_z = 0.0

    def score(self, value):
        """The robust z-score of ``value`` against the current window
        (0.0 during warmup). MAD == 0 (constant window — a converged or
        synthetic loss) falls back to a tiny scale proportional to the
        median so a genuinely different value still registers huge."""
        if self._seen < self.warmup or not self._vals:
            return 0.0
        arr = np.asarray(self._vals, dtype=np.float64)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        scale = 1.4826 * mad
        if scale <= 0.0:
            scale = max(abs(med), 1.0) * 1e-6
        return abs(float(value) - med) / scale

    def observe(self, value) -> bool:
        """Score then (if accepted) absorb ``value``; True = tripped."""
        value = float(value)
        z = self.score(value)
        self.last_z = z
        self._seen += 1
        if z > self.z_threshold:
            return True
        self._vals.append(value)
        if len(self._vals) > self.window:
            del self._vals[0]
        return False

    def reset(self):
        self._vals.clear()
        self._seen = 0
        self.last_z = 0.0


# -------------------------------------------------- gradient fingerprints

def verify_fingerprints(fps):
    """Majority vote over per-rank bucket fingerprints. ``fps`` maps
    rank -> {"fp": str, "injected": bool}. Returns the sorted minority
    ranks to blame, or ``[]`` when all agree (or fewer than two ranks
    reported — one voice is no election).

    The rule mirrors ``flight_recorder.verify_signatures``: a group
    carrying an injected marker can never win a tie (on a 2-rank world
    the perturbed rank would otherwise be a coin flip), and remaining
    ties break toward the group containing the lowest rank — a
    deterministic, cross-rank-agreeable verdict."""
    groups: dict[str, list[int]] = {}
    marked = set()
    for rank, rec in fps.items():
        fp = str(rec.get("fp"))
        groups.setdefault(fp, []).append(int(rank))
        if rec.get("injected"):
            marked.add(fp)
    if len(groups) <= 1:
        return []
    majority = max(groups, key=lambda s: (s not in marked,
                                          len(groups[s]),
                                          -min(groups[s])))
    blamed = sorted(r for s, ranks in groups.items() if s != majority
                    for r in ranks)
    return blamed


class GradFingerprints:
    """Per-bucket pre-collective gradient summaries over the side-channel
    store. One instance per rank, attached to ``BucketedGradSync`` as its
    ``integrity_hook``:

    * ``begin_round()`` — called from ``on_backward_begin`` on EVERY
      backward (before the scheduler's early return), so the round
      counter stays in lockstep across ranks — including redo backwards.
    * ``on_bucket(index, flat)`` — called from the eager ``_fire`` right
      after the async collective dispatches: summarize the PRE-collective
      payload (norm + CRC of a strided host sample) and publish it.
    * ``verify()`` — called at backward end after all tasks are awaited
      and before any writeback: gather every rank's records per bucket,
      vote, raise :class:`GradFingerprintMismatch` naming the minority.
    """

    def __init__(self, rank, world, stride=1021, timeout=None):
        self.rank = int(rank)
        self.world = int(world)
        self.stride = max(1, int(stride))
        if timeout is None:
            timeout = float(os.environ.get(
                "PADDLE_TPU_INTEGRITY_TIMEOUT_S", "30"))
        self.timeout = float(timeout)
        self._store = None
        self._store_tried = False
        self._round = 0
        self._published: list[int] = []    # bucket indices this round

    # The store connection is shared with the flight recorder when one is
    # live; cached locally either way (never retried after failure — an
    # unreachable side channel must not stall every backward).
    def _get_store(self):
        if self._store is None and not self._store_tried:
            self._store_tried = True
            self._store = _fr.side_store(rank=self.rank, world=self.world,
                                         timeout=self.timeout)
        return self._store

    def available(self):
        return self._get_store() is not None

    def begin_round(self):
        self._round += 1
        self._published.clear()

    def _key(self, bucket, rank):
        return f"{_fr.store_scope()}/gfp/r{self._round}/b{bucket}/{rank}"

    def on_bucket(self, bucket_index, flat):
        store = self._get_store()
        if store is None:
            return
        # Strided host sample of the pre-collective payload. The sample
        # (not the full bucket) bounds host bytes per fire; the fetch
        # overlaps the in-flight collective that just dispatched.
        sample = flat.detach().reshape(-1)[::self.stride].float().cpu() \
            .numpy()
        injected = _fault.maybe_inject("grad_fingerprint") == "grad_bitflip"
        if injected and sample.size:
            # SDC model: flip one mantissa-adjacent bit in this rank's
            # HOST copy right before summarizing. The device payload is
            # untouched, so after blame + redo the training math is
            # bit-identical to the clean twin — what the acceptance
            # test's exact loss-parity check relies on.
            bits = sample.view(np.int32).copy()
            bits[0] ^= np.int32(1 << 22)
            sample = bits.view(np.float32)
        norm = float(np.linalg.norm(sample))
        crc = zlib.crc32(sample.tobytes()) & 0xFFFFFFFF
        fp = f"n={norm:.6g}|crc={crc:08x}|len={int(sample.size)}"
        rec = {"fp": fp, "injected": bool(injected), "rank": self.rank}
        try:
            store.set(self._key(bucket_index, self.rank), json.dumps(rec))
        except Exception as e:
            print(f"[integrity] rank {self.rank}: fingerprint publish "
                  f"failed ({e}); bucket {bucket_index} unverified",
                  file=sys.stderr, flush=True)
            return
        self._published.append(int(bucket_index))

    def verify(self):
        if not self._published:
            return
        store = self._get_store()
        published, self._published = self._published, []
        if store is None:
            return
        for bucket in published:
            fps = {}
            for r in range(self.world):
                try:
                    store.wait([self._key(bucket, r)], timeout=self.timeout)
                    raw = store.get(self._key(bucket, r))
                    fps[r] = json.loads(raw)
                except Exception:
                    # A silent peer is itself suspicious, but blame here
                    # belongs to the liveness layer (watchdog/elastic) —
                    # give it a sentinel so the vote still resolves.
                    fps[r] = {"fp": f"<missing rank {r}>",
                              "injected": False}
            blamed = verify_fingerprints(fps)
            if blamed:
                detail = ", ".join(
                    f"rank {r}: {fps[r]['fp']}" for r in sorted(fps))
                raise GradFingerprintMismatch(
                    f"bucket {bucket} gradient fingerprints diverged "
                    f"pre-collective (round {self._round}): blamed "
                    f"rank(s) {blamed} [{detail}]",
                    blamed=blamed, bucket=bucket, round_=self._round,
                    fingerprints=fps)


# ------------------------------------------------------------- the guard

class TrainingGuard:
    """The per-fit integrity policy object (one per ``fit`` call; see the
    module docstring for the full model). All knobs ride the ``integrity=``
    dict: ``window``/``z_threshold``/``warmup`` (health gate),
    ``rewind_after`` (consecutive trips before a rewind), ``max_rewinds``
    (budget; exhaustion raises :class:`IntegrityError`), ``fingerprints``
    (enable cross-rank gradient fingerprints under eager DP),
    ``fingerprint_stride``, ``max_redos`` (mismatch redo budget per
    step), ``quarantine`` (a ``QuarantineList`` to strike blamed ranks
    into), ``verbose``."""

    def __init__(self, window=32, z_threshold=8.0, warmup=8,
                 rewind_after=3, max_rewinds=2, max_redos=2,
                 fingerprints=False, fingerprint_stride=1021,
                 quarantine=None, verbose=True):
        self.mad = MADWindow(window=window, z_threshold=z_threshold,
                             warmup=warmup)
        self.rewind_after = int(rewind_after)
        self.max_rewinds = int(max_rewinds)
        self.max_redos = int(max_redos)
        self.want_fingerprints = bool(fingerprints)
        self.fingerprint_stride = int(fingerprint_stride)
        self.quarantine = quarantine
        self.verbose = bool(verbose)
        self.anomalies: dict[str, int] = {}
        self.blames: dict[int, int] = {}
        self.rewinds = 0
        self.last_rewind_detect_s = None
        self._fp = None
        self._streak = 0
        self._streak_start = None          # (epoch, step) of first trip
        self._first_trip_t = None
        self._redo_key = None
        self._redo_n = 0
        _install_integrity_excepthook()

    # ------------------------------------------------------- fingerprints
    def attach_fingerprints(self, network):
        """Wire :class:`GradFingerprints` onto the network's bucketed DP
        scheduler, if the configuration supports it (eager DP wrapper
        with comm overlap; a staged engine has no pre-collective host
        payload to fingerprint). Quietly a no-op when not requested."""
        if not self.want_fingerprints:
            return
        sync = getattr(network, "_grad_sync", None)
        if sync is None or not getattr(sync, "_attached", False):
            print("[integrity] fingerprints requested but the network has "
                  "no ATTACHED bucketed DP gradient scheduler (need the "
                  "eager DataParallel wrapper with comm overlap: "
                  "comm_overlap=True or PADDLE_TPU_DP_OVERLAP=1) — "
                  "running with health gates only",
                  file=sys.stderr, flush=True)
            self.want_fingerprints = False
            return
        rank = _fault.fault_rank()
        world = int(os.environ.get(
            "PADDLE_TPU_NUM_PROCESSES",
            os.environ.get("PADDLE_TRAINERS_NUM", "1")) or 1)
        fp = GradFingerprints(rank, world, stride=self.fingerprint_stride)
        if not fp.available():
            print("[integrity] fingerprints requested but no side-channel "
                  "store (set PADDLE_TPU_FR_STORE=host:port) — running "
                  "with health gates only", file=sys.stderr, flush=True)
            self.want_fingerprints = False
            return
        self._fp = fp
        sync.integrity_hook = fp

    def fingerprints_active(self):
        return self._fp is not None

    # -------------------------------------------------------- health gate
    def observe_loss(self, value, epoch, step, global_step):
        """Feed one step's (host) loss value. Returns None (healthy),
        ``"anomaly"`` (tripped, streak below the rewind threshold) or
        ``"rewind"`` (the caller should rewind-and-skip now)."""
        value = float(value)
        if not np.isfinite(value):
            # Nonfinite is never "maybe": bypass the warmup grace.
            tripped, kind, z = True, "nonfinite", float("inf")
        else:
            tripped = self.mad.observe(value)
            kind, z = "loss_spike", self.mad.last_z
            g = _metrics.gauge("integrity_last_z")
            if g is not None:
                g.set(z)
        if not tripped:
            self._streak = 0
            self._streak_start = None
            self._first_trip_t = None
            return None
        if self._streak == 0:
            self._streak_start = (int(epoch), int(step))
            self._first_trip_t = time.monotonic()
        self._streak += 1
        self._note_anomaly(kind, z=z, epoch=epoch, step=step,
                           global_step=global_step, value=value)
        if self._streak >= self.rewind_after:
            return "rewind"
        return "anomaly"

    def _note_anomaly(self, kind, z=None, epoch=None, step=None,
                      global_step=None, value=None):
        self.anomalies[kind] = self.anomalies.get(kind, 0) + 1
        c = _metrics.counter("train_anomalies_total", kind=kind)
        if c is not None:
            c.inc()
        extra = {"kind": kind}
        if z is not None and np.isfinite(z):
            extra["z"] = round(float(z), 3)
        if epoch is not None:
            extra["epoch"] = int(epoch)
        if step is not None:
            extra["step"] = int(step)
        _fr.record_complete(_fr.record_issue(
            "integrity_anomaly", group="step", extra=extra))
        if self.verbose:
            print(f"INTEGRITY_ANOMALY kind={kind} z={z} value={value} "
                  f"epoch={epoch} step={step} global_step={global_step}",
                  flush=True)

    # --------------------------------------------------------- rank blame
    def on_mismatch(self, err, epoch, step):
        """A :class:`GradFingerprintMismatch` surfaced from backward:
        strike every blamed rank, count the anomaly, and authorize a redo
        of the step (parameters are untouched — the mismatch raised
        before writeback). Past ``max_redos`` for the same step the
        corruption is persistent, not transient: escalate."""
        for r in err.blamed:
            self.blames[r] = self.blames.get(r, 0) + 1
            c = _metrics.counter("integrity_blames_total", rank=str(r))
            if c is not None:
                c.inc()
            struck = quarantined = False
            if self.quarantine is not None:
                quarantined = self.quarantine.record_failure(f"rank{r}")
                struck = True
            if self.verbose:
                print(f"INTEGRITY_BLAME rank={r} bucket={err.bucket} "
                      f"strikes={self.blames[r]} struck={struck} "
                      f"quarantined={quarantined}", flush=True)
        self._note_anomaly("grad_bitflip", epoch=epoch, step=step)
        key = (int(epoch), int(step))
        if key != self._redo_key:
            self._redo_key, self._redo_n = key, 0
        self._redo_n += 1
        if self._redo_n > self.max_redos:
            raise IntegrityError(
                f"step (epoch {epoch}, step {step}) failed fingerprint "
                f"verification {self._redo_n} times (max_redos="
                f"{self.max_redos}): corruption is persistent, "
                f"not transient") from err
        if self.verbose:
            print(f"INTEGRITY_REDO epoch={epoch} step={step} "
                  f"n={self._redo_n}", flush=True)

    # ------------------------------------------------------------- rewind
    def rewind(self, rt, epoch, step):
        """Restore the newest lineage snapshot in-process and register the
        anomalous batch window as skipped. Returns the restored global
        step; the caller restarts its epoch loop from ``rt``'s state."""
        if rt is None:
            raise IntegrityError(
                f"sustained loss anomaly at epoch {epoch} step {step} "
                f"({self._streak} consecutive trips) and no lineage to "
                "rewind to — pass lineage= alongside integrity= to "
                "enable rewind-and-skip")
        if self.rewinds >= self.max_rewinds:
            raise IntegrityError(
                f"sustained loss anomaly at epoch {epoch} step {step} "
                f"survived {self.rewinds} rewind-and-skip attempts "
                f"(max_rewinds={self.max_rewinds})")
        e0, s0 = self._streak_start or (int(epoch), int(step))
        last = int(step) if int(epoch) == e0 else sys.maxsize
        self.rewinds += 1
        c = _metrics.counter("train_rewinds_total")
        if c is not None:
            c.inc()
        global_step = rt.rewind(skip_window=(e0, s0, last))
        detect_s = (time.monotonic() - self._first_trip_t
                    if self._first_trip_t is not None else 0.0)
        self.last_rewind_detect_s = detect_s
        _fr.record_complete(_fr.record_issue(
            "integrity_rewind", group="step",
            extra={"n": self.rewinds, "to_step": int(global_step),
                   "skip": [e0, s0, last]}))
        if self.verbose:
            print(f"INTEGRITY_REWIND n={self.rewinds} "
                  f"to_step={global_step} skip=({e0},{s0},{last}) "
                  f"detect_s={detect_s:.3f}", flush=True)
        self.mad.reset()
        self._streak = 0
        self._streak_start = None
        self._first_trip_t = None
        return global_step

    # ---------------------------------------------------- fault enactment
    def maybe_poison(self, y):
        """Enact ``loss_spike@batch``: scale this batch's labels so the
        step genuinely corrupts (the gate must then catch it and the
        rewind replay must excise the window). Guard-gated on purpose —
        with ``integrity=None`` the fit loop never calls this, keeping
        the disabled path structurally untouched."""
        if _fault.maybe_inject("batch") == "loss_spike":
            scale = float(os.environ.get(
                "PADDLE_TPU_FAULT_SPIKE_SCALE", "1000"))
            if self.verbose:
                print(f"INTEGRITY_POISON scale={scale}", flush=True)
            return y * scale
        return y


def make_guard(integrity):
    """Normalize the fit loops' ``integrity=`` argument: None/False → no
    guard; True → defaults; a dict → knobs; a ready guard passes
    through."""
    if integrity is None or integrity is False:
        return None
    if integrity is True:
        return TrainingGuard()
    if isinstance(integrity, dict):
        return TrainingGuard(**integrity)
    if isinstance(integrity, TrainingGuard):
        return integrity
    raise TypeError(
        "integrity= expects None, True, a dict of TrainingGuard knobs, "
        f"or a TrainingGuard instance — got {type(integrity).__name__}")
