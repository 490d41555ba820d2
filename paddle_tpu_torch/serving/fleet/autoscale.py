"""Elastic autoscaling — the serving fleet grows and shrinks itself.

The port of ``paddle_tpu/serving/fleet/autoscale.py`` (host Python): the
engines are elastic control-plane members, as training hosts are under
``elastic.ElasticManager``:

* **SLO-driven scaling** — each ``tick()`` reads the router's own
  signals (per-engine queue depth blended with the router's
  unacknowledged in-flight count, plus the oldest in-flight request's
  TTFT/ITL stall age) and scales UP when the fleet is behind its SLO,
  DOWN when it has been idle — inside ``min_engines`` / ``max_engines``;
* **hysteresis + cooldown** — a decision needs the signal to hold for
  ``up_ticks``/``down_ticks`` consecutive ticks AND ``cooldown_s`` since
  the last scale event, so an arrival burst's edge cannot flap the
  roster (scale-up reacts faster than scale-down on purpose);
* **warm-spare admission** — a new engine is built by the caller's
  ``spawn(engine_id)`` factory, ``warm_ragged()``-captured and
  ``start()``-ed BEFORE it enters the router's rotation, so its first
  request never pays the capture;
* **death → quarantine → replacement** — a crashed engine (serve-loop
  error, lost heartbeat) is struck into the fleet's
  :class:`~paddle_tpu_torch.distributed.elastic.QuarantineList`, reaped
  from the rotation (its legs already re-dispatched through
  ``on_done``), and — when the live count fell below ``min_engines`` —
  replaced at once, skipping hysteresis. Quarantined ids are never
  reused within the strike window;
* **membership survives failover** — the quarantine ledger and the
  roster epoch persist through the :class:`~.registry.EngineRegistry`
  under registry-scope keys, which ride the FailoverStore WAL;
* **hedging rides the tick** — ``tick()`` drives
  ``router.hedge_sweep()``, so one periodic thread serves both loops.

``start()`` runs the loop on a daemon thread at ``interval_s``; tests
call ``tick(now=...)`` directly.
"""
from __future__ import annotations

import threading
import time

from ...distributed.elastic import QuarantineList
from ...observability import tracing as _trc

__all__ = ["EngineAutoscaler"]


class EngineAutoscaler:
    """SLO feedback loop over a :class:`~.router.FleetRouter` roster."""

    def __init__(self, router, spawn, min_engines=1, max_engines=4,
                 registry=None, quarantine=None, id_prefix="a",
                 queue_high=6.0, queue_low=0.5, ttft_slo_s=None,
                 up_ticks=2, down_ticks=6, cooldown_s=3.0,
                 interval_s=0.5, warm=True):
        self.router = router
        self.spawn = spawn                  # engine_id -> ServingEngine
        self.min_engines = int(min_engines)
        self.max_engines = int(max_engines)
        self.registry = registry
        # threshold=1: a serve-loop crash is terminal for an engine
        # process (unlike a flaky training host, there is no transient
        # NIC blip to forgive) — one strike benches it for the window
        self.quarantine = quarantine if quarantine is not None \
            else QuarantineList(threshold=1)
        if registry is not None:
            # membership survives store failover: adopt whatever ledger
            # an earlier incarnation (or the pre-failover primary)
            # persisted before making any admission decision
            registry.load_quarantine(self.quarantine)
        self.id_prefix = str(id_prefix)
        # per-engine average of max(reported load, router pending) above
        # which the fleet is behind; below queue_low it is idle
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        # oldest in-flight stall (no first token yet, or no token since)
        # that counts as an SLO breach regardless of queue depth
        self.ttft_slo_s = None if ttft_slo_s is None else float(ttft_slo_s)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self.warm = bool(warm)
        self.events = []                    # scale-event log (tests, callers)
        self.epoch = 0                      # bumps on every roster change
        self.spawn_failures = 0
        self._hi = 0                        # consecutive over-SLO ticks
        self._lo = 0                        # consecutive idle ticks
        self._last_scale = None             # perf_counter of last event
        self._next_id = 0
        self._struck = set()                # dead ids already blamed
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------ signals
    def _roster(self):
        """-> (healthy handles, dead engine ids)."""
        live, dead = [], []
        for eid, h in self.router.handles().items():
            try:
                ok = h.healthy()
            except Exception:
                ok = False
            (live if ok else dead).append(h if ok else eid)
        return live, dead

    def _pressure(self, live):
        """Per-engine average of the router's blended load signal."""
        if not live:
            return float("inf")             # zero capacity IS pressure
        total = 0.0
        for h in live:
            try:
                total += max(h.load(), h.pending)
            except Exception:
                total += h.pending
        return total / len(live)

    def _worst_stall_s(self, now):
        """Age of the most-stalled in-flight request: time since its
        last token (TTFT counts from submit) — the router-observed
        ITL/TTFT tail without per-request histogram plumbing."""
        with self.router._lock:
            frs = list(self.router._inflight.values())
        worst = 0.0
        for fr in frs:
            if fr.done():
                continue
            last = fr.token_times[-1] if fr.token_times else fr.t_submit
            worst = max(worst, now - last)
        return worst

    # ----------------------------------------------------------- lifecycle
    def _strike(self, eid):
        """Blame one dead engine: quarantine strike + reap + persist."""
        if eid in self._struck:
            return
        self._struck.add(eid)
        self.quarantine.record_failure(eid)
        self.router.drop_engine(eid)
        if self.registry is not None:
            try:
                self.registry.save_quarantine(self.quarantine)
            except Exception:
                pass

    def _pick_engine_id(self):
        """Next roster id, skipping live engines AND quarantined ids —
        a struck-out engine must not be re-admitted inside its window."""
        handles = self.router.handles()
        while True:
            eid = f"{self.id_prefix}{self._next_id}"
            self._next_id += 1
            if eid in handles or eid in self._struck \
                    or self.quarantine.is_quarantined(eid):
                continue
            return eid

    def _record_event(self, direction, eid, n_after, now):
        self.epoch += 1
        self._last_scale = now
        ev = {"t": time.time(), "dir": direction, "engine": eid,
              "n_engines": n_after, "epoch": self.epoch}
        self.events.append(ev)
        self.router.metrics.on_scale_event(direction, n_after)
        # fleet-lane trace mark: scale events land in the SAME merged
        # timeline as the request waterfalls, so "p99 spiked here"
        # lines up with "the roster shrank here" (no-op when off)
        _trc.add_complete(f"scale_{direction}", ev["t"], 0.0,
                          cat="fleet", args={"engine": eid,
                                             "n_engines": n_after})
        if self.registry is not None:
            try:
                self.registry.save_autoscale(
                    {"epoch": self.epoch, "n_engines": n_after,
                     "events": self.events[-16:]})
            except Exception:
                pass

    def scale_up(self, now=None):
        """Admit one warm spare. -> engine_id or None (at max / spawn
        failed / no id available)."""
        now = time.perf_counter() if now is None else now
        live, _ = self._roster()
        if len(live) >= self.max_engines:
            return None
        eid = self._pick_engine_id()
        try:
            engine = self.spawn(eid)
            if self.warm:
                # warm-spare admission: capture BEFORE rotation, so the
                # new engine's first real request never pays it
                try:
                    engine.warm_ragged()
                except Exception:
                    pass
            engine.start()
        except Exception:
            self.spawn_failures += 1
            return None
        self.router.add_engine(engine, engine_id=eid)
        self._record_event("up", eid, len(live) + 1, now)
        return eid

    def scale_down(self, now=None):
        """Drain the least-loaded engine out of rotation (its in-flight
        requests migrate). -> engine_id or None."""
        now = time.perf_counter() if now is None else now
        live, _ = self._roster()
        if len(live) <= self.min_engines:
            return None
        victim = min(live, key=lambda h: (max(h.load(), h.pending),
                                          h.engine_id))
        try:
            self.router.remove_engine(victim.engine_id, migrate=True)
        except Exception:
            return None
        self.router.drop_engine(victim.engine_id)
        self._record_event("down", victim.engine_id, len(live) - 1, now)
        return victim.engine_id

    # ---------------------------------------------------------------- tick
    def tick(self, now=None):
        """One control-loop pass. Returns the scale action taken
        ("up"/"down"/None). Deterministic under an injected ``now``."""
        now = time.perf_counter() if now is None else now
        self.router.hedge_sweep(now=now)
        live, dead = self._roster()
        for eid in dead:
            self._strike(eid)
        if dead:
            live, _ = self._roster()
        # death replacement skips hysteresis: running BELOW min_engines
        # is an availability hole, not a load trend to be smoothed
        if len(live) < self.min_engines:
            return "up" if self.scale_up(now=now) else None
        in_cooldown = self._last_scale is not None \
            and now - self._last_scale < self.cooldown_s
        pressure = self._pressure(live)
        stalled = self.ttft_slo_s is not None \
            and self._worst_stall_s(now) > self.ttft_slo_s
        if pressure > self.queue_high or stalled:
            self._hi += 1
            self._lo = 0
            if self._hi >= self.up_ticks and not in_cooldown:
                self._hi = 0
                return "up" if self.scale_up(now=now) else None
        elif pressure < self.queue_low:
            self._lo += 1
            self._hi = 0
            if self._lo >= self.down_ticks and not in_cooldown:
                self._lo = 0
                return "down" if self.scale_down(now=now) else None
        else:
            self._hi = 0
            self._lo = 0
        return None

    # ------------------------------------------------------------- thread
    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-autoscale")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                pass  # one bad tick must not kill the control loop

    def close(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
