"""The port's durable front door against the JAX package's, on the CPU.

Each test mirrors the non-slow test of ``tests/test_router_failover.py``
it names (the request ledger, exactly-once resubmission, the router
lease's fence, a shadow's adoption): the same scenario runs once in each
package on the same ``gpt_tiny`` weights, the JAX test's assertions hold
in both, and the two runs agree exactly on the tokens, the router's
counters (dispatched, replays, attachments, adoptions) and the ledger's
records. The helpers, the weights and the autouse reset of both
packages' process-wide state are ``tests/test_torch_port_fleet.py``'s.
"""
import threading
import time

import pytest

from test_torch_port_fleet import (  # noqa: F401  (fixtures used by name)
    _both, _engine, _free_port, _process_state, _solo, _store, models)


def _record(rec):
    """A ledger record without what differs by run: its trace, its queue
    wait (a time) and its local leg's id (a process-wide counter; whether
    it names a leg is kept)."""
    out = {k: v for k, v in rec.items()
           if k not in ("trace", "queue_wait_s", "leg_rid")}
    if "leg_rid" in rec:
        out["leg_rid"] = rec["leg_rid"] is not None
    return out


def test_exactly_once_terminal_replay_and_inflight_attach(models):
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        led = P.fleet.RequestLedger(_store(P, port), job="t17a")
        eng = _engine(P, engine_id="e0")
        r = P.fleet.FleetRouter(ledger=led)
        r.add_engine(eng, "e0")
        fr = r.submit([5, 6, 7, 8], max_new_tokens=4, request_id="rq-1")
        while not fr.done():
            eng.step()
        out = fr.result(10)
        rec = led.lookup("rq-1")
        assert rec["state"] == "done"
        dispatched_before = r.dispatched
        stream = []
        fr2 = r.submit([5, 6, 7, 8], max_new_tokens=4, request_id="rq-1",
                       on_token=lambda q, t, fin: stream.append((t, fin)))
        assert fr2.done() and fr2.result(1) == out and fr2 is not fr
        assert [t for t, _ in stream] == out
        assert [f for _, f in stream] == [False] * 3 + [True]
        assert r.dispatched == dispatched_before
        assert r.requests_replayed == 1
        fr3 = r.submit([9, 8, 7, 6], max_new_tokens=6, request_id="rq-2")
        assert not fr3.done()
        fr4 = r.submit([9, 8, 7, 6], max_new_tokens=6, request_id="rq-2")
        assert fr4 is fr3 and r.requests_attached == 1
        while not fr3.done():
            eng.step()
        out3 = fr3.result(10)
        assert len(out3) == 6
        eng.close()
        st = r.stats()
        got = (out, out3, stream, _record(rec),
               _record(led.lookup("rq-2")), led.rids(),
               {k: st[k] for k in ("dispatched", "requests_replayed",
                                   "requests_attached", "inflight")})
        del master
        return got
    _both(models, sc)


def test_ledger_records_survive_store_failover():
    def sc(P):
        FleetRequest = P.fleet.FleetRequest
        p1, p2 = _free_port(), _free_port()
        prim = _store(P, p1, is_master=True, timeout=15)
        standby = _store(P, p2, is_master=True, timeout=15)
        fs = P.dist.FailoverStore(f"127.0.0.1:{p1},127.0.0.1:{p2}",
                                  timeout=15, connect_deadline=2.0)
        sh = P.dist.LogShipper(f"127.0.0.1:{p1}", f"127.0.0.1:{p2}",
                               timeout=15)
        led = P.fleet.RequestLedger(fs, job="t17b")
        done_fr = FleetRequest([1, 2, 3], max_new_tokens=3,
                               request_id="done-1")
        led.accept(done_fr)
        done_fr.generated = [11, 12, 13]
        done_fr.engine_id = "e0"
        done_fr.engine_ids = ["e0"]
        done_fr._finish(None)
        led.terminal(done_fr)
        live_fr = FleetRequest([4, 5, 6], max_new_tokens=4,
                               request_id="live-1")
        led.accept(live_fr)
        live_fr.generated = [21, 22]
        led.dispatched(live_fr, "e0", leg_rid="w-9")
        assert sh.ship_once() > 0
        prim.stop_server()
        led2 = P.fleet.RequestLedger(_store(P, p2, timeout=15),
                                     job="t17b")
        assert led2.rids() == ["done-1", "live-1"]
        rec = led2.lookup("live-1")
        assert rec["state"] == "dispatched" and rec["leg_rid"] == "w-9"
        assert rec["tokens"] == [21, 22] and rec["cursor"] == 2
        inflight = led2.inflight_records()
        assert [x["rid"] for x in inflight] == ["live-1"]
        r = P.fleet.FleetRouter(ledger=led2)
        fr = r.submit([1, 2, 3], max_new_tokens=3, request_id="done-1")
        assert fr.done() and fr.result(1) == [11, 12, 13]
        assert r.dispatched == 0
        got = (_record(rec), _record(led2.lookup("done-1")),
               fr.engine_ids, r.requests_replayed)
        standby.stop_server()
        return got
    _both((None, None), sc)


def test_router_lease_term_fence_deposes_old_router(models):
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        led = P.fleet.RequestLedger(_store(P, port), job="t17c")
        lease = P.fleet.RouterLease(_store(P, port), job="t17c", ttl=0.2)
        assert lease.acquire() == 1
        eng = _engine(P, engine_id="e0")
        r = P.fleet.FleetRouter(ledger=led, lease=lease)
        r.add_engine(eng, "e0")
        fr = r.submit([5, 6, 7], max_new_tokens=2, request_id="pre")
        while not fr.done():
            eng.step()
        out = fr.result(10)
        assert len(out) == 2
        shadow = P.fleet.RouterLease(_store(P, port), job="t17c", ttl=0.2)
        assert shadow.adopt() == 2
        time.sleep(0.1)
        with pytest.raises(P.fleet.RouterDeposedError):
            r.submit([5, 6, 7], max_new_tokens=2, request_id="post")
        assert r.stats()["fenced"] is True
        with pytest.raises(P.fleet.RouterDeposedError):
            r.submit([5, 6, 7], max_new_tokens=2, request_id="pre")
        eng.close()
        got = out, lease.term, shadow.term, shadow.read()["term"], \
            led.rids()
        del master
        return got
    _both(models, sc)


def test_shadow_adopts_inflight_from_ledger_local(models):
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        eng = _engine(P, engine_id="e0")
        base = _solo(P, [7, 6, 5, 4], 6, engine_id="solo")
        led1 = P.fleet.RequestLedger(_store(P, port), job="t17d")
        r1 = P.fleet.FleetRouter(ledger=led1)
        r1.add_engine(eng, "e0")
        fr1 = r1.submit([7, 6, 5, 4], max_new_tokens=6,
                        request_id="mid-1")
        while len(fr1.generated) < 3:
            eng.step()
        r1.ledger_sweep()
        rec = led1.lookup("mid-1")
        assert rec["state"] == "streaming" and rec["cursor"] >= 3
        cursor = rec["cursor"]
        led2 = P.fleet.RequestLedger(_store(P, port), job="t17d")
        r2 = P.fleet.FleetRouter(ledger=led2)
        r2.add_engine(eng, "e0")
        tail = []
        fr2 = r2.submit([7, 6, 5, 4], max_new_tokens=6, request_id="mid-1",
                        on_token=lambda q, t, fin: tail.append(t))
        assert r2.requests_adopted == 1 and fr2 is not fr1
        while not fr2.done():
            eng.step()
        out = fr2.result(10)
        assert out == base
        assert tail == base[cursor:]
        final = led2.lookup("mid-1")
        assert final["state"] == "done"
        eng.close()
        del master
        return base, cursor, tail, _record(rec), _record(final)
    _both(models, sc)


def test_adopt_redispatches_when_engine_died_too(models):
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        base = _solo(P, [3, 1, 4, 1], 6, engine_id="solo")
        led = P.fleet.RequestLedger(_store(P, port), job="t17e")
        ghost = P.fleet.FleetRequest([3, 1, 4, 1], max_new_tokens=6,
                                     request_id="orphan-1")
        led.accept(ghost)
        ghost.generated = list(base[:2])
        led.dispatched(ghost, "gone", leg_rid="w-dead")
        eng = _engine(P, engine_id="e0")
        r = P.fleet.FleetRouter(ledger=led)
        r.add_engine(eng, "e0")
        assert r.adopt_from_ledger() == 1
        fr = r.submit([3, 1, 4, 1], max_new_tokens=6,
                      request_id="orphan-1")
        while not fr.done():
            eng.step()
        assert fr.result(10) == base
        assert fr.engine_ids[-1] == "e0"
        eng.close()
        got = (base, fr.engine_ids, _record(led.lookup("orphan-1")),
               r.requests_adopted, r.requests_attached)
        del master
        return got
    _both(models, sc)


def test_remote_reattach_defers_poll_until_attached(models):
    def sc(P):
        port = _free_port()
        master = _store(P, port, is_master=True)
        eng = _engine(P, engine_id="e0", max_queue=8)
        base = eng.generate([6, 5, 4, 3], max_new_tokens=6)
        t = threading.Thread(target=P.fleet.serve_over_store,
                             args=(eng, _store(P, port), "e0"),
                             kwargs={"job": "t17g", "poll_s": 0.01},
                             daemon=True)
        t.start()
        led1 = P.fleet.RequestLedger(_store(P, port), job="t17g")
        h1 = P.fleet.RemoteEngineHandle(lambda: _store(P, port), "e0",
                                        job="t17g", poll_s=0.01)
        r1 = P.fleet.FleetRouter(ledger=led1)
        r1.add_engine(None, handle=h1)
        r1.page_size = 4
        r1.submit([6, 5, 4, 3], max_new_tokens=6, request_id="ra-1")
        deadline = time.time() + 30
        while not eng.scheduler.has_work() and time.time() < deadline:
            time.sleep(0.01)
        assert eng.scheduler.has_work()
        h1.detach()
        rec = led1.lookup("ra-1")
        assert rec["state"] == "dispatched" and rec["cursor"] == 0
        eng.start()
        rp = P.keyspace.fleet_engine_rpc("t17g", "e0")
        deadline = time.time() + 60
        while int(master.add(f"{rp}/out_seq", 0)) < 1 \
                and time.time() < deadline:
            time.sleep(0.01)
        sp = P.keyspace.fleet_engine_stream("t17g", "e0")
        assert int(master.add(f"{rp}/out_seq", 0)) >= 1
        assert int(master.add(f"{sp}/tok_seq", 0)) >= 1
        led2 = P.fleet.RequestLedger(_store(P, port), job="t17g")
        h2 = P.fleet.RemoteEngineHandle(lambda: _store(P, port), "e0",
                                        job="t17g", poll_s=0.01,
                                        defer_poll=True)
        r2 = P.fleet.FleetRouter(ledger=led2)
        r2.add_engine(None, handle=h2)
        r2.page_size = 4
        assert r2.adopt_from_ledger() == 1
        h2.start_polling()
        fr2 = r2.submit([6, 5, 4, 3], max_new_tokens=6, request_id="ra-1")
        out = fr2.result(60)
        assert out == base
        final = led2.lookup("ra-1")
        assert final["state"] == "done"
        master.set(f"{P.keyspace.fleet_registry('t17g')}/stop", b"1")
        t.join(10)
        h2.detach()
        eng.close()
        del master
        return (base, out, final["tokens"], final["state"],
                r2.requests_adopted, r2.requests_attached)
    _both(models, sc)
