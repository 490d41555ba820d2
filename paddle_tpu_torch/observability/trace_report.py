"""Per-request latency attribution from exported request traces.

The port of ``paddle_tpu/observability/trace_report.py`` (stdlib only):
:mod:`.tracing` stamps every lifecycle phase of a served request into the
per-process Chrome-trace JSON; this module folds those span streams back
into a per-request table — which phase took the latency — and renders the
top-N slowest as a text waterfall:

* one row per trace id, with the per-phase milliseconds summed from the
  spans: ``queue_wait``, ``prefill`` (chunk spans summed when the rollup
  span is absent), ``decode``, ``route``, ``ledger``, ``migrate``;
* attribution flags folded from the instant events: ``hedged`` /
  ``hedge_won`` / ``hedge_lost``, ``evicted`` / ``readmit``,
  ``prefix_hit``, ``migrated``, ``error``;
* ``procs`` — how many processes contributed spans.

Also a CLI::

    python -m paddle_tpu_torch.observability.trace_report \
        <dir-or-json...> [--top N] [--json]

Accepts directories (every ``trace*.json`` / ``merged*.json`` under them)
or explicit trace files; the same event found in a per-process file and
in a merged copy counts once.
"""
from __future__ import annotations

import glob
import json
import os
import sys

__all__ = ["load_events", "build_request_rows", "rows_to_report",
           "format_request_rows", "main"]

# span name -> phase column (durations are summed per request)
_PHASE_OF = {"queue_wait": "queue_wait",
             "prefill": "prefill",
             "prefill_chunk": "prefill_chunk",
             "decode": "decode",
             "route": "route",
             "ledger_accept": "ledger",
             "client_submit": "client",
             "kv_migrate": "migrate"}

# instant-event name -> attribution flag
_FLAG_OF = {"hedge_fired": "hedged",
            "hedge_won": "hedge_won",
            "hedge_lost": "hedge_lost",
            "evicted": "evicted",
            "readmit": "readmit",
            "prefix_hit": "prefix_hit",
            "kv_migrate": "migrated",
            "ledger_replay": "replayed"}

_PHASE_COLS = ("queue_wait", "prefill", "decode", "route", "migrate")


def load_events(*sources):
    """Flatten trace events from files and/or directories. Directories
    contribute every ``trace*.json``/``merged*.json`` under them; torn
    or non-trace JSON files are skipped, not fatal."""
    paths = []
    for src in sources:
        if os.path.isdir(src):
            for pat in ("trace*.json", "merged*.json", "*.trace.json"):
                paths.extend(sorted(glob.glob(os.path.join(src, pat))))
        else:
            paths.append(src)
    events = []
    for p in dict.fromkeys(paths):    # de-dup, keep order
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        evs = doc.get("traceEvents") if isinstance(doc, dict) else None
        if isinstance(evs, list):
            events.extend(e for e in evs if isinstance(e, dict))
    return events


def build_request_rows(events):
    """-> {trace_id: row} folded from the request-lane events (those
    carrying ``args.trace``). Durations in ms; ``e2e_ms`` spans the
    earliest event start to the latest event end, which across merged
    processes is the client-visible wall time (one shared wall clock —
    the tracer's deliberate clock-domain choice)."""
    rows = {}
    seen = set()
    for ev in events:
        args = ev.get("args")
        tid = args.get("trace") if isinstance(args, dict) else None
        if tid is None:
            continue
        ts = float(ev.get("ts", 0.0))          # µs wall
        dur = float(ev.get("dur", 0.0) or 0.0)
        # a directory often holds BOTH the per-process trace.N.json files
        # and a merged copy built from them — the same event twice,
        # differing only in pid (a merge rewrites it). De-dup on
        # everything BUT pid, else every phase sum doubles.
        key = (ev.get("name"), ts, dur,
               str(sorted(args.items(), key=repr)))
        if key in seen:
            continue
        seen.add(key)
        row = rows.get(tid)
        if row is None:
            row = rows[tid] = {"trace": str(tid), "t0_us": ts,
                               "t1_us": ts + dur, "phases": {},
                               "flags": set(), "procs": set(),
                               "events": 0, "tokens": 0}
        row["events"] += 1
        row["t0_us"] = min(row["t0_us"], ts)
        row["t1_us"] = max(row["t1_us"], ts + dur)
        row["procs"].add(ev.get("pid"))
        name = ev.get("name")
        phase = _PHASE_OF.get(name)
        if phase is not None and dur > 0:
            row["phases"][phase] = row["phases"].get(phase, 0.0) \
                + dur / 1e3
        flag = _FLAG_OF.get(name)
        if flag is not None:
            row["flags"].add(flag)
        if name == "stream_token":
            row["tokens"] += 1
        elif name in ("request_done", "fleet_done"):
            state = args.get("state")
            if state == "failed":
                row["flags"].add("error")
            if name == "fleet_done" and args.get("hedged"):
                row["flags"].add("hedged")
    for row in rows.values():
        ph = row["phases"]
        # the rollup prefill span wins; chunk spans are the fallback
        # (chunked prefill overlaps decode rounds — summing BOTH would
        # double-count the prefill wall time)
        if "prefill" not in ph and "prefill_chunk" in ph:
            ph["prefill"] = ph["prefill_chunk"]
        ph.pop("prefill_chunk", None)
        row["e2e_ms"] = (row["t1_us"] - row["t0_us"]) / 1e3
        row["procs"] = len(row["procs"])
        row["flags"] = sorted(row["flags"])
    return rows


def rows_to_report(rows, top=10):
    """Top-N slowest as a JSON-friendly list."""
    ordered = sorted(rows.values(), key=lambda r: -r["e2e_ms"])[:top]
    out = []
    for r in ordered:
        rec = {"trace": r["trace"],
               "e2e_ms": round(r["e2e_ms"], 3),
               "procs": r["procs"], "events": r["events"],
               "tokens": r["tokens"], "flags": r["flags"]}
        for c in _PHASE_COLS:
            v = r["phases"].get(c)
            if v is not None:
                rec[f"{c}_ms"] = round(v, 3)
        out.append(rec)
    return out


def format_request_rows(rows, top=10):
    """Text waterfall table of the top-N slowest requests; None when
    there is nothing to say."""
    recs = rows_to_report(rows, top=top)
    if not recs:
        return None
    lines = [f"[trace] slowest {len(recs)} of {len(rows)} request(s) "
             "(phase ms):"]
    lines.append("[trace]   %-18s %9s %6s %8s %8s %8s %7s %s" % (
        "trace", "e2e", "queue", "prefill", "decode", "route",
        "procs", "flags"))

    def _f(v):
        return "-" if v is None else f"{v:.1f}"

    for r in recs:
        lines.append("[trace]   %-18s %9s %6s %8s %8s %8s %7d %s" % (
            r["trace"][:18], _f(r["e2e_ms"]), _f(r.get("queue_wait_ms")),
            _f(r.get("prefill_ms")), _f(r.get("decode_ms")),
            _f(r.get("route_ms")), r["procs"],
            ",".join(r["flags"]) or "-"))
    return "\n".join(lines)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m paddle_tpu_torch.observability."
              "trace_report "
              "<dir-or-json...> [--top N] [--json]", file=sys.stderr)
        return 2
    top = 10
    as_json = False
    sources = []
    it = iter(argv)
    for a in it:
        if a == "--top":
            top = int(next(it, "10"))
        elif a == "--json":
            as_json = True
        else:
            sources.append(a)
    rows = build_request_rows(load_events(*sources))
    if as_json:
        print(json.dumps(rows_to_report(rows, top=top), indent=1))
        return 0
    text = format_request_rows(rows, top=top)
    if text is None:
        print(f"[trace] no request events under {' '.join(sources)}",
              file=sys.stderr)
        return 1
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
