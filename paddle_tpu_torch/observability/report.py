"""Cross-rank run report — the launcher's performance post-mortem: the
port's copy of ``paddle_tpu/observability/report.py`` (the same report
and text, its integrity section included).

Reads the per-rank ``metrics.<rank>.jsonl`` snapshot files the metrics
registry writes into the workerlog dir and renders a one-screen report:
per-rank step time / data wait / tokens/sec / MFU, the slowest rank (and
how many snapshot windows each rank was the straggler of — a rank that is
slowest in every window is degrading hardware, one that is slowest once
hit a GC pause), p50/p99 per-collective latency and the comm/compute
ratio. The launcher prints it at round end AND from the failure
post-mortem path.

Also a CLI::

    python -m paddle_tpu_torch.observability.report <log_dir>

Stdlib-only.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from .metrics import hist_mean, hist_quantile, parse_metric_key

__all__ = ["read_rank_snapshots", "build_run_report", "format_run_report",
           "main"]


def read_rank_snapshots(log_dir):
    """-> {rank: [snapshot dict, ...]} from metrics.*.jsonl under
    ``log_dir`` (unparseable lines are skipped, not fatal: a worker
    killed mid-write leaves a torn last line)."""
    out = {}
    for p in sorted(glob.glob(os.path.join(log_dir, "metrics.*.jsonl"))):
        try:
            rank = int(os.path.basename(p).split(".")[1])
        except (IndexError, ValueError):
            continue
        snaps = []
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        snaps.append(json.loads(line))
                    except ValueError:
                        pass
        except OSError:
            continue
        if snaps:
            out[rank] = snaps
    return out


def _merge_hist(a, b):
    if a is None:
        return dict(b)
    if list(a.get("bounds", [])) != list(b.get("bounds", [])):
        return a  # mismatched layouts: keep the first
    a["counts"] = [x + y for x, y in zip(a["counts"], b["counts"])]
    a["count"] = a.get("count", 0) + b.get("count", 0)
    a["sum"] = a.get("sum", 0.0) + b.get("sum", 0.0)
    for k, f in (("min", min), ("max", max)):
        if b.get(k) is not None:
            a[k] = b[k] if a.get(k) is None else f(a[k], b[k])
    return a


def _hist_delta(new, old):
    """Window histogram between two cumulative snapshots of one rank."""
    if old is None:
        return dict(new)
    if list(new.get("bounds", [])) != list(old.get("bounds", [])):
        return dict(new)
    return {"bounds": new["bounds"],
            "counts": [n - o for n, o in zip(new["counts"],
                                            old["counts"])],
            "count": new.get("count", 0) - old.get("count", 0),
            "sum": new.get("sum", 0.0) - old.get("sum", 0.0),
            "min": new.get("min"), "max": new.get("max")}


def _bucket_windows(rank_windows, default_width_s=10.0):
    """Align per-rank (ts, mean-step-ms) windows into wall-clock buckets:
    ``{bucket_index: {rank: mean}}``. Bucket width = the median
    inter-snapshot interval across all ranks (falling back to the 10s
    default flush interval), anchored at the earliest snapshot. Two
    windows of one rank landing in the same bucket (an extra step-count
    flush) are averaged, and a rank that flushed late simply lands in the
    later bucket instead of shifting every subsequent comparison."""
    deltas = []
    all_ts = []
    for wins in rank_windows.values():
        all_ts.extend(ts for ts, _ in wins)
        deltas.extend(b - a for (a, _), (b, _) in zip(wins, wins[1:])
                      if b > a)
    if not all_ts:
        return {}
    if deltas:
        deltas.sort()
        width = deltas[len(deltas) // 2]
    else:
        width = default_width_s
    width = max(width, 1e-3)
    t0 = min(all_ts)
    acc = {}   # bucket -> rank -> [sum, count]
    for rank, wins in rank_windows.items():
        for ts, m in wins:
            b = int((ts - t0) / width + 0.5)
            cell = acc.setdefault(b, {}).setdefault(rank, [0.0, 0])
            cell[0] += m
            cell[1] += 1
    return {b: {r: s / c for r, (s, c) in by_rank.items()}
            for b, by_rank in acc.items()}


def build_run_report(per_rank):
    """Aggregate per-rank snapshot lists into one report dict."""
    ranks = {}
    collectives = {}
    serving_hists = {}     # (engine, name) -> merged histogram
    serving_phases = {}    # (engine, phase) -> merged histogram
    serving_scalars = {}   # engine -> {row: value} (counters + gauges)
    integrity = {}         # anomalies by kind / rewinds / blamed ranks
    rank_windows = {}
    compute_ms_total = 0.0
    comm_us_total = 0.0
    overlap_pcts = []
    overlap_sources = set()
    for rank, snaps in sorted(per_rank.items()):
        last = snaps[-1]
        hists = last.get("histograms", {})
        gauges = last.get("gauges", {})
        counters = last.get("counters", {})
        st = hists.get("step_time_ms")
        row = {"snapshots": len(snaps),
               "steps": counters.get("steps_total", 0)}
        if st:
            row["step_ms_mean"] = hist_mean(st)
            row["step_ms_p50"] = hist_quantile(st, 0.5)
            row["step_ms_p99"] = hist_quantile(st, 0.99)
        dw = hists.get("data_wait_ms")
        if dw:
            row["data_wait_ms_mean"] = hist_mean(dw)
        cm = hists.get("compute_ms")
        if cm:
            compute_ms_total += cm.get("sum", 0.0)
        for key in ("tokens_per_sec", "mfu_pct"):
            if key in gauges:
                row[key] = gauges[key]
        if "comm_overlap_pct" in gauges:
            overlap_pcts.append(gauges["comm_overlap_pct"])
            # provenance: the overlap engine feeds the gauge in-run from
            # flight-recorder issue/wait stamps (counters present); the
            # bench xplane leg sets the bare gauge from a device trace
            if "comm_inflight_us_total" in counters:
                overlap_sources.add("in-run flight-recorder stamps")
            else:
                overlap_sources.add("device timeline")
        ranks[rank] = row
        # per-collective latency, merged across ranks. Store-backed
        # control-plane waits (TCPStore commit barriers group="store",
        # gloo barriers group="gloo", object collectives group="object"
        # — blocking store rendezvous, not wire transfer) stay in the
        # table — operators should see them — but are EXCLUDED from the
        # comm total: one store-long checkpoint barrier would otherwise
        # read as seconds of "communication"
        for key, h in hists.items():
            name, labels = parse_metric_key(key)
            if name in ("serving_ttft_ms", "serving_inter_token_ms",
                        "serving_e2e_ms", "serving_queue_wait_ms"):
                # per-engine serving tails: the
                # engine label makes N engines in one job attributable —
                # unlabeled single-engine runs aggregate under "-"
                skey = (labels.get("engine", "-"), name)
                serving_hists[skey] = _merge_hist(
                    serving_hists.get(skey), h)
                continue
            if name == "serving_phase_ms":
                # per-lifecycle-phase latency: the aggregate
                # view of the request-trace phase boundaries
                pkey = (labels.get("engine", "-"),
                        labels.get("phase", "?"))
                serving_phases[pkey] = _merge_hist(
                    serving_phases.get(pkey), h)
                continue
            if name != "collective_latency_us":
                continue
            group = labels.get("group", "?")
            ckey = (labels.get("kind", "?"), group)
            collectives[ckey] = _merge_hist(collectives.get(ckey), h)
            if group not in ("store", "gloo", "object"):
                comm_us_total += h.get("sum", 0.0)
        for key, v in counters.items():
            name, labels = parse_metric_key(key)
            if name == "serving_tokens_total":
                eng = labels.get("engine", "-")
                row = serving_scalars.setdefault(eng, {})
                row["tokens"] = row.get("tokens", 0) + int(v)
            elif name == "serving_requests_total":
                eng = labels.get("engine", "-")
                st = labels.get("status", "?")
                row = serving_scalars.setdefault(eng, {})
                k = f"requests_{st}"
                row[k] = row.get(k, 0) + int(v)
            elif name == "train_anomalies_total":
                kinds = integrity.setdefault("anomalies", {})
                k = labels.get("kind", "?")
                kinds[k] = kinds.get(k, 0) + int(v)
            elif name == "train_rewinds_total":
                integrity["rewinds"] = integrity.get("rewinds", 0) + int(v)
            elif name == "integrity_blames_total":
                blamed = integrity.setdefault("blamed", {})
                br = labels.get("rank", "?")
                blamed[br] = blamed.get(br, 0) + int(v)
        # straggler windows: mean step time per inter-snapshot window,
        # stamped with the NEW snapshot's wall-clock ts. Cross-rank
        # alignment happens below by TIMESTAMP bucket, not snapshot
        # index: ranks flushing at different times (extra step-count
        # flushes, a late joiner, a restarted worker) used to shift
        # their later windows against everyone else's, corrupting the
        # per-window straggler attribution.
        prev = None
        for snap in snaps:
            h = snap.get("histograms", {}).get("step_time_ms")
            if h is None:
                continue
            win = _hist_delta(h, prev)
            prev = h
            m = hist_mean(win)
            ts = snap.get("ts")
            if m is not None and ts is not None:
                rank_windows.setdefault(rank, []).append((float(ts), m))

    slowest = None
    with_steps = {r: row for r, row in ranks.items()
                  if row.get("step_ms_mean") is not None}
    if len(with_steps) >= 1:
        slowest = max(with_steps, key=lambda r:
                      with_steps[r]["step_ms_mean"])
    straggler_counts = {}
    for _, by_rank in _bucket_windows(rank_windows).items():
        if len(by_rank) < 2:
            continue
        worst = max(by_rank, key=lambda r: by_rank[r])
        straggler_counts[worst] = straggler_counts.get(worst, 0) + 1

    coll_rows = {}
    for (kind, group), h in sorted(collectives.items()):
        coll_rows[f"{kind}|{group}"] = {
            "count": h.get("count", 0),
            "mean_us": hist_mean(h),
            "p50_us": hist_quantile(h, 0.5),
            "p99_us": hist_quantile(h, 0.99),
        }

    serving_rows = {}
    _short = {"serving_ttft_ms": "ttft_ms",
              "serving_inter_token_ms": "itl_ms",
              "serving_e2e_ms": "e2e_ms",
              "serving_queue_wait_ms": "queue_wait_ms"}
    for (eng, name), h in sorted(serving_hists.items()):
        row = serving_rows.setdefault(eng, {})
        base = _short[name]
        row[f"{base}_p50"] = hist_quantile(h, 0.5)
        row[f"{base}_p99"] = hist_quantile(h, 0.99)
        row[f"{base}_count"] = h.get("count", 0)
    for eng, scal in serving_scalars.items():
        serving_rows.setdefault(eng, {}).update(scal)

    phase_rows = {}
    for (eng, phase), h in sorted(serving_phases.items()):
        row = phase_rows.setdefault(eng, {})
        row[phase] = {"count": h.get("count", 0),
                      "mean_ms": hist_mean(h),
                      "p50_ms": hist_quantile(h, 0.5),
                      "p99_ms": hist_quantile(h, 0.99)}

    report = {"ranks": ranks, "slowest_rank": slowest,
              "straggler_windows": straggler_counts,
              "collectives": coll_rows}
    if serving_rows:
        report["serving"] = serving_rows
    if phase_rows:
        report["serving_phases"] = phase_rows
    if integrity:
        report["integrity"] = integrity
    if compute_ms_total > 0:
        # host-visible (non-hidden) collective time vs compute time; the
        # device-truth overlap gauge (xplane-derived) wins when present
        report["comm_ms_total"] = comm_us_total / 1e3
        report["compute_ms_total"] = compute_ms_total
        report["comm_vs_compute_pct"] = (
            100.0 * (comm_us_total / 1e3) / compute_ms_total)
    if overlap_pcts:
        report["comm_overlap_pct"] = sum(overlap_pcts) / len(overlap_pcts)
        report["comm_overlap_source"] = " + ".join(sorted(overlap_sources))
    return report


def _fmt(v, nd=1):
    return "-" if v is None else f"{v:.{nd}f}"


def format_run_report(report):
    """One-screen text rendering; None when there is nothing to say."""
    ranks = report.get("ranks") or {}
    if not ranks:
        return None
    lines = [f"[telemetry] run report ({len(ranks)} rank(s)):"]
    lines.append("[telemetry]   rank  steps  step_ms(mean/p50/p99)  "
                 "data_wait_ms  tok/s     mfu%")
    for rank, row in sorted(ranks.items()):
        triple = "/".join(_fmt(row.get(k)) for k in
                          ("step_ms_mean", "step_ms_p50", "step_ms_p99"))
        lines.append(
            "[telemetry]   %-5d %-6d %-22s %-12s %-9s %s" % (
                rank, row.get("steps", 0), triple,
                _fmt(row.get("data_wait_ms_mean"), 2),
                _fmt(row.get("tokens_per_sec"), 0),
                _fmt(row.get("mfu_pct"), 2)))
    slowest = report.get("slowest_rank")
    if slowest is not None and len(ranks) > 1:
        row = ranks[slowest]
        wins = report.get("straggler_windows", {}).get(slowest, 0)
        lines.append(
            f"[telemetry] slowest rank {slowest}: mean step "
            f"{_fmt(row.get('step_ms_mean'))} ms"
            + (f", straggler in {wins} window(s)" if wins else ""))
    colls = report.get("collectives") or {}
    if colls:
        lines.append("[telemetry]   collective latency (us): "
                     "count  p50  p99")
        for key, row in sorted(colls.items()):
            lines.append(
                "[telemetry]     %-36s %-6d %-8s %s" % (
                    key, row.get("count", 0), _fmt(row.get("p50_us")),
                    _fmt(row.get("p99_us"))))
    serving = report.get("serving") or {}
    if serving:
        lines.append("[telemetry]   serving engines: "
                     "tokens  reqs_ok  ttft_p99_ms  itl_p99_ms")
        for eng, row in sorted(serving.items()):
            lines.append(
                "[telemetry]     %-10s %-7d %-8d %-12s %s" % (
                    eng, row.get("tokens", 0),
                    row.get("requests_ok", 0),
                    _fmt(row.get("ttft_ms_p99"), 2),
                    _fmt(row.get("itl_ms_p99"), 2)))
    phases = report.get("serving_phases") or {}
    if phases:
        lines.append("[telemetry]   serving phase latency "
                     "(p50/p99 ms):")
        for eng, row in sorted(phases.items()):
            cells = "  ".join(
                f"{ph}={_fmt(st.get('p50_ms'), 1)}/"
                f"{_fmt(st.get('p99_ms'), 1)}"
                for ph, st in sorted(row.items()))
            lines.append(f"[telemetry]     {eng:<10} {cells}")
    slo = report.get("slo_attribution") or []
    if slo:
        lines.append("[telemetry]   slowest traced requests "
                     "(phase-attributed, ms):")
        for r in slo:
            cells = "  ".join(
                f"{c}={_fmt(r.get(c + '_ms'), 1)}"
                for c in ("queue_wait", "prefill", "decode", "route")
                if r.get(c + "_ms") is not None)
            flags = ",".join(r.get("flags") or []) or "-"
            lines.append(
                f"[telemetry]     {r['trace'][:18]:<18} "
                f"e2e={_fmt(r.get('e2e_ms'), 1):<9} {cells}  "
                f"[{flags}]")
    integ = report.get("integrity") or {}
    if integ:
        anomalies = integ.get("anomalies") or {}
        an = ", ".join(f"{k}={v}" for k, v in sorted(anomalies.items())) \
            or "none"
        line = (f"[telemetry] integrity: anomalies {an}; "
                f"rewinds {integ.get('rewinds', 0)}")
        blamed = integ.get("blamed") or {}
        if blamed:
            line += "; blamed rank(s) " + ", ".join(
                f"{r} (x{n})" for r, n in sorted(blamed.items()))
        lines.append(line)
    if report.get("comm_overlap_pct") is not None:
        src = report.get("comm_overlap_source") or "device timeline"
        lines.append(f"[telemetry] comm/compute overlap: "
                     f"{report['comm_overlap_pct']:.1f}% ({src})")
    elif report.get("comm_vs_compute_pct") is not None:
        lines.append(
            f"[telemetry] host-visible comm vs compute: "
            f"{report['comm_vs_compute_pct']:.1f}% "
            f"({report['comm_ms_total']:.1f} / "
            f"{report['compute_ms_total']:.1f} ms)")
    return "\n".join(lines)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m paddle_tpu_torch.observability.report "
              "<log_dir> [--json]", file=sys.stderr)
        return 2
    log_dir = argv[0]
    report = build_run_report(read_rank_snapshots(log_dir))
    try:
        # per-request SLO attribution: when the log dir also
        # holds exported request traces, fold the top slowest into the
        # report — the aggregate phase tails above, the culprits below
        from . import trace_report as _tr
        rows = _tr.build_request_rows(_tr.load_events(log_dir))
        if rows:
            report["slo_attribution"] = _tr.rows_to_report(rows, top=5)
    except Exception:
        pass
    if "--json" in argv:
        print(json.dumps(report, indent=1, default=str))
        return 0
    text = format_run_report(report)
    if text is None:
        print(f"[telemetry] no metrics snapshots under {log_dir}",
              file=sys.stderr)
        return 1
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
