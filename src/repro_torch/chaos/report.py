"""Coverage-matrix artifact: fault class x protection domain -> outcomes.

A copy of the reference package's ``repro/chaos/report.py`` over the
port's registry, so that the same campaign rows give the same artifact in
both packages.  It turns a `CampaignResult` into the machine-readable JSON
a gate asserts on (zero ``missed`` anywhere, zero false alarms) and a
rendered markdown table.  The artifact always carries the
**uncovered-surface ledger**: every registered surface with no protection.
In the port the ledger lists the surfaces whose protection comes with a
later slice, each with a note naming it.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.chaos.faults import ensure_registered, uncovered_surfaces

__all__ = ["coverage_matrix", "summarize", "episodes", "ledger",
           "campaign_dict", "render_markdown"]

SCHEMA = "repro.chaos.campaign/v2"

# "absorbed": an episode event whose corruption was erased by a
# co-occurring recovery's rollback before any detector needed to see it
# (e.g. a DRAM flip landing in the same step window as a pod loss) —
# attributed to the episode, deliberately NOT a "missed"
OUTCOMES = ("corrected", "absorbed", "detected", "missed", "false_alarm",
            "clean", "skipped")


def _latency_stats(lats: List[float]) -> Dict[str, float]:
    if not lats:
        return {}
    return {"n": len(lats), "mean_s": sum(lats) / len(lats),
            "max_s": max(lats)}


def _warm_stats(rows) -> dict:
    """Compile/warm split of the recovery walls (PR10): ``warm`` is the
    steady-state repair cost with every program already traced; the
    difference to the raw latency is jit trace/compile, reported once as
    ``compile`` so a first-trace wall can't masquerade as MTTR."""
    warms = [r.recovery_warm_s for r in rows
             if getattr(r, "recovery_warm_s", None) is not None]
    compiles = [r.recovery_compile_s for r in rows
                if getattr(r, "recovery_compile_s", None) is not None]
    out = {}
    if warms:
        out["warm"] = _latency_stats(warms)
    if compiles:
        out["compile"] = _latency_stats(compiles)
    return out


def coverage_matrix(results) -> dict:
    """``{kind: {surface: {outcome counts, workloads, rungs, latency}}}``.

    One cell per (fault class, protection domain) pair that was actually
    drilled; clean sweeps aggregate under kind "clean_sweep".
    """
    matrix: dict = {}
    for r in results:
        cell = matrix.setdefault(r.kind, {}).setdefault(r.surface, {
            "protected": r.protected, "promise": r.promise,
            "outcomes": {o: 0 for o in OUTCOMES}, "workloads": [],
            "rungs": [], "recovery_latency": [], "events": 0})
        cell["outcomes"][r.outcome] += 1
        cell["events"] += 1
        if r.workload not in cell["workloads"]:
            cell["workloads"].append(r.workload)
        if r.rung and r.rung not in cell["rungs"]:
            cell["rungs"].append(r.rung)
        if r.recovery_latency_s is not None:
            cell["recovery_latency"].append(r.recovery_latency_s)
        if getattr(r, "recovery_warm_s", None) is not None:
            cell.setdefault("_warm", []).append(r.recovery_warm_s)
        if getattr(r, "recovery_compile_s", None) is not None:
            cell.setdefault("_compile", []).append(r.recovery_compile_s)
    for kind in matrix.values():
        for cell in kind.values():
            cell["recovery_latency"] = _latency_stats(
                cell.pop("recovery_latency"))
            cell["recovery_latency_warm"] = _latency_stats(
                cell.pop("_warm", []))
            cell["recovery_compile"] = _latency_stats(
                cell.pop("_compile", []))
    return matrix


def summarize(results) -> dict:
    by_outcome = {o: 0 for o in OUTCOMES}
    for r in results:
        by_outcome[r.outcome] += 1
    missed_protected = [r.name for r in results
                        if r.outcome == "missed" and r.protected]
    missed_anywhere = [r.name for r in results if r.outcome == "missed"]
    false_alarms = [r.name for r in results if r.outcome == "false_alarm"]
    injected = [r for r in results
                if r.kind not in ("clean_sweep",) and r.outcome != "skipped"]
    kinds = sorted({r.kind for r in injected})
    workloads = sorted({r.workload for r in results})
    return {
        "n_events": len(results),
        "n_fault_kinds": len(kinds),
        "fault_kinds": kinds,
        "workloads": workloads,
        "by_outcome": by_outcome,
        "missed_in_protected_domains": missed_protected,
        "missed_anywhere": missed_anywhere,
        "false_alarms": false_alarms,
    }


def episodes(results) -> dict:
    """Episode-level aggregation + the sustained-rate-at-parity summary.

    Rate episodes (their spec carries ``rate_per_1k``) answer the §4.3
    stress question "what fault rate can this workload sustain at
    parity?": per workload, the sustained rate is the highest tested
    events-per-1k-steps rate whose whole schedule came out ``corrected``
    (every event recovered AND the end state at parity with the clean
    golden run); any lower rate that failed is listed alongside, so a
    non-monotonic draw can't hide."""
    rows = [r for r in results if r.kind == "episode"]
    ep_rows = []
    rates: Dict[str, List[tuple]] = {}
    for r in rows:
        spec = r.spec or {}
        rate = spec.get("rate_per_1k")
        ep_rows.append({
            "name": r.name, "episode": r.episode, "workload": r.workload,
            "outcome": r.outcome, "end_state": r.end_state, "rung": r.rung,
            "rate_per_1k": rate,
            "n_events": len(spec.get("events") or []),
            "recovery_latency_s": r.recovery_latency_s,
            "wall_s": r.wall_s,
        })
        if rate is not None:
            rates.setdefault(r.workload, []).append((rate, r.outcome))
    sustained = {}
    for wl, pairs in sorted(rates.items()):
        ok = [rate for rate, o in pairs if o == "corrected"]
        failed = [rate for rate, o in pairs
                  if o not in ("corrected", "skipped")]
        sustained[wl] = {
            "sustained_rate_per_1k": max(ok) if ok else 0.0,
            "rates_tested": sorted(rate for rate, _ in pairs),
            "rates_failed": sorted(failed),
        }
    return {
        "n_episodes": len(rows),
        "by_outcome": {o: sum(1 for r in rows if r.outcome == o)
                       for o in OUTCOMES
                       if any(r.outcome == o for r in rows)},
        "not_corrected": [r.name for r in rows
                          if r.outcome not in ("corrected", "skipped")],
        "skipped": [r.name for r in rows if r.outcome == "skipped"],
        "episodes": ep_rows,
        "sustained_rate_at_parity": sustained,
    }


def ledger(results) -> List[dict]:
    """The uncovered-surface ledger, annotated with what the campaign
    actually observed on each (drilled + the resulting outcome, or an
    explicit "not drilled")."""
    ensure_registered()
    drilled: Dict[str, List[str]] = {}
    for r in results:
        if r.spec is not None:
            drilled.setdefault(r.surface, []).append(r.outcome)
    rows = []
    for s in uncovered_surfaces():
        outcomes = drilled.get(s.name)
        rows.append({
            "surface": s.name,
            "owner": s.owner,
            "note": s.note,
            "drilled": bool(outcomes),
            "observed_outcomes": sorted(set(outcomes)) if outcomes else [],
            "status": ("confirmed unprotected: injected faults classify as "
                       + "/".join(sorted(set(outcomes)))
                       if outcomes else
                       "not drilled this campaign — unprotected by "
                       "registry declaration"),
        })
    return rows


def campaign_dict(res) -> dict:
    """The full machine-readable artifact (CAMPAIGN_PR7.json)."""
    return {
        "schema": SCHEMA,
        "space": res.space,
        "meta": res.meta,
        "summary": summarize(res.results),
        "matrix": coverage_matrix(res.results),
        "episodes": episodes(res.results),
        "uncovered_surfaces": ledger(res.results),
        "events": [r.asdict() for r in res.results],
    }


def _fmt_lat(cell) -> str:
    st = cell["recovery_latency"]
    if not st:
        return "—"
    warm = cell.get("recovery_latency_warm") or {}
    comp = cell.get("recovery_compile") or {}
    if warm:
        # warm MTTR first-class; a non-trivial compile share is broken out
        s = f"{warm['mean_s'] * 1e3:.1f}ms warm"
        if comp and comp["mean_s"] > 1e-4:
            s += f" (+{comp['mean_s'] * 1e3:.1f}ms compile)"
        return s
    return f"{st['mean_s'] * 1e3:.1f}ms"


def render_markdown(res) -> str:
    """Human-readable coverage matrix + ledger."""
    matrix = coverage_matrix(res.results)
    summ = summarize(res.results)
    lines = [
        f"# Chaos campaign `{res.space}`",
        "",
        f"{summ['n_events']} events over workloads "
        f"{', '.join(summ['workloads'])} — "
        f"{summ['n_fault_kinds']} fault kinds; outcomes: "
        + ", ".join(f"{k}={v}" for k, v in summ["by_outcome"].items()
                    if v),
        "",
        "| fault kind | surface | protected | workloads | corrected | "
        "absorbed | detected | missed | false alarm | rung(s) | "
        "recovery latency |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for kind in sorted(matrix):
        for surface in sorted(matrix[kind]):
            c = matrix[kind][surface]
            o = c["outcomes"]
            lines.append(
                f"| {kind} | {surface} | "
                f"{'yes' if c['protected'] else 'NO'} | "
                f"{'+'.join(c['workloads'])} | {o['corrected']} | "
                f"{o['absorbed']} | "
                f"{o['detected']} | {o['missed']} | {o['false_alarm']} | "
                f"{', '.join(c['rungs']) or '—'} | {_fmt_lat(c)} |")
    eps = episodes(res.results)
    if eps["n_episodes"]:
        lines += [
            "", "## Episodes", "",
            "| episode | workload | events | rate/1k | outcome | "
            "end state | rung(s) |",
            "|---|---|---|---|---|---|---|",
        ]
        for e in eps["episodes"]:
            rate = "—" if e["rate_per_1k"] is None else f"{e['rate_per_1k']:g}"
            lines.append(
                f"| {e['episode']} | {e['workload']} | {e['n_events']} | "
                f"{rate} | {e['outcome']} | {e['end_state']} | "
                f"{e['rung'] or '—'} |")
        sus = eps["sustained_rate_at_parity"]
        if sus:
            lines += ["", "**Sustained rate at parity** "
                          "(events per 1k steps, all recovered, end state "
                          "at parity): "
                      + "; ".join(
                          f"{wl} = {st['sustained_rate_per_1k']:g}"
                          + (f" (failed at {st['rates_failed']})"
                             if st["rates_failed"] else "")
                          for wl, st in sus.items())]
    lines += ["", "## Uncovered-surface ledger", ""]
    rows = ledger(res.results)
    for row in rows:
        lines.append(f"- **{row['surface']}** — {row['status']}. "
                     f"{row['note']}")
    if not rows:
        lines.append("*(empty — every registered surface is protected; a "
                     "surface appearing here is a regression)*")
    ma = summ["missed_anywhere"]
    fa = summ["false_alarms"]
    lines += [
        "",
        f"**Misses (anywhere):** {ma if ma else 'none'}  ",
        f"**False alarms:** {fa if fa else 'none'}",
        "",
    ]
    return "\n".join(lines)
