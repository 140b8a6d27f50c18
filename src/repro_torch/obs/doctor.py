"""Sweep doctor — post-hoc audit of a recorded sweep's decisions (port of
``repro.obs.doctor``, copied).

The paper's hybrid BFS stands on one claim: the alpha/beta switch picks
the cheaper direction every layer. The flight recorder captures the
evidence (per-lane e_f/v_f/e_u counters AND the direction the engine
actually took); this module is the audit that replays the switch rule as
an *oracle* on the recorded counters and flags every layer where the
recorded direction disagrees — plus two more anomaly families the
records expose:

* **mis_switch** — per lane, per layer: replay the switch rule in
  float32 (the reference's oracle as it stands, ``e_u / alpha`` divided;
  the engines multiply by the float32 reciprocal, as XLA compiles the
  reference's rule, so the oracle is kept as the reference's doctor has
  it and flags the same layers on the same records) from the lane's
  previous recorded direction
  over the recorded counters; a disagreement is a mis-switched layer,
  reported with the estimated wasted edges (edges the recorded direction
  inspected minus what the oracle's choice would have: TD inspects
  ``e_f``, BU inspects ``e_u`` — the paper's per-layer work model). On a
  healthy recording the oracle agrees everywhere by construction, so ANY
  finding means the trace was produced by different alpha/beta/mode than
  the audit assumes, or the recording is corrupt — both worth an alarm.
* **exchange_regression** — layers where the compressed wire format cost
  MORE bytes than the dense form would have. Dense is population-blind
  (constant per layer), so the dense baseline is inferred from the
  recording's own dense-format layers when present, else passed
  explicitly (``dense_bytes=``); with neither, the exchange audit is
  skipped and says so.
* **queue_stall / lane_starvation** — engine steps that did no lane work
  (``active_lanes == 0``) while the sweep continued, and sustained
  low-occupancy runs that RECOVER later (occupancy back above threshold
  afterwards — the natural drain tail of a finishing sweep never flags).

Findings land three ways: structured ``Finding`` values in a
``DoctorReport``, registry counters (``obs_doctor_findings_total`` by
kind), and a human-readable ``report.text()``. The CLI audits a JSONL
flight log (``obs.FlightSink`` output)::

    PYTHONPATH=src python -m repro_torch.obs.doctor out/flight.jsonl \
        --n 1024 [--alpha 14 --beta 24] [--out out/doctor.txt]
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs.sweeplog import LayerRecord

__all__ = [
    "DoctorReport", "Finding", "diagnose", "diagnose_log",
    "records_from_jsonl", "replay_switch", "split_sweeps",
]

# finding kinds (wire-stable strings)
MIS_SWITCH = "mis_switch"
EXCHANGE_REGRESSION = "exchange_regression"
QUEUE_STALL = "queue_stall"
LANE_STARVATION = "lane_starvation"


@dataclass(frozen=True)
class Finding:
    """One audited anomaly in one recorded sweep."""
    kind: str                    # mis_switch | exchange_regression | ...
    layer: int                   # engine sweep-step index
    slot: int = -1               # queue slot (lane audits; -1 sweep-wide)
    wasted_edges: int = 0        # estimated extra edges inspected
    message: str = ""
    detail: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return dict(kind=self.kind, layer=self.layer, slot=self.slot,
                    wasted_edges=self.wasted_edges, message=self.message,
                    detail=self.detail)


@dataclass
class DoctorReport:
    """The audit result over one recorded sweep."""
    engine: str = ""
    kind: str = ""
    layers: int = 0
    decisions_audited: int = 0   # per-lane switch decisions replayed
    exchange_audited: bool = False
    notes: list = field(default_factory=list)
    findings: list = field(default_factory=list)

    def ok(self) -> bool:
        return not self.findings

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def wasted_edges(self) -> int:
        return sum(f.wasted_edges for f in self.findings
                   if f.kind == MIS_SWITCH)

    def as_dict(self) -> dict:
        return dict(engine=self.engine, kind=self.kind, layers=self.layers,
                    decisions_audited=self.decisions_audited,
                    exchange_audited=self.exchange_audited,
                    notes=list(self.notes), counts=self.counts(),
                    wasted_edges=self.wasted_edges(),
                    findings=[f.as_dict() for f in self.findings])

    def text(self) -> str:
        """Human-readable audit report."""
        head = (f"sweep doctor: engine={self.engine or '?'} "
                f"kind={self.kind or '?'} layers={self.layers} "
                f"decisions_audited={self.decisions_audited}")
        lines = [head]
        for note in self.notes:
            lines.append(f"  note: {note}")
        if self.ok():
            lines.append("  OK — no anomalies")
            return "\n".join(lines)
        counts = ", ".join(f"{k}={v}" for k, v in
                           sorted(self.counts().items()))
        lines.append(f"  ANOMALIES ({counts}, "
                     f"~{self.wasted_edges()} wasted edges):")
        for f in self.findings:
            where = f"layer {f.layer}" + (f" slot {f.slot}"
                                          if f.slot >= 0 else "")
            lines.append(f"    [{f.kind}] {where}: {f.message}")
        return "\n".join(lines)


def replay_switch(topdown_prev: bool, e_f: int, v_f: int, e_u: int,
                  n: int, alpha: float, beta: float) -> bool:
    """The oracle: the switch rule replayed host-side in float32, as the
    reference's doctor replays it (``f32(e_u) / f32(alpha)``, a division).
    Returns the direction the rule picks for THIS layer given the PREVIOUS
    layer's direction and this layer's counters."""
    f32 = np.float32
    if topdown_prev:
        go_bu = f32(e_f) > f32(e_u) / f32(alpha)
        return not bool(go_bu)
    go_td = f32(v_f) < f32(n) / f32(beta)
    return bool(go_td)


def _lane_sequences(records) -> dict[int, list]:
    """slot -> [(row, layer, dir, vf, ef, eu)] sorted by trace row —
    each slot's recorded decision sequence, whichever layers it spanned."""
    seqs: dict[int, list] = {}
    for r in records:
        for s, row, d, v, e, u in zip(r.slots, r.rows, r.dirs, r.vf,
                                      r.ef, r.eu):
            seqs.setdefault(int(s), []).append(
                (int(row), int(r.layer), int(d), int(v), int(e), int(u)))
    for seq in seqs.values():
        seq.sort()
    return seqs


def _audit_switch(records, n: int, alpha: float, beta: float,
                  report: DoctorReport) -> None:
    for slot, seq in sorted(_lane_sequences(records).items()):
        prev_td = True               # lanes seat top-down (engine _refill)
        for row, layer, d, vf, ef, eu in seq:
            oracle_td = replay_switch(prev_td, ef, vf, eu, n, alpha, beta)
            recorded_td = d == 0
            report.decisions_audited += 1
            if oracle_td != recorded_td:
                cost_rec = ef if recorded_td else eu
                cost_ora = ef if oracle_td else eu
                report.findings.append(Finding(
                    kind=MIS_SWITCH, layer=layer, slot=slot,
                    wasted_edges=int(cost_rec - cost_ora),
                    message=(f"recorded {'TD' if recorded_td else 'BU'} "
                             f"but oracle picks "
                             f"{'TD' if oracle_td else 'BU'} "
                             f"(e_f={ef} v_f={vf} e_u={eu}, "
                             f"~{cost_rec - cost_ora} wasted edges)"),
                    detail=dict(row=row, e_f=ef, v_f=vf, e_u=eu,
                                prev_topdown=prev_td)))
            # continue from what the engine ACTUALLY did, so one
            # disagreement cannot cascade into false findings downstream
            prev_td = recorded_td


def _audit_exchange(records, dense_bytes: int | None,
                    report: DoctorReport) -> None:
    compressed = [r for r in records
                  if r.exch_format == "compressed" and r.exch_bytes > 0]
    if not compressed:
        return
    if dense_bytes is None:
        dense_steps = [r.exch_bytes for r in records
                       if r.exch_format == "dense" and r.exch_bytes > 0]
        # dense is population-blind: every dense layer costs the same
        dense_bytes = max(dense_steps) if dense_steps else None
    if dense_bytes is None:
        report.notes.append(
            "exchange audit skipped: no dense-format layers recorded and "
            "no dense_bytes baseline given")
        return
    report.exchange_audited = True
    for r in compressed:
        if r.exch_bytes > dense_bytes:
            report.findings.append(Finding(
                kind=EXCHANGE_REGRESSION, layer=r.layer,
                wasted_edges=0,
                message=(f"compressed wire cost {r.exch_bytes} B > dense "
                         f"{dense_bytes} B — density switch should have "
                         f"shipped dense"),
                detail=dict(exch_bytes=r.exch_bytes,
                            dense_bytes=int(dense_bytes),
                            frontier_words=r.frontier_words)))


def _audit_occupancy(records, starvation_frac: float,
                     starvation_layers: int,
                     report: DoctorReport) -> None:
    active = [r.active_lanes for r in records]
    if not active:
        return
    # queue stalls: steps that advanced no lane while the sweep went on
    for i, r in enumerate(records[:-1]):
        if r.active_lanes == 0:
            report.findings.append(Finding(
                kind=QUEUE_STALL, layer=r.layer,
                message=("engine stepped with zero active lanes while "
                         "work remained — queue/refill stall"),
                detail=dict(index=i)))
    # starvation: sustained low occupancy that RECOVERS later (the drain
    # tail of a finishing sweep never recovers, so it never flags)
    peak = max(active)
    threshold = max(1, int(np.ceil(peak * starvation_frac)))
    last_healthy = max((i for i, a in enumerate(active) if a >= threshold),
                      default=-1)
    run_start = None
    for i, a in enumerate(active):
        starved = 0 < a < threshold and i < last_healthy
        if starved and run_start is None:
            run_start = i
        elif not starved and run_start is not None:
            if i - run_start >= starvation_layers:
                report.findings.append(Finding(
                    kind=LANE_STARVATION, layer=records[run_start].layer,
                    message=(f"{i - run_start} consecutive layers below "
                             f"{threshold}/{peak} active lanes with "
                             f"pending work (occupancy recovered at "
                             f"layer {records[i].layer})"),
                    detail=dict(run_layers=i - run_start,
                                threshold=threshold, peak=peak)))
            run_start = None


def diagnose(records, *, n: int | None = None, alpha: float | None = None,
             beta: float | None = None, mode: str = "hybrid",
             dense_bytes: int | None = None, registry=None,
             starvation_frac: float = 0.25, starvation_layers: int = 3,
             ) -> DoctorReport:
    """Audit one recorded sweep (a ``SweepRecorder.records`` list or any
    ``LayerRecord`` iterable from one sweep).

    ``n``/``alpha``/``beta``/``mode`` describe the run that produced the
    recording (defaults: the engine defaults). The switch audit runs only
    for BFS-kind records under ``mode="hybrid"`` with ``n`` known —
    forced-direction sweeps and SSSP phase traces have no alpha/beta
    decision to audit (noted in the report)."""
    records = list(records)
    report = DoctorReport(
        engine=records[0].engine if records else "",
        kind=records[0].kind if records else "",
        layers=len(records))
    if not records:
        report.notes.append("empty recording — nothing to audit")
        return report
    if alpha is None or beta is None:
        from repro_torch.core.hybrid import ALPHA_DEFAULT, BETA_DEFAULT
        alpha = ALPHA_DEFAULT if alpha is None else alpha
        beta = BETA_DEFAULT if beta is None else beta
    if report.kind != "bfs":
        report.notes.append(
            f"switch audit skipped: {report.kind} records carry no "
            f"TD/BU decision")
    elif mode != "hybrid":
        report.notes.append(
            f"switch audit skipped: mode={mode!r} forces the direction")
    elif n is None:
        report.notes.append(
            "switch audit skipped: pass n (the switch-rule vertex count)")
    else:
        _audit_switch(records, int(n), float(alpha), float(beta), report)
    _audit_exchange(records, dense_bytes, report)
    _audit_occupancy(records, starvation_frac, starvation_layers, report)
    report.findings.sort(key=lambda f: (f.layer, f.slot, f.kind))
    if registry is not None:
        registry.counter(
            "obs_doctor_decisions_total",
            "switch decisions replayed by the sweep doctor").inc(
                report.decisions_audited)
        for kind, count in report.counts().items():
            registry.counter(
                "obs_doctor_findings_total", "doctor findings by kind",
                ("kind",)).labels(kind=kind).inc(count)
    return report


# ---------------------------------------------------------------------------
# Flight-log (JSONL) surface — the post-mortem path.
# ---------------------------------------------------------------------------

_RECORD_FIELDS = set(LayerRecord.__dataclass_fields__)
_TUPLE_FIELDS = ("slots", "rows", "dirs", "vf", "ef", "eu", "buckets")


def records_from_jsonl(path: str) -> list[LayerRecord]:
    """Parse a ``FlightSink`` JSONL flight log back into ``LayerRecord``
    values (unknown keys ignored — forward-compatible with schema
    growth; non-record lines are skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if not isinstance(d, dict) or "layer" not in d:
                continue
            kw = {k: v for k, v in d.items() if k in _RECORD_FIELDS}
            for k in _TUPLE_FIELDS:
                if k in kw:
                    kw[k] = tuple(kw[k])
            out.append(LayerRecord(**kw))
    return out


def split_sweeps(records) -> list[list[LayerRecord]]:
    """Group a mixed record stream (one flight log may interleave several
    engines' recorders) into per-sweep record lists: records are bucketed
    by engine, and a non-increasing layer index starts a new sweep."""
    by_engine: dict[str, list] = {}
    for r in records:
        by_engine.setdefault(r.engine, []).append(r)
    sweeps = []
    for engine in sorted(by_engine):
        cur: list = []
        for r in by_engine[engine]:
            if cur and r.layer <= cur[-1].layer:
                sweeps.append(cur)
                cur = []
            cur.append(r)
        if cur:
            sweeps.append(cur)
    return sweeps


def diagnose_log(records, **kwargs) -> list[DoctorReport]:
    """``diagnose`` every sweep in a mixed record stream."""
    return [diagnose(sweep, **kwargs) for sweep in split_sweeps(records)]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Audit a JSONL flight log (obs.FlightSink output).")
    ap.add_argument("flight_log", help="JSONL flight log path")
    ap.add_argument("--n", type=int, default=None,
                    help="switch-rule vertex count of the recorded run "
                         "(enables the alpha/beta mis-switch audit)")
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--mode", default="hybrid")
    ap.add_argument("--dense-bytes", type=int, default=None,
                    help="dense wire bytes per exchange step (baseline "
                         "for the compression-regression audit)")
    ap.add_argument("--out", default=None,
                    help="also write the report text here")
    ap.add_argument("--json", action="store_true",
                    help="emit the structured reports as JSON instead")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 when any sweep has anomalies")
    args = ap.parse_args(argv)

    records = records_from_jsonl(args.flight_log)
    reports = diagnose_log(records, n=args.n, alpha=args.alpha,
                           beta=args.beta, mode=args.mode,
                           dense_bytes=args.dense_bytes)
    if args.json:
        text = json.dumps([r.as_dict() for r in reports], indent=2)
    else:
        text = "\n".join(r.text() for r in reports) or (
            "sweep doctor: no records in flight log")
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    anomalies = sum(len(r.findings) for r in reports)
    print(f"audited {len(reports)} sweep(s), {len(records)} layer "
          f"records: {anomalies} anomalies")
    return 1 if (args.fail_on_findings and anomalies) else 0


if __name__ == "__main__":
    raise SystemExit(main())
