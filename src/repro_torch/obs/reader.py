"""Run-log reader + CLI, port of ``repro.obs.reader``:
``python -m repro_torch.obs summarize|tail|compare|validate``.

Reads the ``events.jsonl`` + ``meta.json`` pair a JsonlRecorder writes
(either package's) and renders:

  summarize  meta header, per-round table (nmse / wire bytes / gamp health /
             buffer stats / wall-clock), decode-health + phase-time summary
  tail       the last N events, raw
  compare    aggregate deltas between two run dirs (same columns)
  validate   schema check (exit 1 on problems)

The rendering is the reference's, line for line: on one run directory both
CLIs print the same text (the header's ``jax``/``backend`` fields read
``meta.json``, so a run the port wrote shows ``jax ?`` and its backend).
Columns a run never recorded are shown as "-", unknown event kinds are
skipped.  The module itself uses the standard library only.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, Iterator, List, Optional, Sequence

from repro_torch.obs.schema import validate_run

__all__ = ["load_meta", "iter_events", "load_rounds", "summarize", "compare", "main"]


def load_meta(run_dir: str) -> Dict[str, Any]:
    with open(os.path.join(run_dir, "meta.json")) as f:
        return json.load(f)


def iter_events(run_dir: str) -> Iterator[Dict[str, Any]]:
    path = os.path.join(run_dir, "events.jsonl")
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def load_rounds(run_dir: str) -> List[Dict[str, Any]]:
    return [ev for ev in iter_events(run_dir) if ev.get("kind") == "round"]


def _fmt(v: Any, spec: str = "") -> str:
    if v is None:
        return "-"
    try:
        return format(v, spec)
    except (TypeError, ValueError):
        return str(v)


def _bytes_h(v: Any) -> str:
    if v is None:
        return "-"
    v = float(v)
    for unit in ("B", "KB", "MB", "GB"):
        if v < 1024 or unit == "GB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024
    return "-"


# (header, event field, format spec or callable)
_ROUND_COLS = (
    ("rnd", "round", "d"),
    ("cohort", "cohort", "d"),
    ("part", "participating", "d"),
    ("nmse", "nmse", ".3e"),
    ("up", "wire_up_bytes", _bytes_h),
    ("down", "wire_down_bytes", _bytes_h),
    ("it_mean", "gamp_iters_mean", ".1f"),
    ("conv%", "gamp_converged_frac", ".0%"),
    ("sat%", "clip_saturation", ".1%"),
    ("buf", "buffer_peak_occupancy", "d"),
    ("ms", "round_ms", ".0f"),
)


def _table(rows: List[List[str]], headers: Sequence[str]) -> str:
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]
    def line(cells):
        return "  ".join(c.rjust(w) for c, w in zip(cells, widths))
    return "\n".join([line(headers)] + [line(r) for r in rows])


def _round_table(rounds: List[Dict[str, Any]]) -> str:
    # drop columns no round ever recorded, so barrier runs don't show buf=-
    cols = [c for c in _ROUND_COLS if any(r.get(c[1]) is not None for r in rounds)]
    rows = []
    for r in rounds:
        row = []
        for _, field, spec in cols:
            v = r.get(field)
            row.append(spec(v) if callable(spec) else _fmt(v, spec))
        rows.append(row)
    return _table(rows, [c[0] for c in cols])


def _mean(rounds: List[Dict[str, Any]], field: str) -> Optional[float]:
    vals = [float(r[field]) for r in rounds if r.get(field) is not None]
    return sum(vals) / len(vals) if vals else None


def _health_summary(rounds: List[Dict[str, Any]]) -> List[str]:
    out = []
    pairs = (
        ("gamp iters (mean)", "gamp_iters_mean", ".2f"),
        ("gamp converged frac", "gamp_converged_frac", ".1%"),
        ("quantizer clip saturation", "clip_saturation", ".2%"),
        ("unconverged survivors", "unconverged_survivors", ".1f"),
        ("buffer peak occupancy", "buffer_peak_occupancy", ".1f"),
        ("dedup drops / round", "batches_rejected_dup", ".2f"),
        ("backpressure drains / round", "batches_backpressure", ".2f"),
        ("post-combine nu (mean)", "nu_channel", ".3e"),
        ("CSI target mismatch", "csi_target_mismatch", ".3e"),
    )
    for label, field, spec in pairs:
        m = _mean(rounds, field)
        if m is not None:
            out.append(f"  {label:<28s} {format(m, spec)}")
    return out


def _phase_summary(rounds: List[Dict[str, Any]]) -> List[str]:
    from repro_torch.obs.trace import SUB_PHASES

    acc: Dict[str, List[float]] = {}
    for r in rounds:
        for name, ms in (r.get("phase_ms") or {}).items():
            acc.setdefault(name, []).append(float(ms))
    if not acc:
        return []
    # sub-phases (backward/encode_overlap) nest inside client_pass: they get
    # a share of the round but must not inflate the denominator
    total = sum(sum(v) for k, v in acc.items() if k not in SUB_PHASES)
    out = []
    for name, vals in sorted(acc.items(), key=lambda kv: -sum(kv[1])):
        share = sum(vals) / total if total else 0.0
        label = f"{name} *" if name in SUB_PHASES else name
        out.append(
            f"  {label:<14s} {sum(vals) / len(vals):8.1f} ms/round  {share:5.1%}"
        )
    if any(k in SUB_PHASES for k in acc):
        out.append("  (* nested inside client_pass; excluded from totals)")
    return out


def summarize(run_dir: str) -> str:
    meta = load_meta(run_dir)
    rounds = load_rounds(run_dir)
    lines = [
        f"run {meta.get('run_id')}  "
        f"(schema v{meta.get('schema_version')}, "
        f"jax {meta.get('jax_version', '?')}, "
        f"backend {meta.get('backend', '?')}, "
        f"git {str(meta.get('git_sha'))[:10]})",
    ]
    if not rounds:
        return "\n".join(lines + ["no round events recorded"])
    lines += ["", _round_table(rounds)]
    health = _health_summary(rounds)
    if health:
        lines += ["", "decode health (mean over rounds):"] + health
    phases = _phase_summary(rounds)
    if phases:
        lines += ["", "phase wall-clock:"] + phases
    return "\n".join(lines)


_COMPARE_FIELDS = (
    ("nmse", "nmse", ".3e"),
    ("round_ms", "round_ms", ".1f"),
    ("wire_up_bytes", "wire_up_bytes", ".0f"),
    ("gamp_iters_mean", "gamp_iters_mean", ".2f"),
    ("gamp_converged_frac", "gamp_converged_frac", ".3f"),
    ("clip_saturation", "clip_saturation", ".4f"),
)


def compare(run_a: str, run_b: str) -> str:
    ra, rb = load_rounds(run_a), load_rounds(run_b)
    name_a = load_meta(run_a).get("run_id", run_a)
    name_b = load_meta(run_b).get("run_id", run_b)
    headers = ["metric", name_a, name_b, "delta"]
    rows = []
    for label, field, spec in _COMPARE_FIELDS:
        ma, mb = _mean(ra, field), _mean(rb, field)
        if ma is None and mb is None:
            continue
        delta = (mb - ma) if (ma is not None and mb is not None) else None
        rows.append([label, _fmt(ma, spec), _fmt(mb, spec), _fmt(delta, "+" + spec)])
    rows.append(["rounds", str(len(ra)), str(len(rb)), "-"])
    return _table(rows, headers)


def tail(run_dir: str, n: int = 10) -> str:
    events = list(iter_events(run_dir))[-n:]
    return "\n".join(json.dumps(ev) for ev in events)


def validate_dir(run_dir: str) -> List[str]:
    try:
        meta = load_meta(run_dir)
    except (OSError, json.JSONDecodeError) as e:
        return [f"meta.json unreadable: {e}"]
    try:
        events = list(iter_events(run_dir))
    except json.JSONDecodeError as e:
        return [f"events.jsonl unreadable: {e}"]
    problems = validate_run(meta, events)
    if not events:
        problems.append("no events recorded")
    return problems


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description="run-log toolchain"
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("summarize", "tail", "validate"):
        sp = sub.add_parser(name)
        sp.add_argument("run_dir")
        if name == "tail":
            sp.add_argument("-n", type=int, default=10)
    cp = sub.add_parser("compare")
    cp.add_argument("run_a")
    cp.add_argument("run_b")
    args = p.parse_args(argv)

    if args.cmd == "summarize":
        print(summarize(args.run_dir))
    elif args.cmd == "tail":
        print(tail(args.run_dir, args.n))
    elif args.cmd == "compare":
        print(compare(args.run_a, args.run_b))
    elif args.cmd == "validate":
        problems = validate_dir(args.run_dir)
        if problems:
            for prob in problems:
                print(f"INVALID: {prob}", file=sys.stderr)
            return 1
        print(f"{args.run_dir}: valid")
    return 0
