"""Results analysis: results.csv loading, best-epoch extraction, ablation tables.

A copy of the JAX package's ``experiments/analysis.py``, a rebuild of the
fork's script/analysis.py (load_results; best epoch = idxmax of mAP50-95)
and of the table in run_ablation.py:597-599 / paper_plots.py. It reads the
port's ``results.csv``, whose columns are the JAX trainer's.
"""

from __future__ import annotations

import csv
from pathlib import Path

__all__ = ["load_results", "best_epoch", "ablation_table", "format_table"]

MAP_KEY = "metrics/mAP50-95(B)"
MAP50_KEY = "metrics/mAP50(B)"


def load_results(run_dir: str | Path) -> list[dict]:
    """Read a run's results.csv into a list of typed row dicts."""
    path = Path(run_dir) / "results.csv"
    if not path.exists():
        raise FileNotFoundError(f"no results.csv in {run_dir}")
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            out = {}
            for k, v in row.items():
                if v is None or v == "":
                    out[k] = None
                    continue
                try:
                    out[k] = float(v) if "." in v or "e" in v.lower() else int(v)
                except ValueError:
                    out[k] = v
            rows.append(out)
    return rows


def best_epoch(rows: list[dict], key: str = MAP_KEY) -> dict:
    """Row with max mAP50-95 (fork's best-epoch convention, analysis.py)."""
    scored = [r for r in rows if isinstance(r.get(key), (int, float))]
    if not scored:
        raise ValueError(f"no rows with {key}")
    return max(scored, key=lambda r: r[key])


def ablation_table(
    runs: dict[str, str | Path],
    baseline: str | None = None,
    key: str = MAP_KEY,
) -> list[dict]:
    """Build the M1->M4 ablation summary: best mAP per variant + delta vs
    baseline and vs the previous row (reference run_ablation.py:597-599)."""
    names = list(runs)
    base = baseline or names[0]
    table = []
    prev_map = None
    base_map = None
    for name in names:
        b = best_epoch(load_results(runs[name]), key=key)
        m = float(b[key]) * 100
        if name == base:
            base_map = m
        row = {
            "model": name,
            "epoch": b.get("epoch"),
            "mAP50": round(float(b.get(MAP50_KEY, 0.0) or 0.0) * 100, 2),
            "mAP50-95": round(m, 2),
            "delta_vs_baseline": round(m - base_map, 2) if base_map is not None else None,
            "delta_vs_prev": round(m - prev_map, 2) if prev_map is not None else None,
        }
        prev_map = m
        table.append(row)
    return table


def format_table(rows: list[dict]) -> str:
    """Plain-text aligned table."""
    if not rows:
        return "(empty)"
    keys = list(rows[0])
    widths = {k: max(len(str(k)), *(len(str(r.get(k, ""))) for r in rows)) for k in keys}
    lines = [" | ".join(f"{k:>{widths[k]}}" for k in keys)]
    lines.append("-+-".join("-" * widths[k] for k in keys))
    for r in rows:
        lines.append(" | ".join(f"{str(r.get(k, '')):>{widths[k]}}" for k in keys))
    return "\n".join(lines)
