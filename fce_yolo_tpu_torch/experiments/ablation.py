"""Fair-ablation pipeline M1->M4 on the port (reference
``fce_yolo_tpu/experiments/ablation.py``, a rebuild of script/run_ablation.py).

Runs the four registry variants {baseline, bifpn, fce, fce_wiou} with the
identical two-stage recipe, validates run integrity (expected epochs,
iou_type echo, stale-artifact detection — reference run_ablation.py:239,
281, 370, 445), and emits the incremental results table (:597-599).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from fce_yolo_tpu_torch.experiments.analysis import ablation_table, format_table, load_results
from fce_yolo_tpu_torch.experiments.config import ABLATION_ORDER, TrainConfig, get_model_config
from fce_yolo_tpu_torch.experiments.trainer import ExperimentTrainer

__all__ = ["run_ablation", "validate_run", "detect_stale_runs"]


def detect_stale_runs(project: str | Path, expected: list[str]) -> list[str]:
    """Find leftover run dirs that would contaminate a fresh ablation
    (reference residue detection, run_ablation.py:281,370)."""
    project = Path(project)
    if not project.exists():
        return []
    return sorted(str(p) for p in project.iterdir() if p.is_dir() and p.name in expected)


def validate_run(run_dir: str | Path, expected_epochs: int, iou_type: str) -> list[str]:
    """Integrity checks on a finished run; returns a list of problems
    (reference run_ablation.py:239,445: epoch count + the iou_type echoed in
    ``weights/best/meta.json``)."""
    problems = []
    run_dir = Path(run_dir)
    try:
        rows = load_results(run_dir)
    except FileNotFoundError:
        return [f"{run_dir}: missing results.csv"]
    # early stop makes fewer epochs legitimate; more than expected is a residue
    if len(rows) > expected_epochs:
        problems.append(f"{run_dir}: {len(rows)} epochs > expected {expected_epochs} (stale run?)")
    meta_path = run_dir / "weights" / "best" / "meta.json"
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        got = meta.get("train_args", {}).get("iou_type")
        if got != iou_type:
            problems.append(f"{run_dir}: trained with iou_type={got}, expected {iou_type}")
    else:
        problems.append(f"{run_dir}: missing best checkpoint")
    return problems


def run_ablation(
    train_cfg: TrainConfig,
    scale: str = "m",
    models: list[str] | None = None,
    clean: bool = False,
    skip_existing: bool = True,
    verbose: bool = True,
    device: torch.device | str = "cuda",
) -> dict:
    """Train the ablation sequence on ``device`` and build the summary table;
    writes it to ``<project>/ablation_<scale>.json``.

    Args:
        train_cfg: shared config (data/batch/imgsz/...; stage overrides merge
            in from each ModelConfig).
        clean: delete stale run dirs first.
        skip_existing: reuse a finished run (its results.csv exists) instead
            of retraining.
    """
    models = models or ABLATION_ORDER
    project = Path(train_cfg.project)
    expected_dirs = []
    for name in models:
        mc = get_model_config(name)
        expected_dirs += [mc.get_result_path(scale, stage=1), mc.get_result_path(scale)]

    stale = detect_stale_runs(project, expected_dirs)
    if stale and clean:
        for s in stale:
            shutil.rmtree(s)

    summaries: dict[str, dict] = {}
    problems: list[str] = []
    runs: dict[str, str] = {}
    for name in models:
        mc = get_model_config(name)
        final_dir = project / mc.get_result_path(scale)
        if skip_existing and (final_dir / "results.csv").exists():
            if verbose:
                print(f"[ablation] reusing existing run {final_dir}")
        else:
            if verbose:
                print(f"[ablation] training {name} ({mc.get_display_name(scale)})")
            trainer = ExperimentTrainer(mc, scale=scale, train_cfg=train_cfg, device=device)
            summaries[name] = trainer.train()
        runs[name] = str(final_dir)
        problems += validate_run(final_dir, mc.stage2.epochs, mc.iou_type if mc.iou_type != "CIoU" else train_cfg.iou_type)

    table = ablation_table(runs, baseline=models[0])
    report = {"table": table, "runs": runs, "problems": problems, "summaries": summaries}
    if verbose:
        print(format_table(table))
        for p in problems:
            print(f"WARNING: {p}")
    project.mkdir(parents=True, exist_ok=True)
    (project / f"ablation_{scale}.json").write_text(
        json.dumps({k: v for k, v in report.items() if k != "summaries"}, indent=2)
    )
    return report
