"""Result packaging (reference ``fce_yolo_tpu/experiments/pack.py``, a
rebuild of script/pack_results.py): bundle an ablation's artifacts
(results.csv, figures, best-checkpoint metadata, summary table) into one
zip for hand-off, with the same members."""

from __future__ import annotations

import json
import zipfile
from pathlib import Path

from fce_yolo_tpu_torch.experiments.analysis import ablation_table, best_epoch, load_results

__all__ = ["pack_results"]

ARTIFACTS = ("results.csv", "results.png", "weights/best/meta.json")


def pack_results(
    runs: dict[str, str | Path],
    out_zip: str | Path = "results_pack.zip",
    include_weights: bool = False,
) -> str:
    """Zip each run's artifacts + a summary.json with the ablation table.

    Args:
        runs: {variant_name: run_dir}.
        include_weights: also pack the best checkpoint's files (large).
    """
    out_zip = Path(out_zip)
    out_zip.parent.mkdir(parents=True, exist_ok=True)
    summary = {"runs": {}, "table": None}
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as z:
        for name, run in runs.items():
            run = Path(run)
            try:
                b = best_epoch(load_results(run))
                summary["runs"][name] = {k: v for k, v in b.items() if isinstance(v, (int, float))}
            except (FileNotFoundError, ValueError):
                summary["runs"][name] = None
            for rel in ARTIFACTS:
                f = run / rel
                if f.exists():
                    z.write(f, f"{name}/{rel}")
            if include_weights:
                best = run / "weights" / "best"
                if best.exists():
                    for f in best.rglob("*"):
                        if f.is_file():
                            z.write(f, f"{name}/weights/best/{f.relative_to(best)}")
        try:
            summary["table"] = ablation_table(runs)
        except (FileNotFoundError, ValueError):
            pass
        z.writestr("summary.json", json.dumps(summary, indent=2))
    return str(out_zip)
