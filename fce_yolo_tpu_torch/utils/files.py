"""Run directories (reference ``fce_yolo_tpu/utils/files.py:18-70``):
``runs/train`` -> ``runs/train2`` -> ..., and the latest ``last`` checkpoint
for ``resume=True``."""

from __future__ import annotations

import glob
import os
from pathlib import Path

__all__ = ["increment_path", "get_latest_run"]


def increment_path(path: str | Path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """The next free ``path{N}`` (N from 2) when ``path`` exists, else
    ``path``; ``exist_ok=True`` returns ``path`` unchanged (resume)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                path = Path(p)
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def get_latest_run(search_dir: str = ".") -> str:
    """The most recently created ``weights/last`` checkpoint under
    ``search_dir`` (a directory holding ``meta.json``), or ""."""
    cands = glob.glob(f"{search_dir}/**/weights/last/meta.json", recursive=True)
    return max(cands, key=os.path.getctime).rsplit("/meta.json", 1)[0] if cands else ""
