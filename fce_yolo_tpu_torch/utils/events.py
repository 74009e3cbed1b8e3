"""Usage events with a local spool (reference ``fce_yolo_tpu/utils/events.py``).

The same call contract as the reference: ``EVENTS(cfg)`` from the CLI
entrypoint, at most 25 queued events, rate-limited flushes, disabled under
tests, and enabled only when ``SETTINGS["sync"]`` opts in. Events go to a
JSONL file in the port's config directory (``utils/settings.py``); nothing
leaves the machine.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

from fce_yolo_tpu_torch.utils.settings import SETTINGS, _config_dir
from fce_yolo_tpu_torch.utils.sysinfo import CPUInfo, GitRepo

__all__ = ["Events", "EVENTS"]

_TASKS = {"detect", "segment", "classify", "pose", "obb"}
_MODES = {"train", "val", "predict", "track", "export", "benchmark", "solutions"}


class Events:
    """Queue usage events; flush them to a JSONL spool at most every
    ``rate_limit`` seconds (reference ``Events``: metadata captured once,
    ``other`` for a task or mode outside the known ones, one enable gate
    computed at construction)."""

    def __init__(self, path: str | Path | None = None) -> None:
        self.events: list[dict] = []
        self.rate_limit = 30.0
        self.t = 0.0
        from fce_yolo_tpu_torch import __version__

        self.metadata = {
            "cli": Path(sys.argv[0]).name in ("yolo-tpu-torch", "__main__.py"),
            "install": "git" if GitRepo().root else "pip",
            "python": ".".join(map(str, sys.version_info[:2])),
            "cpu": CPUInfo.name(),
            "version": __version__,
            "session_id": round(time.time() * 1e3) % 2**31,
        }
        self.path = Path(path) if path else _config_dir() / "events.jsonl"
        self.enabled = bool(SETTINGS.get("sync")) and "pytest" not in sys.modules

    def __call__(self, cfg, device=None) -> None:
        """Queue one event from a run cfg; flush if the rate limit elapsed."""
        if not self.enabled:
            return
        if len(self.events) < 25:
            task = getattr(cfg, "task", None) or (cfg.get("task") if isinstance(cfg, dict) else None)
            mode = getattr(cfg, "mode", None) or (cfg.get("mode") if isinstance(cfg, dict) else None)
            model = getattr(cfg, "model", None) or (cfg.get("model") if isinstance(cfg, dict) else None)
            self.events.append({
                "name": str(mode) if mode in _MODES else "other",
                "params": {
                    **self.metadata,
                    "task": str(task) if task in _TASKS else "other",
                    "model": str(model) if model else "other",
                    "device": str(device) if device is not None else "cuda",
                },
            })
        now = time.time()
        if now - self.t < self.rate_limit:
            return
        self.flush(now)

    def flush(self, now: float | None = None) -> None:
        """Append queued events to the local spool and reset the queue."""
        if not self.events:
            return
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self.path.open("a") as f:
                for e in self.events:
                    f.write(json.dumps(e, separators=(",", ":")) + "\n")
        except OSError:
            pass
        self.events = []
        self.t = now if now is not None else time.time()


EVENTS = Events()
