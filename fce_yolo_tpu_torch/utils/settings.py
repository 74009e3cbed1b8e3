"""Versioned persistent user settings (reference ``fce_yolo_tpu/utils/settings.py``).

A JSON file at ``~/.config/fce_yolo_tpu_torch/settings.json``, or in
``$FCE_YOLO_TORCH_CONFIG_DIR``: the port's own file, never the JAX
package's. Unknown keys are dropped and missing keys defaulted on load, and
a file of another ``settings_version`` is reset, as in the reference.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

__all__ = ["SettingsManager", "SETTINGS", "DEFAULTS"]

DEFAULTS: dict[str, Any] = {
    "settings_version": "1.0",
    "datasets_dir": "datasets",
    "weights_dir": "weights",
    "runs_dir": "runs",
    "tensorboard": False,
    "sync": False,  # usage events go to a local spool only when on (utils/events.py)
}


def _config_dir() -> Path:
    return Path(os.environ.get("FCE_YOLO_TORCH_CONFIG_DIR", Path.home() / ".config" / "fce_yolo_tpu_torch"))


class SettingsManager(dict):
    """The settings dict, read from ``path`` (written with the defaults when
    missing or unreadable) and written back on every ``update`` and
    ``reset``."""

    def __init__(self, path: str | Path | None = None):
        super().__init__(DEFAULTS)
        self.path = Path(path) if path else _config_dir() / "settings.json"
        self.load()

    def load(self):
        try:
            data = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            self.save()
            return
        if data.get("settings_version") != DEFAULTS["settings_version"]:
            self.reset()
            return
        for k in DEFAULTS:
            if k in data:
                self[k] = data[k]

    def save(self):
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(json.dumps(dict(self), indent=2))
        except OSError:
            pass

    def update(self, *args, **kwargs):  # type: ignore[override]
        new = dict(*args, **kwargs)
        unknown = set(new) - set(DEFAULTS)
        if unknown:
            raise KeyError(f"unknown settings {sorted(unknown)}; valid: {sorted(DEFAULTS)}")
        super().update(new)
        self.save()

    def reset(self):
        self.clear()
        super().update(DEFAULTS)
        self.save()


SETTINGS = SettingsManager()
