"""Logging and profiling utilities (reference ``fce_yolo_tpu/utils/logger.py``):
the package ``LOGGER``, the ``Profile`` timer, ``SystemLogger`` snapshots,
``trace_profile`` (``torch.profiler`` where the reference wraps
``jax.profiler``) and ``colorstr``."""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

import torch

__all__ = ["LOGGER", "Profile", "SystemLogger", "trace_profile", "colorstr"]


def _make_logger(name: str = "fce_yolo_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(h)
        level = os.environ.get("FCE_YOLO_VERBOSE", "1") == "1"
        logger.setLevel(logging.INFO if level else logging.WARNING)
        logger.propagate = False
    return logger


LOGGER = _make_logger()


class Profile:
    """Accumulating wall-clock timer context (reference ``utils/ops.py:18-70``).
    When the card is in use (this process has initialised CUDA) it
    synchronises the card on entry and exit, so the time covers the work
    queued inside the block.

        with Profile() as t:
            out = model(x)
        print(t.t)  # accumulated seconds
    """

    def __init__(self, t: float = 0.0):
        self.t = t
        self.dt = 0.0

    @staticmethod
    def _sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.dt = time.perf_counter() - self._start
        self.t += self.dt

    def __str__(self):
        return f"{self.t:.6f}s"


@contextmanager
def trace_profile(log_dir: str = "runs/profile"):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when a card is
    present), written to ``log_dir/trace.json`` (chrome://tracing, Perfetto).
    Yields the profiler, so ``prof.key_averages()`` reads the kernels' times."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class SystemLogger:
    """Host and device utilisation snapshots (reference
    ``utils/logger.py:266-430``); the card's memory from
    ``torch.cuda.memory_allocated`` (this process) and
    ``torch.cuda.mem_get_info`` (the whole card)."""

    def snapshot(self) -> dict:
        out: dict = {"time": time.time()}
        try:
            la1, _, _ = os.getloadavg()
            out["cpu_load_1m"] = round(la1, 2)
        except OSError:
            pass
        try:
            import shutil

            du = shutil.disk_usage("/")
            out["disk_used_frac"] = round(du.used / du.total, 3)
        except Exception:
            pass
        try:
            with open("/proc/meminfo") as f:
                info = dict(line.split(":", 1) for line in f if ":" in line)
            total = float(info["MemTotal"].split()[0])
            avail = float(info["MemAvailable"].split()[0])
            out["ram_used_frac"] = round(1 - avail / total, 3)
        except Exception:
            pass
        if torch.cuda.is_available():
            free, total = torch.cuda.mem_get_info()
            out["device_mem_used"] = torch.cuda.memory_allocated()
            out["device_mem_limit"] = total
            out["device_mem_free"] = free
        return out


def colorstr(*input) -> str:
    """ANSI-coloured string: colorstr('blue', 'bold', 'hello') (reference
    utils/__init__.py colorstr). With one argument, blue and bold."""
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
        "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
        "cyan": "\033[36m", "white": "\033[37m",
        "bright_black": "\033[90m", "bright_red": "\033[91m",
        "bright_green": "\033[92m", "bright_yellow": "\033[93m",
        "bright_blue": "\033[94m", "bright_magenta": "\033[95m",
        "bright_cyan": "\033[96m", "bright_white": "\033[97m",
        "end": "\033[0m", "bold": "\033[1m", "underline": "\033[4m",
    }
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]
