"""Dependency-free progress bar (reference ``fce_yolo_tpu/utils/tqdm.py``, line for line).

A single small class covering the tqdm API surface the framework uses:
iterate, manual ``update``, ``desc``/``postfix``, context manager. Rendering
adapts to the console: interactive ttys get an in-place carriage-return bar;
non-interactive consoles (CI logs, redirected output) get sparse newline
snapshots (~every 10% or 30 s) so logs stay readable.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Iterable, Iterator

__all__ = ["TQDM"]


def _fmt_time(seconds: float) -> str:
    if not (seconds >= 0) or seconds == float("inf"):
        return "?"
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    return f"{h:d}:{m:02d}:{s:02d}" if h else f"{m:02d}:{s:02d}"


def _fmt_num(n: float) -> str:
    for div, suffix in ((1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(n) >= div:
            return f"{n / div:.1f}{suffix}"
    return f"{n:.0f}" if n == int(n) else f"{n:.2f}"


class TQDM:
    """Progress bar over an iterable or a manually-updated counter.

    Examples:
        >>> for x in TQDM(range(100), desc="caching"):
        ...     work(x)
        >>> with TQDM(total=n_files, desc="scan", unit="img") as bar:
        ...     bar.update(8)
    """

    def __init__(
        self,
        iterable: Iterable | None = None,
        desc: str = "",
        total: int | None = None,
        disable: bool = False,
        unit: str = "it",
        leave: bool = True,
        file=None,
        mininterval: float = 0.1,
        **_: Any,  # absorb unused tqdm kwargs (bar_format, ncols, ...)
    ):
        self.iterable = iterable
        self.desc = desc
        self.total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None
        )
        self.disable = disable
        self.unit = unit
        self.leave = leave
        self.file = file or sys.stderr
        self.n = 0
        self.postfix = ""
        self._start = time.perf_counter()
        self._last_render = 0.0
        self._last_frac = -1.0
        self._tty = bool(getattr(self.file, "isatty", lambda: False)())
        self._min_dt = mininterval if self._tty else 30.0
        self._closed = False

    # ------------------------------------------------------------- display
    def _bar(self, width: int = 12) -> str:
        if not self.total:
            return ""
        fill = int(width * min(self.n / self.total, 1.0))
        return "|" + "█" * fill + "-" * (width - fill) + "| "

    def _line(self) -> str:
        elapsed = time.perf_counter() - self._start
        rate = self.n / elapsed if elapsed > 0 else 0.0
        if self.total:
            pct = 100.0 * self.n / self.total
            eta = (self.total - self.n) / rate if rate > 0 else float("inf")
            counts = f"{pct:3.0f}% {self._bar()}{_fmt_num(self.n)}/{_fmt_num(self.total)}"
            timing = f"[{_fmt_time(elapsed)}<{_fmt_time(eta)}, {_fmt_num(rate)}{self.unit}/s]"
        else:
            counts = f"{_fmt_num(self.n)}{self.unit}"
            timing = f"[{_fmt_time(elapsed)}, {_fmt_num(rate)}{self.unit}/s]"
        desc = f"{self.desc}: " if self.desc else ""
        post = f" {self.postfix}" if self.postfix else ""
        return f"{desc}{counts} {timing}{post}"

    def _render(self, final: bool = False) -> None:
        if self.disable:
            return
        now = time.perf_counter()
        frac = self.n / self.total if self.total else 0.0
        # throttle: interactive = every mininterval; logs = every 10% or 30s
        if not final:
            if now - self._last_render < self._min_dt and (
                self._tty or frac - self._last_frac < 0.1
            ):
                return
        self._last_render, self._last_frac = now, frac
        line = self._line()
        if self._tty:
            self.file.write(f"\r{line}\x1b[K")
            if final and self.leave:
                self.file.write("\n")
        else:
            self.file.write(line + "\n")
        self.file.flush()

    # ------------------------------------------------------------- tqdm api
    def update(self, n: int = 1) -> None:
        self.n += n
        self._render()

    def set_description(self, desc: str | None) -> None:
        self.desc = desc or ""

    def set_postfix(self, **kwargs: Any) -> None:
        self.postfix = ", ".join(f"{k}={v}" for k, v in kwargs.items())

    def refresh(self) -> None:
        self._render(final=False)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._render(final=True)

    @staticmethod
    def write(s: str, file=None, end: str = "\n") -> None:
        (file or sys.stdout).write(s + end)

    def __iter__(self) -> Iterator:
        assert self.iterable is not None, "TQDM needs an iterable to iterate"
        try:
            for x in self.iterable:
                yield x
                self.update(1)
        finally:
            self.close()

    def __enter__(self) -> "TQDM":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
