"""Environment introspection: git state and CPU model (reference
``fce_yolo_tpu/utils/sysinfo.py:18``, ``:91``; its ``TPUInfo`` is not ported).

Both read the filesystem directly, with no ``git`` binary or subprocess, so
they work in minimal containers; they feed the ``checks`` command
(``utils/checks.py::collect_system_info``) and the usage events.
"""

from __future__ import annotations

import platform
import re
from pathlib import Path

__all__ = ["GitRepo", "CPUInfo"]


class GitRepo:
    """Read-only git metadata from the .git directory (reference git.py:9).

    Resolves worktree-style `.git` *files* (gitdir: pointers), symbolic HEAD
    refs, loose ref files and packed-refs — enough to report
    branch/commit/origin without invoking git.
    """

    def __init__(self, path: str | Path | None = None):
        start = Path(path) if path else Path(__file__).resolve()
        self.root: Path | None = None
        self.gitdir: Path | None = None
        for p in [start, *start.parents]:
            g = p / ".git"
            if g.is_dir():
                self.root, self.gitdir = p, g
                break
            if g.is_file():  # worktree/submodule: ".git" is a pointer file
                target = g.read_text().partition("gitdir:")[2].strip()
                if target:
                    self.root, self.gitdir = p, (p / target).resolve()
                break

    @property
    def is_repo(self) -> bool:
        return self.gitdir is not None

    def _read(self, rel: str) -> str | None:
        try:
            return (self.gitdir / rel).read_text().strip()  # type: ignore[operator]
        except (OSError, TypeError):
            return None

    def _resolve_ref(self, ref: str) -> str | None:
        """ref name -> commit sha, via loose ref file then packed-refs."""
        loose = self._read(ref)
        if loose:
            return loose
        packed = self._read("packed-refs") or ""
        for line in packed.splitlines():
            if line.endswith(" " + ref):
                return line.split(" ", 1)[0]
        return None

    @property
    def branch(self) -> str | None:
        head = self._read("HEAD")
        if head and head.startswith("ref:"):
            return head.split("/", 2)[-1]
        return None  # detached HEAD

    @property
    def commit(self) -> str | None:
        head = self._read("HEAD")
        if head is None:
            return None
        if head.startswith("ref:"):
            return self._resolve_ref(head.split(None, 1)[1])
        return head  # detached: HEAD holds the sha itself

    @property
    def origin(self) -> str | None:
        cfg = self._read("config") or ""
        in_origin = False
        for line in cfg.splitlines():
            s = line.strip()
            if s.startswith("["):
                in_origin = s.replace('"', "") == "[remote origin]"
            elif in_origin and s.startswith("url"):
                return s.split("=", 1)[1].strip()
        return None


class CPUInfo:
    """Human-readable CPU model string (reference cpu.py:12)."""

    @staticmethod
    def name() -> str:
        try:
            text = Path("/proc/cpuinfo").read_text()
            m = re.search(r"model name\s*:\s*(.+)", text)
            if m:
                return CPUInfo._clean(m.group(1))
        except OSError:
            pass
        return platform.processor() or platform.machine() or "unknown"

    @staticmethod
    def _clean(s: str) -> str:
        """Strip trademark/frequency noise: 'Intel(R) Xeon(R) CPU @ 2.20GHz'
        -> 'Intel Xeon 2.20GHz'."""
        s = re.sub(r"\((?:R|TM|r|tm)\)|CPU|Processor", "", s)
        s = re.sub(r"\s*@\s*", " ", s)
        return re.sub(r"\s+", " ", s).strip()

    def __str__(self) -> str:
        return self.name()
