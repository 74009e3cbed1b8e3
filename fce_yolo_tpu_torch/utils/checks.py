"""Validation helpers (reference ``fce_yolo_tpu/utils/checks.py``):
``check_imgsz`` (stride-multiple rounding), ``check_version`` (a version
gate), ``check_numeric_stability`` (the ``check_amp`` analog: a bfloat16
forward of the port's model against float32), ``cuda_is_available`` and
``collect_system_info``, which backs the ``checks`` command."""

from __future__ import annotations

import re

import torch

__all__ = ["check_imgsz", "check_version", "check_numeric_stability", "cuda_is_available",
           "collect_system_info"]


def check_imgsz(imgsz, stride: int = 32, min_dim: int = 1, floor: int = 0):
    """Round image size(s) up to the nearest stride multiple
    (reference checks.py check_imgsz semantics)."""
    vals = [imgsz] if isinstance(imgsz, int) else list(imgsz)
    out = [max(int(-(-v // stride) * stride), max(floor, stride)) for v in vals]
    if out != vals:
        print(f"imgsz {vals} not a multiple of stride {stride}; using {out}")
    if isinstance(imgsz, int):
        return out[0]
    if min_dim == 2 and len(out) == 1:
        out = out * 2
    return out


def check_version(current: str, required: str = "") -> bool:
    """Version constraint check: '>=1.2.3', '==...', '<...', bare = '>='."""
    if not required:
        return True

    def parse(v: str):
        return tuple(int(x) for x in re.findall(r"\d+", v)[:3])

    m = re.match(r"([<>=!]*)\s*([\d.]+)", required)
    op, ver = (m.group(1) or ">="), m.group(2)
    c, r = parse(current), parse(ver)
    return {
        ">=": c >= r, ">": c > r, "<=": c <= r, "<": c < r, "==": c == r, "!=": c != r,
    }[op]


def check_numeric_stability(model: torch.nn.Module | None = None, imgsz: int = 64, atol: float = 0.5) -> bool:
    """bfloat16 sanity probe (reference ``check_amp``'s forward): one eval
    forward of ``model`` (a port ``DetectionModel`` on its device; by
    default yolo11n from seed 0 on the card) in float32 and in bfloat16 on the same random
    image; True when the bfloat16 preds are finite and their mean distance
    from the float32 ones is below ``atol``. ``model`` is left as it was."""
    import copy

    import numpy as np

    if model is None:
        from fce_yolo_tpu_torch.nn.model import build_model, init_weights

        model, _, _ = build_model("yolo11n.yaml", device="cuda")
        init_weights(model, torch.Generator().manual_seed(0))
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.random.RandomState(0).rand(1, imgsz, imgsz, 3)).float().permute(0, 3, 1, 2).to(dev)
    with torch.inference_mode():
        f32 = copy.deepcopy(model).float().eval()(x)["preds"]
        bf = copy.deepcopy(model).to(torch.bfloat16).eval()(x.to(torch.bfloat16))["preds"].float()
    return bool(torch.isfinite(bf).all()) and float((f32 - bf).abs().mean()) < atol


def cuda_is_available() -> bool:
    """Whether torch sees a CUDA card."""
    return torch.cuda.is_available()


def collect_system_info(device_timeout: float = 10.0) -> dict:
    """Print and return the environment (reference ``collect_system_info``,
    backing the ``checks`` command): the port's version, Python, the
    platform, the CPU, the checkout's git state, the versions of torch, its
    CUDA, numpy and scipy, and each CUDA card's name and memory. The cards
    are asked in a daemon thread with a timeout, so a diagnostics command
    never hangs."""
    import platform
    import sys
    import threading

    import fce_yolo_tpu_torch
    from fce_yolo_tpu_torch.utils.sysinfo import CPUInfo, GitRepo

    info: dict = {
        "version": fce_yolo_tpu_torch.__version__,
        "python": platform.python_version(),
        "platform": platform.platform(),
        "cpu": CPUInfo.name(),
        "executable": sys.executable,
    }
    repo = GitRepo()
    if repo.is_repo:
        info["git"] = f"{repo.branch or 'detached'} @ {(repo.commit or '?')[:12]}"
    info["torch"] = torch.__version__
    info["cuda"] = torch.version.cuda or "none (a CPU build of torch)"
    for pkg in ("numpy", "scipy"):
        try:
            info[pkg] = getattr(__import__(pkg), "__version__", "installed")
        except ImportError:
            info[pkg] = "not installed"

    devices: list[str] = []
    done = threading.Event()

    def probe():
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                p = torch.cuda.get_device_properties(i)
                devices.append(f"cuda:{i} {p.name} ({p.total_memory / 2**30:.1f} GiB)")
        done.set()

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(device_timeout)
    if not done.is_set():
        info["devices"] = f"unavailable (no response in {device_timeout:.0f}s)"
    else:
        info["devices"] = devices or "none (torch.cuda.is_available() is False)"

    width = max(len(k) for k in info)
    for k, v in info.items():
        print(f"{k:<{width}}  {v}")
    return info
