"""Run configuration and the command line of the port (reference
``fce_yolo_tpu/cfg/__init__.py:18-373``).

A flat typed namespace from the port's ``default.yaml`` (read by
``utils/yaml_read.py``: the card machine has no pyyaml), the ``k=v`` CLI
grammar with did-you-mean suggestions for unknown keys, and the
``entrypoint`` behind ``python -m fce_yolo_tpu_torch`` and the
``yolo-tpu-torch`` console script:

    python -m fce_yolo_tpu_torch detect train data=coco8.yaml model=yolo11n-fce.yaml epochs=10
    python -m fce_yolo_tpu_torch val model=runs/detect/train/weights/best data=coco8.yaml device=cpu

The model runs on the card (``device=`` empty) unless ``device=cpu`` or
another torch device is named; without CUDA the card raises.
"""

from __future__ import annotations

import difflib
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Any

import numpy as np

from fce_yolo_tpu_torch.utils.yaml_read import read_yaml

DEFAULT_CFG_PATH = Path(__file__).parent / "default.yaml"

# flags typed by constraint (reference cfg/__init__.py:81-118)
CFG_FLOAT_KEYS = {"warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "time", "workspace", "batch"}
CFG_FRACTION_KEYS = {
    "dropout", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum", "warmup_bias_lr",
    "hsv_h", "hsv_s", "hsv_v", "translate", "scale", "perspective", "flipud", "fliplr",
    "mosaic", "mixup", "cutmix", "copy_paste", "conf", "iou", "fraction",
}
CFG_INT_KEYS = {
    "epochs", "patience", "workers", "seed", "close_mosaic", "max_det", "vid_stride",
    "line_width", "nbs", "save_period", "max_labels",
}
CFG_BOOL_KEYS = {
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr",
    "resume", "profile", "multi_scale", "bf16", "val", "save_json", "plots", "visualize",
    "augment", "agnostic_nms", "show", "save_frames", "save_txt", "save_conf", "save_crop",
    "show_labels", "show_conf", "show_boxes", "int8", "dynamic", "nms", "pretrained",
}

TASKS = ("detect", "segment", "classify", "pose", "obb")
MODES = ("train", "val", "predict", "export", "track", "benchmark")

__all__ = ["get_cfg", "entrypoint", "DEFAULT_CFG_PATH", "load_default_cfg", "check_cfg"]


def load_default_cfg() -> dict[str, Any]:
    return read_yaml(DEFAULT_CFG_PATH.read_text())


def _coerce(k: str, v: Any) -> Any:
    """Parse CLI string values into their typed form."""
    if not isinstance(v, str):
        return v
    low = v.lower()
    if low == "none":
        return None
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if "," in v:
        return [_coerce(k, s) for s in v.split(",") if s]
    return v


def check_cfg(cfg: dict[str, Any]) -> dict[str, Any]:
    """Type-check known keys, raising readable errors (get_cfg:323-387)."""
    for k, v in cfg.items():
        if v is None:
            continue
        if k in CFG_FLOAT_KEYS | CFG_FRACTION_KEYS and not isinstance(v, (int, float)):
            raise TypeError(f"'{k}={v}' must be a number, got {type(v).__name__}")
        if k in CFG_FRACTION_KEYS and not (0.0 <= float(v) <= 1.0):
            raise ValueError(f"'{k}={v}' must be in [0, 1]")
        if k in CFG_INT_KEYS and not isinstance(v, int):
            if isinstance(v, float) and v.is_integer():
                cfg[k] = int(v)
            else:
                raise TypeError(f"'{k}={v}' must be an int, got {type(v).__name__}")
        if k in CFG_BOOL_KEYS and not isinstance(v, bool):
            raise TypeError(f"'{k}={v}' must be a bool, got {type(v).__name__}")
    return cfg


def check_dict_alignment(base: dict, custom: dict):
    """Reject unknown keys with did-you-mean suggestions (cfg/__init__.py:463)."""
    unknown = [k for k in custom if k not in base]
    if unknown:
        msgs = []
        for k in unknown:
            sim = difflib.get_close_matches(k, base.keys(), n=3, cutoff=0.5)
            hint = f" — did you mean {', '.join(repr(s) for s in sim)}?" if sim else ""
            msgs.append(f"'{k}' is not a valid argument{hint}")
        raise SyntaxError("\n".join(msgs))


def get_cfg(overrides: dict[str, Any] | None = None, cfg: dict | str | None = None) -> SimpleNamespace:
    """Merge default.yaml <- optional cfg file <- overrides, typed + validated."""
    base = load_default_cfg()
    if cfg:
        extra = read_yaml(Path(cfg).read_text()) if isinstance(cfg, (str, Path)) else dict(cfg)
        check_dict_alignment(base, extra)
        base.update(extra)
    if overrides:
        overrides = {k: _coerce(k, v) for k, v in overrides.items()}
        check_dict_alignment(base, overrides)
        base.update(overrides)
    return SimpleNamespace(**check_cfg(base))


HELP_MSG = """FCE-YOLO-TPU CLI (PyTorch + CUDA port) — usage:  yolo-tpu-torch TASK MODE [k=v ...]
  (or python -m fce_yolo_tpu_torch TASK MODE [k=v ...])

  TASK: detect (default) | segment | classify | pose | obb
  MODE: train | val | predict | export | track | benchmark
        (export: format=torch_export (.pt2, nms=True bakes in NMS) | native (.fyir);
         stablehlo, saved_model and tflite need JAX or TensorFlow)
  or:   yolo-tpu-torch solutions [count|heatmap|speed|queue|workout|crop|blur|
        isegment|visioneye|analytics|trackzone|inference] source=... [save_dir=...] [k=v ...]
  or:   yolo-tpu-torch version | checks | settings [reset] [k=v ...] | cfg | copy-cfg

  device=: empty runs on the card (cuda), device=cpu on the CPU, device=0 or cuda:0 a given card.

examples:
  yolo-tpu-torch detect train data=coco_custom.yaml model=yolo11n-fce.yaml epochs=100 iou_type=WIoU
  yolo-tpu-torch segment train data=coco8-seg.yaml model=yolo11n-seg.yaml epochs=10
  yolo-tpu-torch classify val model=runs/classify/train/weights/best data=imagenet10/
  yolo-tpu-torch pose predict model=yolo11n-pose.yaml source=images/
  yolo-tpu-torch obb val model=yolo11n-obb.yaml data=dota8.yaml
  yolo-tpu-torch detect export model=runs/detect/train/weights/best format=torch_export nms=True
"""

# reference cfg/__init__.py:134 TASK2MODEL (model YAMLs: nothing downloads)
TASK2MODEL = {
    "detect": "yolo11n.yaml",
    "segment": "yolo11n-seg.yaml",
    "classify": "yolo11n-cls.yaml",
    "pose": "yolo11n-pose.yaml",
    "obb": "yolo11n-obb.yaml",
}


# ``solutions NAME`` -> the solution's class in ``fce_yolo_tpu_torch.solutions`` (reference cfg/__init__.py:145)
SOLUTION_MAP = {
    "count": "ObjectCounter",
    "crop": "ObjectCropper",
    "blur": "ObjectBlurrer",
    "workout": "AIGym",
    "heatmap": "Heatmap",
    "isegment": "InstanceSegmentation",
    "visioneye": "VisionEye",
    "speed": "SpeedEstimator",
    "queue": "QueueManager",
    "analytics": "Analytics",
    "inference": "Inference",
    "trackzone": "TrackZone",
}
SOLUTION_LITERALS = ("region", "regions", "slots", "selected_ids", "kpts", "classes")  # Python literals


def handle_solutions(args: list[str]) -> list:
    """``solutions NAME [k=v ...]`` (reference ``handle_solutions``,
    cfg/__init__.py:161): the solution over ``source=``, the list of each
    frame's result; ``region=``, ``regions=``, ``slots=``, ``selected_ids=``,
    ``kpts=`` and ``classes=`` are Python literals, ``device=`` places the
    model (empty: the card), and with ``save_dir=`` each frame's ``plot_im``
    is written there as ``<i>.jpg`` (the forward DCT on that device).
    ``inference`` writes its own frames and gives their paths (the reference
    raises on them: ROADMAP queue 3, item 41)."""
    import ast

    import fce_yolo_tpu_torch.solutions as S
    from fce_yolo_tpu_torch.utils.patches import imwrite

    name = args[0] if args and "=" not in args[0] else "count"
    if name == "help" or name not in SOLUTION_MAP:
        print(f"solutions: one of {sorted(SOLUTION_MAP)}")
        return []
    kv: dict[str, Any] = {}
    for a in args[1:] if (args and "=" not in args[0]) else args:
        k, v = a.split("=", 1)
        kv[k] = ast.literal_eval(v) if k in SOLUTION_LITERALS else _coerce(k, v)
    source = kv.pop("source", None)
    if not source:
        raise SyntaxError(f"solutions {name} requires source=<path>")
    save_dir = kv.pop("save_dir", None)
    sol = getattr(S, SOLUTION_MAP[name])(**kv)
    device = sol.model.device
    results = []
    for i, r in enumerate(sol(source)):
        results.append(r)
        if save_dir and getattr(r, "plot_im", None) is not None:
            out = Path(save_dir)
            out.mkdir(parents=True, exist_ok=True)
            imwrite(out / f"{i:06d}.jpg", np.ascontiguousarray(r.plot_im), device=device)
    return results


def handle_settings(args: list[str]) -> dict:
    """`settings [reset] [k=v ...]` (reference handle_yolo_settings:
    cfg/__init__.py:555) — print, reset, or update the persistent settings."""
    from fce_yolo_tpu_torch.utils.settings import SETTINGS

    if args and args[0] == "reset":
        SETTINGS.reset()
        print("settings reset to defaults")
    elif args:
        SETTINGS.update({k: _coerce(k, v) for k, v in
                         (a.split("=", 1) for a in args if "=" in a)})
    print(f"settings file: {SETTINGS.path}")
    for k, v in SETTINGS.items():
        print(f"  {k}={v}")
    return dict(SETTINGS)


def copy_default_cfg() -> Path:
    """Copy default.yaml next to cwd for editing (reference copy_default_cfg,
    cfg/__init__.py:805) and print the follow-up usage hint."""
    import shutil

    dst = Path.cwd() / DEFAULT_CFG_PATH.name.replace(".yaml", "_copy.yaml")
    shutil.copy2(DEFAULT_CFG_PATH, dst)
    print(f"{DEFAULT_CFG_PATH} copied to {dst}\n"
          f"usage example: yolo-tpu-torch cfg={dst.name} detect train data=coco8.yaml")
    return dst


def select_device(device):
    """The torch device of ``device=``: empty means the card, an int that
    card (the reference chose a JAX platform here, cfg/__init__.py:292-294).
    Where CUDA is absent, ``YOLO`` raises for a card, as it does outside
    the CLI."""
    import torch

    if isinstance(device, list):
        raise NotImplementedError(f"device={','.join(map(str, device))}: more than one card is ROADMAP queue 1, "
                                  "item 11 (distributed)")
    return torch.device("cuda" if device in (None, "") else f"cuda:{device}" if isinstance(device, int) else device)


def entrypoint(argv: list[str] | None = None) -> Any:
    """CLI: `yolo-tpu-torch [task] [mode] k=v ...` (reference entrypoint:824-995)."""
    args = list(argv if argv is not None else sys.argv[1:])
    if not args:
        print(HELP_MSG)
        return None

    # special no-mode commands (reference entrypoint:853-870), accepted with
    # the same spelling forgiveness: singular forms and -/-- prefixes
    def _version():
        import fce_yolo_tpu_torch

        print(fce_yolo_tpu_torch.__version__)
        return fce_yolo_tpu_torch.__version__

    def _checks():
        from fce_yolo_tpu_torch.utils.checks import collect_system_info

        return collect_system_info()

    special = {
        "help": lambda rest: print(HELP_MSG),
        "version": lambda rest: _version(),
        "checks": lambda rest: _checks(),
        "settings": handle_settings,
        "cfg": lambda rest: print(DEFAULT_CFG_PATH.read_text()),
        "copy-cfg": lambda rest: copy_default_cfg(),
        "solutions": handle_solutions,
    }
    aliases = dict(special)
    for k in list(special):
        if len(k) > 1 and k.endswith("s"):
            aliases[k[:-1]] = special[k]  # singular: "setting", "check"
    for k in list(aliases):
        aliases[f"-{k}"] = aliases[f"--{k}"] = aliases[k]
    aliases["-h"] = aliases["help"]

    task, mode, kv = "detect", None, {}
    for i, a in enumerate(args):
        if "=" in a and not a.startswith("-"):
            k, v = a.split("=", 1)
            kv[k] = v
        elif a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        elif a.lower() in aliases:
            return aliases[a.lower()](args[i + 1:])
        elif a in CFG_BOOL_KEYS:
            kv[a] = "true"  # bare bool flag, e.g. `predict ... save`
        else:
            raise SyntaxError(f"unrecognized argument {a!r}\n{HELP_MSG}")
    if mode is None:
        raise SyntaxError(f"no mode given (one of {MODES})\n{HELP_MSG}")

    # default model per task (reference entrypoint:931 TASK2MODEL); when a
    # model IS given, its spec decides the task (reference guess_model_task)
    model_src = kv.pop("model", None) or TASK2MODEL[task]
    source = kv.pop("source", None)
    data = kv.pop("data", None)
    cfg_file = kv.pop("cfg", None)  # cfg=custom.yaml full-config override
    if cfg_file:
        print(f"Overriding {DEFAULT_CFG_PATH} with {cfg_file}")
    cfg = get_cfg(cfg=cfg_file,
                  overrides={**kv, "task": task, "mode": mode, "model": model_src})
    device = select_device(cfg.device)

    from fce_yolo_tpu_torch.api import YOLO
    from fce_yolo_tpu_torch.utils.events import EVENTS

    EVENTS(cfg, device)  # local JSONL spool; only when SETTINGS["sync"] opts in
    model = YOLO(model_src, device=device)
    if mode == "train":
        assert data, "train requires data=<dataset.yaml>"
        return model.train(
            data=data, epochs=cfg.epochs, batch=int(cfg.batch), imgsz=cfg.imgsz,
            optimizer=cfg.optimizer, lr0=kv.get("lr0") and float(kv["lr0"]), lrf=cfg.lrf,
            cos_lr=cfg.cos_lr, iou_type=cfg.iou_type, close_mosaic=cfg.close_mosaic,
            patience=cfg.patience, workers=cfg.workers, max_labels=cfg.max_labels,
            project=cfg.project or f"runs/{model.task}", name=cfg.name or "train",
            val=cfg.val, save_period=cfg.save_period, seed=cfg.seed, verbose=cfg.verbose,
            hsv_h=cfg.hsv_h, hsv_s=cfg.hsv_s, hsv_v=cfg.hsv_v, degrees=cfg.degrees,
            translate=cfg.translate, scale=cfg.scale, shear=cfg.shear,
            perspective=cfg.perspective, flipud=cfg.flipud, fliplr=cfg.fliplr,
            mosaic=cfg.mosaic, mixup=cfg.mixup, cutmix=cfg.cutmix,
            # the reference accepts these six and drops them (ROADMAP queue 3, item 30)
            resume=cfg.resume, freeze=cfg.freeze, exist_ok=cfg.exist_ok, time_limit_hours=cfg.time,
            plots=cfg.plots, copy_paste=cfg.copy_paste,
        )
    if mode == "val":
        assert data, "val requires data=<dataset.yaml>"
        res = model.val(data=data, imgsz=cfg.imgsz, batch=int(cfg.batch),
                        conf=cfg.conf or 0.001, iou=cfg.iou, max_det=cfg.max_det,
                        workers=cfg.workers, verbose=cfg.verbose)
        return {k: v for k, v in res.items() if isinstance(v, float)}
    if mode == "predict":
        assert source, "predict requires source=<path>"
        results = model.predict(source, conf=cfg.conf or 0.25, iou=cfg.iou,
                                imgsz=cfg.imgsz, max_det=cfg.max_det)
        if cfg.verbose:  # reference per-image log line (engine/predictor.py)
            for i, r in enumerate(results):
                print(f"image {i + 1}/{len(results)} {r.path}: {r.verbose()}")
        if cfg.save or cfg.save_txt or cfg.save_crop:
            out_dir = Path(cfg.project or f"runs/{model.task}") / (cfg.name or "predict")
            out_dir.mkdir(parents=True, exist_ok=True)
            for i, r in enumerate(results):
                if r.path in ("array", "pil"):
                    stem = f"im{i}"
                elif "#frame" in r.path:  # video source: one file per frame
                    v, fi = r.path.rsplit("#frame", 1)
                    stem = f"{Path(v).stem}_frame{fi}"
                else:
                    stem = Path(r.path).stem
                if cfg.save:
                    r.save(str(out_dir / f"{stem}.jpg"))
                if cfg.save_txt:
                    r.save_txt(str(out_dir / "labels" / f"{stem}.txt"), save_conf=cfg.save_conf)
                if cfg.save_crop:
                    r.save_crop(str(out_dir / "crops"), f"{stem}.jpg")
        return results
    if mode == "track":
        assert source, "track requires source=<path>"
        out = model.track(source, tracker=cfg.tracker, conf=cfg.conf or 0.25,
                          iou=cfg.iou, imgsz=cfg.imgsz)
        if cfg.save:  # annotated frames with track ids (reference save=True)
            from fce_yolo_tpu_torch.utils.annotator import Annotator
            from fce_yolo_tpu_torch.utils.patches import imwrite

            out_dir = Path(cfg.project or f"runs/{model.task}") / (cfg.name or "track")
            out_dir.mkdir(parents=True, exist_ok=True)
            for i, (r, tracks) in enumerate(out):
                ann = Annotator(r.orig_img.copy(), cfg.line_width or 2, device=device)
                for row in tracks:
                    ann.box_label(row[:4], f"id{int(row[4])} {model.names.get(int(row[6]), '')}",
                                  color=(0, 255, 0))
                imwrite(out_dir / f"{i:06d}.jpg", ann.result(), device=device)
        return out
    if mode == "export":
        return model.export(format=cfg.format, imgsz=cfg.imgsz, nms=cfg.nms, int8=cfg.int8)
    if mode == "benchmark":
        from fce_yolo_tpu_torch.utils.benchmarks import benchmark

        return benchmark(model, imgsz=cfg.imgsz, data=data, batch=int(cfg.batch))
    raise NotImplementedError(f"mode {mode!r}")
