"""``YOLO`` facade of the port (reference ``fce_yolo_tpu/api.py:77-995``):
predict, embed, track, val and train for detect, segment, pose and OBB,
predict, val and train for classify, checkpoints, the model summary,
``export``, ``benchmark`` and ``tune``; ``YOLO(artifact)`` predicts and
validates through ``nn/autobackend.py``, ``YOLO("tcp://host:port")``
predicts through a remote ``serve.InferenceServer``."""

from __future__ import annotations

import copy
import csv
import subprocess
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from fce_yolo_tpu_torch.cfg.models import load_model_dict, packaged_model_dict
from fce_yolo_tpu_torch.nn.model import (build_model, estimate_flops, fold_conv_bn, init_weights, is_folded,
                                         param_count, weights_version)
from fce_yolo_tpu_torch.nn.import_torch import import_torch_state_dict, load_pt_state_dict
from fce_yolo_tpu_torch.nn.modules import ConvBNAct
from fce_yolo_tpu_torch.nn.weights import key_to_flax, variables_to_state_dict
from fce_yolo_tpu_torch.utils.checkpoint import (is_checkpoint, is_jax_checkpoint, load_checkpoint,
                                                 load_jax_checkpoint, save_checkpoint)

EMBED_BATCH = 64  # images a forward in ``embed``
OPTIM_KEYS = ("momentum", "weight_decay", "warmup_epochs", "warmup_momentum", "warmup_bias_lr", "nbs")


def _jax_cfg(cfg_yaml: str) -> str:
    """The config of a JAX checkpoint's ``cfg_yaml`` (a path on the machine
    that trained it): its file name when a packaged config has that name,
    else the path as given (a user's own YAML)."""
    name = Path(cfg_yaml).name
    return name if packaged_model_dict(name) is not None else cfg_yaml


def _is_folded_tree(model: torch.nn.Module, params: Mapping[str, Any]) -> bool:
    """Whether flax ``params`` of ``model``'s architecture were folded by the
    JAX ``fold_conv_bn`` (``fce_yolo_tpu/nn/model.py:419``): the scope of
    the model's first ConvBNAct has no ``bn``."""
    for name, m in model.named_modules():
        if isinstance(m, ConvBNAct):
            _, path = key_to_flax(model, f"{name}.conv.weight")
            node = params
            for p in path[:-2]:
                node = node.get(p, {})
            return "bn" not in node
    return False


def _git_describe() -> dict:
    """The checkout's commit and whether it has local changes, for checkpoint provenance."""
    root = Path(__file__).resolve().parent.parent
    try:
        sha = subprocess.run(["git", "-C", str(root), "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=5).stdout.strip()
        dirty = bool(subprocess.run(["git", "-C", str(root), "status", "--porcelain"],
                                    capture_output=True, text=True, timeout=5).stdout.strip())
    except (OSError, subprocess.SubprocessError):
        return {"commit": None, "dirty": None}
    return {"commit": sha or None, "dirty": dirty if sha else None}


class YOLO:
    """Detection model facade: ``YOLO("yolo11s-fce.yaml", device="cuda")``.

    ``model`` is a model name or YAML (built with ``nc`` classes if given,
    initialized from seed 0, as the JAX facade's lazy init); a checkpoint
    directory written by ``save``/``train`` (built from its ``meta.json``,
    folded if it was saved folded, weights loaded); a checkpoint directory
    of the JAX package (``meta.json`` + orbax ``tree/``, read without orbax:
    ``utils/checkpoint.py::load_jax_checkpoint``; its ``cfg_yaml`` resolved
    by file name among the packaged configs, folded if its tree was saved
    after the JAX ``fuse()``); or an Ultralytics ``.pt`` file (the
    architecture from the file name, ``yolo11n.pt`` -> ``yolo11n.yaml``
    with ``nc`` classes; ``nn/import_torch.py``). The model lives on
    ``device``: the card unless another is named; no CUDA raises.
    ``reset_weights`` re-seeds, ``load`` reads any of these weights into
    this architecture, ``load_jax_variables`` loads weights exported from
    the JAX package. ``predict`` runs a folded copy of the model, made once
    per version of the weights; ``model`` keeps its BatchNorm unless
    ``fuse`` folds it.

    ``model`` may also be an exported artifact (``.pt2`` or ``.fyir``,
    read by ``AutoBackend`` on ``device``: predict and val at the
    artifact's size, detect boxes only) or a ``tcp://host:port`` URL of an
    inference server (``utils/remote.py``: predict only, detect, rows in
    each image's pixels; ``device`` is where files are decoded), as in the
    JAX facade (api.py:85-112).
    """

    def __init__(self, model: str | Path = "yolo11n.yaml", device: torch.device | str = "cuda", nc: int | None = None):
        self.device = torch.device(device)
        self.ckpt_meta: dict[str, Any] = {}
        self._folded_copy: tuple[tuple | None, torch.nn.Module] | None = None  # (weights_version, folded copy)
        self._tracker: tuple[str, Any] | None = None  # (tracker config, tracker) that ``track(persist=True)`` keeps
        self.yaml_overrides: dict[str, Any] = {}
        self.backend = None  # AutoBackend when built from an exported artifact
        self.remote = None  # RemoteModel when built from a tcp:// URL
        if isinstance(model, str) and model.startswith("tcp://"):
            from fce_yolo_tpu_torch.utils.remote import RemoteModel

            self.remote = RemoteModel(model)
            self._no_model(model, {i: f"class_{i}" for i in range(80)}, (8, 16, 32))
            return
        from fce_yolo_tpu_torch.nn.autobackend import AutoBackend, is_exported_artifact

        if is_exported_artifact(model):
            self.backend = AutoBackend(model, device=self.device)
            self._no_model(str(model), self.backend.names, self.backend.strides)
            return
        if is_jax_checkpoint(model):
            tree, meta = load_jax_checkpoint(model, device=self.device)
            self._build(_jax_cfg(meta["cfg_yaml"]), meta.get("scale"), meta.get("nc"), meta.get("yaml_overrides"))
            self._load_jax_tree(tree)
            self.names = {int(k): v for k, v in meta.get("names", {}).items()} or self.names
            self.ckpt_meta = meta
        elif is_checkpoint(model):
            tree, meta = load_checkpoint(model)
            self._build(meta["cfg_yaml"], meta.get("scale"), meta.get("nc"), meta.get("yaml_overrides"))
            if meta.get("folded"):
                fold_conv_bn(self.model)
            self.model.load_state_dict(tree["model"])
            self.names = {int(k): v for k, v in meta.get("names", {}).items()}
            self.ckpt_meta = meta
        elif str(model).endswith(".pt"):
            self._build(Path(model).with_suffix(".yaml").name, nc=nc)
            import_torch_state_dict(load_pt_state_dict(str(model)), self.model)
        else:
            self._build(str(model), nc=nc)
            self.reset_weights(0)

    def _no_model(self, source: str, names: dict[int, str], strides: tuple) -> None:
        """A facade without a model of its own (an artifact, a server)."""
        self.model, self.spec, self.strides = None, None, tuple(strides)
        self.cfg_yaml, self.scale, self.names = source, None, dict(names)

    def _build(self, cfg: str, scale: str | None = None, nc: int | None = None,
               overrides: Mapping[str, Any] | None = None) -> None:
        """Build the model of ``cfg`` with ``nc`` classes and the model-dict
        ``overrides`` a training set (a pose head's ``kpt_shape`` from the
        data); checkpoints record the overrides and rebuild with them."""
        d, guessed = load_model_dict(cfg)
        if nc is not None:
            d["nc"] = nc
        self.yaml_overrides = dict(overrides or {})
        d.update(self.yaml_overrides)
        self.cfg_yaml, self.scale = cfg, scale or guessed
        self.model, self.spec, self.strides = build_model(d, scale=self.scale, device=self.device)
        self.scale = self.spec.scale
        self.names = {i: f"class_{i}" for i in range(self.spec.nc)}

    @property
    def nc(self) -> int:
        return self.spec.nc if self.spec is not None else len(self.names)

    @property
    def task(self) -> str:
        """"detect", "segment", "pose", "obb" or "classify", from the model's
        head; an artifact's from its metadata, a server's "detect"."""
        if self.remote is not None:
            return "detect"
        if self.backend is not None:
            return self.backend.meta.get("task", "detect")
        return self.spec.task


    @property
    def folded(self) -> bool:
        """Whether the facade's model is folded (``fuse``, or a folded checkpoint): it predicts but cannot train."""
        return is_folded(self.model)

    def reset_weights(self, seed: int = 0) -> "YOLO":
        """Re-initialize all parameters from ``seed`` (reference Model.reset_weights)."""
        init_weights(self.model, torch.Generator().manual_seed(seed))
        return self

    def load_jax_variables(self, variables: Mapping[str, Any]) -> "YOLO":
        """Load flax ``{"params", "batch_stats"}`` (numpy leaves) from the JAX package.

        The bridge (``nn/weights.py``) must fill every tensor of this model;
        fold before loading if the variables are folded.
        """
        sd = variables_to_state_dict(variables, self.model)
        self.model.load_state_dict(sd, strict=True)
        return self

    def _load_jax_tree(self, tree: Mapping[str, Any]) -> None:
        """Load a JAX checkpoint's ``params``/``batch_stats``, folding the
        model first when the tree was saved after the JAX ``fuse()`` (its
        ConvBNAct scopes hold a conv bias and no ``bn``), or building it
        anew unfolded when the model is folded and the tree is not."""
        params = tree["params"]
        folded_tree = _is_folded_tree(self.model, params)
        if folded_tree and not self.folded:
            fold_conv_bn(self.model)
        elif self.folded and not folded_tree:
            self._build(self.cfg_yaml, self.scale, self.nc, self.yaml_overrides)
        self.load_jax_variables({"params": params, "batch_stats": tree.get("batch_stats", {})})

    def load(self, weights: str | Path) -> "YOLO":
        """Load weights into this architecture (reference Model.load,
        ``fce_yolo_tpu/api.py:155-170``): a checkpoint directory of the port
        or of the JAX package (its class names too), or an Ultralytics
        ``.pt`` file. The model is folded, or built anew unfolded, as the
        checkpoint was saved; a ``.pt`` loads unfolded."""
        if is_jax_checkpoint(weights):
            tree, meta = load_jax_checkpoint(weights, device=self.device)
            self._load_jax_tree(tree)
            if meta.get("names"):
                self.names = {int(k): v for k, v in meta["names"].items()}
            return self
        if not is_checkpoint(weights):
            if not str(weights).endswith(".pt"):
                raise ValueError(f"cannot load weights from {weights!r}: not a checkpoint directory (meta.json) or "
                                 "a .pt file")
            if self.folded:
                self._build(self.cfg_yaml, self.scale, self.nc, self.yaml_overrides)
            import_torch_state_dict(load_pt_state_dict(str(weights)), self.model)
            return self
        tree, meta = load_checkpoint(weights)
        if bool(meta.get("folded")) != self.folded:
            if self.folded:
                self._build(self.cfg_yaml, self.scale, self.nc, self.yaml_overrides)
            else:
                fold_conv_bn(self.model)
        self.model.load_state_dict(tree["model"])
        if meta.get("names"):
            self.names = {int(k): v for k, v in meta["names"].items()}
        return self

    def _meta(self, extra: dict | None = None) -> dict:
        over = {"yaml_overrides": self.yaml_overrides} if self.yaml_overrides else {}
        return {"cfg_yaml": self.cfg_yaml, "scale": self.scale, "nc": self.nc, "names": self.names,
                "folded": self.folded, **over, **(extra or {})}

    def save(self, path: str | Path, extra_meta: dict | None = None) -> str:
        """Write the model's weights and ``meta.json`` to the directory ``path``."""
        return save_checkpoint(path, {"model": _cpu(self.model.state_dict())}, self._meta(extra_meta))

    def fuse(self) -> "YOLO":
        """Fold Conv+BN into conv weights in place (reference Model.fuse);
        idempotent. ``save`` records the fold and a load builds the model
        folded; a folded facade cannot ``train``."""
        fold_conv_bn(self.model)
        return self

    def info(self, flops: bool = False, imgsz: int = 640) -> dict:
        """Model summary (reference ``YOLO.info``, api.py:224): {"params",
        "nc", "strides", "yaml"} and, with ``flops``, "gflops" of one image at
        ``imgsz`` (``nn/model.py::estimate_flops``)."""
        out = {"params": param_count(self.model), "nc": self.nc, "strides": self.strides, "yaml": self.cfg_yaml}
        if flops:
            out["gflops"] = estimate_flops(self.model, imgsz=imgsz) / 1e9
        return out

    def _inference_model(self) -> torch.nn.Module:
        """A copy of the model with Conv+BN folded, for ``predict``; folded
        again only when ``weights_version`` shows the weights changed (the
        reference's ``_maybe_fold``, engine/predictor.py:247-268)."""
        if self.model is None:
            raise NotImplementedError(f"{self.cfg_yaml} is an exported artifact or a server: it predicts and "
                                      "validates detect boxes only")
        key = weights_version(self.model)
        if key is None or self._folded_copy is None or self._folded_copy[0] != key:
            self._folded_copy = None  # free the old copy first
            self._folded_copy = (key, fold_conv_bn(copy.deepcopy(self.model)).eval())
        return self._folded_copy[1]

    def to(self, dtype_or_device) -> "YOLO":
        """Move the model to a dtype (e.g. ``torch.bfloat16``) or a device."""
        self.model.to(dtype_or_device)
        self.device = next(self.model.parameters()).device
        return self

    def __call__(self, source, **kw):
        """``predict(source, **kw)``, as the JAX facade's call (api.py:329-330)."""
        return self.predict(source, **kw)

    def export(self, format: str = "torch_export", imgsz: int = 640, **kw) -> str:
        """Export to a deployable artifact; returns its path (reference
        ``YOLO.export``, api.py:333; ``engine/exporter.py``). Formats:
        ``torch_export`` (a ``.pt2`` program, ``batch``, ``nms``, ``conf``,
        ``iou``, ``max_det``, ``out_dir``) and ``native`` (``.fyir`` +
        ``.fybin`` for ``native/infer/fy_infer.cpp``); ``stablehlo``,
        ``saved_model`` and ``tflite`` need JAX or TensorFlow and raise."""
        from fce_yolo_tpu_torch.engine.exporter import export_model

        if self.model is None:
            raise NotImplementedError(f"{self.cfg_yaml} has no model to export: it is an artifact or a server")
        return export_model(self, fmt=format, imgsz=imgsz, **kw)

    def benchmark(self, data=None, imgsz: int = 640, **kw) -> list[dict]:
        """The benchmark table (reference ``YOLO.benchmark``, api.py:341;
        ``utils/benchmarks.py::benchmark``): the ``torch (native)`` row (a
        bfloat16 copy of the model through the predictor path; mAP50-95 of
        ``val`` on ``data`` when given), then a row per JAX export format
        (``stablehlo`` as ``torch_export``; the TensorFlow ones ``FAILED``)."""
        from fce_yolo_tpu_torch.utils.benchmarks import benchmark as _benchmark

        return _benchmark(self, data=data, imgsz=imgsz, **kw)

    def tune(self, data, space: dict | None = None, iterations: int = 10, use_ray: bool = False,
             **train_kw) -> dict:
        """Evolutionary hyperparameter search over short trainings of this
        model's config on its device (reference ``YOLO.tune``, api.py:349;
        ``engine/tuner.py``); ``use_ray`` routes to the Ray Tune bridge,
        which raises without ``ray``."""
        from fce_yolo_tpu_torch.engine.tuner import DEFAULT_SPACE, Tuner

        if use_ray:
            from fce_yolo_tpu_torch.engine.tuner import run_ray_tune

            return run_ray_tune(self, space=space, max_samples=iterations, data=data, **train_kw)
        base = {"model": self.cfg_yaml, "data": data, "device": self.device, **train_kw}
        t = Tuner(space=space or DEFAULT_SPACE, base_args=base)
        return t(iterations=iterations)

    def predict(self, source, conf: float = 0.25, iou: float = 0.7, imgsz: int = 640, max_det: int = 300,
                batch: int = 1, stream: bool = False, classes: list[int] | None = None, verbose: bool = False):
        """Predict on ``source``: an image file, a directory, an MJPEG
        ``.avi`` video, a numpy BGR image, a PIL image, or a list of these
        (``engine/predictor.py::load_source``). Returns a list of
        ``Results`` (boxes, and masks,
        keypoints or oriented boxes by the task), or with ``stream`` a
        generator of them. ``classes`` keeps only those class ids (NMS
        offsets boxes by class, so a filter after it keeps the same boxes);
        ``verbose`` prints a line an image. Files decode on the model's
        device. Runs a folded copy of the model (``_inference_model``). A
        classify model gives each image's ``probs`` (``_predict_classify``;
        ``imgsz`` 640 means its 224)."""
        from fce_yolo_tpu_torch.engine.predictor import DetectionPredictor

        if self.remote is not None:
            gen = self._predict_remote(source)
        elif self.backend is not None:
            self._detect_artifact("predict")
            gen = DetectionPredictor(None, self.names, imgsz=self.backend.imgsz, conf=conf, iou=iou, max_det=max_det,
                                     batch_size=batch, infer_fn=self.backend).stream(source)
        elif self.task == "classify":
            gen, classes = self._predict_classify(source, imgsz=imgsz if imgsz != 640 else 224, batch=batch), None
        else:
            gen = DetectionPredictor(self._inference_model(), self.names, imgsz=imgsz, conf=conf, iou=iou,
                                     max_det=max_det, batch_size=batch).stream(source)
        gen = _postfilter(gen, classes, verbose)
        return gen if stream else list(gen)

    def _detect_artifact(self, what: str) -> None:
        if self.task != "detect":
            raise NotImplementedError(f"{what} of an exported {self.task} artifact: an artifact gives detect boxes "
                                      "only (fy_infer's image mode runs the task's post-processing)")

    def _predict_remote(self, source):
        """Remote predict (reference ``_predict_remote``, api.py:299-310):
        each frame to the server; its rows, already in the frame's pixels,
        wrapped as ``Results``."""
        from fce_yolo_tpu_torch.engine.predictor import load_source
        from fce_yolo_tpu_torch.engine.results import Results

        for img, path in load_source(source, self.device):
            t0 = time.perf_counter()
            rows = self.remote(img)
            ms = (time.perf_counter() - t0) * 1000.0
            yield Results(img, path, self.names, boxes=rows,
                          speed={"preprocess": 0.0, "inference": ms, "postprocess": 0.0}, device=self.device)

    def _predict_classify(self, source, imgsz: int = 224, batch: int = 1):
        """Classification predict (reference ``_predict_classify``,
        api.py:312-329): each image through ``val_transform`` (BGR -> RGB,
        / 255), ``batch`` images a forward of the folded model, softmax ->
        ``Results.probs``."""
        from fce_yolo_tpu_torch.data.classify import val_transform
        from fce_yolo_tpu_torch.engine.predictor import load_source
        from fce_yolo_tpu_torch.engine.results import Results

        model = self._inference_model()
        dtype = next(model.parameters()).dtype
        pending: list[tuple[np.ndarray, str, np.ndarray]] = []

        def flush():
            t0 = time.perf_counter()
            x = torch.from_numpy(np.stack([x for _, _, x in pending])).to(self.device).permute(0, 3, 1, 2)
            with torch.inference_mode():
                probs = model((x.float() / 255.0).to(dtype))["probs"].cpu().numpy()
            ms = (time.perf_counter() - t0) * 1000 / len(pending)
            for (img, path, _), p in zip(pending, probs):
                yield Results(img, path, self.names, probs=p,
                              speed={"preprocess": 0.0, "inference": ms, "postprocess": 0.0}, device=self.device)
            pending.clear()

        for img, path in load_source(source, self.device):
            pending.append((img, path, np.ascontiguousarray(val_transform(img, imgsz)[..., ::-1])))
            if len(pending) == batch:
                yield from flush()
        if pending:
            yield from flush()

    def embed(self, source, imgsz: int = 640) -> list[np.ndarray]:
        """One feature vector an image of ``source`` (what ``predict``
        takes; reference api.py:365): the image letterboxed to ``imgsz``
        (BGR -> RGB, / 255), the folded model (``_inference_model``, the plain
        graph: no stem kernel), the deepest level of the Detect head's
        output maps (4 * reg_max + nc channels) averaged over H and W. float32
        vectors; the images run ``EMBED_BATCH`` a forward."""
        from fce_yolo_tpu_torch.data.augment import letterbox
        from fce_yolo_tpu_torch.engine.predictor import load_source

        model = self._inference_model()
        dtype = next(model.parameters()).dtype
        imgs = [np.ascontiguousarray(letterbox(img, imgsz)[0][..., ::-1])  # BGR -> RGB
                for img, _ in load_source(source, self.device)]
        out: list[np.ndarray] = []
        with torch.inference_mode():
            for i in range(0, len(imgs), EMBED_BATCH):
                x = torch.from_numpy(np.stack(imgs[i: i + EMBED_BATCH])).to(self.device).permute(0, 3, 1, 2)
                feats = model((x.float() / 255.0).to(dtype))["feats"][-1]
                out.extend(feats.float().mean((2, 3)).cpu().numpy())
        return out

    def track(self, source, tracker: str = "bytetrack.yaml", stream: bool = False, persist: bool = False,
              conf: float | None = None, batch: int | None = None, **predict_kw):
        """Detection and multi-object tracking over ``source`` (what
        ``predict`` takes: frames, a directory of frame images, files, an
        MJPEG ``.avi`` video; reference api.py:388): a list, or with
        ``stream`` a generator, of (Results, tracks (M, 7) [x1, y1, x2, y2,
        id, score, cls]) a frame.
        ``tracker`` is a tracker YAML (``bytetrack.yaml``, ``botsort.yaml``
        or a path). Two differences from the JAX facade, which are the
        Ultralytics ``Model.track``'s: ``conf`` defaults to 0.1 and ``batch``
        to 1 (at predict's 0.25, ByteTrack's second association, on scores in
        (0.1, 0.25), never sees a detection); ``persist=True`` keeps the
        tracker of the last call, and its ids, where the JAX facade starts a
        new one every call. Segment and pose models track their boxes, OBB
        models the axis-aligned hulls of their rotated boxes (``Results.boxes``),
        and a classify model, which has no boxes, gives empty tracks, as in
        the JAX facade."""
        from fce_yolo_tpu_torch.trackers.track import _crop_embed_encoder, build_tracker, track_stream

        if not (persist and self._tracker is not None and self._tracker[0] == str(tracker)):
            self._tracker = (str(tracker), build_tracker(tracker, encoder=_crop_embed_encoder(self)))
        gen = track_stream(self, source, self._tracker[1], conf=0.1 if conf is None else conf,
                           batch=1 if batch is None else batch, **predict_kw)
        return gen if stream else list(gen)

    def val(self, data, imgsz: int = 640, batch: int = 16, conf: float = 0.001, iou: float = 0.7,
            max_det: int = 300, workers: int = 8, verbose: bool = True, save_json=None, plots_dir=None) -> dict:
        """mAP on the ``val`` split of ``data`` (a data YAML path or dict;
        baseline JPEG, PNG or ``.npy`` images), on the model's device (JPEGs
        decode there too). The dataset's class
        names replace ``class_*`` placeholders. Returns the validator's
        results dict. A classify model takes a class-folder directory
        (``_val_classify``; ``imgsz`` 640 means its 224). ``plots_dir``: a
        detect model writes the first batch's label and prediction mosaics
        there; the task heads draw nothing, as the JAX package's."""
        from fce_yolo_tpu_torch.data.dataset import check_det_dataset

        if self.remote is not None:
            raise NotImplementedError("a server predicts only: validate the model it serves")
        if self.task == "classify":
            return self._val_classify(data, imgsz=imgsz if imgsz != 640 else 224, batch=batch, verbose=verbose)
        d = check_det_dataset(data)
        if not self.names or all(v.startswith("class_") for v in self.names.values()):
            self.names = d["names"]
        if self.backend is not None:  # the artifact's size (reference api.py:411-417)
            from fce_yolo_tpu_torch.engine.validator import DetectionValidator

            self._detect_artifact("val")
            validator = DetectionValidator(None, self.names, imgsz=self.backend.imgsz, conf=conf, iou=iou,
                                           max_det=max_det, batch_size=batch, workers=workers, infer_fn=self.backend)
            return validator(data=d, verbose=verbose, save_json=save_json, plots_dir=plots_dir)
        validator = self._validator(imgsz=imgsz, conf=conf, iou=iou, max_det=max_det, batch_size=batch,
                                    workers=workers)
        return validator(data=d, verbose=verbose, save_json=save_json, plots_dir=plots_dir)

    def _val_classify(self, data, imgsz: int = 224, batch: int = 16, verbose: bool = True) -> dict:
        """Top-1 and top-5 accuracy on the ``val`` split of the class-folder
        directory ``data`` (else ``test``, else ``data`` itself; reference
        ``_val_classify``, api.py:425-467), ``batch`` images a forward of the
        folded model; the dataset's class names replace ``class_*``
        placeholders."""
        from fce_yolo_tpu_torch.data.classify import ClassificationDataset

        root = Path(data)
        split = next((root / s for s in ("val", "test") if (root / s).is_dir()), root)
        ds = ClassificationDataset(split, imgsz=imgsz, mode="val", device=self.device)
        if not self.names or all(v.startswith("class_") for v in self.names.values()):
            self.names = dict(ds.names)
        res = _classify_accuracy(self._inference_model(), ds, batch, self.device)
        if verbose:
            print(f"top1 {res['metrics/accuracy_top1']:.3f}  top5 {res['metrics/accuracy_top5']:.3f}  "
                  f"({len(ds)} images)")
        return res

    def _validator(self, model: torch.nn.Module | None = None, **kw):
        """The task's validator on ``model`` (the facade's unless another,
        such as training's EMA copy, is given; reference ``_make_validator``,
        api.py:469-490)."""
        from fce_yolo_tpu_torch.engine.seg_validator import SegmentationValidator
        from fce_yolo_tpu_torch.engine.task_validators import OBBValidator, PoseValidator
        from fce_yolo_tpu_torch.engine.validator import DetectionValidator

        model = self.model if model is None else model
        if self.task == "segment":
            return SegmentationValidator(model, self.names, **kw)
        if self.task == "pose":
            return PoseValidator(model, self.names, kpt_shape=model.detect.kpt_shape, **kw)
        if self.task == "obb":
            return OBBValidator(model, self.names, **kw)
        return DetectionValidator(model, self.names, **kw)

    def train(self, data, epochs: int = 100, batch: int = 16, imgsz: int = 640, optimizer: str = "auto",
              lr0: float | None = None, lrf: float = 0.01, cos_lr: bool = False, iou_type: str = "CIoU",
              close_mosaic: int = 10, patience: int = 100, workers: int = 8, max_labels: int = 128,
              project: str = "runs/detect", name: str = "train", val: bool = True, save_period: int = -1,
              seed: int = 0, verbose: bool = True, freeze: int | list | None = None, resume: bool = False,
              exist_ok: bool = False, time_limit_hours: float | None = None, bf16: bool | None = None,
              plots: bool = True, **hyp_overrides) -> dict:
        """Train on ``data`` (a data YAML path or dict) on the model's device
        (reference ``api.py:495-881``), with the task's loss: detection,
        segmentation (the batch carries the instance masks), pose (the
        keypoints; the data's ``kpt_shape`` rebuilds a head of another
        shape, and its ``flip_idx`` swaps left and right on a flip) or OBB
        (rotated boxes from the corners); a classify model trains on a
        class-folder directory (``_train_classify``).

        After every epoch: a val of the task on the EMA model (if ``val``), a row of
        ``results.csv``, ``weights/last`` (EMA weights and the full train
        state, for ``resume``) and, when the fitness improves, ``weights/best``
        (EMA weights). The best weights are loaded at the end. ``bf16=None``
        means bfloat16 autocast on a card, float32 on the CPU. ``plots``:
        write the first epoch's first three batches as ``train_batch0..2.jpg``
        (``plot_images``; oriented boxes as their axis-aligned hulls) and, at
        the end, ``results.png`` from ``results.csv`` (``plot_results``). The
        reference prints a failure of that figure and goes on; here it
        raises, as the renderer needs no optional package.
        ``hyp_overrides``: ``AugmentCfg`` fields, the optimizer's (momentum,
        weight_decay, warmup_*, nbs), ``state_bf16`` and ``bf16_ema``.

        Returns {"save_dir", "best_fitness", "epochs_run", "results" (the csv
        rows), "speed" (per epoch: img/s and the per-step split in ms)}.
        """
        if self.task == "classify":
            return self._train_classify(data, epochs=epochs, batch=batch, imgsz=imgsz, optimizer=optimizer,
                                        lr0=lr0, lrf=lrf, cos_lr=cos_lr, patience=patience, project=project,
                                        name=name, val=val, seed=seed, verbose=verbose, exist_ok=exist_ok or resume,
                                        bf16=bf16, **hyp_overrides)
        from fce_yolo_tpu_torch.data.augment import AugmentCfg
        from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
        from fce_yolo_tpu_torch.data.loader import DataLoader
        from fce_yolo_tpu_torch.train.loss import DetectionLossCfg
        from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer, accumulate_steps, boundary_schedule
        from fce_yolo_tpu_torch.train.task_losses import task_loss_for
        from fce_yolo_tpu_torch.train.trainer import EarlyStopping, create_train_state, make_train_step
        from fce_yolo_tpu_torch.utils.files import get_latest_run, increment_path

        if self.folded:
            raise RuntimeError("YOLO.train: the model is folded (YOLO.fuse() or a checkpoint saved folded): its "
                               "BatchNorms are gone, so it cannot train; build the model anew or load an unfolded "
                               "checkpoint")
        d = check_det_dataset(data)
        over = {}  # the data's kpt_shape makes the pose head (reference PoseTrainer)
        if self.task == "pose" and d.get("kpt_shape") and tuple(d["kpt_shape"]) != self.model.detect.kpt_shape:
            over["kpt_shape"] = [int(x) for x in d["kpt_shape"]]
        if d["nc"] != self.nc or over:  # another class count or keypoint shape rebuilds the model
            self._build(self.cfg_yaml, self.scale, d["nc"], {**self.yaml_overrides, **over})
            self.reset_weights(0)
        self.names = d["names"]
        kpt_shape = tuple(self.model.detect.kpt_shape) if self.task == "pose" else (17, 3)
        hyp = AugmentCfg(**{k: v for k, v in hyp_overrides.items() if k in AugmentCfg.__dataclass_fields__})
        train_ds = YOLODataset(d["train"], imgsz=imgsz, mode="train", hyp=hyp, nc=d["nc"], seed=seed,
                               device=self.device, task=self.task, kpt_shape=kpt_shape, flip_idx=d.get("flip_idx"))
        loader = DataLoader(train_ds, batch_size=batch, workers=workers, max_labels=max_labels, seed=seed)
        steps_per_epoch = len(loader)
        save_dir = increment_path(Path(project) / name, exist_ok=resume or exist_ok, mkdir=True)

        optim_cfg = OptimCfg(optimizer=optimizer, lr0=lr0 if lr0 is not None else 0.01, lrf=lrf, cos_lr=cos_lr,
                             batch_size=batch, epochs=epochs, steps_per_epoch=max(steps_per_epoch, 1), nc=d["nc"],
                             state_bf16=bool(hyp_overrides.get("state_bf16")),
                             **{k: v for k, v in hyp_overrides.items() if k in OPTIM_KEYS})
        if lr0 is not None and optimizer == "auto":
            optim_cfg = optim_cfg._replace(optimizer="AdamW" if epochs * steps_per_epoch <= 10000 else "SGD")
        loss_cfg = DetectionLossCfg(nc=d["nc"], strides=tuple(self.strides), iou_type=iou_type)
        accumulate = accumulate_steps(optim_cfg)
        bounds = ni_map = None
        if accumulate > 1:
            bounds, ni_map = boundary_schedule(optim_cfg)
        model = self.model
        opt = Optimizer(optim_cfg, model, freeze=freeze, ni_map=ni_map)
        state = create_train_state(model, opt, accumulate=accumulate,
                                   ema_dtype=torch.bfloat16 if hyp_overrides.get("bf16_ema") else None)
        if bf16 is None:  # the autocast analog is on for the accelerator
            bf16 = self.device.type == "cuda"
        task_loss, extra_keys = task_loss_for(self.task, loss_cfg, kpt_shape,
                                              end2end=self.spec.layers[-1].name == "v10Detect")
        batch_keys = ("img", "cls", "bboxes", "mask", *extra_keys)
        step_fn = make_train_step(model, opt, loss_cfg, bf16=bf16, accumulate=accumulate, boundaries=bounds,
                                  task_loss=task_loss)

        start_epoch = 0
        if resume and not is_checkpoint(save_dir / "weights" / "last"):
            latest = get_latest_run(str(project))  # the newest run under project
            if latest:
                save_dir = Path(latest).parent.parent
                if verbose:
                    print(f"resume: picked up latest run {save_dir}")
        if resume and is_checkpoint(save_dir / "weights" / "last"):
            tree, meta0 = load_checkpoint(save_dir / "weights" / "last", map_location=self.device)
            state.load_state_dict(tree["train_state"])
            start_epoch = int(meta0.get("epoch", -1)) + 1
            if verbose:
                print(f"resuming from epoch {start_epoch} ({save_dir / 'weights' / 'last'})")

        ema_model = copy.deepcopy(model).eval()  # the EMA weights with the live buffers, for val and saving
        ema_params = [p for _, p in ema_model.named_parameters()]

        def sync_ema_model() -> None:
            with torch.no_grad():
                torch._foreach_copy_(ema_params, state.ema.params)
                for (_, b_ema), (_, b) in zip(ema_model.named_buffers(), model.named_buffers()):
                    b_ema.copy_(b)

        validator = self._validator(ema_model, imgsz=imgsz, batch_size=batch, workers=workers) if val else None
        val_loader = validator.get_dataloader(d) if validator else None
        if verbose:
            n_params = sum(p.numel() for p in model.parameters())
            print(f"train: {self.cfg_yaml} scale={self.scale} params={n_params:,} nc={d['nc']} imgsz={imgsz} "
                  f"batch={batch} epochs={epochs} steps/epoch={steps_per_epoch} optimizer={opt.cfg.optimizer} "
                  f"device={self.device} bf16={bf16}")

        stopper = EarlyStopping(patience)
        best_fitness = -1.0
        csv_rows: list[dict] = []
        speed: list[dict] = []
        t_start = time.time()
        meta: dict = {}
        for epoch in range(start_epoch, epochs):
            loader.set_epoch(epoch, close_mosaic_at=close_mosaic, total_epochs=epochs)
            t0 = time.perf_counter()
            sums: dict[str, float] = {}
            n_logged = nb = 0
            t_wait = t_step = t_sync = 0.0
            batches = iter(loader)
            try:
                while True:
                    tw = time.perf_counter()
                    b = next(batches, None)
                    t_wait += time.perf_counter() - tw
                    if b is None:
                        break
                    if plots and epoch == start_epoch and nb < 3:
                        _plot_train_batch(b, self.names, save_dir / f"train_batch{nb}.jpg", self.device)
                    ts = time.perf_counter()
                    bdev = {k: torch.from_numpy(b[k]).to(self.device) for k in batch_keys}
                    state, m = step_fn(state, bdev)
                    t_step += time.perf_counter() - ts
                    t_sync += m["sync_s"]
                    nb += 1
                    if nb == 1 or nb % 10 == 0 or nb == steps_per_epoch:
                        keys = ("loss", "box", "cls", "dfl")
                        for k, v in zip(keys, torch.stack([m[k].float() for k in keys]).tolist()):
                            sums[k] = sums.get(k, 0.0) + v
                        n_logged += 1
            finally:
                batches.close()
            train_s = time.perf_counter() - t0
            n_logged = max(n_logged, 1)
            row = {"epoch": epoch, "time": round(time.time() - t_start, 2),
                   "train/box_loss": sums.get("box", 0.0) / n_logged,
                   "train/cls_loss": sums.get("cls", 0.0) / n_logged,
                   "train/dfl_loss": sums.get("dfl", 0.0) / n_logged}

            sync_ema_model()
            fitness = None
            tv = time.perf_counter()
            if validator is not None:
                res = validator(dataloader=val_loader, verbose=False)
                fitness = res["fitness"]
                row.update({k: v for k, v in res.items() if k.startswith("metrics/")})
                row["fitness"] = fitness
            val_s = time.perf_counter() - tv
            csv_rows.append(row)
            _write_csv(save_dir / "results.csv", csv_rows)
            per = 1e3 / max(nb, 1)
            speed.append({"epoch": epoch, "img_per_s": nb * batch / max(train_s, 1e-9), "loader_wait_ms": t_wait * per,
                          "step_ms": t_step * per, "sync_ms": t_sync * per, "val_s": val_s})

            # last: EMA weights + the whole train state (resume); best: EMA weights only
            meta = {"epoch": epoch, "fitness": fitness, "git": _git_describe(),
                    "train_args": {"data": str(data) if not isinstance(data, dict) else "<dict>", "epochs": epochs,
                                   "batch": batch, "imgsz": imgsz, "iou_type": iou_type}}
            ema_sd = _cpu(ema_model.state_dict())
            save_checkpoint(save_dir / "weights" / "last",
                            {"model": ema_sd, "train_state": _cpu(state.state_dict())}, self._meta(meta))
            if fitness is not None and fitness > best_fitness:
                best_fitness = fitness
                save_checkpoint(save_dir / "weights" / "best", {"model": ema_sd}, self._meta(meta))
            if save_period > 0 and (epoch + 1) % save_period == 0:
                save_checkpoint(save_dir / "weights" / f"epoch{epoch}", {"model": ema_sd}, self._meta(meta))
            if verbose:
                fit_s = f" fitness={fitness:.4f}" if fitness is not None else ""
                s = speed[-1]
                print(f"epoch {epoch + 1}/{epochs} loss(box/cls/dfl)={row['train/box_loss']:.3f}/"
                      f"{row['train/cls_loss']:.3f}/{row['train/dfl_loss']:.3f}{fit_s} ({train_s:.1f}s train, "
                      f"{s['img_per_s']:.1f} img/s; per step: loader wait {s['loader_wait_ms']:.1f} ms, step "
                      f"{s['step_ms']:.1f} ms of which the sync {s['sync_ms']:.1f} ms; val {val_s:.1f}s)")
            if time_limit_hours is not None and (time.time() - t_start) > time_limit_hours * 3600:
                if verbose:
                    print(f"time limit {time_limit_hours}h reached at epoch {epoch + 1}")
                break
            if stopper(epoch, fitness):
                if verbose:
                    print(f"early stop at epoch {epoch + 1} (patience {patience})")
                break

        if plots and csv_rows:
            from fce_yolo_tpu_torch.utils.plotting import plot_results

            plot_results(save_dir)  # the training-curve grid, results.png
        # the facade keeps the best weights if fitness was tracked, else the last EMA weights
        best_dir = save_dir / "weights" / "best"
        if best_fitness >= 0 and is_checkpoint(best_dir):
            self.load(best_dir)
        elif csv_rows:
            self.model.load_state_dict(ema_model.state_dict())
        self.model.eval()
        return {"save_dir": str(save_dir), "best_fitness": best_fitness, "epochs_run": len(csv_rows),
                "results": csv_rows, "speed": speed}

    def _train_classify(self, data, epochs: int = 100, batch: int = 16, imgsz: int = 640, optimizer: str = "auto",
                        lr0: float | None = None, lrf: float = 0.01, cos_lr: bool = False, patience: int = 100,
                        project: str = "runs/detect", name: str = "train", val: bool = True, seed: int = 0,
                        verbose: bool = True, exist_ok: bool = False, bf16: bool | None = None, **hyp) -> dict:
        """Classification training (reference ``_train_classify``,
        api.py:883-995) on the class-folder directory ``data`` (``train``,
        and ``val`` else ``test``): the port's optimizer, EMA and train step
        with ``classification_loss``, one optimizer step a batch (the
        reference accumulates nothing here), the items of an epoch in a
        permutation drawn from ``default_rng(seed)``, a batch short of
        ``batch`` dropped. The model is rebuilt when the folder's class
        count differs from ``nc``. After every epoch: top-1/top-5 of the EMA
        model on the val split (the mean over its images; queue 3 item 21:
        the reference averages per-batch means over a padded last batch), a
        row of ``results.csv``, ``weights/last`` and, when the top-1
        improves, ``weights/best`` (EMA weights, with the class names). The
        facade keeps the last epoch's EMA weights, as the reference does.
        Of ``hyp``, only ``momentum``, ``weight_decay`` and
        ``warmup_epochs`` are read. ``bf16=None`` means bfloat16 autocast on
        a card, float32 on the CPU."""
        from fce_yolo_tpu_torch.data.classify import ClassificationDataset, classify_collate
        from fce_yolo_tpu_torch.train.loss import DetectionLossCfg
        from fce_yolo_tpu_torch.train.optim import OptimCfg, Optimizer
        from fce_yolo_tpu_torch.train.task_losses import task_loss_for
        from fce_yolo_tpu_torch.train.trainer import EarlyStopping, create_train_state, make_train_step
        from fce_yolo_tpu_torch.utils.files import increment_path

        if self.folded:
            raise RuntimeError("YOLO.train: the model is folded; build the model anew or load an unfolded checkpoint")
        root = Path(data)
        train_ds = ClassificationDataset(root / "train", imgsz=imgsz, mode="train", seed=seed, device=self.device)
        val_ds = ClassificationDataset(root / ("val" if (root / "val").exists() else "test"), imgsz=imgsz,
                                       mode="val", device=self.device) if val else None
        if len(train_ds.names) != self.nc:
            self._build(self.cfg_yaml, self.scale, len(train_ds.names), self.yaml_overrides)
            self.reset_weights(0)
        self.names = dict(train_ds.names)
        n = len(train_ds)
        steps = max(n // batch, 1)
        cfg = OptimCfg(optimizer=optimizer, lr0=lr0 if lr0 is not None else 0.01, lrf=lrf, cos_lr=cos_lr,
                       batch_size=batch, epochs=epochs, steps_per_epoch=steps, nc=self.nc,
                       **{k: hyp[k] for k in ("momentum", "weight_decay", "warmup_epochs") if k in hyp})
        model = self.model
        state = create_train_state(model, Optimizer(cfg, model))
        if bf16 is None:
            bf16 = self.device.type == "cuda"
        task_loss, _ = task_loss_for("classify", DetectionLossCfg(nc=self.nc))
        step_fn = make_train_step(model, state.optimizer, DetectionLossCfg(nc=self.nc), bf16=bf16,
                                  task_loss=task_loss)
        save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)
        (save_dir / "weights").mkdir(parents=True, exist_ok=True)
        ema_model = copy.deepcopy(model).eval()
        ema_params = [p for _, p in ema_model.named_parameters()]
        if verbose:
            print(f"train: {self.cfg_yaml} scale={self.scale} classes={self.nc} imgsz={imgsz} batch={batch} "
                  f"epochs={epochs} steps/epoch={steps} optimizer={state.optimizer.cfg.optimizer} "
                  f"device={self.device} bf16={bf16}")
        stopper = EarlyStopping(patience)
        rng = np.random.default_rng(seed)
        rows: list[dict] = []
        speed: list[dict] = []
        best = -1.0
        for epoch in range(epochs):
            train_ds.set_epoch(epoch)
            order = rng.permutation(n)
            t0 = time.perf_counter()
            losses: list[torch.Tensor] = []
            t_load = 0.0
            for bi in range(steps):
                idx = order[bi * batch: (bi + 1) * batch]
                if len(idx) < batch:
                    break
                tl = time.perf_counter()
                b = classify_collate([train_ds[int(j)] for j in idx])
                t_load += time.perf_counter() - tl
                bdev = {"img": torch.from_numpy(b["img"]).to(self.device),
                        "cls": torch.from_numpy(b["label"]).to(self.device)}
                state, m = step_fn(state, bdev)
                losses.append(m["loss"].float())
            train_s = time.perf_counter() - t0
            row = {"epoch": epoch, "train/loss": torch.stack(losses).double().mean().item() if losses else 0.0}
            with torch.no_grad():
                torch._foreach_copy_(ema_params, state.ema.params)
                for (_, b_ema), (_, b_live) in zip(ema_model.named_buffers(), model.named_buffers()):
                    b_ema.copy_(b_live)
            fitness = None
            tv = time.perf_counter()
            if val_ds is not None:
                acc = _classify_accuracy(ema_model, val_ds, batch, self.device)
                row.update(acc)
                fitness = acc["metrics/accuracy_top1"]
            speed.append({"epoch": epoch, "img_per_s": len(losses) * batch / max(train_s, 1e-9),
                          "loader_ms": t_load * 1e3 / max(len(losses), 1), "val_s": time.perf_counter() - tv})
            rows.append(row)
            _write_csv(save_dir / "results.csv", rows)
            meta = self._meta({"epoch": epoch, "fitness": fitness})
            ema_sd = _cpu(ema_model.state_dict())
            save_checkpoint(save_dir / "weights" / "last", {"model": ema_sd}, meta)
            if fitness is not None and fitness > best:
                best = fitness
                save_checkpoint(save_dir / "weights" / "best", {"model": ema_sd}, meta)
            if verbose:
                print(f"epoch {epoch + 1}/{epochs} loss={row['train/loss']:.3f}"
                      + (f" top1={fitness:.3f}" if fitness is not None else "")
                      + f" ({speed[-1]['img_per_s']:.1f} img/s)")
            if stopper(epoch, fitness):
                break
        if rows:
            self.model.load_state_dict(ema_model.state_dict())
        self.model.eval()
        return {"save_dir": str(save_dir), "best_fitness": best, "epochs_run": len(rows), "results": rows,
                "speed": speed}


def _classify_accuracy(model: torch.nn.Module, ds, batch: int, device: torch.device) -> dict:
    """Top-1 and top-5 accuracy of ``model`` (in eval mode) over the
    classification dataset ``ds``, the mean over its images (the reference
    pads the last batch to a fixed shape and drops the pads)."""
    from fce_yolo_tpu_torch.data.classify import classify_collate

    dtype = next(model.parameters()).dtype
    t1s: list[torch.Tensor] = []
    t5s: list[torch.Tensor] = []
    with torch.inference_mode():
        for i in range(0, len(ds), batch):
            b = classify_collate([ds[j] for j in range(i, min(i + batch, len(ds)))])
            x = torch.from_numpy(b["img"]).to(device).permute(0, 3, 1, 2)
            y = torch.from_numpy(b["label"]).to(device).long()
            probs = model((x.float() / 255.0).to(dtype))["probs"]
            top5 = torch.argsort(-probs, dim=-1, stable=True)[:, :5]
            t1s.append(top5[:, 0] == y)
            t5s.append((top5 == y[:, None]).any(-1))
    t1 = torch.cat(t1s).double().mean().item() if t1s else 0.0
    t5 = torch.cat(t5s).double().mean().item() if t5s else 0.0
    return {"metrics/accuracy_top1": t1, "metrics/accuracy_top5": t5}


def _postfilter(results, classes: list[int] | None, verbose: bool):
    """Keep only ``classes`` (through ``Results`` indexing, so masks,
    keypoints and oriented boxes stay in step) and print a line an image
    (reference ``_postfilter``, api.py:286-297)."""
    for i, r in enumerate(results):
        if classes is not None:
            r = r[np.isin(r.boxes.cls.astype(int), np.asarray(classes, int))]
        if verbose:
            print(f"image {i + 1} {r.path}: {r.verbose()} {r.speed['inference']:.1f}ms")
        yield r


def _cpu(tree):
    """A copy of a nested dict/list of tensors on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree


def _write_csv(path: Path, rows: list[dict]) -> None:
    keys: list[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def _plot_train_batch(b: dict, names: dict[int, str], fname: Path, device) -> None:
    """``plot_images`` of a train batch (the reference's contract: RGB
    uint8 NHWC, ``cls``, normalised xywh ``bboxes``, ``mask``); a batch of
    oriented boxes (xywhr) draws their axis-aligned hulls."""
    from fce_yolo_tpu_torch.ops.geometry import xywhr2xyxyxyxy
    from fce_yolo_tpu_torch.utils.annotator import plot_images

    bboxes = b["bboxes"]
    if bboxes.shape[-1] == 5:
        h, w = b["img"].shape[1:3]
        scale = np.array([w, h], np.float32)
        xywhr = bboxes.reshape(-1, 5).copy()
        xywhr[:, [0, 2]] *= w
        xywhr[:, [1, 3]] *= h
        corners = xywhr2xyxyxyxy(xywhr) / scale
        lo, hi = corners.min(1), corners.max(1)
        bboxes = np.concatenate([(lo + hi) / 2, hi - lo], 1).reshape(*bboxes.shape[:-1], 4)
    plot_images({"img": b["img"], "cls": b["cls"], "bboxes": bboxes, "mask": b["mask"]}, names=names, fname=fname,
                device=device)
