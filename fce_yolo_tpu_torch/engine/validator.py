"""Detection validator (reference ``fce_yolo_tpu/engine/validator.py:26-337``):
the model and NMS on the model's device, the matching and AP on the host.

Per fixed-shape batch: ``x = img_u8 / 255`` in the model's dtype, the model
in eval mode on the plain graph (no stem kernel, as in the JAX validator),
then ``batched_nms`` multi-label at ``conf=0.001``, ``iou=0.7``,
``max_det=300`` over a pool of ``pre_nms_topk=4096`` candidates, whose
greedy pass is the NMS kernel on a card. With fewer dataset classes than the
model has, the other class channels ride along as ``extra``. Predictions are
matched to the labels in letterbox pixels; only the first ``n_valid`` images
of a batch count. ``TaskValidator`` runs the same pass for the task heads'
validators (``engine/seg_validator.py``, ``engine/task_validators.py``).

A V10Detect model validates end to end, as Ultralytics does: its
``preds6`` are taken as the detections (valid where the score is above
``conf`` and the class is one the data names), with no NMS. The JAX
validator reads ``preds``, which that head does not give, and raises
(ROADMAP queue 3, item 26).

Exported artifacts (reference validator.py:77-94): with ``infer_fn`` (an
``nn/autobackend.py::AutoBackend``) and no model, the batch goes to the
artifact and its raw preds to the same multi-label NMS; a dict means that
NMS ran inside the artifact.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
from fce_yolo_tpu_torch.data.loader import DataLoader
from fce_yolo_tpu_torch.nn.heads import V10Detect
from fce_yolo_tpu_torch.nn.model import DetectionModel
from fce_yolo_tpu_torch.ops.boxes import detr_detections
from fce_yolo_tpu_torch.ops.nms import batched_nms
from fce_yolo_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics, box_iou_np, match_predictions

__all__ = ["DetectionValidator", "RTDETRValidator", "TaskValidator", "xywh_to_xyxy_np"]


class DetectionValidator:
    """Runs a val epoch and returns the results dict (P, R, mAP50, mAP50-95,
    fitness, the confusion matrix and the ``DetMetrics``).

    Args:
        model: the port's ``DetectionModel``, on the device it runs on (the
            trainer passes its EMA model).
        names: class id -> name; its length is the class count scored.
        imgsz: square letterbox size.
        conf, iou, max_det, pre_nms_topk: NMS settings (the val defaults).
        batch_size, workers: loader batch and reader threads.
        infer_fn: an exported artifact's ``AutoBackend`` (``model`` None).
    """

    task = "detect"  # the label format its loader reads
    kpt_shape = (17, 3)

    def __init__(self, model: DetectionModel, names: dict[int, str], imgsz: int = 640, conf: float = 0.001,
                 iou: float = 0.7, max_det: int = 300, batch_size: int = 16, workers: int = 8,
                 pre_nms_topk: int = 4096, infer_fn=None):
        self.model = model
        self.infer_fn = infer_fn  # AutoBackend: uint8 images -> raw preds, or the NMS dict
        self.names = names
        self.nc = len(names)
        self.imgsz = imgsz
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.batch_size = batch_size
        self.workers = workers
        self.pre_nms_topk = pre_nms_topk
        self.end2end = isinstance(getattr(model, "detect", None), V10Detect)  # preds6, no NMS

    @property
    def device(self) -> torch.device:
        """The model's device, or the artifact backend's."""
        return self.infer_fn.device if self.model is None else next(self.model.parameters()).device

    def get_dataloader(self, data: str | Path | dict) -> DataLoader:
        """Fixed-shape batches of the ``val`` split of ``data``; JPEG images
        decode on the model's device."""
        d = check_det_dataset(data)
        ds = YOLODataset(d["val"], imgsz=self.imgsz, mode="val", nc=d["nc"], device=self.device, task=self.task,
                         kpt_shape=self.kpt_shape)
        return DataLoader(ds, batch_size=self.batch_size, workers=self.workers)

    @torch.inference_mode()
    def forward(self, img_u8: torch.Tensor) -> torch.Tensor:
        """uint8 RGB NHWC batch on the model's device -> decoded preds (B, N, 4 + nc),
        or V10Detect's ``preds6`` (B, max_det, 6); an artifact's raw preds or NMS dict."""
        if self.infer_fn is not None:
            return self.infer_fn(img_u8)
        dtype = next(self.model.parameters()).dtype
        x = (img_u8.permute(0, 3, 1, 2).float() / 255.0).to(dtype)
        return self.model(x)["preds6" if self.end2end else "preds"]

    @torch.inference_mode()
    def nms(self, preds: torch.Tensor) -> dict[str, torch.Tensor]:
        """Multi-label NMS over the dataset's classes (fixed (B, max_det)
        outputs); ``preds6`` pass through as they are (end to end), and so
        does an artifact's NMS dict."""
        if isinstance(preds, dict):
            return preds
        if self.end2end:
            cls = preds[..., 5].to(torch.int32)
            return {"boxes": preds[..., :4], "scores": preds[..., 4], "classes": cls,
                    "valid": (preds[..., 4] > self.conf) & (cls < self.nc)}
        return batched_nms(preds, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
                           nc=self.nc, pre_nms_topk=self.pre_nms_topk)

    def __call__(self, data: str | Path | dict | None = None, verbose: bool = True,
                 save_json: str | Path | None = None, dataloader: DataLoader | None = None,
                 plots_dir: str | Path | None = None) -> dict[str, Any]:
        """Validate on the ``val`` split of ``data`` (a data YAML path or dict),
        or on ``dataloader`` (built once by ``get_dataloader`` and reused, as
        the trainer does after every epoch).

        ``save_json``: write COCO-format detections (original image pixels) there.
        ``plots_dir``: write the first batch's mosaics there,
        ``val_batch0_labels.jpg`` and ``val_batch0_pred.jpg``
        (``_plot_val_batch``), and after the metrics the six figures
        (``_plot_figures``): ``confusion_matrix.png``,
        ``confusion_matrix_normalized.png`` and, when predictions were scored,
        ``PR_curve.png``, ``F1_curve.png``, ``P_curve.png`` and ``R_curve.png``.
        """
        metrics = DetMetrics(names=self.names)
        cm = ConfusionMatrix(names=self.names)
        json_dets: list[dict] = []

        def update(out, batch, base):
            if plots_dir and base == 0:
                self._plot_val_batch(batch, out, plots_dir)
            self._update_metrics(out, batch, metrics, cm, json_dets if save_json else None, base)

        n_images, speed = self.run(dataloader if dataloader is not None else self.get_dataloader(data), update)
        metrics.process(nc=self.nc)
        metrics.speed = speed
        results = metrics.results_dict
        if verbose:
            print(f"{'Class':>12} {'Images':>8} {'Instances':>10} {'P':>8} {'R':>8} {'mAP50':>8} {'mAP50-95':>9}")
            mp, mr, map50, map5095 = metrics.mean_results()
            print(f"{'all':>12} {n_images:>8} {int(metrics.nt_per_class.sum()):>10} "
                  f"{mp:>8.3g} {mr:>8.3g} {map50:>8.3g} {map5095:>9.3g}")
            if self.nc > 1 and metrics.ap_class_index.size:
                for i, c in enumerate(metrics.ap_class_index):
                    p, r, a50, a = metrics.class_result(i)
                    print(f"{self.names.get(int(c), c):>12} {int(metrics.nt_per_image[c]):>8} "
                          f"{int(metrics.nt_per_class[c]):>10} {p:>8.3g} {r:>8.3g} {a50:>8.3g} {a:>9.3g}")
        if save_json:
            Path(save_json).parent.mkdir(parents=True, exist_ok=True)
            Path(save_json).write_text(json.dumps(json_dets))
        if plots_dir:
            self._plot_figures(metrics, cm, plots_dir)
        results["confusion_matrix"] = cm
        results["metrics"] = metrics
        return results

    def _plot_figures(self, metrics: DetMetrics, cm: ConfusionMatrix, plots_dir: str | Path) -> None:
        """The confusion matrices (counts and column-normalized) and, when
        ``metrics.curves`` is set, the PR, F1, P and R curves (``utils/plotting.py``)."""
        from fce_yolo_tpu_torch.utils.plotting import plot_confusion_matrix, plot_mc_curve, plot_pr_curve

        out = Path(plots_dir)
        out.mkdir(parents=True, exist_ok=True)
        plot_confusion_matrix(cm.matrix, self.names, out / "confusion_matrix.png", normalize=False)
        plot_confusion_matrix(cm.matrix, self.names, out / "confusion_matrix_normalized.png", normalize=True)
        cv = metrics.curves
        if cv is not None:
            plot_pr_curve(cv["x"], cv["prec_values"], metrics.all_ap, self.names, out / "PR_curve.png")
            plot_mc_curve(cv["x"], cv["f1_curve"], self.names, out / "F1_curve.png", ylabel="F1")
            plot_mc_curve(cv["x"], cv["p_curve"], self.names, out / "P_curve.png", ylabel="Precision")
            plot_mc_curve(cv["x"], cv["r_curve"], self.names, out / "R_curve.png", ylabel="Recall")

    def _plot_val_batch(self, batch: dict, out: dict, plots_dir: str | Path, conf: float = 0.25,
                        max_det: int = 50) -> None:
        """The first val batch's mosaics: its labels (``val_batch0_labels.jpg``)
        and its predictions (``val_batch0_pred.jpg``: conf >= ``conf``, the
        ``max_det`` best by score of each image), as the reference draws them."""
        from fce_yolo_tpu_torch.utils.annotator import plot_images

        device = self.device
        outp = Path(plots_dir)
        outp.mkdir(parents=True, exist_ok=True)
        plot_images(batch, names=self.names, fname=outp / "val_batch0_labels.jpg", device=device)
        bh, bw = batch["img"].shape[1:3]
        n = len(batch["img"])
        pb = np.zeros((n, max_det, 4), np.float32)
        pc = np.zeros((n, max_det), np.float32)
        pm = np.zeros((n, max_det), bool)
        for i in range(min(n, batch["n_valid"])):
            valid = out["valid"][i]
            boxes, scores, cls_ = out["boxes"][i][valid], out["scores"][i][valid], out["classes"][i][valid]
            keep = np.argsort(-scores)[:max_det]
            keep = keep[scores[keep] >= conf]
            k = len(keep)
            if k:
                xyxy = boxes[keep]
                pb[i, :k, 0] = (xyxy[:, 0] + xyxy[:, 2]) / 2 / bw
                pb[i, :k, 1] = (xyxy[:, 1] + xyxy[:, 3]) / 2 / bh
                pb[i, :k, 2] = (xyxy[:, 2] - xyxy[:, 0]) / bw
                pb[i, :k, 3] = (xyxy[:, 3] - xyxy[:, 1]) / bh
                pc[i, :k] = cls_[keep]
                pm[i, :k] = True
        plot_images({"img": batch["img"], "cls": pc, "bboxes": pb, "mask": pm}, names=self.names,
                    fname=outp / "val_batch0_pred.jpg", device=device)

    def to_host(self, out: dict[str, torch.Tensor]) -> dict:
        """The NMS dict as numpy arrays."""
        return {k: v.cpu().numpy() for k, v in out.items()}

    def run(self, loader: DataLoader, update) -> tuple[int, dict[str, float]]:
        """One pass over ``loader``: per batch the model and NMS on the
        model's device (``forward``, ``nms``, ``to_host``), then ``update(out,
        batch, images before it)`` on the host; the model is validated in eval
        mode and handed back in the mode it came in. Returns the count of
        images scored and the ms an image of the loader wait, inference and
        metrics."""
        device = self.device
        t_pre = t_infer = t_post = 0.0
        n_images = 0
        was_training = self.model is not None and self.model.training
        if self.model is not None:
            self.model.eval()
        batches = iter(loader)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                t_pre += time.perf_counter() - t0
                if batch is None:
                    break
                t0 = time.perf_counter()
                img = torch.from_numpy(batch["img"]).to(device)
                out = self.to_host(self.nms(self.forward(img)))
                t_infer += time.perf_counter() - t0
                t0 = time.perf_counter()
                update(out, batch, n_images)
                t_post += time.perf_counter() - t0
                n_images += batch["n_valid"]
        finally:
            batches.close()  # stops the loader's reader threads if a batch raised
            if self.model is not None:
                self.model.train(was_training)
        ms = 1000.0 / max(n_images, 1)
        return n_images, {"preprocess": t_pre * ms, "inference": t_infer * ms, "loss": 0.0, "postprocess": t_post * ms}

    def _update_metrics(self, out: dict, batch: dict, metrics: DetMetrics, cm: ConfusionMatrix,
                        json_dets: list | None = None, image_id_base: int = 0) -> None:
        """Match one batch's predictions to its labels in letterbox pixels
        (the NMS outputs as they are, the labels lifted to the batch's image
        size); scale back to original pixels only for the JSON rows."""
        bh_img, bw_img = batch["img"].shape[1:3]
        s = np.array([bw_img, bh_img, bw_img, bh_img], np.float32)
        for i in range(batch["n_valid"]):
            valid = np.asarray(out["valid"][i])
            pboxes = np.asarray(out["boxes"][i])[valid]  # letterbox-pixel xyxy
            pconf = np.asarray(out["scores"][i])[valid]
            pcls = np.asarray(out["classes"][i])[valid].astype(float)

            m = batch["mask"][i]
            gboxes = xywh_to_xyxy_np(batch["bboxes"][i][m] * s)  # letterbox pixels
            gcls = batch["cls"][i][m].astype(float)

            if len(pcls) and len(gcls):
                tp = match_predictions(pcls, gcls, box_iou_np(gboxes, pboxes))
            else:
                tp = np.zeros((len(pcls), 10), bool)
            metrics.update_stats(dict(tp=tp, conf=pconf, pred_cls=pcls, target_cls=gcls, target_img=np.unique(gcls)))
            cm.process_batch(dict(bboxes=pboxes, conf=pconf, cls=pcls), dict(bboxes=gboxes, cls=gcls))
            if json_dets is not None:  # COCO rows in original image pixels
                r = float(batch["ratio"][i])
                pw, ph = batch["pad"][i]
                oh, ow = batch["orig_shape"][i]
                jboxes = (pboxes - np.array([pw, ph, pw, ph])) / r
                jboxes[:, [0, 2]] = jboxes[:, [0, 2]].clip(0, ow)
                jboxes[:, [1, 3]] = jboxes[:, [1, 3]].clip(0, oh)
                for bb, cf, cl in zip(jboxes, pconf, pcls):
                    json_dets.append({
                        "image_id": image_id_base + i,
                        "category_id": int(cl),
                        "bbox": [round(float(bb[0]), 3), round(float(bb[1]), 3),
                                 round(float(bb[2] - bb[0]), 3), round(float(bb[3] - bb[1]), 3)],
                        "score": round(float(cf), 5),
                    })


class RTDETRValidator(DetectionValidator):
    """RT-DETR validation without NMS (reference ``RTDETRValidator``,
    ``fce_yolo_tpu/engine/validator.py:339-375``): the decoder's queries are
    the detections, each with its best class, in descending score, valid
    above ``conf`` (``ops/boxes.py::detr_detections``, every query kept as
    the JAX validator keeps them); matching and AP are the base class's.
    There is no RT-DETR artifact (``YOLO.export`` refuses one), so no
    ``infer_fn``."""

    def __init__(self, model, names: dict[int, str], **kw: Any):
        if kw.get("infer_fn") is not None:
            raise NotImplementedError("an RT-DETR artifact is not ported yet (ROADMAP queue 1, item 12.1)")
        super().__init__(model, names, **kw)

    @torch.inference_mode()
    def nms(self, preds: torch.Tensor) -> dict[str, torch.Tensor]:
        return detr_detections(preds, self.imgsz, self.conf)


def xywh_to_xyxy_np(xywh: np.ndarray) -> np.ndarray:
    """Label boxes (n, 4) xywh -> xyxy, as the JAX validators build them."""
    if not len(xywh):
        return np.zeros((0, 4))
    return np.stack([xywh[:, 0] - xywh[:, 2] / 2, xywh[:, 1] - xywh[:, 3] / 2,
                     xywh[:, 0] + xywh[:, 2] / 2, xywh[:, 1] + xywh[:, 3] / 2], 1)


class TaskValidator(DetectionValidator):
    """The pass of the task heads' validators (segment, pose, OBB): the base
    class's loop, one ``DetMetrics`` per metric family (``families``: B for
    boxes, M masks, P poses; the rotated family is tagged B, as in the JAX
    package), filled by ``update_metrics`` batch by batch."""

    families: dict[str, str] = {"B": "box"}  # tag -> name in results["metrics"]

    def update_metrics(self, out: dict, batch: dict, metrics: dict[str, DetMetrics]) -> None:
        raise NotImplementedError

    def __call__(self, data: str | Path | dict | None = None, verbose: bool = True,
                 save_json: str | Path | None = None, dataloader: DataLoader | None = None,
                 plots_dir: str | Path | None = None) -> dict[str, Any]:
        """Validate on the ``val`` split of ``data`` or on ``dataloader``.
        Returns P, R, mAP50 and mAP50-95 of each family, ``fitness`` (their
        mean) and ``metrics``. ``save_json`` (COCO detection rows) is
        detect's only. ``plots_dir`` is taken and nothing is drawn, as the
        JAX task validators do (ROADMAP queue 3, item 23)."""
        if save_json:
            raise NotImplementedError(f"save_json writes detect rows only, not {self.task} results")
        nc = self.model.spec.nc
        if self.nc != nc:  # the class scores and the extras share one output (the JAX validators assume it)
            raise ValueError(f"the {self.task} head has {nc} classes and the data names {self.nc}: build the "
                             "model with the data's class count (YOLO(..., nc=...))")
        metrics = {tag: DetMetrics(names=self.names) for tag in self.families}
        n_images, speed = self.run(dataloader if dataloader is not None else self.get_dataloader(data),
                                   lambda out, batch, _: self.update_metrics(out, batch, metrics))
        results: dict[str, Any] = {}
        for tag, m in metrics.items():
            m.process(nc=self.nc)
            m.speed = speed
            mp, mr, map50, map5095 = m.mean_results()
            results.update({f"metrics/precision({tag})": mp, f"metrics/recall({tag})": mr,
                            f"metrics/mAP50({tag})": map50, f"metrics/mAP50-95({tag})": map5095})
        results["fitness"] = sum(m.fitness for m in metrics.values()) / len(metrics)
        results["metrics"] = ({self.families[t]: m for t, m in metrics.items()} if len(metrics) > 1
                              else metrics["B"])
        if verbose:
            print(" | ".join(f"{self.families[t]} mAP50-95 {m.map:.3f}" for t, m in metrics.items())
                  + f" ({n_images} images)")
        return results
