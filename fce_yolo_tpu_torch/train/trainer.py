"""The train step (reference ``fce_yolo_tpu/train/trainer.py:36-250``).

``make_train_step`` returns a function that runs one micro-batch: forward,
the loss (the detection loss, or a task loss handed the whole head output),
backward, then, on an optimizer boundary, the optimizer and the EMA. It
mutates the ``TrainState`` in place and returns the metrics.

- The batch image is uint8 NHWC; it becomes NCHW float ``/ 255`` on the device.
- ``bf16``: the forward and backward run under ``torch.autocast`` to
  bfloat16 (convolutions and matmuls in bfloat16, the float32 parameters
  stay the master weights, gradients land in float32); every floating head
  output is cast to float32 and the loss is computed in float32.
- ``frozen_bn``: BatchNorm runs in eval mode (running statistics, never
  updated) inside the loss graph.
- ``accumulate > 1``: gradients are summed into a buffer over micro-batches;
  the optimizer and the EMA fire where ``boundaries[step]`` is True (the
  warmup ramp), else every ``accumulate`` micro-batches.
- NaN rollback: when the loss is not finite the step keeps the parameters,
  the optimizer state (its step count too), the EMA parameters, the
  ``LossState``, the gradient buffer and the BN running buffers, which the
  training-mode forward has already moved (they are snapshotted before it).
  ``step`` still advances, and so does the EMA's update count on a boundary,
  as in the reference.

Whether the loss is finite is read on the host after the backward: one
synchronisation with the device per micro-batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from fce_yolo_tpu_torch.train.loss import DetectionLossCfg, LossState, detection_loss
from fce_yolo_tpu_torch.train.optim import EMA, OptimCfg, Optimizer

__all__ = ["TrainState", "create_train_state", "make_train_step", "TrainCfg", "EarlyStopping"]


@dataclass
class TrainState:
    """Everything a step reads and writes. The model holds the parameters
    and the BN running buffers ("batch_stats")."""

    model: nn.Module
    optimizer: Optimizer
    ema: EMA
    loss_state: LossState
    step: int = 0
    grad_accum: list[torch.Tensor] | None = None  # summed gradients when accumulating

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for _, p in self.model.named_parameters()]

    def state_dict(self) -> dict[str, Any]:
        """Tensors and counters of the whole state, for a resumable checkpoint."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "ema": self.ema.state_dict(), "loss_state": self.loss_state.wiou_loss_mean,
                "step": self.step, "grad_accum": self.grad_accum}

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.ema.load_state_dict(sd["ema"])
        device = self.loss_state.wiou_loss_mean.device
        self.loss_state = LossState(wiou_loss_mean=sd["loss_state"].to(device))
        self.step = int(sd["step"])
        if self.grad_accum is not None:
            torch._foreach_copy_(self.grad_accum, [t.to(device) for t in sd["grad_accum"]])


def create_train_state(model: nn.Module, optimizer: Optimizer, accumulate: int = 1,
                       ema_dtype: torch.dtype | None = None) -> TrainState:
    params = [p for _, p in model.named_parameters()]
    device = params[0].device
    return TrainState(model=model, optimizer=optimizer, ema=EMA(params, dtype=ema_dtype, frozen=optimizer.is_frozen),
                      loss_state=LossState.init(device), step=0,
                      grad_accum=[torch.zeros_like(p) for p in params] if accumulate > 1 else None)


def _bn_buffers(model: nn.Module) -> list[torch.Tensor]:
    return [b for m in model.modules() if isinstance(m, nn.BatchNorm2d)
            for b in (m.running_mean, m.running_var)]


def make_train_step(model: nn.Module, optimizer: Optimizer, loss_cfg: DetectionLossCfg, ema_decay: float = 0.9999,
                    bf16: bool = False, accumulate: int = 1, frozen_bn: bool = False,
                    boundaries: np.ndarray | None = None,
                    task_loss: Callable | None = None, model_kwargs: Callable[[dict], dict] | None = None
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build ``train_step(state, batch) -> (state, metrics)`` (module docstring).

    ``batch``: "img" (B, H, W, 3) uint8 (or float in [0, 1]), "cls" (B, M),
    "bboxes" (B, M, 4) normalized xywh (5 with the angle for OBB), "mask"
    (B, M) bool, and whatever else the task's loss reads ("masks",
    "keypoints", ...), all on the model's device; every key but "img" goes to
    the loss. ``task_loss(out, batch, loss_cfg, loss_state) -> (total, parts,
    new_state)`` replaces the detection loss (``train/task_losses.py``).
    ``model_kwargs(batch)`` gives the task's keyword arguments for the
    model's forward (RT-DETR's denoising queries); a batch's ``txt_feats``
    (a multimodal batch's sampled texts) and ``visual_prompts`` (YOLOE's
    prompt masks) go to the forward as they are (reference trainer.py:147-150).
    ``metrics``: "loss" and the loss parts as device tensors (a part the
    loss gives as a float stays one: ``detr_loss``'s "match_host_s"), "finite"
    (bool) and "sync_s", the seconds the host waited for the device to tell
    whether the loss was finite.
    """
    bn_modules = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]) -> tuple[TrainState, dict]:
        img = batch["img"]
        x = img.permute(0, 3, 1, 2)
        x = x.float() / 255.0 if img.dtype == torch.uint8 else x.float()
        model.train()
        if frozen_bn:
            for m in bn_modules:
                m.eval()
        snapshot = None if frozen_bn else [b.clone() for b in _bn_buffers(model)]
        params = state.params
        for p in params:
            p.grad = None
        kw = model_kwargs(batch) if model_kwargs is not None else {}
        kw.update({k: batch[k] for k in ("txt_feats", "visual_prompts") if k in batch})
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
            out = model(x, **kw)
        out = {k: [f.float() for f in v] if isinstance(v, (list, tuple)) else v.float() for k, v in out.items()}
        targets = {k: v for k, v in batch.items() if k != "img"}
        if task_loss is not None:
            total, parts, new_ls = task_loss(out, targets, loss_cfg, state.loss_state)
        else:
            total, parts, new_ls = detection_loss(out["feats"], targets, loss_cfg, state.loss_state)
        total.backward()
        t_sync = time.perf_counter()
        finite = bool(torch.isfinite(total))  # the step's one wait for the device
        t_sync = time.perf_counter() - t_sync
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]

        if accumulate > 1:
            if boundaries is not None:
                boundary = bool(boundaries[min(state.step, len(boundaries) - 1)])
            else:
                boundary = (state.step + 1) % accumulate == 0
        else:
            boundary = True
        if finite:
            if accumulate > 1:
                torch._foreach_add_(state.grad_accum, grads)
                grads = state.grad_accum
            if boundary:
                state.optimizer.step(params, grads)
                state.ema.update(params, decay=ema_decay)
                if accumulate > 1:
                    torch._foreach_zero_(state.grad_accum)
            state.loss_state = new_ls
        else:
            if snapshot is not None:
                torch._foreach_copy_(_bn_buffers(model), snapshot)
            if boundary:
                state.ema.updates += 1
        state.step += 1
        for p in params:
            p.grad = None
        metrics = {"loss": total.detach(), "finite": finite, "sync_s": t_sync,
                   **{k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in parts.items()}}
        return state, metrics

    return train_step


@dataclass
class TrainCfg:
    epochs: int = 100
    batch_size: int = 16
    imgsz: int = 640
    optim: OptimCfg = field(default_factory=OptimCfg)
    loss: DetectionLossCfg = field(default_factory=DetectionLossCfg)
    ema_decay: float = 0.9999
    patience: int = 100  # early-stop epochs without fitness improvement
    close_mosaic: int = 10


class EarlyStopping:
    """Stop after ``patience`` epochs without a fitness improvement
    (reference ``trainer.py:231-249``)."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float | None) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_fitness = fitness
            self.best_epoch = epoch
        return (epoch - self.best_epoch) >= self.patience
