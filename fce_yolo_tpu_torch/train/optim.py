"""Optimizer, LR and momentum schedules, EMA (reference ``fce_yolo_tpu/train/optim.py``).

The reference is one optax chain; ``Optimizer.step`` applies the same
transforms to the same tensors in the same order:

1. ``clip_by_global_norm(10)``: ``g / ||g|| * 10`` when ``||g|| >= 10``;
2. the transform: SGD adds the decay, then a Nesterov trace; AdamW (and
   Adam, which the reference maps to the same decoupled chain) scales by
   Adam's moments with b1 = the momentum schedule, b2 0.999, eps 1e-8, then
   adds the decay; RMSProp adds the decay, scales by optax's
   ``scale_by_rms`` (decay 0.9, eps 1e-8 inside the root, initial 0), then
   a plain trace;
3. the decay ``weight_decay * batch * accumulate / nbs``, added only to the
   "decay" group (conv kernels and BiFPN weights, not biases or BN scales);
4. ``-lr`` per group: biases follow ``warmup_bias_lr`` during warmup;
5. frozen parameters are left as they are (their state still updates).

Schedules are read at ``to_ni(optimizer step)`` before the step counts, so
the first warmup step has LR 0 on the weights and ``warmup_bias_lr`` on the
biases. The scalar schedule values are computed on the host in float32 with
the reference's operations and order; the tensor math runs as
``torch._foreach_*`` calls on the parameters' device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from fce_yolo_tpu_torch.nn.weights import key_to_flax

__all__ = ["OptimCfg", "accumulate_steps", "boundary_schedule", "resolve_auto", "lr_schedule",
           "momentum_schedule", "param_groups", "flax_path", "freeze_mask", "Optimizer", "EMA"]

_f32 = np.float32


class OptimCfg(NamedTuple):
    optimizer: str = "auto"  # SGD | AdamW | Adam | RMSProp | auto
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    cos_lr: bool = False
    nbs: int = 64  # nominal batch size for decay scaling
    batch_size: int = 16
    epochs: int = 100
    steps_per_epoch: int = 100
    nc: int = 80
    grad_clip_norm: float = 10.0
    state_bf16: bool = False  # momentum / first moment stored in bfloat16


def accumulate_steps(cfg: OptimCfg) -> int:
    """Micro-batches per optimizer step: max(round(nbs / batch), 1)."""
    return max(round(cfg.nbs / cfg.batch_size), 1)


def _warmup_iters(cfg: OptimCfg) -> int:
    nb = cfg.steps_per_epoch
    return max(round(cfg.warmup_epochs * nb), 100) if cfg.warmup_epochs > 0 else -1


def boundary_schedule(cfg: OptimCfg) -> tuple[np.ndarray, np.ndarray]:
    """The warmup accumulate ramp as per-micro-step arrays (reference ``optim.py:54-96``).

    ``accumulate`` rises from 1 to ``accumulate_steps`` over the warmup,
    interpolating to that rounded value (as the reference does, even when
    nbs / batch is fractional). Returns (boundaries, ni_of_step):
    ``boundaries[ni]`` is True where micro-step ni fires an optimizer step;
    ``ni_of_step[s]`` is the micro-step at which optimizer step s fires,
    padded with the last position so later steps clamp to it.
    """
    acc_full = accumulate_steps(cfg)
    nb = max(cfg.steps_per_epoch, 1)
    total = max(cfg.epochs * nb, 1)
    nw = max(round(cfg.warmup_epochs * nb), 100) if cfg.warmup_epochs > 0 else -1
    bounds = np.zeros((total,), bool)
    ni_of_step = []
    last = -1
    for ni in range(total):
        acc = acc_full
        if ni <= nw:
            acc = max(1, int(round(np.interp(ni, [0, nw], [1, acc_full]))))
        if ni - last >= acc:
            bounds[ni] = True
            ni_of_step.append(ni)
            last = ni
    pad = total + acc_full + 1
    while len(ni_of_step) < pad:
        ni_of_step.append(total - 1 if ni_of_step else 0)
    return bounds, np.asarray(ni_of_step, np.int32)


def resolve_auto(cfg: OptimCfg) -> OptimCfg:
    """'auto': SGD (lr 0.01, momentum 0.9) above 10,000 iterations, else
    AdamW with lr = round(0.002 * 5 / (4 + nc), 6), momentum 0.9 and no bias
    warmup LR."""
    if cfg.optimizer != "auto":
        return cfg
    if cfg.epochs * cfg.steps_per_epoch > 10000:
        return cfg._replace(optimizer="SGD", lr0=0.01, momentum=0.9)
    lr_fit = round(0.002 * 5 / (4 + cfg.nc), 6)
    return cfg._replace(optimizer="AdamW", lr0=lr_fit, momentum=0.9, warmup_bias_lr=0.0)


def _fma32(a, b, c) -> np.float32:
    """float32 ``a * b + c`` rounded once."""
    return _f32(np.float64(a) * np.float64(b) + np.float64(c))


def lr_schedule(cfg: OptimCfg, bias: bool = False) -> Callable[[int], np.float32]:
    """LR at micro-step ni, in float32: warmup from 0 (``warmup_bias_lr``
    for biases) to lr0 * lf(epoch), then lf's linear or cosine decay over
    the epochs (reference ``optim.py:118-135``).

    The float32 operations are those XLA runs for the reference's jitted
    schedule: a division by a constant is a multiplication by its float32
    reciprocal, and the warmup interpolation one fused multiply-add."""
    nb = cfg.steps_per_epoch
    nw = _warmup_iters(cfg)

    def sched(step: int) -> np.float32:
        step = _f32(step)
        epoch = np.floor(step * (_f32(1) / _f32(nb)))
        epoch_frac = np.clip(epoch * (_f32(1) / _f32(max(cfg.epochs - 1, 1))), _f32(0), _f32(1))
        if cfg.cos_lr:
            lf = _f32(cfg.lrf) + _f32(1 - cfg.lrf) * (_f32(1) + np.cos(_f32(math.pi) * epoch_frac)) * _f32(0.5)
        else:
            lf = (_f32(1) - epoch_frac) * _f32(1 - cfg.lrf) + _f32(cfg.lrf)
        base = _f32(cfg.lr0) * lf
        if nw <= 0:
            return base
        start = _f32(cfg.warmup_bias_lr if bias else 0.0)
        w = np.clip(step * (_f32(1) / _f32(nw)), _f32(0), _f32(1))
        return _fma32(w, base - start, start) if step < nw else base

    return sched


def momentum_schedule(cfg: OptimCfg) -> Callable[[int], np.float32]:
    """Momentum at micro-step ni: warmup_momentum -> momentum over the
    warmup (float32, as ``lr_schedule``)."""
    nw = _warmup_iters(cfg)

    def sched(step: int) -> np.float32:
        if nw <= 0:
            return _f32(cfg.momentum)
        w = np.clip(_f32(step) * (_f32(1) / _f32(nw)), _f32(0), _f32(1))
        return _fma32(w, _f32(cfg.momentum - cfg.warmup_momentum), _f32(cfg.warmup_momentum))

    return sched


def flax_path(model: nn.Module, name: str) -> str:
    """The reference's flax path of one parameter or buffer, "/"-joined, as
    its ``freeze`` matches it: ``model.0.bn.weight`` -> ``layers_0/bn/scale``."""
    return "/".join(key_to_flax(model, name)[1])


def param_groups(model: nn.Module) -> dict[str, str]:
    """Parameter name -> "bias" | "norm" | "decay", from the flax leaf name
    as the reference's ``_param_group_masks`` reads it: ``bias`` leaves,
    BN ``scale``, everything else (kernels, BiFPN ``w``) decayed."""
    groups = {}
    for name, _ in model.named_parameters():
        leaf = flax_path(model, name).rsplit("/", 1)[-1]
        groups[name] = "bias" if leaf == "bias" else "norm" if leaf == "scale" else "decay"
    return groups


def freeze_mask(model: nn.Module, freeze: int | list | None) -> dict[str, bool]:
    """Parameter name -> True if it must not update (reference ``optim.py:169-196``):
    ``freeze`` is the first N layers, or a list of layer indices and flax-path
    substrings, where ``"except:<s>"`` freezes everything whose path lacks s."""
    if freeze is None:
        idxs: set[int] = set()
        subs: list[str] = []
    elif isinstance(freeze, int):
        idxs, subs = set(range(freeze)), []
    else:
        idxs = {int(i) for i in freeze if not isinstance(i, str)}
        subs = [s for s in freeze if isinstance(s, str)]
    excepts = [s[len("except:"):] for s in subs if s.startswith("except:")]
    subs = [s for s in subs if not s.startswith("except:")]
    names = {f"layers_{i}" for i in idxs}
    out = {}
    for name, _ in model.named_parameters():
        full = flax_path(model, name)
        if excepts and not any(e in full for e in excepts):
            out[name] = True
        else:
            out[name] = full.split("/", 1)[0] in names or any(s in full for s in subs)
    return out


def _pow_f32(base: np.float32, count: int) -> np.float32:
    """float32 ``base ** count``, correctly rounded (XLA's pow)."""
    return _f32(np.float64(base) ** count)


class Optimizer:
    """The reference's optax chain over ``model``'s parameters (module docstring).

    Args:
        cfg: hyperparameters (``optimizer="auto"`` is resolved here).
        model: the module whose ``named_parameters()`` are optimized.
        freeze: as ``freeze_mask``.
        ni_map: ``boundary_schedule``'s ni_of_step; without it an optimizer
            step s sits at micro-step s * accumulate.
    """

    def __init__(self, cfg: OptimCfg, model: nn.Module, freeze: int | list | None = None,
                 ni_map: np.ndarray | None = None):
        self.cfg = cfg = resolve_auto(cfg)
        self.name = cfg.optimizer.lower()
        if self.name not in ("adamw", "adam", "nadam", "radam", "adamax", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.adam = self.name not in ("sgd", "rmsprop")
        self.accumulate = accumulate_steps(cfg)
        self.decay = cfg.weight_decay * cfg.batch_size * self.accumulate / cfg.nbs
        self.ni_map = None if ni_map is None else np.asarray(ni_map)
        self.lr_main, self.lr_bias = lr_schedule(cfg, bias=False), lr_schedule(cfg, bias=True)
        self.mom = momentum_schedule(cfg)
        names = [n for n, _ in model.named_parameters()]
        groups = param_groups(model)
        frozen = freeze_mask(model, freeze) if freeze else {n: False for n in names}
        self.names = names
        self.is_decay = [groups[n] == "decay" for n in names]
        self.is_bias = [groups[n] == "bias" for n in names]
        self.is_frozen = [frozen[n] for n in names]
        params = [p for _, p in model.named_parameters()]
        mu_dtype = torch.bfloat16 if cfg.state_bf16 else None
        self.count = 0  # optimizer steps taken
        if self.adam:
            self.state = {"mu": [torch.zeros_like(p, dtype=mu_dtype) for p in params],
                          "nu": [torch.zeros_like(p) for p in params]}
        elif self.name == "sgd":
            self.state = {"trace": [torch.zeros_like(p, dtype=mu_dtype) for p in params]}
        else:
            self.state = {"nu": [torch.zeros_like(p) for p in params], "trace": [torch.zeros_like(p) for p in params]}

    def to_ni(self, step: int) -> int:
        if self.ni_map is not None:
            return int(self.ni_map[min(max(step, 0), len(self.ni_map) - 1)])
        return step * self.accumulate

    @staticmethod
    def _pick(xs: list, flags: list[bool], want: bool = True) -> list:
        return [x for x, f in zip(xs, flags) if f == want]

    def _add_decay(self, u: list[torch.Tensor], params: list[torch.Tensor]) -> None:
        """u += decay * p on the "decay" group."""
        d_u, d_p = self._pick(u, self.is_decay), self._pick(params, self.is_decay)
        if d_u:
            torch._foreach_add_(d_u, torch._foreach_mul(d_p, self.decay))

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> None:
        """One optimizer step: ``params`` (in ``named_parameters`` order)
        updated in place from ``grads`` (left as they are)."""
        u = self.update(params, grads)
        live = self._pick(params, self.is_frozen, False)
        if live:
            torch._foreach_add_(live, self._pick(u, self.is_frozen, False))

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The chain's updates for ``grads`` (zero for frozen parameters);
        advances the state and the step count, leaves ``params`` as they are."""
        ni = self.to_ni(self.count)
        mom = self.mom(ni)
        # 1. clip by the global norm: g / ||g|| * max unless ||g|| < max (division first, as optax);
        # the norm is summed in float64, then rounded to float32
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64))).float()
        keep = norm < self.cfg.grad_clip_norm
        u = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(u, torch.where(keep, 1.0, self.cfg.grad_clip_norm).to(norm.dtype))
        if self.name == "sgd":  # decay, then the Nesterov trace
            self._add_decay(u, params)
            trace = [t.float() for t in self.state["trace"]]
            torch._foreach_mul_(trace, float(mom))
            torch._foreach_add_(trace, u)  # g + m * t
            torch._foreach_add_(u, torch._foreach_mul(trace, float(mom)))  # g + m * (new trace)
            self._store("trace", trace)
        elif self.name == "rmsprop":  # decay, scale_by_rms, then a plain trace
            self._add_decay(u, params)
            nu = self.state["nu"]
            torch._foreach_mul_(nu, float(_f32(0.9)))
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(u, u), float(_f32(1 - 0.9))))
            torch._foreach_mul_(u, torch._foreach_rsqrt(torch._foreach_add(nu, float(_f32(1e-8)))))
            trace = self.state["trace"]
            torch._foreach_mul_(trace, float(mom))
            torch._foreach_add_(trace, u)
            u = [t.clone() for t in trace]
        else:  # Adam's moments with b1 = momentum, then the decoupled decay
            count = self.count + 1
            mu = [t.float() for t in self.state["mu"]]
            nu = self.state["nu"]
            torch._foreach_mul_(mu, float(mom))
            torch._foreach_add_(mu, torch._foreach_mul(u, float(_f32(1) - mom)))
            torch._foreach_mul_(nu, float(_f32(0.999)))
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(u, u), float(_f32(1 - 0.999))))
            mu_hat = torch._foreach_div(mu, float(_f32(1) - _pow_f32(mom, count)))
            den = torch._foreach_sqrt(torch._foreach_div(nu, float(_f32(1) - _pow_f32(_f32(0.999), count))))
            torch._foreach_add_(den, float(_f32(1e-8)))
            u = torch._foreach_div(mu_hat, den)
            self._add_decay(u, params)
            self._store("mu", mu)
        for bias, lr in ((False, self.lr_main(ni)), (True, self.lr_bias(ni))):  # -lr per group
            group = self._pick(u, self.is_bias, bias)
            if group:
                torch._foreach_mul_(group, float(-lr))
        self.count += 1
        return [torch.zeros_like(x) if f else x for x, f in zip(u, self.is_frozen)]

    def _store(self, key: str, values: list[torch.Tensor]) -> None:
        """Keep ``values`` as the state ``key`` in its storage dtype."""
        state = self.state[key]
        if state and state[0].dtype == values[0].dtype:
            self.state[key] = values
        else:
            torch._foreach_copy_(state, values)

    def state_dict(self) -> dict:
        return {"count": self.count, **{k: list(v) for k, v in self.state.items()}}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for k, v in self.state.items():
            torch._foreach_copy_(v, [t.to(v[0].device) for t in sd[k]])


class EMA:
    """Exponential moving average of the parameters (reference ``optim.py:274-303``):
    ``e = e * d + p * (1 - d)``, d = decay * (1 - exp(-updates / tau)), in
    float32, stored as ``dtype`` (float32 unless bfloat16 is asked for).
    Buffers (BN running statistics) are not averaged: a model evaluated on
    the EMA takes the live model's buffers. A ``frozen`` parameter is left
    out: its average is the parameter, which never moves, kept bit-equal
    (the JAX EMA averages it too, which rounds it by up to an ulp a step;
    ROADMAP queue 3, item 38)."""

    def __init__(self, params: list[torch.Tensor], dtype: torch.dtype | None = None,
                 frozen: list[bool] | None = None):
        self.params = [p.detach().to(dtype or p.dtype, copy=True) for p in params]
        self.live = [i for i in range(len(params)) if not (frozen and frozen[i])]  # the averaged parameters
        self.updates = 0

    @torch.no_grad()
    def update(self, new_params: list[torch.Tensor], decay: float = 0.9999, tau: float = 2000.0) -> None:
        self.updates += 1
        d = _f32(decay) * (_f32(1) - _f32(np.exp(np.float64(-_f32(self.updates) / _f32(tau)))))
        if not self.live:
            return
        dst = [self.params[i] for i in self.live]
        ema = [e.float() for e in dst]
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, torch._foreach_mul([new_params[i].float() for i in self.live], float(_f32(1) - d)))
        if ema[0] is not dst[0]:
            torch._foreach_copy_(dst, ema)

    def state_dict(self) -> dict:
        return {"updates": self.updates, "params": list(self.params)}

    def load_state_dict(self, sd: dict) -> None:
        self.updates = int(sd["updates"])
        torch._foreach_copy_(self.params, [t.to(self.params[0].device) for t in sd["params"]])
