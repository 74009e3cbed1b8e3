"""Fused narrow-conv stem: /255 + Conv(s2) + Conv(s2) + C3k2 in one kernel
(reference ``fce_yolo_tpu/ops/pallas_stem.py``).

The first three YOLO11 layers run at the widest resolutions and narrowest
channel counts of the network; unfused, every intermediate map makes a
round trip to device memory. ``fused_stem`` runs them as ONE CUDA launch
(``csrc/stem.cu``) that reads the uint8 image and writes only the stride-4
C3k2 output. On CPU tensors it runs the plain version ``stem_reference``.

Layers, with BN folded into the weights (``fold_stem_params``):
  L0: Conv c0 3x3 s2 (+ the /255 normalisation folded into its weights)
  L1: Conv c1 3x3 s2
  L2: C3k2(c2, e=0.25): inner blocks are Bottleneck(e=0.5) at n/s scales and
      C3k (two e=1.0 bottlenecks between 1x1s) at m/l/x (the parser's forced c3k)
Public layouts are the JAX package's: uint8 NHWC in, bf16 NHWC out. The
kernel reads the weights packed once per model (``stem_weights``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fce_yolo_tpu_torch.kernels import build as kbuild
from fce_yolo_tpu_torch.nn.modules import BN_EPS, ConvBNAct

_MAX_INNER = 4  # inner-block repeats the kernel's argument struct holds


@dataclass(frozen=True)
class StemSpec:
    """Static shape/architecture info for the fused stem (one YOLO11-family scale)."""

    H: int  # input image height
    W: int  # input image width
    c0: int  # L0 out channels
    c1: int  # L1 out channels
    c2: int  # C3k2 out channels
    ch: int  # C3k2 hidden width int(c2 * 0.25)
    n: int = 1  # C3k2 inner-block repeats
    c3k: bool = False  # inner block is C3k (m/l/x) vs plain Bottleneck (n/s)

    @property
    def h4(self) -> int:
        return self.H // 4

    @property
    def w4(self) -> int:
        return self.W // 4

    @property
    def halo(self) -> int:
        """Stride-4 rows of receptive field: one per 3x3 conv of the inner chain."""
        return self.n * (4 if self.c3k else 2)


def stem_spec_from_model(spec, imgsz: tuple[int, int]) -> StemSpec | None:
    """A StemSpec when the model's first three layers match the fusable
    pattern (Conv k3 s2, Conv k3 s2, C3k2 e=0.25), else None.

    The rules are the JAX package's default ones (pallas_stem.py:580-641),
    which were set by TPU measurements (``c2 % 128``; no n > 1; no c3k above
    640 px); the H100 gate waits for this port's own A/B. The JAX tile
    choice is left out: it never rejects a spec. ``spec`` is the parser's
    ModelSpec. Other forms (n > 1, C3k at any size) are built as a
    ``StemSpec`` directly.
    """
    if len(spec.layers) < 3:
        return None
    l0, l1, l2 = spec.layers[0], spec.layers[1], spec.layers[2]
    if [l0.name, l1.name, l2.name] != ["Conv", "Conv", "C3k2"]:
        return None
    if list(l0.args[2:4]) != [3, 2] or list(l1.args[2:4]) != [3, 2]:
        return None
    if len(l0.args) > 7 and l0.args[7] is not True:
        return None  # non-SiLU activation
    if any(i in spec.save for i in (0, 1)):
        return None
    a2 = list(l2.args)  # (c1, c2, n, c3k, e, ...)
    n = int(a2[2]) if len(a2) > 2 else 1
    c3k = bool(a2[3]) if len(a2) > 3 else False
    e = float(a2[4]) if len(a2) > 4 else 0.5
    if abs(e - 0.25) > 1e-6:
        return None
    h, w = imgsz
    if h % 4 or w % 4:
        return None
    c0, c1, c2 = int(l0.args[1]), int(l1.args[1]), int(a2[1])
    ch = int(c2 * 0.25)
    if ch % 2 or (c3k and (ch // 2) % 2):
        return None
    if c2 % 128:
        return None
    if n > 1:
        return None
    if w // 4 > 160 and c3k:
        return None
    return StemSpec(H=h, W=w, c0=c0, c1=c1, c2=c2, ch=ch, n=n, c3k=c3k)


def _fold(m: ConvBNAct, normalize: bool = False) -> list[torch.Tensor]:
    """ConvBNAct -> [(kh*kw*cin, cout) weight with (dy, dx, cin) rows, (1, cout) bias], f32.
    Already folded modules (``fold_conv_bn``) pass their conv weights through."""
    k = m.conv.weight.float()  # (cout, cin, kh, kw)
    if m.folded:
        w, b = k, m.conv.bias.float()
    else:
        s = m.bn.weight.float() * torch.rsqrt(m.bn.running_var.float() + BN_EPS)
        w = k * s[:, None, None, None]
        b = m.bn.bias.float() - m.bn.running_mean.float() * s
    if normalize:
        w = w / 255.0
    return [w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]), b[None]]


@torch.no_grad()
def fold_stem_params(model, spec: StemSpec) -> list[torch.Tensor]:
    """Layers 0..2 of a DetectionModel -> the kernel's flat list of bf16 arrays.

    Order (the JAX ``fold_stem_params``): [w0, b0, w1, b1, wc1, bc1,
    <inner blocks>, wc2, bc2]; a plain Bottleneck adds (wb1, bb1, wb2, bb2),
    a C3k adds (cv1, cv2, m.0.cv1, m.0.cv2, m.1.cv1, m.1.cv2, cv3) pairs.
    """
    layers = model.model
    out = _fold(layers[0], normalize=True) + _fold(layers[1])
    l2 = layers[2]
    out += _fold(l2.cv1)
    for blk in list(l2.m)[: spec.n]:
        if spec.c3k:
            out += _fold(blk.cv1) + _fold(blk.cv2)
            for inner in blk.m:
                out += _fold(inner.cv1) + _fold(inner.cv2)
            out += _fold(blk.cv3)
        else:
            out += _fold(blk.cv1) + _fold(blk.cv2)
    out += _fold(l2.cv2)
    return [a.to(torch.bfloat16).contiguous() for a in out]


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, k: int) -> torch.Tensor:
    """NCHW f32 conv + SiLU from a folded (k*k*cin, cout) weight."""
    cout = w.shape[-1]
    k4 = w.float().reshape(k, k, -1, cout).permute(3, 2, 0, 1)
    return F.silu(F.conv2d(x, k4, b[0].float(), stride, k // 2))


def stem_reference(x_u8: torch.Tensor, folded: list[torch.Tensor], spec: StemSpec) -> torch.Tensor:
    """The plain version: same math as the kernel as float32 convolutions
    (= the JAX ``stem_reference_jnp``). uint8 (B, H, W, 3) -> f32 (B, H/4, W/4, c2)."""
    w0, b0, w1, b1, wc1, bc1 = folded[:6]
    x = x_u8.permute(0, 3, 1, 2).float()  # /255 folded into w0
    y = _conv(x, w0, b0, 2, 3)
    y = _conv(y, w1, b1, 2, 3)
    y = _conv(y, wc1, bc1, 1, 1)
    c = spec.ch
    ys = [y[:, :c], y[:, c:]]
    idx = 6
    for _ in range(spec.n):
        if spec.c3k:
            wk1, bk1, wk2, bk2 = folded[idx: idx + 4]
            a = _conv(ys[-1], wk1, bk1, 1, 1)
            bb = _conv(ys[-1], wk2, bk2, 1, 1)
            for j in range(2):
                w1_, b1_, w2_, b2_ = folded[idx + 4 + 4 * j: idx + 8 + 4 * j]
                a = a + _conv(_conv(a, w1_, b1_, 1, 3), w2_, b2_, 1, 3)
            wk3, bk3 = folded[idx + 12: idx + 14]
            ys.append(_conv(torch.cat([a, bb], 1), wk3, bk3, 1, 1))
            idx += 14
        else:
            wb1, bb1, wb2, bb2 = folded[idx: idx + 4]
            ys.append(ys[-1] + _conv(_conv(ys[-1], wb1, bb1, 1, 3), wb2, bb2, 1, 3))
            idx += 4
    wc2, bc2 = folded[idx: idx + 2]
    return _conv(torch.cat(ys, 1), wc2, bc2, 1, 1).permute(0, 2, 3, 1)


class StemWeights(NamedTuple):
    """The folded stem convs in the two layouts ``fused_stem`` reads; built
    once per model by ``stem_weights``."""

    arrays: list[torch.Tensor]  # fold_stem_params order: the plain version's input
    packed: torch.Tensor  # one flat bf16 buffer: the kernel's input


def _conv_shapes(spec: StemSpec) -> list[tuple[int, int, int]]:
    """(k, cin, cout) of each conv, in fold_stem_params order."""
    ch, c_ = spec.ch, spec.ch // 2
    convs = [(3, 3, spec.c0), (3, spec.c0, spec.c1), (1, spec.c1, 2 * ch)]
    for _ in range(spec.n):
        if spec.c3k:
            convs += [(1, ch, c_), (1, ch, c_)] + [(3, c_, c_)] * 4 + [(1, 2 * c_, ch)]
        else:
            convs += [(3, ch, c_), (3, c_, ch)]
    return convs + [(1, (2 + spec.n) * ch, spec.c2)]


def folded_shapes(spec: StemSpec) -> list[tuple[int, int]]:
    """Shapes of the ``fold_stem_params`` arrays: (k*k*cin, cout) weight, (1, cout) bias."""
    return [s for k, cin, cout in _conv_shapes(spec) for s in ((k * k * cin, cout), (1, cout))]


@torch.no_grad()
def stem_weights(folded: list[torch.Tensor], spec: StemSpec) -> StemWeights:
    """Check the ``fold_stem_params`` arrays and pack them as the kernel
    reads them, one flat bf16 buffer: per conv the weight as
    [cout][k*k][cin padded to 16] (the tensor-core B operand, K contiguous
    per output channel), then the bias [cout]. L0's weight packs K as
    (tap, rgb + a zero channel) = 36 padded to 48."""
    shapes = folded_shapes(spec)
    if [tuple(w.shape) for w in folded] != shapes or any(
            w.dtype != torch.bfloat16 or w.device != folded[0].device for w in folded):
        raise ValueError(f"stem weights are the {len(shapes)} bf16 arrays of fold_stem_params, on one device")
    parts = []
    for i, ((k, cin, cout), w, b) in enumerate(zip(_conv_shapes(spec), folded[0::2], folded[1::2])):
        wk = w.reshape(k * k, cin, cout).permute(2, 0, 1)
        if i == 0:
            wk = F.pad(F.pad(wk, (0, 1)).reshape(cout, 36), (0, 12))
        else:
            wk = F.pad(wk, (0, -cin % 16))
        parts += [wk.reshape(-1), b.reshape(-1)]
    return StemWeights(list(folded), torch.cat(parts))


def fused_stem(x_u8: torch.Tensor, weights: StemWeights, spec: StemSpec) -> torch.Tensor:
    """Run the fused stem: uint8 NHWC (B, H, W, 3) -> bf16 NHWC (B, H/4, W/4, c2).

    CUDA tensors launch the kernel, CPU tensors run ``stem_reference``; any
    input the kernel does not take raises, and so does a spec whose working
    set fits no tile of one block's shared memory (the kernel picks the tile).
    """
    if x_u8.dtype != torch.uint8 or x_u8.ndim != 4 or tuple(x_u8.shape[1:]) != (spec.H, spec.W, 3):
        raise ValueError(f"fused_stem takes uint8 (B, {spec.H}, {spec.W}, 3), got {x_u8.dtype} {tuple(x_u8.shape)}")
    if any(t.device != x_u8.device for t in (weights.packed, *weights.arrays)):
        raise ValueError(f"fused_stem takes the stem weights on {x_u8.device}")
    if x_u8.device.type == "cpu":
        return stem_reference(x_u8, weights.arrays, spec).to(torch.bfloat16)
    if x_u8.device.type != "cuda":
        raise ValueError(f"no stem kernel for device {x_u8.device}")
    if not x_u8.is_contiguous():
        raise ValueError("fused_stem takes a contiguous image batch")
    if any(c % 8 for c in (spec.c0, spec.c1, spec.c2, spec.ch, spec.ch // 2)) or not 1 <= spec.n <= _MAX_INNER:
        raise ValueError(f"{spec}: the kernel takes channel counts that are multiples of 8 and 1 <= n <= {_MAX_INNER}")
    out = torch.empty(x_u8.shape[0], spec.h4, spec.w4, spec.c2, dtype=torch.bfloat16, device=x_u8.device)
    lib = kbuild.library()
    with torch.cuda.device(x_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fce_fused_stem(x_u8.data_ptr(), weights.packed.data_ptr(), out.data_ptr(), x_u8.shape[0],
                                 spec.H, spec.W, spec.c0, spec.c1, spec.c2, spec.ch, spec.n, int(spec.c3k), stream)
    kbuild.check(err, "fce_fused_stem")
    fused_stem.launches += 1  # a launch the kernel took
    return out


fused_stem.launches = 0


def apply_with_fused_stem(model, images_u8: torch.Tensor, spec: StemSpec, weights: StemWeights) -> dict:
    """Inference forward with the fused stem: uint8 NHWC images in, the
    model's output dict out. Layers 0..2 (+ /255) run in ``fused_stem``; the
    graph resumes at layer 3 on the NHWC output viewed as channels_last NCHW
    (a permute, no copy)."""
    y = fused_stem(images_u8, weights, spec).permute(0, 3, 1, 2)
    dtype = next(model.parameters()).dtype
    return model(y.to(dtype), start_layer=3)
