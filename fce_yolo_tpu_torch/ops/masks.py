"""Instance-mask ops: prototype combination, crop, upsample (reference
``fce_yolo_tpu/ops/masks.py:16-70``).

The JAX package keeps all ``max_det`` rows of every image because its
shapes are static; the port's callers pass only the rows that survived NMS,
and each row gives the mask the JAX package gives it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fce_yolo_tpu_torch.data.augment import _linear_taps

__all__ = ["crop_mask", "process_mask", "scale_masks", "scale_masks_np"]


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero the pixels of each (N, H, W) mask outside its (N, 4) xyxy box
    (mask pixels; a pixel x is inside when x1 <= x < x2)."""
    _, h, w = masks.shape
    ys = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[None, :, None]
    xs = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, None, :]
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    inside = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return masks * inside


def process_mask(mask_coefs: torch.Tensor, proto: torch.Tensor, boxes: torch.Tensor,
                 img_shape: tuple[int, int], upsample: bool = True, threshold: float = 0.5) -> torch.Tensor:
    """Coefficients x prototypes -> sigmoid -> crop to the box -> (optional)
    bilinear upsample to the input size -> binarize.

    Args: ``mask_coefs`` (N, nm), ``proto`` (nm, Hp, Wp) (the port's NCHW
    layout, one image), ``boxes`` (N, 4) xyxy in input pixels, ``img_shape``
    (H, W) of the network input. Returns (N, H, W) bool at the input size
    (``upsample``) or at the prototypes' size. Computed in float32.

    The upsample is ``F.interpolate(mode="bilinear", align_corners=False)``:
    for an upsample it computes what ``jax.image.resize(method="bilinear")``
    does (half-pixel centres, the edge rows and columns clamped), up to
    float32 rounding.
    """
    nm, hp, wp = proto.shape
    ih, iw = img_shape
    m = torch.einsum("nk,khw->nhw", mask_coefs.float(), proto.float()).sigmoid()
    scale = torch.tensor([wp / iw, hp / ih, wp / iw, hp / ih], dtype=torch.float32, device=boxes.device)
    m = crop_mask(m, boxes.float() * scale)
    if upsample and len(m):
        m = F.interpolate(m[:, None], size=(ih, iw), mode="bilinear", align_corners=False)[:, 0]
    elif upsample:
        m = m.new_zeros((0, ih, iw))
    return m > threshold


def scale_masks(masks: torch.Tensor, orig_shape: tuple[int, int], pad: tuple[float, float]) -> torch.Tensor:
    """(N, H, W) bool masks in letterbox pixels -> (N, h0, w0) bool in the
    original image, on the masks' device: the padding stripped, then cv2's
    INTER_LINEAR resize of the 0/1 crop (the integer arithmetic of
    ``data/augment.py::resize_linear``: 11-bit taps, the same shifts and
    rounding), kept where above 0."""
    n, h, w = masks.shape
    pw, ph = pad
    top, left = int(round(ph)), int(round(pw))
    crop = masks[:, top: h - int(round(ph)), left: w - int(round(pw))]
    (oh, ow), (ch, cw) = orig_shape, crop.shape[1:]
    if not n or not crop.numel():
        return masks.new_zeros((n, oh, ow))
    if (ch, cw) == (oh, ow):
        return crop.clone()
    dev = masks.device

    def taps(src: int, dst: int, clamp: bool):
        sx, c0, c1 = _linear_taps(src, dst, clamp)
        i0, i1 = np.clip(sx, 0, src - 1), np.clip(sx + 1, 0, src - 1)
        return [torch.from_numpy(np.ascontiguousarray(t)).to(dev) for t in (i0, i1, c0.astype(np.int32),
                                                                             c1.astype(np.int32))]

    x0, x1, a0, a1 = taps(cw, ow, clamp=True)
    y0, y1, b0, b1 = taps(ch, oh, clamp=False)
    src = crop.to(torch.int32)
    hor = (src[:, :, x0] * a0 + src[:, :, x1] * a1) >> 4
    out = ((hor[:, y0] * b0[:, None]) >> 16) + ((hor[:, y1] * b1[:, None]) >> 16)
    return ((out + 2) >> 2) > 0


def scale_masks_np(masks: np.ndarray, orig_shape: tuple[int, int], ratio: float,
                   pad: tuple[float, float]) -> np.ndarray:
    """``scale_masks`` on numpy masks (the reference's host-side signature,
    ``ratio`` unused as there)."""
    return scale_masks(torch.from_numpy(np.asarray(masks, bool)), orig_shape, pad).numpy()
