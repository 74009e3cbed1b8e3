"""PFM (portable float map) decoding without cv2, bit-equal to
``cv2.imdecode(..., IMREAD_COLOR)`` (OpenCV's ``grfmt_pfm.cpp``), the JAX
package's ``imread``, but for the shape of a gray file.

The header is ``PF`` (RGB) or ``Pf`` (gray), a line break, then the width,
the height and the scale, each ended by one whitespace byte; the sign of
the scale gives the byte order (negative: little-endian). Rows run bottom
to top. As OpenCV does, each float32 sample is multiplied by the float32
``1 / |scale|``, RGB turned to BGR, and converted to uint8 by a rounding
saturate cast: round half to even, then clamp to 0-255, where NaN,
infinities and anything past the int32 range round to int32's minimum, so
to 0.

cv2 gives a ``Pf`` file as a 2-D (H, W) array; this reader copies it into
three equal channels, as every other gray image comes out.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["decode_pfm", "PFM_SIGNATURES"]

PFM_SIGNATURES = (b"PF\n", b"Pf\n")
_SPACE = b" \t\n\v\f\r"
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _number(buf: bytes, pos: int, name: str) -> tuple[str, int]:
    """OpenCV's read_number: bytes up to the first whitespace byte, which is consumed."""
    end = pos
    while end < len(buf) and buf[end] not in _SPACE:
        end += 1
    if end >= len(buf):
        raise ValueError(f"{name}: PFM header ends early")
    return buf[pos:end].decode("latin-1"), end + 1


def _prefix(pattern: re.Pattern, s: str, kind):
    """C's atoi / atof: the longest leading number, else 0."""
    m = pattern.match(s)
    return kind(m.group()) if m else kind(0)


def decode_pfm(buf: bytes, name: str = "<pfm>") -> np.ndarray:
    """PFM bytes -> BGR uint8 (H, W, 3)."""
    if buf[:3] not in PFM_SIGNATURES:
        raise ValueError(f"{name}: not a PFM file")
    ch = 3 if buf[1:2] == b"F" else 1
    w, pos = _number(buf, 3, name)
    h, pos = _number(buf, pos, name)
    scale_text, pos = _number(buf, pos, name)
    w, h, scale = _prefix(_INT, w, int), _prefix(_INT, h, int), _prefix(_FLOAT, scale_text, float)
    if w <= 0 or h <= 0 or w > 1 << 20 or h > 1 << 20 or w * h > 1 << 30:
        raise ValueError(f"{name}: a PFM of {w} x {h} pixels (cv2 reads none)")
    if not abs(scale) > 0:
        raise ValueError(f"{name}: PFM scale {scale_text!r} is zero (cv2 reads none)")
    n = w * h * ch * 4
    if len(buf) - pos < n:
        raise ValueError(f"{name}: PFM data ends before the image does")
    x = np.frombuffer(buf, "<f4" if scale < 0 else ">f4", w * h * ch, pos).reshape(h, w, ch)[::-1]
    x = x.astype(np.float32) * np.float32(1.0 / abs(scale))
    with np.errstate(invalid="ignore"):
        ok = np.abs(x) < 2.0 ** 31  # False for NaN and infinities
        r = np.where(ok, np.rint(np.where(ok, x, 0)), -(2.0 ** 31))
    img = np.clip(r, 0, 255).astype(np.uint8)
    return np.repeat(img, 3, axis=2) if ch == 1 else img[..., ::-1].copy()
