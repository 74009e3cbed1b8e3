"""WebP decoding without cv2 or PIL, bit-equal to the JAX package's
``imread`` (``fce_yolo_tpu/utils/patches.py:18``: ``cv2.imdecode(...,
IMREAD_COLOR)``, whose WebP reader is the libwebp cv2 carries).

Two paths give the same bytes:

- ``device="cuda"``: ``fce_webp_decode`` of ``csrc/webp.cu``. The container
  walk and the VP8L / VP8 / ALPH decoders run as host C++ into a pinned
  buffer with the interpreter lock released for the whole call; a lossy
  frame's planes then go to the card, where ``webp_color_kernel`` upsamples
  and converts them to BGR. A lossless frame is BGR on the host already and
  launches nothing. Each thread keeps its own stream and buffers.
- ``device="cpu"``: the plain version, ``decode_webp_reference``: this
  module's container walk, ``webp_lossless.py`` (VP8L, ALPH),
  ``webp_lossy.py`` (VP8) and ``webp_color_reference`` (numpy int32).

What is read, as libwebp and cv2 read it:

- the RIFF container: ``RIFF`` size checks (a file shorter than the 32
  bytes cv2 reads a header from, or cut short of its RIFF size, raises),
  odd chunks padded to even, a simple file's ``VP8 `` or ``VP8L`` chunk, and
  an extended file's ``VP8X`` (canvas size, flags) followed by any chunks
  (``ICCP``, ``EXIF``, ``XMP `` and unknown ones skipped; the last ``ALPH``
  before the image chunk is its alpha). The canvas must match the image;
  one over 2^30 pixels or 2^20 a side raises (cv2's limits).
- an animation (``VP8X`` with the animation flag): libwebp's demuxer rules
  (``ANIM`` before the ``ANMF`` frames, each frame's ``ALPH`` before its
  image, inside the canvas) and its first frame decoded at its offset on a
  canvas of zeros, as ``WebPAnimDecoder`` gives it.
- a bitstream reads on to the end of the buffer, as libwebp's does, not
  only to the end of its chunk.
- the EXIF orientation is applied as cv2 applies it: from the first
  ``EXIF`` chunk of an extended file whose VP8X EXIF flag is set and which
  libwebp's demuxer accepts; a simple file's ``EXIF`` chunk, an unflagged
  one and one that starts with ``Exif\0\0`` orient nothing.
- the alpha plane is decoded (a file whose alpha cv2 cannot decode raises)
  and dropped: ``cv2.imdecode(IMREAD_COLOR)`` gives the first three
  channels of the BGRA image.

Lossy frames go through libwebp's fancy upsampler (``UpsampleRgbLinePair``,
first and last rows as ``EmitFancyRGB`` treats them) and its fixed-point
YUV -> BGR (``VP8YuvToBgr``, 14-bit ``MultHi``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from fce_yolo_tpu_torch.data.jpeg import apply_orientation, exif_orientation
from fce_yolo_tpu_torch.data.webp_lossless import decode_alpha, decode_vp8l, vp8l_info
from fce_yolo_tpu_torch.data.webp_lossy import decode_vp8, vp8_size

__all__ = ["WEBP_SIGNATURE", "WebpImage", "parse_webp", "webp_image_reference", "webp_color_reference",
           "decode_webp_reference", "decode_webp", "webp_decode_host", "webp_color", "webp_planes_reference",
           "INFO_LEN"]

WEBP_SIGNATURE = (b"RIFF", b"WEBP")  # bytes 0-3 and 8-11
MAX_PIXELS, MAX_SIDE = 1 << 30, 1 << 20  # cv2's CV_IO_MAX_IMAGE_PIXELS and _WIDTH / _HEIGHT
_MAX_CHUNK = 0xFFFFFFFF - 8 - 1  # libwebp's MAX_CHUNK_PAYLOAD
_FLAG_ALPHA, _FLAG_ANIMATION, _FLAG_EXIF = 0x10, 0x02, 0x08
_VALID_FLAGS = 0x3E  # the demuxer's ALL_VALID_FLAGS


def _le(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _refuse(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: {what}; cv2 reads nothing of it (WebP)")


@dataclass
class WebpLayout:
    """Where the image lies in the file."""

    canvas: tuple[int, int]  # W, H
    offset: tuple[int, int]  # the frame's x, y on the canvas
    lossless: bool
    image: int  # offset of the image bitstream (after its chunk header)
    image_end: int  # the end of the data the bitstream may read
    alpha: tuple[int, int] | None  # ALPH payload offset, size
    has_alpha: bool  # libwebp's features.has_alpha
    exif: tuple[int, int] | None  # first EXIF payload offset, size
    animated: bool


def _chunks(buf: bytes, pos: int, end: int):
    """Chunk headers from ``pos`` (offset, fourcc, size, padded end), as far
    as whole headers lie before ``end``."""
    while pos + 8 <= end:
        size = _le(buf[pos + 4: pos + 8])
        yield pos, buf[pos: pos + 4], size, pos + 8 + size + (size & 1)
        pos += 8 + size + (size & 1)


def _first_exif(buf: bytes, start: int, end: int) -> tuple[int, int] | None:
    for pos, tag, size, nxt in _chunks(buf, start, end):
        if size > _MAX_CHUNK:
            return None
        if tag == b"EXIF" and pos + 8 + size <= end:
            return pos + 8, size
    return None


def _still_exif(buf: bytes, flags: int, end: int) -> tuple[int, int] | None:
    """The EXIF chunk cv2 orients an extended still by: the first one, when
    the VP8X EXIF flag is set and libwebp's demuxer accepts the file (no
    reserved flag, every chunk inside the RIFF, one image, its ALPH right
    before it, no animation chunk)."""
    if not flags & _FLAG_EXIF or flags & ~_VALID_FLAGS & 0xFF:
        return None
    pos, first, image, alph, anim = 30, None, False, False, False
    while pos < end:
        if end - pos < 8:
            return None
        tag, size = buf[pos: pos + 4], _le(buf[pos + 4: pos + 8])
        padded = size + (size & 1)
        if size > _MAX_CHUNK or padded > end - pos - 8 or tag in (b"VP8X", b"ANMF"):
            return None
        if tag in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or image or (tag == b"ALPH" and alph) or (tag == b"VP8L" and alph):
                return None
            alph, image = tag == b"ALPH", tag != b"ALPH"
        elif alph:  # a chunk between ALPH and its image
            return None
        elif tag == b"ANIM":
            anim = True
        elif tag == b"EXIF" and first is None:
            first = (pos + 8, size)
        pos += 8 + padded
    return first if image else None


def _anim_layout(buf: bytes, name: str, cw: int, ch: int, flags: int, end: int) -> WebpLayout:
    """libwebp's demuxer on an animation (every frame checked, as
    ``WebPAnimDecoderNew`` checks them), down to its first frame."""
    if flags & ~_VALID_FLAGS & 0xFF:
        raise _refuse(name, "a VP8X chunk with reserved flags set")
    pos, anim, frames = 30, 0, []
    while pos != end:
        if end - pos < 8:
            raise _refuse(name, "an animation that ends inside a chunk header")
        tag, size = buf[pos: pos + 4], _le(buf[pos + 4: pos + 8])
        padded = size + (size & 1)
        if size > _MAX_CHUNK or padded > end - pos - 8:
            raise _refuse(name, "a chunk past the RIFF's end")
        if tag in (b"VP8X", b"ALPH", b"VP8 ", b"VP8L"):
            raise _refuse(name, "an animation with an image chunk outside its frames")
        if tag == b"ANMF":
            if anim == 0 or padded < 16:
                raise _refuse(name, "an ANMF frame before the ANIM chunk, or a short one")
            frame, pos = _anmf_frame(buf, name, pos, padded, end)
            if frame is not None:
                frames.append(frame)
            continue
        if tag == b"ANIM":
            if padded < 6:
                raise _refuse(name, "a short ANIM chunk")
            anim += 1
        pos += 8 + padded
    if not frames:
        raise _refuse(name, "an animation without frames")
    for x, y, _, _, _, w, h, _ in frames:
        if x + w > cw or y + h > ch:
            raise _refuse(name, "an animation frame outside its canvas")
    x, y, image, img_end, lossless, w, h, alpha = frames[0]
    exif = _first_exif(buf, 30, end) if flags & _FLAG_EXIF else None  # the demuxer keeps it only when flagged
    return WebpLayout((cw, ch), (x, y), lossless, image, img_end, alpha, bool(flags & _FLAG_ALPHA), exif, True)


def _anmf_frame(buf: bytes, name: str, pos: int, padded: int, end: int):
    """The demuxer's StoreFrame on an ANMF chunk at ``pos``: its offset,
    then ALPH (optional) and the image chunk. Returns the frame (None when
    it holds neither) and where the demuxer goes on reading (after the
    image, not at the ANMF's end)."""
    x, y = 2 * _le(buf[pos + 8: pos + 11]), 2 * _le(buf[pos + 11: pos + 14])
    if (1 + _le(buf[pos + 14: pos + 17])) * (1 + _le(buf[pos + 17: pos + 20])) >= 1 << 32:
        raise _refuse(name, "an animation frame over 2^32 pixels")
    start = q = pos + 24
    if end - q < 8 or end - q < padded - 16:
        raise _refuse(name, "an animation frame cut short")
    alpha = image = None
    while True:
        tag, size = buf[q: q + 4], _le(buf[q + 4: q + 8])
        cpad = size + (size & 1)
        if size > _MAX_CHUNK or cpad > end - q - 8:
            raise _refuse(name, "an animation frame's chunk past the RIFF's end")
        if tag == b"ALPH" and alpha is None:
            alpha = (q + 8, size)
        elif tag == b"VP8L" and alpha is not None:
            raise _refuse(name, "a lossless animation frame with an ALPH chunk")
        elif tag in (b"VP8 ", b"VP8L") and image is None:
            lossless, w, h, _ = _image_info(buf, name, tag, q + 8, size, q + 8 + cpad)
            image = (q + 8, q + 8 + cpad, lossless, w, h)
        else:
            break
        q += 8 + cpad
        if q == end:
            break
        if end - q < 8:
            raise _refuse(name, "an animation that ends inside a chunk header")
    if q - start > padded - 16:
        raise _refuse(name, "an animation frame's chunks overrun its ANMF chunk")
    if image is None and alpha is None:
        return None, q  # the demuxer drops the frame and reads on from its first chunk
    if image is None:
        raise _refuse(name, "an animation frame without an image")
    img, img_end, lossless, w, h = image
    return (x, y, img, img_end, lossless, w, h, None if lossless else alpha), q


def _image_info(buf: bytes, name: str, tag: bytes, start: int, size: int, end: int) -> tuple[bool, int, int, bool]:
    data = buf[start: end]
    if tag == b"VP8L":
        info = vp8l_info(data)
        if info is None:
            raise _refuse(name, "a VP8L chunk that is not a VP8L stream")
        return True, info[0], info[1], bool(info[2])
    wh = vp8_size(data, size)
    if wh is None:
        raise _refuse(name, "a VP8 chunk that is not a VP8 key frame")
    return False, wh[0], wh[1], False


def parse_webp(buf: bytes, name: str = "<webp>") -> WebpLayout:
    """The container walk of libwebp's ``ParseHeadersInternal`` (and of its
    demuxer for an animation)."""
    n = len(buf)
    if n < 32:
        raise _refuse(name, "a WebP file under 32 bytes")
    if buf[:4] != b"RIFF" or buf[8:12] != b"WEBP":
        raise _refuse(name, "not a RIFF WEBP file")
    riff = _le(buf[4:8])
    if riff < 12 or riff > _MAX_CHUNK:
        raise _refuse(name, "a bad RIFF size")
    if riff > n - 8:
        raise _refuse(name, "a WebP file cut short of its RIFF size")
    pos = 12
    flags, vp8x = 0, False
    cw = ch = 0
    if buf[12:16] == b"VP8X":
        if _le(buf[16:20]) != 10:
            raise _refuse(name, "a VP8X chunk of another size than 10")
        flags = _le(buf[20:24])
        cw, ch = 1 + _le(buf[24:27]), 1 + _le(buf[27:30])
        if cw * ch >= 1 << 32:
            raise _refuse(name, "a canvas over 2^32 pixels")
        vp8x = True
        pos = 30
        if flags & _FLAG_ANIMATION:
            if cw * ch > MAX_PIXELS or max(cw, ch) > MAX_SIDE:
                raise _refuse(name, "a canvas over 2^30 pixels or 2^20 a side (cv2's limits)")
            return _anim_layout(buf, name, cw, ch, flags, riff + 8)  # the demuxer reads no further
    alpha = None
    if vp8x:  # ParseOptionalChunks: skip up to the image chunk
        total = 4 + 8 + 10
        while True:
            if n - pos < 8:
                raise _refuse(name, "a WebP file without an image chunk")
            size = _le(buf[pos + 4: pos + 8])
            if size > _MAX_CHUNK:
                raise _refuse(name, "a bad chunk size")
            disk = (8 + size + 1) & ~1
            total += disk
            if total > riff:
                raise _refuse(name, "a chunk past the RIFF's end")
            if buf[pos: pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if n - pos < disk:
                raise _refuse(name, "a chunk cut short")
            if buf[pos: pos + 4] == b"ALPH":
                alpha = (pos + 8, size)
            pos += disk
    tag = buf[pos: pos + 4]
    if n - pos < 8:
        raise _refuse(name, "a WebP file cut short")
    if tag not in (b"VP8 ", b"VP8L"):
        raise _refuse(name, f"a WebP file whose image chunk is {tag!r}")
    size = _le(buf[pos + 4: pos + 8])
    if size > riff - 12:
        raise _refuse(name, "an image chunk larger than the RIFF")
    if size > n - pos - 8:
        raise _refuse(name, "an image chunk cut short")
    lossless, w, h, vp8l_alpha = _image_info(buf, name, tag, pos + 8, size, n)
    if vp8x and (cw, ch) != (w, h):
        raise _refuse(name, "a canvas of another size than its image")
    if w * h > MAX_PIXELS:
        raise _refuse(name, "an image over 2^30 pixels")
    has_alpha = bool(flags & _FLAG_ALPHA)
    if lossless:
        has_alpha = vp8l_alpha
    has_alpha = has_alpha or alpha is not None
    exif = _still_exif(buf, flags, riff + 8) if vp8x else None  # a simple file's EXIF is not read
    return WebpLayout((w, h), (0, 0), lossless, pos + 8, n, None if lossless else alpha, has_alpha, exif, False)


@dataclass
class WebpImage:
    """A decoded frame before colour conversion: ARGB (lossless) or the
    Y/U/V planes (lossy) and the alpha plane, with its layout."""

    layout: WebpLayout
    width: int
    height: int
    argb: np.ndarray | None = None  # uint32 (h, w)
    y: np.ndarray | None = None
    u: np.ndarray | None = None
    v: np.ndarray | None = None
    alpha: np.ndarray | None = None  # uint8 (h, w), lossy frames with an ALPH chunk
    orientation: int = 1  # EXIF


def webp_image_reference(buf: bytes, name: str = "<webp>") -> WebpImage:
    """The plain decoders on a file's image (or its first frame)."""
    lay = parse_webp(buf, name)
    data = buf[lay.image: lay.image_end]
    if lay.lossless:
        argb = decode_vp8l(data, name)
        img = WebpImage(lay, argb.shape[1], argb.shape[0], argb=argb)
    else:
        y, u, v = decode_vp8(data, name)
        img = WebpImage(lay, y.shape[1], y.shape[0], y=y, u=u, v=v)
        if lay.alpha is not None:
            a0, an = lay.alpha
            img.alpha = decode_alpha(buf[a0: a0 + an], img.width, img.height, name)
    if lay.exif is not None:
        img.orientation = exif_orientation(buf[lay.exif[0]: lay.exif[0] + lay.exif[1]])
    return img


def webp_planes_reference(buf: bytes, name: str = "<webp>") -> np.ndarray:
    """The plain decoders' frame as the C decoder's flat host buffer lays
    it out (``fce_webp_planes``): lossy Y, U, V (and alpha), or ARGB."""
    img = webp_image_reference(buf, name)
    if img.argb is not None:
        return img.argb.ravel().view(np.uint8)
    parts = [img.y.ravel(), img.u.ravel(), img.v.ravel()] + ([img.alpha.ravel()] if img.alpha is not None else [])
    return np.concatenate(parts)


def _mult_hi(v: np.ndarray, c: int) -> np.ndarray:
    return (v * c) >> 8


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def webp_color_reference(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's fancy upsampling + VP8YuvToBgr: Y (H, W), U and V
    ((H + 1) // 2, (W + 1) // 2) uint8 -> BGR uint8 (H, W, 3).

    A luma row r takes chroma row r >> 1 as its near row and the one above
    (r even) or below (r odd) as its far row, clamped at the plane's edges
    (EmitFancyRGB mirrors the first row and, for an even height, the last);
    columns likewise. Each sample is
    ``((nn + 3 nf + 3 fn + ff + 8) >> 3 + nn) >> 1``, which is libwebp's
    diagonal form, and at the edges its ``(3 near + far + 2) >> 2``."""
    h, w = y.shape
    uh, uw = u.shape

    def near_far(n: int, m: int) -> tuple[np.ndarray, np.ndarray]:
        i = np.arange(n)
        near = i >> 1
        far = np.where(i & 1, near + 1, near - 1).clip(0, m - 1)
        return near, far

    nr, fr = near_far(h, uh)
    nc, fc = near_far(w, uw)

    def up(p: np.ndarray) -> np.ndarray:
        p = p.astype(np.int32)
        nn, nf = p[nr][:, nc], p[nr][:, fc]
        fn, ff = p[fr][:, nc], p[fr][:, fc]
        return (((nn + 3 * nf + 3 * fn + ff + 8) >> 3) + nn) >> 1

    uu, vv, yy = up(u), up(v), y.astype(np.int32)
    yv = _mult_hi(yy, 19077)
    out = np.empty((h, w, 3), np.uint8)
    out[..., 0] = _clip8(yv + _mult_hi(uu, 33050) - 17685)
    out[..., 1] = _clip8(yv - _mult_hi(uu, 6419) - _mult_hi(vv, 13320) + 8708)
    out[..., 2] = _clip8(yv + _mult_hi(vv, 26149) - 14234)
    return out


def _bgra(img: WebpImage) -> np.ndarray:
    """The frame as BGRA (alpha 255 for a lossy frame without ALPH)."""
    if img.argb is not None:
        a = img.argb
        return np.stack([a & 0xFF, (a >> 8) & 0xFF, (a >> 16) & 0xFF, a >> 24], axis=-1).astype(np.uint8)
    bgr = webp_color_reference(img.y, img.u, img.v)
    alpha = img.alpha if img.alpha is not None else np.full(img.y.shape, 255, np.uint8)
    return np.concatenate([bgr, alpha[..., None]], axis=-1)


def decode_webp_reference(buf: bytes, name: str = "<webp>") -> np.ndarray:
    """The plain path: WebP bytes -> BGR uint8 (H, W, 3), or BGRA (H, W, 4)
    when libwebp reports alpha, oriented as ``cv2.imdecode`` orients."""
    img = webp_image_reference(buf, name)
    lay = img.layout
    frame = _bgra(img)
    if lay.animated:
        canvas = np.zeros((lay.canvas[1], lay.canvas[0], 4), np.uint8)
        x, y = lay.offset
        canvas[y: y + img.height, x: x + img.width] = frame
        frame = canvas
    out = frame if lay.has_alpha else frame[..., :3]
    return apply_orientation(np.ascontiguousarray(out), img.orientation)


# ------------------------------------------------------------------ the card
_LAUNCH_LOCK = threading.Lock()
_TLS = threading.local()
# the C decoder's int32 record: 0 kind (1 lossy, 2 lossless), 1 canvas W, 2 canvas H, 3 frame W, 4 frame H,
# 5 frame x, 6 frame y, 7 has_alpha (libwebp's features), 8 an ALPH plane follows the lossy planes,
# 9 EXIF offset, 10 EXIF length (0: none), 11 host plane bytes needed, 12 animated
INFO_LEN = 16
_GROW = -13  # the caller's buffers are too small for the record just filled in
# fce_webp_* return codes below 0 -> what the file is
_ERRORS = {-1: "not a WebP file, or a corrupt or truncated one", -2: "a corrupt VP8 (lossy) bitstream",
           -3: "a corrupt VP8L (lossless) bitstream", -4: "a corrupt ALPH (alpha) chunk",
           -5: "an animation libwebp's demuxer refuses", -12: "a WebP image over 2^30 pixels (cv2's limit)"}


def _check(code: int, name: str, what: str) -> None:
    if code == 0:
        return
    if code < 0:
        raise ValueError(f"{name}: {_ERRORS.get(code, f'error {code}')}; cv2 reads nothing of it (WebP)")
    raise RuntimeError(f"{what} of {name}: CUDA error {code}")


def _count(*wrappers) -> None:
    with _LAUNCH_LOCK:
        for w in wrappers:
            w.launches += 1


def _planes_of(info: np.ndarray, flat: np.ndarray) -> dict:
    w, h = int(info[3]), int(info[4])
    if info[0] == 2:
        return {"argb": flat[: 4 * w * h].view(np.uint32).reshape(h, w)}
    uw, uh = (w + 1) // 2, (h + 1) // 2
    o = [0, w * h, w * h + uw * uh, w * h + 2 * uw * uh]
    out = {"y": flat[o[0]: o[1]].reshape(h, w), "u": flat[o[1]: o[2]].reshape(uh, uw),
           "v": flat[o[2]: o[3]].reshape(uh, uw)}
    if info[8]:
        out["alpha"] = flat[o[3]: o[3] + w * h].reshape(h, w)
    return out


def webp_decode_host(buf: bytes, name: str = "<webp>") -> tuple[np.ndarray, np.ndarray, dict]:
    """The C host decoder alone (``fce_webp_planes``): (info record, the
    flat host buffer, its planes by name: ``y``/``u``/``v`` (+ ``alpha``) of
    a lossy frame or ``argb`` of a lossless one)."""
    from fce_yolo_tpu_torch.kernels import build as kbuild

    info = np.zeros(INFO_LEN, np.int32)
    flat = np.zeros(0, np.uint8)
    while (err := kbuild.library().fce_webp_planes(buf, len(buf), info.ctypes.data, flat.ctypes.data,
                                                    flat.size)) == _GROW:
        flat = np.zeros(int(info[11]), np.uint8)
    _check(err, name, "fce_webp_planes")
    flat = flat[: int(info[11])]
    return info, flat, _planes_of(info, flat)


class _Buffers:
    """One thread's stream and buffers, grown to the largest image seen:
    pinned host planes and BGR out, device planes and BGR."""

    def __init__(self, device):
        import torch

        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.plane_n = self.out_n = 0
        self.h_planes = self.d_planes = self.d_out = self.h_out = None

    def ensure(self, plane_n: int, out_n: int) -> None:
        import torch

        with torch.cuda.stream(self.stream):
            if plane_n > self.plane_n:
                self.h_planes = torch.empty(plane_n, dtype=torch.uint8, pin_memory=True)
                self.d_planes = torch.empty(plane_n, dtype=torch.uint8, device=self.device)
                self.plane_n = plane_n
            if out_n > self.out_n:
                self.d_out = torch.empty(out_n, dtype=torch.uint8, device=self.device)
                self.h_out = torch.empty(out_n, dtype=torch.uint8, pin_memory=True)
                self.out_n = out_n


def _buffers(device):
    import torch

    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    per = getattr(_TLS, "buffers", None)
    if per is None:
        per = _TLS.buffers = {}
    if device not in per:
        per[device] = _Buffers(device)
    return per[device]


def decode_webp(buf: bytes, name: str = "<webp>", device="cuda", times: np.ndarray | None = None) -> np.ndarray:
    """WebP bytes -> BGR uint8 (H, W, 3), oriented as ``cv2.imdecode`` does.

    ``device="cuda"`` (or a CUDA device): ``fce_webp_decode`` (host decode,
    for a lossy frame the copies and ``webp_color_kernel``) on this thread's
    stream; raises without CUDA, on a build or launch failure, and for the
    files cv2 cannot read; ``decode_webp.launches`` counts these calls.
    ``device="cpu"``: the plain version. ``times``
    (float32 (4,), CUDA only) receives ms of host decode, H2D, colour, D2H
    (the last three 0 for a lossless frame)."""
    import torch

    device = torch.device(device)
    if device.type == "cpu":
        return np.ascontiguousarray(decode_webp_reference(buf, name)[..., :3])
    if device.type != "cuda":
        raise ValueError(f"no WebP kernel for device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: WebP decode on {device} needs CUDA, which is not available; pass device='cpu' "
                           "for the plain version")
    from fce_yolo_tpu_torch.kernels import build as kbuild

    if times is not None and (times.dtype != np.float32 or times.size < 4):
        raise ValueError("times must be a float32 array of 4")
    lib = kbuild.library()
    info = np.zeros(INFO_LEN, np.int32)
    b = _buffers(device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(b.device):
        while (err := lib.fce_webp_decode(buf, len(buf), info.ctypes.data, ptr(b.h_planes), ptr(b.d_planes),
                                          b.plane_n, ptr(b.d_out), ptr(b.h_out), b.out_n,
                                          None if times is None else times.ctypes.data,
                                          b.stream.cuda_stream)) == _GROW:
            b.ensure(int(info[11]), 3 * int(info[1]) * int(info[2]))
    _check(err, name, "fce_webp_decode")
    if info[0] == 1:
        _count(decode_webp, webp_color)
    else:
        _count(decode_webp)
    w, h = int(info[1]), int(info[2])
    img = b.h_out[: h * w * 3].numpy().reshape(h, w, 3)
    orientation = 1 if info[10] == 0 else exif_orientation(buf[int(info[9]): int(info[9]) + int(info[10])])
    return apply_orientation(img, orientation) if orientation != 1 else img.copy()


def webp_color(planes, info: np.ndarray):
    """Upsample + colour-convert a lossy frame: uint8 planes (flat, the
    layout of ``webp_decode_host``: Y, U, V) and the C decoder's record ->
    BGR uint8 (h, w, 3) of the frame. A CUDA tensor launches
    ``webp_color_kernel`` on the current stream; a CPU tensor takes
    ``webp_color_reference``."""
    import torch

    if info[0] != 1:
        raise ValueError("webp_color takes the planes of a lossy (VP8) frame")
    w, h = int(info[3]), int(info[4])
    uw, uh = (w + 1) // 2, (h + 1) // 2
    need = w * h + 2 * uw * uh
    if planes.device.type == "cpu":
        p = _planes_of(info, planes.numpy())
        return torch.from_numpy(webp_color_reference(p["y"], p["u"], p["v"]))
    if planes.device.type != "cuda":
        raise ValueError(f"no WebP kernel for device {planes.device}")
    if planes.dtype != torch.uint8 or not planes.is_contiguous() or planes.numel() < need:
        raise ValueError("webp_color takes contiguous uint8 planes of the record's size")
    from fce_yolo_tpu_torch.kernels import build as kbuild

    out = torch.empty(h, w, 3, dtype=torch.uint8, device=planes.device)
    with torch.cuda.device(planes.device):
        err = kbuild.library().fce_webp_color(planes.data_ptr(), out.data_ptr(), w, h, w, 0, 0,
                                              torch.cuda.current_stream().cuda_stream)
    kbuild.check(err, "fce_webp_color")
    _count(webp_color)
    return out


decode_webp.launches = 0  # calls of the host decoder (fce_webp_decode)
webp_color.launches = 0
