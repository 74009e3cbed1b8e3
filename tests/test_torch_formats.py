"""The port's still-image readers (``data/png.py``, ``bmp.py``, ``tiff.py``,
``pfm.py`` and the dispatch in ``imread.py``) against the JAX package's
``imread`` (``cv2.imdecode``: cv2 5.0 with libpng 1.6, its own BMP and PFM
code and libtiff 4.7), on files written here from seeded numpy arrays by
hand-built writers (every PNG colour type, depth and Adam7; BMP headers,
depths and RLE streams; TIFF layouts, compressions and samples; PFM), by
cv2 and by PIL.

Tolerance: none. Every image equals the JAX package's byte for byte, with
one stated difference: cv2 gives a gray PFM as a 2-D array, the port as
three equal channels. Where cv2 returns None the port raises, and where cv2
reads a file the port does not (JPEG-in-TIFF, CCITT, YCbCr, CMYK, Lab) it
raises ``ValueError`` naming the file and the format. WebP reads, and has
its own tests (``tests/test_torch_webp.py``).

TIFF's LZW and PackBits run twice: in Python (``device="cpu"``) and as
the host C++ the card's library holds (``csrc/imgcodecs.cu``, built here
with g++ and put in place of ``kbuild.library``).
"""

import ctypes
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from fce_yolo_tpu.utils.patches import imread as jax_imread
from fce_yolo_tpu_torch.data import tiff as T
from fce_yolo_tpu_torch.data.imread import imread
from fce_yolo_tpu_torch.data.png import ADAM7
from fce_yolo_tpu_torch.kernels import build as kbuild

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as C  # noqa: E402  (the card script's writers)

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _same(path, device="cpu"):
    """The port's read equals the JAX package's, byte for byte."""
    ref = jax_imread(path)
    assert ref is not None, f"cv2 reads nothing of {path}"
    out = imread(path, device=device)
    if ref.ndim == 2:
        ref = np.repeat(ref[..., None], 3, axis=2)
    assert out.dtype == np.uint8 and out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_array_equal(out, ref)
    return out


def _cv2_reads(path) -> bool:
    try:
        return jax_imread(path) is not None
    except cv2.error:  # cv2.imdecode throws for some headers (a width of 0)
        return False


def _refused(path, match, cv2_reads, device="cpu"):
    with pytest.raises(ValueError, match=match):
        imread(path, device=device)
    assert _cv2_reads(path) == cv2_reads


# ------------------------------------------------------------------ PNG
def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png(samples: np.ndarray, color: int, depth: int, interlace: bool = False, palette=None, extra=b"",
         after=b"") -> bytes:
    """A PNG of ``samples`` (H, W, channels), values below 2^depth: rows packed MSB first below 8 bits,
    big-endian at 16; row r of each pass takes filter r % 5; ``extra`` chunks before IDAT, ``after`` after it."""
    h, w, ch = samples.shape
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        if depth == 16:
            rows = sub.astype(">u2").reshape(sub.shape[0], -1).view(np.uint8)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(sub.shape[0], -1)
        else:
            bits = np.unpackbits(sub.astype(np.uint8).reshape(sub.shape[0], -1, 1), axis=2)[..., 8 - depth:]
            rows = np.packbits(bits.reshape(sub.shape[0], -1), axis=1)
        raw += C._png_filtered(rows, max(1, ch * depth // 8)).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + extra + _chunk(b"IDAT", zlib.compress(raw)) + after + _chunk(b"IEND", b"")


PNG_CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16),
             (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_CASES, ids=[f"type{c}-{d}bit" for c, d in PNG_CASES])
def test_png_every_type_and_depth_matches_jax_imread(tmp_path, color, depth, interlace):
    """Gray, RGB, palette, gray+alpha and RGBA at every depth, with and
    without Adam7, from 1x1 (six of the seven passes empty) to 37x61; a
    palette shorter than its indices reach, and a ``tRNS`` chunk, which
    changes nothing."""
    rng = np.random.RandomState(color * 100 + depth + interlace)
    for i, (h, w) in enumerate([(1, 1), (2, 3), (5, 1), (9, 17), (37, 61)]):
        top = 1 << depth
        px = rng.randint(0, top, (h, w, CHANNELS[color]))
        px[h // 2:, : w // 3] = top - 1  # a flat area
        palette, extra = None, b""
        if color == 3:
            n = max(1, min(256, top) - 1)  # one index past the entries: black
            palette = rng.randint(0, 256, (n, 3))
            extra = _chunk(b"tRNS", bytes(rng.randint(0, 256, n).astype(np.uint8)))
        elif color in (0, 2) and depth == 8:
            extra = _chunk(b"tRNS", b"\x00\x07" * (3 if color == 2 else 1))
        path = tmp_path / f"{i}.png"
        path.write_bytes(_png(px, color, depth, interlace, palette, extra))
        _same(path)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P", "1", "I;16"])
def test_png_written_by_pil_matches_jax_imread(tmp_path, mode):
    rng = np.random.RandomState(len(mode))
    arr = rng.randint(0, 256, (23, 31, 3)).astype(np.uint8)
    im = Image.fromarray(arr).convert(mode) if mode != "I;16" else Image.fromarray(
        rng.randint(0, 65536, (23, 31)).astype(np.uint16))
    im.save(tmp_path / "a.png")
    _same(tmp_path / "a.png")


def _exif(orientation: int, order: bytes = b"MM") -> bytes:
    e = ">" if order == b"MM" else "<"
    return order + struct.pack(e + "HIH", 42, 8, 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + b"\0" * 4


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_matches_jax_imread(tmp_path, orientation):
    """The repro of the repair: PIL saves a 30x50 RGB PNG with EXIF
    Orientation in an ``eXIf`` chunk; cv2 rotates it, and the port does too
    (it ignored the chunk before). Also from the port's own writer, the chunk
    after IDAT and little-endian."""
    arr = np.random.RandomState(orientation).randint(0, 256, (30, 50, 3)).astype(np.uint8)
    ex = Image.Exif()
    ex[0x0112] = orientation
    Image.fromarray(arr).save(tmp_path / "pil.png", exif=ex)
    out = _same(tmp_path / "pil.png")
    assert out.shape == ((50, 30, 3) if orientation >= 5 else (30, 50, 3))
    (tmp_path / "after.png").write_bytes(_png(arr, 2, 8, after=_chunk(b"eXIf", _exif(orientation, b"II"))))
    _same(tmp_path / "after.png")


@pytest.mark.parametrize("kind", ["exif-header", "duplicate", "invalid-then-valid", "bad-crc-then-valid",
                                  "short-then-valid", "orientation-9", "long-type", "ancillary-bad-crc",
                                  "unknown-ancillary", "magic-40"])
def test_png_exif_edge_cases_match_jax_imread(tmp_path, kind):
    """What libpng keeps when an ``eXIf`` chunk is malformed or repeated:
    the first chunk that starts ``MM`` or ``II`` and passes its CRC, valid
    orientation or not; an ancillary chunk that fails its CRC is skipped.
    cv2's Exif reader then wants the TIFF magic 42."""
    arr = np.random.RandomState(3).randint(0, 256, (12, 20, 3)).astype(np.uint8)
    bad = bytearray(_chunk(b"eXIf", _exif(6)))
    bad[-1] ^= 1
    extra = {"exif-header": _chunk(b"eXIf", b"Exif\0\0" + _exif(6)),
             "duplicate": _chunk(b"eXIf", _exif(6)) + _chunk(b"eXIf", _exif(3)),
             "invalid-then-valid": _chunk(b"eXIf", b"MI" + _exif(6)[2:]) + _chunk(b"eXIf", _exif(3)),
             "bad-crc-then-valid": bytes(bad) + _chunk(b"eXIf", _exif(8)),
             "short-then-valid": _chunk(b"eXIf", b"MM\0*") + _chunk(b"eXIf", _exif(3)),
             "orientation-9": _chunk(b"eXIf", _exif(9)),
             "long-type": _chunk(b"eXIf", b"MM" + struct.pack(">HIH", 42, 8, 1) + struct.pack(">HHII", 0x112, 4, 1, 6)
                                 + b"\0" * 4),
             "ancillary-bad-crc": _chunk(b"tEXt", b"a\0b")[:-1] + b"\0",
             "unknown-ancillary": _chunk(b"abCD", b"x"),
             "magic-40": _chunk(b"eXIf", _exif(6)[:3] + b"(" + _exif(6)[4:])}[kind]
    (tmp_path / "a.png").write_bytes(_png(arr, 2, 8, extra=extra))
    _same(tmp_path / "a.png")


@pytest.mark.parametrize("kind", ["idat-bad-crc", "unknown-critical", "no-iend", "ihdr-not-first"])
def test_png_cv2_refuses_the_port_raises(tmp_path, kind):
    buf = _png(np.zeros((4, 4, 3), np.uint8), 2, 8)
    i, j = buf.index(b"IDAT") - 4, buf.index(b"IEND") - 4
    buf = {"idat-bad-crc": buf[:j - 1] + bytes([buf[j - 1] ^ 1]) + buf[j:],
           "unknown-critical": buf[:i] + _chunk(b"ABCD", b"x") + buf[i:],
           "no-iend": buf[:j],
           "ihdr-not-first": buf[:8] + _chunk(b"tEXt", b"a\0b") + buf[8:]}[kind]
    (tmp_path / "a.png").write_bytes(buf)
    _refused(tmp_path / "a.png", "a.png: ", cv2_reads=False)


@pytest.mark.parametrize("interlace", [False, True])
def test_chip_smoke_png_writer_gives_files_cv2_reads(interlace):
    """chip_smoke.py's PNG writer at 8 and 16 bits, plain and Adam7: cv2
    reads the array written, and so does the port."""
    rng = np.random.RandomState(5)
    for h, w in [(1, 1), (3, 7), (33, 47)]:
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for depth in (8, 16):
            buf = C.png_bytes(rgb, depth, interlace)
            ref = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
            np.testing.assert_array_equal(ref, rgb[..., ::-1])
            from fce_yolo_tpu_torch.data.png import decode_png

            np.testing.assert_array_equal(decode_png(buf), ref)


# ------------------------------------------------------------------ BMP
def _bmp(pixels: bytes, w: int, h: int, bpp: int, comp: int = 0, palette: bytes = b"", size: int = 40,
         masks: bytes = b"", clrused: int | None = None) -> bytes:
    if size == 12:
        header = struct.pack("<IhhHH", 12, w, h, 1, bpp)
    else:
        n = len(palette) // 4 if clrused is None else clrused
        header = struct.pack("<IiiHHIIiiII", size, w, h, 1, bpp, comp, len(pixels), 0, 0, n, 0)
        header += bytes(size - 40)
    offset = 14 + len(header) + len(masks) + len(palette)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + header + masks + palette + pixels


def _rows(data: np.ndarray, bits: int) -> bytes:
    """(H, W) or (H, W, n) values -> file rows of ``bits`` a pixel, padded to 4 bytes."""
    h = data.shape[0]
    flat = data.reshape(h, -1)
    if bits < 8:
        b = np.unpackbits(flat.astype(np.uint8)[..., None], axis=2)[..., 8 - bits:]
        rows = np.packbits(b.reshape(h, -1), axis=1)
    elif bits == 16:
        rows = flat.astype("<u2").view(np.uint8)
    else:
        rows = flat.astype(np.uint8)
    pad = (-rows.shape[1]) % 4
    return np.pad(rows, ((0, 0), (0, pad))).tobytes()


@pytest.mark.parametrize("kind", ["1", "4", "8", "8-gray", "8-short-palette", "16-555", "16-555-bitfields",
                                  "16-565", "24", "32", "32-bitfields", "os2-1", "os2-8", "os2-24", "v4-24", "v5-8"])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_formats_match_jax_imread(tmp_path, kind, top_down):
    """Every header and pixel format cv2's own reader takes, bottom-up and
    top-down (negative height), at widths whose rows need padding."""
    rng = np.random.RandomState(len(kind) + top_down)
    for i, (h, w) in enumerate([(1, 1), (3, 5), (17, 13), (8, 33)]):
        hh = -h if top_down and not kind.startswith("os2") else h  # OS/2's height is unsigned
        size, comp, masks, palette, clrused = 40, 0, b"", b"", None
        if kind.startswith("os2"):
            size = 12
        elif kind.startswith("v4"):
            size = 108
        elif kind.startswith("v5"):
            size = 124
        bits = int(kind.split("-")[-1] if kind.startswith(("os2", "v")) else kind.split("-")[0])
        if bits <= 8:
            n = 1 << bits
            pal = rng.randint(0, 256, (n, 3))
            if kind == "8-gray":
                pal = np.repeat(np.arange(256)[:, None], 3, 1)
            if kind == "8-short-palette":
                clrused = 10
                pal = pal[:10]
            palette = (pal.astype(np.uint8).tobytes() if size == 12 else
                       np.concatenate([pal, np.zeros((len(pal), 1), int)], 1).astype(np.uint8).tobytes())
            data = rng.randint(0, n, (h, w))
        elif bits == 16:
            data = rng.randint(0, 65536, (h, w))
            if kind != "16-555":
                comp = 3
                masks = struct.pack("<III", *((0x7C00, 0x3E0, 0x1F) if kind.endswith("555-bitfields")
                                              else (0xF800, 0x7E0, 0x1F)))
        else:
            data = rng.randint(0, 256, (h, w, bits // 8))
            if kind == "32-bitfields":
                comp, masks = 3, struct.pack("<III", 0xFF0000, 0xFF00, 0xFF)
        buf = _bmp(_rows(data, bits), w, hh, bits, comp, palette, size, masks, clrused)
        (tmp_path / f"{i}.bmp").write_bytes(buf)
        _same(tmp_path / f"{i}.bmp")


def _rle_ops(rng, w: int, h: int, bits: int, ops: int) -> bytes:
    """A random RLE stream: encoded runs, absolute runs, end of line, delta and a final end of bitmap."""
    out = bytearray()
    for _ in range(ops):
        k = rng.randint(0, 10)
        if k < 5:
            out += bytes([rng.randint(1, max(2, w // 2)), rng.randint(0, 256)])
        elif k < 7:
            n = rng.randint(3, max(4, w // 2))
            nbytes = n if bits == 8 else (n + 1) // 2
            body = bytes(rng.randint(0, 256, nbytes).astype(np.uint8))
            out += bytes([0, n]) + body + b"\0" * ((-len(body)) % 2)
        elif k < 9:
            out += b"\0\0"
        else:
            out += bytes([0, 2, rng.randint(0, 4), rng.randint(0, 2)])
    return bytes(out) + b"\0\1"


@pytest.mark.parametrize("bits", [8, 4])
def test_bmp_rle_streams_match_jax_imread(tmp_path, bits):
    """Random RLE8/RLE4 streams: what cv2 reads (the escapes fill the pixels
    they pass with palette entry 0, runs wrap as OpenCV's do) the port
    reads bit for bit, and where cv2 returns None (a run past its row's
    end, a stream that breaks off) the port raises. Both outcomes occur."""
    rng = np.random.RandomState(bits)
    outcomes = {True: 0, False: 0}
    for i in range(120):
        w, h = rng.randint(1, 20), rng.randint(1, 8)
        stream = _rle_ops(rng, w, h, bits, rng.randint(1, 3 * h + 3))
        if i % 10 == 9:
            stream = stream[: rng.randint(0, len(stream))]  # breaks off
        pal = rng.randint(0, 256, (1 << bits, 4)).astype(np.uint8).tobytes()
        path = tmp_path / f"{i}.bmp"
        path.write_bytes(_bmp(stream, w, h if i % 3 else -h, bits, 1 if bits == 8 else 2, pal))
        ok = _cv2_reads(path)
        outcomes[ok] += 1
        if ok:
            _same(path)
        else:
            with pytest.raises(ValueError, match=f"{i}.bmp: "):
                imread(path, device="cpu")
    assert min(outcomes.values()) >= 10, outcomes


@pytest.mark.parametrize("kind", ["16-other-masks", "v4-16-bitfields", "cut-short", "os2-16", "width-0",
                                  "jpeg-compression"])
def test_bmp_cv2_refuses_the_port_raises(tmp_path, kind):
    rng = np.random.RandomState(1)
    data = rng.randint(0, 65536, (4, 6))
    if kind == "16-other-masks":
        buf = _bmp(_rows(data, 16), 6, 4, 16, 3, masks=struct.pack("<III", 0xF00, 0xF0, 0xF))
    elif kind == "v4-16-bitfields":  # the masks inside the v4 header: cv2 reads the pixels after it as masks
        buf = _bmp(_rows(data, 16), 6, 4, 16, 3, size=108)
    elif kind == "cut-short":
        buf = _bmp(_rows(data, 16), 6, 4, 16)[:-5]
    elif kind == "os2-16":
        buf = _bmp(_rows(data, 16), 6, 4, 16, size=12)
    elif kind == "width-0":
        buf = _bmp(b"", 0, 4, 24)
    else:
        buf = _bmp(b"\xff\xd8\xff\xd9", 6, 4, 0, 4)
    (tmp_path / "a.bmp").write_bytes(buf)
    _refused(tmp_path / "a.bmp", "a.bmp: ", cv2_reads=False)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_written_by_cv2_and_pil_matches_jax_imread(tmp_path, mode):
    arr = np.random.RandomState(4).randint(0, 256, (19, 23, 3)).astype(np.uint8)
    Image.fromarray(arr).convert(mode).save(tmp_path / "pil.bmp")
    _same(tmp_path / "pil.bmp")
    img = np.array(Image.fromarray(arr).convert(mode).convert("RGBA" if mode == "RGBA" else "RGB"))
    cv2.imwrite(str(tmp_path / "cv2.bmp"), img[..., [2, 1, 0, 3][: img.shape[2]]])
    _same(tmp_path / "cv2.bmp")


@pytest.mark.parametrize("kind", ["24", "8", "rle8"])
def test_chip_smoke_bmp_writer_gives_files_cv2_reads(kind):
    """chip_smoke.py's BMP writer: cv2 reads the array written (an RLE8 file
    with encoded and absolute runs and deltas), and so does the port."""
    from fce_yolo_tpu_torch.data.bmp import decode_bmp

    rng = np.random.RandomState(6)
    for h, w in [(1, 1), (5, 3), (40, 57)]:
        rgb = np.full((h, w, 3), 60, np.uint8)
        rgb[h // 3:, w // 4:] = (80, 80, 255)
        rgb[:, :2] = rng.choice([0, 60, 255], (h, min(2, w), 1))
        rgb[::7, ::5] = (255, 80, 80)  # dots: runs of entry 0 that end rows (no delta may reach a row's end)
        buf = C.bmp_bytes(rgb, kind)
        ref = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(ref, rgb[..., ::-1])
        np.testing.assert_array_equal(decode_bmp(buf), ref)


# ------------------------------------------------------------------ PFM
def _pfm(a: np.ndarray, scale: float = -1.0) -> bytes:
    h, w = a.shape[:2]
    head = (b"PF" if a.ndim == 3 else b"Pf") + f"\n{w} {h}\n{scale!r}\n".encode()
    return head + np.ascontiguousarray(a[::-1]).astype(("<" if scale < 0 else ">") + "f4").tobytes()


@pytest.mark.parametrize("scale", [-1.0, 1.0, -2.0, 0.5, 3.0, -0.3])
@pytest.mark.parametrize("gray", [False, True])
def test_pfm_matches_jax_imread(tmp_path, scale, gray):
    """Both byte orders, the scale applied, rows bottom to top, cv2's
    rounding saturate cast (half to even; NaN, infinities and values past
    int32 to 0). cv2 gives a gray file as (H, W): the port copies it into
    three channels (``_same`` compares so)."""
    rng = np.random.RandomState(int(abs(scale) * 10) + gray)
    a = rng.uniform(-20, 300, (7, 9, 3)).astype(np.float32)
    a[0, :6, 0] = [0.5, 1.5, 2.5, np.nan, np.inf, -np.inf]
    a[1, :4, 1] = [1e10, -1e10, 2 ** 31, 254.5]
    a[2] = np.round(a[2])
    path = tmp_path / "a.pfm"
    path.write_bytes(_pfm(a[..., 0] if gray else a, scale))
    if gray:
        assert jax_imread(path).ndim == 2
    _same(path)


@pytest.mark.parametrize("kind", ["zero-scale", "cut-short", "no-line-break", "width-0"])
def test_pfm_cv2_refuses_the_port_raises(tmp_path, kind):
    a = np.zeros((3, 4, 3), np.float32)
    buf = {"zero-scale": _pfm(a, 0.0), "cut-short": _pfm(a)[:-3], "no-line-break": b"PF " + _pfm(a)[3:],
           "width-0": b"PF\n0 3\n-1.0\n"}[kind]
    (tmp_path / "a.pfm").write_bytes(buf)
    if kind == "no-line-break":  # not a PFM signature: nothing reads it
        assert jax_imread(tmp_path / "a.pfm") is None
        with pytest.raises(ValueError, match="a.pfm: not a file of any of these formats"):
            imread(tmp_path / "a.pfm", device="cpu")
        return
    _refused(tmp_path / "a.pfm", "a.pfm: ", cv2_reads=False)


# ------------------------------------------------------------------ MPO, dispatch, WebP
def test_mpo_reads_its_first_frame_as_jax_imread(tmp_path):
    """A two-frame MPO (PIL): a JPEG whose first frame cv2 and the port read."""
    rng = np.random.RandomState(7)
    frames = [Image.fromarray(rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)) for _ in range(2)]
    frames[0].save(tmp_path / "a.mpo", save_all=True, append_images=frames[1:])
    assert (tmp_path / "a.mpo").read_bytes().count(b"\xff\xd8\xff") >= 2
    _same(tmp_path / "a.mpo")


def test_dispatch_is_by_leading_bytes_not_suffix(tmp_path):
    """A PNG named .jpg, a BMP named .png, a TIFF named .bmp, a JPEG named
    .tif and a PFM named .png read as what they are, as cv2 reads them."""
    rgb = np.random.RandomState(8).randint(0, 256, (9, 13, 3)).astype(np.uint8)
    files = {"png.jpg": C.png_bytes(rgb), "bmp.png": C.bmp_bytes(rgb), "tiff.bmp": C.tiff_bytes(rgb, 5, 2),
             "jpeg.tif": C.jpeg_bytes(rgb, 90), "pfm.png": _pfm(rgb.astype(np.float32))}
    for name, buf in files.items():
        (tmp_path / name).write_bytes(buf)
        _same(tmp_path / name)


# ------------------------------------------------------------------ TIFF
@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The card library's TIFF codecs (``csrc/imgcodecs.cu``, host C++ only),
    built here with g++ and typed as ``kernels/build.py`` types them."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host C++ codecs")
    lib = tmp_path_factory.mktemp("imgcodecs") / "libimgcodecs.so"
    res = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib),
                          str(REPO / "fce_yolo_tpu_torch" / "csrc" / "imgcodecs.cu")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-3000:]
    fn = ctypes.CDLL(str(lib)).fce_tiff_decode
    fn.argtypes = kbuild.SIGNATURES["fce_tiff_decode"]
    fn.restype = ctypes.c_int
    return type("Lib", (), {"fce_tiff_decode": staticmethod(fn)})


@pytest.fixture(params=["cpu", "cuda"], ids=["python", "host-c++"])
def device(request, monkeypatch):
    """Each codec path: the plain Python one, and the C++ one the card's library holds."""
    if request.param == "cuda":
        lib = request.getfixturevalue("native")
        monkeypatch.setattr(kbuild, "library", lambda: lib)
    return request.param


TIFF_LAYOUTS = {
    "strips": {}, "one-strip": {"rows_per_strip": 1 << 20}, "row-strips": {"rows_per_strip": 1},
    "tiles": {"tile": (16, 32)}, "tiles-16": {"tile": (16, 16)}, "big-endian": {"big_endian": True},
    "bigtiff": {"bigtiff": True}, "bigtiff-be-tiles": {"bigtiff": True, "big_endian": True, "tile": (32, 16)},
    "planar": {"planar": 2}, "planar-tiles": {"planar": 2, "tile": (16, 32)}, "two-pages": {"pages": 2},
}


@pytest.mark.parametrize("compression,predictor", [(1, 1), (5, 1), (5, 2), (8, 1), (8, 2), (32946, 2), (32773, 1)],
                         ids=["none", "lzw", "lzw-pred", "deflate", "deflate-pred", "adobe-deflate-pred", "packbits"])
@pytest.mark.parametrize("layout", list(TIFF_LAYOUTS))
def test_tiff_layouts_and_compressions_match_jax_imread(tmp_path, device, layout, compression, predictor):
    """RGB at 8 and 16 bits: every layout and compression, on the Python and
    the C++ codecs. Uncompressed 16 x 32 tiles of 8-bit RGB (1536 bytes)
    cv2 refuses, and so does the port (the 16-bit ones, 3072 bytes, read)."""
    rng = np.random.RandomState(len(layout) + compression + predictor)
    for i, (h, w) in enumerate([(1, 1), (19, 37), (40, 33)]):
        for dtype in (np.uint8, np.uint16):
            img = rng.randint(0, np.iinfo(dtype).max + 1, (h, w, 3)).astype(dtype)
            img[h // 2:, : w // 2] = img[0, 0]  # a flat area: long LZW strings and PackBits runs
            path = tmp_path / f"{i}-{dtype.__name__}.tif"
            path.write_bytes(C.tiff_bytes(img, compression, predictor, **TIFF_LAYOUTS[layout]))
            tile = TIFF_LAYOUTS[layout].get("tile")
            per = 1 if TIFF_LAYOUTS[layout].get("planar") == 2 else 3
            if tile and compression == 1 and (tile[0] * tile[1] * per * img.itemsize) % 1024:
                _refused(path, "uncompressed .* tiles", cv2_reads=False, device=device)
            else:
                _same(path, device)


SAMPLE_KINDS = ["gray1", "gray1-white", "gray8", "gray8-white", "gray16", "gray16-white", "graya8", "graya16",
                "rgba8", "rgba8-assoc", "rgba8-unassoc", "rgba16-unassoc", "rgba16", "pal1", "pal8", "pal8-16bit-map",
                "gray8-planar-alpha-unassoc", "gray16-planar-alpha", "rgba8-planar-unassoc"]


@pytest.mark.parametrize("kind", SAMPLE_KINDS)
def test_tiff_samples_match_jax_imread(tmp_path, device, kind):
    """libtiff's RGBA rules: gray maps (MinIsWhite inverted, 16-bit gray's
    high byte), 16-bit colour rounded, unassociated alpha premultiplied,
    palettes with 8- and 16-bit entries, gray in planes read as RGB."""
    rng = np.random.RandomState(SAMPLE_KINDS.index(kind))
    for i, (h, w) in enumerate([(1, 1), (13, 9), (33, 47)]):
        bits = int("".join(ch for ch in kind.split("-")[0] if ch.isdigit()))
        dtype = np.uint16 if bits == 16 else np.uint8
        top = 1 << bits
        spp = 4 if kind.startswith("rgba") else 2 if kind.startswith("graya") or "alpha" in kind else 1
        img = rng.randint(0, top, (h, w, spp)).astype(dtype)
        kw = {"compression": 5, "predictor": 2 if bits >= 8 else 1, "bits": bits}
        if kind.startswith("gray"):
            kw["photometric"] = 0 if kind.endswith("-white") else 1
        if kind.startswith("rgba"):
            kw["photometric"] = 2
        if "unassoc" in kind:
            kw["extra_samples"] = 2
        elif "assoc" in kind:
            kw["extra_samples"] = 1
        elif spp == 2:
            kw["extra_samples"] = 0
        if "planar" in kind:
            kw["planar"] = 2
        if kind.startswith("pal"):
            n = 1 << bits
            pal = rng.randint(0, 65536 if "16bit" in kind else 256, (n, 3))
            kw.update(palette=pal, predictor=1)
        path = tmp_path / f"{i}.tif"
        path.write_bytes(C.tiff_bytes(img, **kw))
        _same(path, device)


@pytest.mark.parametrize("tile", [None, (16, 32)], ids=["strips", "tiles"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_matches_jax_imread(tmp_path, orientation, tile):
    """Tag 274: the whole image turned for strips; for tiles libtiff mirrors
    each tile in its place for orientations 2, 3, 6 and 7, as cv2 reads it."""
    img = np.random.RandomState(orientation).randint(0, 256, (37, 45, 3)).astype(np.uint8)
    path = tmp_path / "a.tif"
    path.write_bytes(C.tiff_bytes(img, 5, 2, tile=tile, rows_per_strip=8, orientation=orientation))
    _same(path)


@pytest.mark.parametrize("mode", ["1", "L", "RGB", "RGBA", "P", "I;16"])
@pytest.mark.parametrize("compression", [None, "tiff_lzw", "tiff_deflate", "packbits"])
def test_tiff_written_by_pil_and_cv2_matches_jax_imread(tmp_path, device, mode, compression):
    rng = np.random.RandomState(len(mode))
    arr = rng.randint(0, 256, (21, 34, 3)).astype(np.uint8)
    im = Image.fromarray(arr).convert(mode) if mode != "I;16" else Image.fromarray(
        rng.randint(0, 65536, (21, 34)).astype(np.uint16))
    im.save(tmp_path / "pil.tif", compression=compression)
    _same(tmp_path / "pil.tif", device)
    cv2.imwrite(str(tmp_path / "cv2.tif"), arr)  # LZW with horizontal differencing
    _same(tmp_path / "cv2.tif", device)


def _dng(preview: np.ndarray, cfa_in_ifd0: bool) -> bytes:
    """A DNG-like TIFF: DNGVersion, and either an RGB preview in IFD0 with a
    CFA image in a SubIFD, or the CFA image in IFD0."""
    cfa = np.random.RandomState(1).randint(0, 4096, (16, 24)).astype(np.uint16)
    dng = {50706: ("B", [1, 4, 0, 0]), 33421: ("H", [2, 2]), 33422: ("B", [0, 1, 1, 2])}
    if cfa_in_ifd0:
        return C.tiff_bytes(cfa, photometric=32803, tags=dng)
    head = C.tiff_bytes(preview, tags={**dng, 254: ("I", [1]), 330: ("I", [0])})
    raw = C.tiff_bytes(cfa, photometric=32803, tags={254: ("I", [0])})
    (ifd,) = struct.unpack_from("<I", raw, 4)
    buf = bytearray(head) + bytes(len(head) % 2)
    base = len(buf)
    # raw's IFD0, its offsets shifted by base, appended; the SubIFDs tag pointed at it
    n = struct.unpack_from("<H", raw, ifd)[0]
    body = bytearray(raw)
    for i in range(n):
        tag, typ, cnt, val = struct.unpack_from("<HHII", raw, ifd + 2 + 12 * i)
        if tag == 273:
            struct.pack_into("<I", body, ifd + 10 + 12 * i, val + base)
    buf += body
    t = T._ifd(bytes(head), struct.unpack_from("<I", head, 4)[0], "<", False, "dng")
    assert 330 in t
    first = struct.unpack_from("<I", head, 4)[0]
    for i in range(struct.unpack_from("<H", head, first)[0]):
        if struct.unpack_from("<H", head, first + 2 + 12 * i)[0] == 330:
            struct.pack_into("<I", buf, first + 10 + 12 * i, base + ifd)
    return bytes(buf)


@pytest.mark.parametrize("cfa_in_ifd0", [False, True], ids=["preview", "cfa"])
def test_dng_reads_ifd0_as_jax_imread(tmp_path, cfa_in_ifd0):
    """A DNG's IFD0: an RGB preview reads as cv2 reads it; raw CFA data in
    IFD0 cv2 returns None for, and the port raises."""
    preview = np.random.RandomState(2).randint(0, 256, (12, 18, 3)).astype(np.uint8)
    path = tmp_path / "a.dng"
    path.write_bytes(_dng(preview, cfa_in_ifd0))
    if cfa_in_ifd0:
        _refused(path, "a.dng: a TIFF with a CFA", cv2_reads=False)
    else:
        np.testing.assert_array_equal(_same(path), preview[..., ::-1])


@pytest.mark.parametrize("kind", ["jpeg", "ccitt4", "ycbcr", "cmyk", "lab", "fill-order-2"])
def test_tiff_cv2_reads_the_port_raises(tmp_path, kind):
    """Files cv2 reads (through libtiff) and the port refuses, naming what."""
    rgb = np.random.RandomState(3).randint(0, 256, (16, 24, 3)).astype(np.uint8)
    im = Image.fromarray(rgb)
    if kind == "jpeg":
        im.save(tmp_path / "a.tif", compression="jpeg")
        match = "JPEG compression"
    elif kind == "ccitt4":
        im.convert("1").save(tmp_path / "a.tif", compression="group4")
        match = "CCITT Group 4"
    elif kind == "ycbcr":
        im.convert("YCbCr").save(tmp_path / "a.tif")
        match = "YCbCr"
    elif kind == "cmyk":
        im.convert("CMYK").save(tmp_path / "a.tif")
        match = "CMYK"
    elif kind == "lab":
        im.convert("LAB").save(tmp_path / "a.tif")
        match = "Lab"
    else:
        (tmp_path / "a.tif").write_bytes(C.tiff_bytes(rgb, tags={266: ("H", [2])}))
        match = "FillOrder 2"
    _refused(tmp_path / "a.tif", f"a.tif: a TIFF with .*{match}", cv2_reads=True)


@pytest.mark.parametrize("kind", ["10-samples", "float32", "gray4", "gray2", "no-photometric", "lzw-cut-short",
                                  "packbits-cut-short", "lzw-corrupt"])
def test_tiff_cv2_refuses_the_port_raises(tmp_path, monkeypatch, device, kind):
    """What cv2 returns None for: a hand-written 10-sample TIFF (as
    coco8-multispectral holds), float samples, 2- and 4-bit gray, no
    PhotometricInterpretation. Data that decodes short or holds a code past
    the LZW table cv2 reads as libtiff leaves it (the rest of the strip zero,
    the differencing not undone): the port gives the same bytes and warns."""
    rng = np.random.RandomState(4)
    if kind == "10-samples":
        buf = C.tiff_bytes(rng.randint(0, 256, (8, 8, 10)).astype(np.uint8), photometric=1, planar=2)
    elif kind == "float32":  # 32-bit samples: two 16-bit halves a sample, each row 8 floats
        halves = rng.uniform(0, 1, (8, 8)).astype("<f4").view("<u2").reshape(8, 8, 2)
        buf = C.tiff_bytes(halves, photometric=1, tags={258: ("H", [32]), 277: ("H", [1]), 339: ("H", [3])})
    elif kind in ("gray4", "gray2"):
        bits = int(kind[-1])
        buf = C.tiff_bytes(rng.randint(0, 1 << bits, (8, 8)).astype(np.uint8), bits=bits)
    elif kind == "no-photometric":
        buf = C.tiff_bytes(rng.randint(0, 256, (8, 8)).astype(np.uint8), photometric=1)
        at = buf.index(struct.pack("<HHI", 262, 3, 1))
        buf = buf[:at] + struct.pack("<HHI", 65000, 3, 1) + buf[at + 8:]  # the tag renamed to a private one
    else:  # the first strip's data: half its bytes, or codes 256, 65, 300 (past the table), 257 at 9 bits
        seen = []
        img = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
        comp, half = (32773 if kind.startswith("packbits") else 5), img[:4].tobytes()[:48]
        data = {"lzw-cut-short": C.tiff_lzw(half), "packbits-cut-short": C.tiff_packbits(half),
                "lzw-corrupt": np.packbits(np.unpackbits(np.array([256, 65, 300, 257], ">u2").view(np.uint8))
                                           .reshape(4, 16)[:, 7:]).tobytes()}[kind]
        real = C.tiff_lzw if comp == 5 else C.tiff_packbits

        def first_cut(raw):  # the first strip's data replaced, the others written as they are
            seen.append(raw)
            return data if len(seen) == 1 else real(raw)

        monkeypatch.setattr(C, "tiff_lzw" if comp == 5 else "tiff_packbits", first_cut)
        buf = C.tiff_bytes(img, comp, 2 if comp == 5 else 1, rows_per_strip=4)
        (tmp_path / "a.tif").write_bytes(buf)
        with pytest.warns(UserWarning, match="a.tif: TIFF data .*reads as zeros"):
            out = _same(tmp_path / "a.tif", device)
        assert (out[:4] == 0).any() and (out[4:] != 0).any()  # only the first strip is cut
        return
    (tmp_path / "a.tif").write_bytes(buf)
    _refused(tmp_path / "a.tif", "a.tif: a TIFF with ", cv2_reads=False, device=device)


def test_chip_smoke_tiff_writer_gives_files_cv2_reads():
    """chip_smoke.py's TIFF writer as phase formats uses it: LZW strips with
    horizontal differencing, PackBits tiles, and 16 bits: cv2 reads the array
    written (16 bits: v * 257 + d, |d| <= 128, which libtiff rounds back to v)."""
    rng = np.random.RandomState(10)
    for h, w in [(1, 1), (17, 33), (64, 80)]:
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for kw in ({"compression": 5, "predictor": 2}, {"compression": 32773, "tile": (32, 32)}):
            buf = C.tiff_bytes(rgb, **kw)
            np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR), rgb[..., ::-1])
        buf = C.tiff_bytes(C.tiff16(rgb, rng), 5, 2)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR), rgb[..., ::-1])


@pytest.mark.parametrize("codec", ["lzw", "packbits"])
def test_tiff_host_codecs_match_python(native, codec):
    """The C++ codecs against the Python ones on seeded data: the same bytes
    and codes (0, or -1 for short data with the rest zero), and never a byte
    written past the room asked for."""
    rng = np.random.RandomState(11)
    enc = C.tiff_lzw if codec == "lzw" else C.tiff_packbits
    dec = T.lzw_decode if codec == "lzw" else T.packbits_decode
    comp = 5 if codec == "lzw" else 32773
    for n in [1, 2, 255, 4096, 70000]:
        data = rng.randint(0, 4 if n > 300 else 256, n).astype(np.uint8).tobytes()
        raw = enc(data)
        for need, cut in [(n, len(raw)), (n // 2, len(raw)), (n, len(raw) // 2)]:
            out = np.full(need + 1, 0xA5, np.uint8)
            err = native.fce_tiff_decode(comp, raw[:cut], cut, out.ctypes.data, need)
            want, code = dec(raw[:cut], need)
            assert err == code and out[:need].tobytes() == want and out[need] == 0xA5, (n, need, cut, err)
