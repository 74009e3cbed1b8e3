"""The port's WebP reader (``data/webp.py``, ``webp_lossless.py``,
``webp_lossy.py`` and the host C++ of ``csrc/webp.cu``) against the JAX
package's ``imread`` (``cv2.imdecode``: cv2 5.0 with its bundled libwebp), on
files written here from seeded numpy arrays by PIL's libwebp 1.6 and by cv2,
and on files built or re-written by hand.

Tolerance: none. Every image equals the JAX package's byte for byte, and an
alpha plane equals the 4th channel of ``cv2.IMREAD_UNCHANGED``. Where cv2
returns None the port raises.

Each case runs twice: through the plain version (``decode_webp_reference``,
Python; images up to 64 x 96) and through the host C++ the card's library
holds (``csrc/webp.cu`` built here with g++ and put in place of
``kbuild.library``; its planes go through ``webp_color_reference``, the
plain version of the card's colour kernel; images up to 480 x 640).

No encoder here writes the simple loop filter, a sharpness, several token
partitions or loop-filter deltas, so ``_rewrite_vp8`` re-emits a cv2-made
file's syntax elements, as the plain parser reads them, with those header
choices changed; cv2's decode of the re-written file is the oracle.
"""

import ctypes
import io
import shutil
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from fce_yolo_tpu.utils.patches import imread as jax_imread
from fce_yolo_tpu_torch.data import webp as W
from fce_yolo_tpu_torch.data import webp_lossy as WL
from fce_yolo_tpu_torch.data.imread import imread
from fce_yolo_tpu_torch.data.jpeg import apply_orientation
from fce_yolo_tpu_torch.kernels import build as kbuild

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------------ readers
@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The card library's WebP host decoder (``csrc/webp.cu`` without its
    CUDA part), built here with g++ and typed as ``kernels/build.py`` types it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host C++ decoder")
    lib = tmp_path_factory.mktemp("webp") / "libwebp.so"
    res = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib),
                          str(REPO / "fce_yolo_tpu_torch" / "csrc" / "webp.cu")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-3000:]
    fn = ctypes.CDLL(str(lib)).fce_webp_planes
    fn.argtypes = kbuild.SIGNATURES["fce_webp_planes"]
    fn.restype = ctypes.c_int
    return type("Lib", (), {"fce_webp_planes": staticmethod(fn)})


def _host_bgra(buf: bytes) -> np.ndarray:
    """The C++ host decode, its planes turned into the image as
    ``fce_webp_decode`` and the kernel turn them (BGRA when libwebp reports
    alpha), oriented."""
    info, _, p = W.webp_decode_host(buf, "x")
    if info[0] == 2:
        a = p["argb"]
        frame = np.stack([a & 0xFF, (a >> 8) & 0xFF, (a >> 16) & 0xFF, a >> 24], axis=-1).astype(np.uint8)
    else:
        alpha = p.get("alpha", np.full(p["y"].shape, 255, np.uint8))
        frame = np.concatenate([W.webp_color_reference(p["y"], p["u"], p["v"]), alpha[..., None]], axis=-1)
    canvas = np.zeros((info[2], info[1], 4), np.uint8)
    canvas[info[6]: info[6] + info[4], info[5]: info[5] + info[3]] = frame
    out = canvas if info[7] else canvas[..., :3]
    o = 1 if info[10] == 0 else W.exif_orientation(buf[info[9]: info[9] + info[10]])
    return apply_orientation(np.ascontiguousarray(out), o)


@pytest.fixture(params=["python", "host-c++"])
def reader(request, monkeypatch):
    """Each decoder: the plain Python one, and the C++ one the card's library holds."""
    if request.param == "python":
        return lambda buf: W.decode_webp_reference(buf, "x")
    lib = request.getfixturevalue("native")
    monkeypatch.setattr(kbuild, "library", lambda: lib)
    return _host_bgra


def _same(tmp_path, buf: bytes, reader, name="a.webp"):
    """The reader's image equals the JAX package's ``imread``, byte for byte."""
    path = tmp_path / name
    path.write_bytes(buf)
    ref = jax_imread(path)
    assert ref is not None, f"cv2 reads nothing of {name}"
    out = reader(buf)[..., :3]
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_array_equal(out, ref)
    return out


def _same_or_refused(tmp_path, buf: bytes, reader, name="a.webp"):
    """Where cv2 reads the file the reader gives its bytes, else it raises."""
    path = tmp_path / name
    path.write_bytes(buf)
    try:
        ref = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:  # cv2 throws past its size limits
        ref = None
    if ref is None:
        with pytest.raises(ValueError):
            reader(buf)
        return
    np.testing.assert_array_equal(reader(buf)[..., :3], ref)


def _unchanged(buf: bytes, reader):
    """BGRA (or BGR) against ``IMREAD_UNCHANGED`` (unoriented files only)."""
    ref = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    out = reader(buf)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_array_equal(out, ref)


# ------------------------------------------------------------------ writers
def _image(rng, h: int, w: int, channels: int = 3, noise: int = 60) -> np.ndarray:
    """Gradients with noise: flat runs, edges and texture in one image."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) * 3 % 256,
                     (xx * 7 + yy * 3) % 256][:channels], axis=-1)
    return (base + rng.randint(0, noise, (h, w, channels))).clip(0, 255).astype(np.uint8)


def _pil(a: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a).save(b, "WEBP", **kw)
    return b.getvalue()


def _chunk(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack("<I", len(data)) + data + (b"\0" if len(data) & 1 else b"")


def _riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _vp8x(flags: int, w: int, h: int) -> bytes:
    return _chunk(b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def _chunks(buf: bytes) -> list[tuple[bytes, bytes]]:
    out, p = [], 12
    while p + 8 <= len(buf):
        n = struct.unpack("<I", buf[p + 4: p + 8])[0]
        out.append((buf[p: p + 4], buf[p + 8: p + 8 + n]))
        p += 8 + n + (n & 1)
    return out


def _anmf(x: int, y: int, w: int, h: int, payload: bytes) -> bytes:
    le = [(x // 2).to_bytes(3, "little"), (y // 2).to_bytes(3, "little"), (w - 1).to_bytes(3, "little"),
          (h - 1).to_bytes(3, "little"), (100).to_bytes(3, "little")]
    return _chunk(b"ANMF", b"".join(le) + b"\0" + payload)


def _exif(orientation: int) -> bytes:
    e = Image.Exif()
    e[0x0112] = orientation
    raw = e.tobytes()
    return raw[6:] if raw.startswith(b"Exif\0\0") else raw


# ------------------------------------------------------------------ lossy, lossless
@pytest.mark.parametrize("method", range(7))
@pytest.mark.parametrize("quality", [0, 5, 25, 50, 75, 90, 100])
def test_lossy_qualities_and_methods_match_jax_imread(tmp_path, reader, quality, method):
    """VP8 at every ``method`` and qualities 0-100 (segments, skip
    probabilities, 16x16 and 4x4 modes, the normal loop filter at the levels
    the encoder picks), smooth and noisy, at even and odd sizes."""
    rng = np.random.RandomState(quality * 7 + method)
    for (h, w), noise in (((37, 53), 60), ((19, 22), 256)):
        _same(tmp_path, _pil(_image(rng, h, w, noise=noise), quality=quality, method=method), reader)


@pytest.mark.parametrize("quality", [0, 50, 100])
@pytest.mark.parametrize("method", range(7))
def test_lossless_methods_match_jax_imread(tmp_path, reader, method, quality):
    """VP8L at every ``method`` (predictor, cross-colour and subtract-green
    transforms, the colour cache, LZ77 copies, meta prefix codes at the
    higher methods and qualities)."""
    rng = np.random.RandomState(100 + method * 3 + quality)
    for (h, w), noise in (((41, 57), 30), ((23, 17), 256)):
        _same(tmp_path, _pil(_image(rng, h, w, noise=noise), lossless=True, quality=quality, method=method), reader)


@pytest.mark.parametrize("colours", [1, 2, 3, 4, 5, 16, 17, 100, 256])
def test_palette_images_match_jax_imread(tmp_path, reader, colours):
    """Colour-indexing with 8, 4, 2 and 1 pixels bundled a byte, and the
    palette entries past the last colour."""
    rng = np.random.RandomState(colours)
    palette = rng.randint(0, 256, (colours, 3)).astype(np.uint8)
    for h, w in ((29, 31), (8, 3)):
        _same(tmp_path, _pil(palette[rng.randint(0, colours, (h, w))], lossless=True), reader)


@pytest.mark.parametrize("writer", ["cv2-1", "cv2-50", "cv2-100", "cv2-lossless"])
def test_cv2_written_files_match_jax_imread(tmp_path, reader, writer):
    rng = np.random.RandomState(len(writer))
    ok, enc = cv2.imencode(".webp", _image(rng, 33, 45), [cv2.IMWRITE_WEBP_QUALITY,
                                                          101 if writer == "cv2-lossless" else int(writer[4:])])
    assert ok
    _same(tmp_path, enc.tobytes(), reader)


@pytest.mark.parametrize("size", [(1, 1), (1, 40), (40, 1), (15, 17), (33, 63), (64, 96)])
@pytest.mark.parametrize("lossless", [False, True])
def test_odd_sizes_match_jax_imread(tmp_path, reader, size, lossless):
    """Sizes off the 16-pixel macroblock grid and odd chroma planes (the
    upsampler's first, last and only rows and columns)."""
    rng = np.random.RandomState(size[0] * 100 + size[1])
    _same(tmp_path, _pil(_image(rng, *size), lossless=lossless, quality=80), reader)


@pytest.mark.parametrize("lossless", [False, True])
def test_480x640_on_the_host_cpp(tmp_path, native, monkeypatch, lossless):
    """A full-size image through the C++ decoder (the plain version is too
    slow at this size)."""
    monkeypatch.setattr(kbuild, "library", lambda: native)
    rng = np.random.RandomState(11 + lossless)
    _same(tmp_path, _pil(_image(rng, 480, 640, noise=90), lossless=lossless, quality=85), _host_bgra)


@pytest.mark.parametrize("lossless", [True, False])
def test_webp_reads_where_it_once_raised(tmp_path, reader, lossless):
    """The two files the reader once refused (a simple file and a VP8X file
    with EXIF orientation 1) now read as cv2 reads them."""
    rgb = np.random.RandomState(9).randint(0, 256, (9, 13, 3)).astype(np.uint8)
    _same(tmp_path, _pil(rgb, lossless=lossless), reader)
    ex = Image.Exif()
    ex[0x0112] = 1
    buf = _pil(rgb, lossless=lossless, exif=ex)
    assert _chunks(buf)[0][0] == b"VP8X"
    _same(tmp_path, buf, reader)


# ------------------------------------------------------------------ alpha
@pytest.mark.parametrize("alpha_method", [0, 1])
@pytest.mark.parametrize("alpha_quality", [0, 30, 100])
def test_lossy_alpha_matches_imread_unchanged(tmp_path, reader, alpha_quality, alpha_method):
    """ALPH raw (``alpha_method`` 0) and VP8L-compressed, level-reduced below
    ``alpha_quality`` 100, with the encoder's chosen filter; the colour
    channels equal ``IMREAD_COLOR``'s."""
    rng = np.random.RandomState(alpha_quality + alpha_method)
    buf = _pil(_image(rng, 37, 53, 4), quality=70, alpha_quality=alpha_quality, alpha_method=alpha_method)
    assert any(tag == b"ALPH" for tag, _ in _chunks(buf))
    _unchanged(buf, reader)
    _same(tmp_path, buf, reader)


@pytest.mark.parametrize("alpha_filter", range(4), ids=["none", "horizontal", "vertical", "gradient"])
@pytest.mark.parametrize("compressed", [False, True])
def test_alpha_unfilters_match_imread_unchanged(tmp_path, reader, alpha_filter, compressed):
    """Each of libwebp's unfilters: on a raw ALPH chunk filtered here, and on
    a compressed one whose filter bits are re-written (cv2 unfilters the
    same decompressed plane the other way)."""
    rng = np.random.RandomState(alpha_filter + 4 * compressed)
    buf = _pil(_image(rng, 21, 26, 4), quality=60, alpha_quality=100 if compressed else 50,
               alpha_method=int(compressed))
    parts = _chunks(buf)
    alph = next(data for tag, data in parts if tag == b"ALPH")
    if compressed:
        alph = bytes([(alph[0] & ~0x0C) | (alpha_filter << 2)]) + alph[1:]
    else:
        a = rng.randint(0, 256, (21, 26)).astype(np.uint8)
        f = a.astype(np.int32)
        if alpha_filter == 1:
            f[:, 1:] -= a[:, :-1]
            f[1:, 0] -= a[:-1, 0]
        elif alpha_filter == 2:
            f[0, 1:] -= a[0, :-1]
            f[1:] -= a[:-1]
        elif alpha_filter == 3:
            f[0, 1:] -= a[0, :-1]
            f[1:, 0] -= a[:-1, 0]
            ai = a.astype(np.int32)
            f[1:, 1:] -= (ai[1:, :-1] + ai[:-1, 1:] - ai[:-1, :-1]).clip(0, 255)
        alph = bytes([alpha_filter << 2]) + (f & 0xFF).astype(np.uint8).tobytes()
    body = b"".join(_chunk(tag, alph if tag == b"ALPH" else data) for tag, data in parts)
    _unchanged(_riff(body), reader)


@pytest.mark.parametrize("exact", [False, True])
def test_lossless_alpha_matches_imread_unchanged(reader, exact):
    rng = np.random.RandomState(20 + exact)
    a = _image(rng, 40, 33, 4)
    a[:10, :10, 3] = 0
    _unchanged(_pil(a, lossless=True, exact=exact), reader)


# ------------------------------------------------------------------ VP8X, EXIF, animation
@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_jax_imread(tmp_path, reader, orientation, lossless):
    rng = np.random.RandomState(orientation)
    ex = Image.Exif()
    ex[0x0112] = orientation
    _same(tmp_path, _pil(_image(rng, 20, 30), lossless=lossless, exif=ex), reader)


def test_icc_and_xmp_are_skipped(tmp_path, reader):
    rng = np.random.RandomState(3)
    buf = _pil(_image(rng, 21, 22), icc_profile=b"\0" * 131, xmp=b"<x:xmpmeta>hello</x:xmpmeta>")
    assert {b"ICCP", b"XMP "} <= {tag for tag, _ in _chunks(buf)}
    _same(tmp_path, buf, reader)


EXIF_CASES = ["after", "before", "before-unflagged", "prefixed", "two", "simple", "unknown-chunks", "anim-flagged",
              "anim-unflagged", "reserved-flag", "anim-chunk-in-still", "order-XX", "order-II-as-MM", "magic-40"]


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("case", EXIF_CASES)
def test_exif_chunk_rules_match_jax_imread(tmp_path, reader, case, lossless):
    """Where cv2 takes the orientation from: the first EXIF chunk, before or
    after the image, of an extended file whose VP8X EXIF flag is set and
    which libwebp's demuxer accepts (not with a reserved flag or an ANIM
    chunk in a still); not a simple file's, not one prefixed
    ``Exif\\0\\0``. cv2's Exif reader takes any byte order but ``II`` as
    big-endian and wants the magic 42."""
    rng = np.random.RandomState(len(case))
    tag = b"VP8L" if lossless else b"VP8 "
    image = _chunk(tag, _chunks(_pil(_image(rng, 20, 30), lossless=lossless))[0][1])
    six, eight = _chunk(b"EXIF", _exif(6)), _chunk(b"EXIF", _exif(8))
    anim = _chunk(b"ANIM", struct.pack("<IH", 0xFF0000FF, 0)) + _anmf(8, 12, 30, 20, image)
    big = _exif(6).startswith(b"MM")
    swapped = b"II" + _exif(6)[2:] if big else b"MM" + _exif(6)[2:]
    body = {"after": _vp8x(8, 30, 20) + image + six, "before": _vp8x(8, 30, 20) + six + image,
            "before-unflagged": _vp8x(0, 30, 20) + six + image, "reserved-flag": _vp8x(9, 30, 20) + image + six,
            "anim-chunk-in-still": _vp8x(8, 30, 20) + _chunk(b"ANIM", bytes(6)) + image + six,
            "order-XX": _vp8x(8, 30, 20) + image + _chunk(b"EXIF", b"XX" + _exif(6)[2:] if big else _exif(6)),
            "order-II-as-MM": _vp8x(8, 30, 20) + image + _chunk(b"EXIF", swapped),
            "magic-40": _vp8x(8, 30, 20) + image + _chunk(b"EXIF", _exif(6)[:3] + bytes([40]) + _exif(6)[4:]
                                                          if big else _exif(6)[:2] + bytes([40]) + _exif(6)[3:]),
            "prefixed": _vp8x(8, 30, 20) + image + _chunk(b"EXIF", b"Exif\0\0" + _exif(6)),
            "two": _vp8x(8, 30, 20) + image + eight + six, "simple": image + six,
            "unknown-chunks": _vp8x(0, 30, 20) + _chunk(b"ZZZZ", b"abc") + image + six + _chunk(b"QQQQ", b"12"),
            "anim-flagged": _vp8x(2 | 8, 50, 40) + anim + six, "anim-unflagged": _vp8x(2, 50, 40) + anim + six}[case]
    _same(tmp_path, _riff(body), reader)


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
def test_animation_first_frame_matches_jax_imread(tmp_path, reader, kind):
    """PIL's animations: cv2 gives the first frame (max |delta| against the
    later frames is large, so a wrong frame shows)."""
    rng = np.random.RandomState(len(kind))
    frames = [Image.fromarray(_image(rng, 30, 40, 4 if kind == "alpha" else 3, noise=256)) for _ in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:], lossless=kind == "lossless", duration=50)
    buf = b.getvalue()
    assert [tag for tag, _ in _chunks(buf)].count(b"ANMF") == 3
    _same(tmp_path, buf, reader)
    _unchanged(buf, reader)


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("case", ["offset", "offset-alpha-flag", "outside", "no-anim-chunk", "bad-flag",
                                  "anmf-size-differs", "canvas-over-2^20-wide"])
def test_hand_built_animation_matches_jax_imread(tmp_path, reader, case, lossless):
    """A first frame smaller than its canvas at an offset: placed on a canvas
    of zeros, as cv2's animation decode gives it; frames outside the canvas,
    ANMF before ANIM and reserved flags refused, as the demuxer refuses them,
    and a canvas past cv2's 2^20-pixel side."""
    rng = np.random.RandomState(len(case) + lossless)
    tag = b"VP8L" if lossless else b"VP8 "
    image = _chunk(tag, _chunks(_pil(_image(rng, 20, 30, noise=256), lossless=lossless))[0][1])
    anim = _chunk(b"ANIM", struct.pack("<IH", 0xFF0000FF, 0))
    body = {"offset": _vp8x(2, 50, 40) + anim + _anmf(8, 12, 30, 20, image) + _anmf(0, 0, 30, 20, image),
            "offset-alpha-flag": _vp8x(2 | 0x10, 50, 40) + anim + _anmf(8, 12, 30, 20, image),
            "outside": _vp8x(2, 50, 40) + anim + _anmf(30, 30, 30, 20, image),
            "no-anim-chunk": _vp8x(2, 50, 40) + _anmf(8, 12, 30, 20, image),
            "bad-flag": _vp8x(2 | 1, 50, 40) + anim + _anmf(8, 12, 30, 20, image),
            "anmf-size-differs": _vp8x(2, 50, 40) + anim + _anmf(8, 12, 33, 21, image),
            "canvas-over-2^20-wide": _vp8x(2, (1 << 20) + 2, 40) + anim + _anmf(8, 12, 30, 20, image)}[case]
    buf = _riff(body)
    _same_or_refused(tmp_path, buf, reader)
    if case == "offset":
        out = reader(buf)
        assert out.shape == (40, 50, 3) and not out[:12].any() and not out[:, :8].any() and out[12:32, 8:38].any()


# ------------------------------------------------------------------ corrupt files
@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha", "lossless-alpha", "animation"])
def test_corrupt_or_truncated_files_match_or_raise(tmp_path, reader, kind):
    """Cut short at every kind of boundary, a RIFF size off either way,
    trailing bytes, and 60 files with 1-2 bits flipped: where cv2 reads
    the file the reader gives its bytes (a flip inside the data often still
    decodes), where cv2 returns None the reader raises."""
    rng = np.random.RandomState(len(kind))
    if kind == "animation":
        frames = [Image.fromarray(_image(rng, 24, 30)) for _ in range(2)]
        b = io.BytesIO()
        frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:], duration=50)
        buf = b.getvalue()
    else:
        buf = _pil(_image(rng, 37, 53, 4 if "alpha" in kind else 3), lossless=kind.startswith("lossless"),
                   quality=70, alpha_quality=50)
    n = len(buf)
    variants = [buf[:cut] for cut in sorted({31, 32, 33, 40, 50, n // 4, n // 2, 3 * n // 4, n - 8, n - 1})]
    variants += [buf + b"\0" * 7]
    for delta in (100, -10):
        bb = bytearray(buf)
        bb[4:8] = struct.pack("<I", n - 8 + delta)
        variants.append(bytes(bb))
    for _ in range(60):
        bb = bytearray(buf)
        for _ in range(rng.randint(1, 3)):
            bb[12 + rng.randint(0, n - 12)] ^= 1 << rng.randint(8)
        variants.append(bytes(bb))
    for i, v in enumerate(variants):
        _same_or_refused(tmp_path, v, reader, name=f"v{i}.webp")


CORRUPT_LOSSY = [(118, 0xFF), (132, 0x80)]  # bytes of one lossy file's token data that need both rules below


def _corrupt_lossy(pos: int, val: int) -> bytes:
    rng = np.random.RandomState(31)
    bb = bytearray(_pil(_image(rng, 29, 41, noise=120), quality=70))
    assert len(bb) == 622, "the encoder wrote another file"
    bb[pos] = val
    return bytes(bb)


@pytest.mark.parametrize("pos,val", CORRUPT_LOSSY)
def test_corrupt_lossy_data_decodes_as_cv2_does(tmp_path, reader, pos, val):
    """Token data broken so that libwebp's decoder leaves its valid states:
    its 64-bit value wraps at the 56-bit loads of its x86-64 build, and the
    out-of-range coefficients that follow wrap in the 16-bit lanes of its
    SSE2 inverse DCT. cv2 reads such a file, and the port gives its bytes."""
    _same(tmp_path, _corrupt_lossy(pos, val), reader)


@pytest.mark.parametrize("pos,val", CORRUPT_LOSSY)
def test_corrupt_lossy_cases_need_the_sse2_transform(pos, val, monkeypatch):
    """The cases above are not read so by the C inverse DCT: they hold the
    SSE2 emulation to account."""
    buf = _corrupt_lossy(pos, val)
    good = W.decode_webp_reference(buf)
    transform = WL._transform
    monkeypatch.setattr(WL, "_transform", lambda *a: transform(*a[:4], False))
    assert not np.array_equal(W.decode_webp_reference(buf), good)


# ------------------------------------------------------------------ the VP8 re-writer
class _BoolWriter:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _encode(decisions) -> bytes:
    w = _BoolWriter()
    for prob, bit in decisions:
        w.put(prob, bit)
    return w.finish()


def _bits(v: int, n: int) -> list[tuple[int, int]]:
    return [(128, (v >> (n - 1 - i)) & 1) for i in range(n)]


def _signed(v: int, n: int) -> list[tuple[int, int]]:
    return _bits(abs(v), n) + [(128, int(v < 0))]


def _log_vp8(vp8: bytes, monkeypatch):
    """Decode with the plain parser, logging every boolean decision: the
    readers' logs, the filter header's span in partition 0 and where each
    macroblock's tokens start."""
    readers, marks = [], {}

    class Logged(WL._BoolReader):
        def __init__(self, *a):
            super().__init__(*a)
            self.log = []
            readers.append(self)

        def get(self, prob):
            bit = super().get(prob)
            self.log.append((prob, bit))
            return bit

        def signed(self, v):
            out = super().signed(v)
            self.log.append((128, int(out < 0)))
            return out

    filter_header, decode_mb = WL._filter_header, WL._decode_mb

    def logged_filter(br, hd):
        marks["filter"] = [len(br.log)]
        filter_header(br, hd)
        marks["filter"].append(len(br.log))
        marks["header"] = hd

    def logged_mb(br, hd, mb_x, block):
        marks.setdefault("mbs", []).append(len(br.log))
        decode_mb(br, hd, mb_x, block)

    with monkeypatch.context() as m:
        m.setattr(WL, "_BoolReader", Logged)
        m.setattr(WL, "_filter_header", logged_filter)
        m.setattr(WL, "_decode_mb", logged_mb)
        WL.decode_vp8(vp8)
    assert len(readers) == 2, "the source file has one token partition"
    return readers, marks


def _rewrite_vp8(vp8: bytes, monkeypatch, simple=None, level=None, sharpness=None, parts=1, ref0=None,
                 mode0=None) -> bytes:
    """The same frame with the filter header and the token partitions
    changed: partition 0 re-emitted with a new filter header and partition
    count, the tokens dealt out by macroblock row."""
    (p0, tok), marks = _log_vp8(vp8, monkeypatch)
    hd = marks["header"]
    simple = hd.simple if simple is None else simple
    level = hd.level if level is None else level
    sharpness = hd.sharpness if sharpness is None else sharpness
    deltas = ref0 is not None or mode0 is not None
    fh = [(128, simple)] + _bits(level, 6) + _bits(sharpness, 3) + [(128, int(deltas))]
    if deltas:
        fh += [(128, 1)]
        for v in ([ref0 or 0, 5, -7, 0], [mode0 or 0, -3, 9, 2]):
            for d in v:
                fh += [(128, 1)] + _signed(d, 6)
    f0, f1 = marks["filter"]
    first = _encode(p0.log[:f0] + fh + _bits(parts.bit_length() - 1, 2) + p0.log[f1 + 2:])
    mbs = marks["mbs"] + [len(tok.log)]
    rows = [tok.log[mbs[r * hd.mb_w]: mbs[(r + 1) * hd.mb_w]] for r in range(hd.mb_h)]
    streams = [_encode([d for r in range(k, hd.mb_h, parts) for d in rows[r]]) for k in range(parts)]
    tag = (len(first) << 5) | (1 << 4) | (((vp8[0] | vp8[1] << 8) >> 1) & 7) << 1
    sizes = b"".join(len(s).to_bytes(3, "little") for s in streams[:-1])
    return tag.to_bytes(3, "little") + vp8[3:10] + first + sizes + b"".join(streams)


REWRITES = {
    "simple": dict(simple=1), "simple-level-63": dict(simple=1, level=63), "normal-level-1": dict(level=1),
    "level-0": dict(level=0), "partitions-2": dict(parts=2), "partitions-4": dict(parts=4),
    "partitions-8": dict(parts=8), "deltas": dict(ref0=12, mode0=-9), "deltas-negative": dict(ref0=-20, mode0=30),
    "simple-sharp-5-partitions-4-deltas": dict(simple=1, sharpness=5, parts=4, ref0=3, mode0=6),
    **{f"sharpness-{s}": dict(sharpness=s) for s in range(1, 8)},
}


@pytest.mark.parametrize("case", list(REWRITES))
def test_rewritten_vp8_headers_match_jax_imread(tmp_path, reader, monkeypatch, case):
    """The simple filter, sharpness 1-7, 2/4/8 token partitions and
    reference/mode loop-filter deltas, which no encoder here writes, on a
    cv2-made frame re-written with those header choices."""
    rng = np.random.RandomState(len(case))
    ok, enc = cv2.imencode(".webp", _image(rng, 67, 45, noise=120), [cv2.IMWRITE_WEBP_QUALITY, 60])
    vp8 = _chunks(enc.tobytes())[0][1]
    kw = REWRITES[case]
    new = _rewrite_vp8(vp8, monkeypatch, **kw)
    hd, _, parts = WL._parse_header(new, "re-written")
    assert len(parts) == kw.get("parts", 1)
    assert hd.filter_type == (0 if kw.get("level", hd.level) == 0 else (1 if kw.get("simple") else 2))
    assert hd.sharpness == kw.get("sharpness", hd.sharpness)
    assert hd.use_lf_delta == ("ref0" in kw)
    _same(tmp_path, _riff(_chunk(b"VP8 ", new)), reader)


def test_rewriter_reproduces_its_source(monkeypatch):
    """With no change the re-written frame decodes to the source's planes."""
    rng = np.random.RandomState(1)
    ok, enc = cv2.imencode(".webp", _image(rng, 40, 50), [cv2.IMWRITE_WEBP_QUALITY, 80])
    vp8 = _chunks(enc.tobytes())[0][1]
    for a, b in zip(WL.decode_vp8(vp8), WL.decode_vp8(_rewrite_vp8(vp8, monkeypatch))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ imread, wrappers
def test_imread_dispatches_webp_by_leading_bytes(tmp_path):
    """``imread`` on the CPU reads WebP whatever the suffix, and equals the
    JAX package's; ``decode_webp`` and ``webp_color`` on CPU data take the
    plain versions."""
    rng = np.random.RandomState(2)
    buf = _pil(_image(rng, 30, 41), quality=80)
    for name in ("a.webp", "a.jpg"):
        (tmp_path / name).write_bytes(buf)
        np.testing.assert_array_equal(imread(tmp_path / name, device="cpu"), jax_imread(tmp_path / name))
    np.testing.assert_array_equal(W.decode_webp(buf, "a", "cpu"), jax_imread(tmp_path / "a.webp"))
    img = W.webp_image_reference(buf)
    info = np.zeros(W.INFO_LEN, np.int32)
    info[[0, 3, 4]] = 1, img.width, img.height
    planes = torch.from_numpy(np.concatenate([img.y.ravel(), img.u.ravel(), img.v.ravel()]))
    with torch.inference_mode():
        out = W.webp_color(planes, info)
    np.testing.assert_array_equal(out.numpy(), jax_imread(tmp_path / "a.webp"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_imread_on_cuda_without_cuda_raises(tmp_path):
    (tmp_path / "a.webp").write_bytes(_pil(np.zeros((8, 8, 3), np.uint8)))
    with pytest.raises(RuntimeError, match="needs CUDA"):
        imread(tmp_path / "a.webp")
