"""The JPEG decoder's and writer's own source (``csrc/jpeg.cu``) run on the
CPU: g++ compiles it against the CUDA stand-in in ``tests/cuda_emu`` (one
thread per CUDA thread, ``__syncthreads`` as a barrier, copies as memcpy),
with the launches turned into ``emu_launch``. ``jpeg_main.cpp`` calls
``fce_jpeg_coefficients`` and ``fce_jpeg_decode``, ``jpeg_enc_main.cpp``
``fce_jpeg_fdct`` and ``fce_jpeg_entropy``, each first with too little room
where it takes one (it must ask for more and write nothing), and checks
that no buffer is written past its room.

Tolerance: none. The C host decoder's coefficients equal the Python
decoder's (``entropy_decode``), its info record equals ``parse_jpeg``'s
header, and the pixels of the two kernels equal the plain path
(``jpeg_idct_reference`` + ``jpeg_color_reference``), on the matrix of
``test_torch_jpeg.py`` at small sizes; the files it refuses return the
codes the wrapper names. The writer's kernel gives ``jpeg_fdct_reference``'s
coefficients and its host stage the plain writer's file, which is cv2's.
"""

import re
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from cuda_emu.emulate import CSRC, build, emulated
from fce_yolo_tpu_torch.data import jpeg as J
from test_torch_jpeg import _chip_smoke, _exif, _image, _progressive, _refused, _segment, _without_app0, _write


def _emulated_source() -> str:
    src = emulated((CSRC / "jpeg.cu").read_text(), {})
    return re.sub(r"(\w+)<<<(\w+), (\w+), (\w+), (\w+)>>>\(", r"emu_launch(\2, \3, \4, \1, ", src)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    return build(tmp_path_factory.mktemp("jpeg_emu"), "jpeg_main.cpp", "jpeg", _emulated_source())


def _run(exe: Path, buf: bytes):
    d = exe.parent
    (d / "in.jpg").write_bytes(buf)
    res = subprocess.run([str(exe), *(str(d / f) for f in ("in.jpg", "info.bin", "coef.bin", "qt.bin", "bgr.bin"))],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        return res, None
    info = np.fromfile(d / "info.bin", np.int32)
    return res, (info, np.fromfile(d / "coef.bin", np.int16), np.fromfile(d / "qt.bin", np.int32).reshape(3, 64),
                 np.fromfile(d / "bgr.bin", np.uint8))


def _assert_matches_plain(exe: Path, buf: bytes) -> np.ndarray:
    res, out = _run(exe, buf)
    assert res.returncode == 0, res.stderr[-2000:]
    info, coef, qt, bgr = out
    hdr = J.parse_jpeg(buf)
    planes = J.entropy_decode(hdr)
    assert list(info[:7]) == [hdr.width, hdr.height, len(hdr.comps), hdr.color, hdr.orientation, hdr.hmax, hdr.vmax]
    off = 0
    for c, comp in enumerate(hdr.comps):
        assert list(info[16 + 8 * c: 24 + 8 * c]) == [comp.h, comp.v, comp.bw, comp.bh, comp.width, comp.height, off,
                                                     comp.tq]
        np.testing.assert_array_equal(qt[c], hdr.qt[comp.tq])
        off += comp.bw * comp.bh * 64
    np.testing.assert_array_equal(coef, np.concatenate([p.ravel() for p in planes]))
    pix = J.jpeg_color_reference([J.jpeg_idct_reference(p, hdr.qt[c.tq]) for p, c in zip(planes, hdr.comps)], hdr)
    np.testing.assert_array_equal(bgr.reshape(pix.shape), pix)
    # the wrappers' plain branches (CPU tensors) on the C decoder's record give the same pixels
    planes_cpu = J.jpeg_idct(torch.from_numpy(coef), qt, info)
    np.testing.assert_array_equal(J.jpeg_color(planes_cpu, info).numpy(), pix)
    return info


@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444", "gray"])
@pytest.mark.parametrize("h,w,quality,restart", [(1, 1, 30, 0), (1, 17, 75, 1), (15, 1, 100, 5), (3, 4, 90, 0),
                                                 (33, 47, 95, 5), (33, 47, 50, 0)])
def test_emulated_decoder_matches_plain(emulator, tmp_path, sampling, h, w, quality, restart):
    img = _image(np.random.RandomState(h * w + quality), h, w)
    _assert_matches_plain(emulator, _write(tmp_path / "a.jpg", img, sampling, quality, restart).read_bytes())


@pytest.mark.parametrize("optimize", [False, True])
def test_emulated_decoder_at_loader_size(emulator, tmp_path, optimize):
    """120 x 160 4:2:0 q95 (the tiny dataset's size), Annex K and optimized tables."""
    img = _image(np.random.RandomState(1), 120, 160)
    _assert_matches_plain(emulator, _write(tmp_path / "a.jpg", img, "420", 95, 0, optimize).read_bytes())


@pytest.mark.parametrize("kind", ["gray-22", "gray-41", "separate-420", "separate-411-restart"])
def test_emulated_decoder_non_interleaved_scans(emulator, tmp_path, kind):
    """Scans of one component whose sampling factors are above 1x1: a gray
    file with its SOF patched to 2x2 or 4x1, and 4:2:0 / 4:1:1 files with a
    scan per component (chip_smoke.py's writer). Each MCU is one block of
    the component's own grid, placed in the MCU-padded plane."""
    rng = np.random.RandomState(len(kind))
    for h, w in [(1, 1), (17, 40), (64, 64)]:
        if kind.startswith("gray"):
            buf = bytearray(_write(tmp_path / "a.jpg", _image(rng, h, w), "gray", 90).read_bytes())
            buf[buf.index(b"\xff\xc0") + 11] = {"gray-22": 0x22, "gray-41": 0x41}[kind]
            buf = bytes(buf)
        else:
            buf = _chip_smoke().jpeg_bytes(_image(rng, h, w), 90, kind.split("-")[1], 5 if "restart" in kind else 0,
                                           interleave=False)
        _assert_matches_plain(emulator, buf)
        np.testing.assert_array_equal(J.decode_jpeg_reference(buf), cv2.imdecode(np.frombuffer(buf, np.uint8),
                                                                                 cv2.IMREAD_COLOR))


@pytest.mark.parametrize("kind", ["adobe-rgb", "orientation-6", "cut-short"])
def test_emulated_decoder_headers_and_cut_data(emulator, tmp_path, kind):
    """Adobe transform 0 (RGB), an EXIF orientation carried in the record,
    and data cut short by EOI: zero fill, flagged in info[8]."""
    buf = _write(tmp_path / "a.jpg", _image(np.random.RandomState(2), 40, 56), "444" if kind == "adobe-rgb" else "420",
                 90, 2).read_bytes()
    if kind == "adobe-rgb":
        buf = buf[:2] + _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)) + _without_app0(buf)[2:]
    elif kind == "orientation-6":
        buf = buf[:2] + _exif(6, b"MM") + buf[2:]
    else:
        start = buf.index(b"\xff\xda")
        buf = buf[: start + (len(buf) - start) // 2] + b"\xff\xd9"
    info = _assert_matches_plain(emulator, buf)
    assert info[3] == (J.COLOR_RGB if kind == "adobe-rgb" else J.COLOR_YCC)
    assert info[4] == (6 if kind == "orientation-6" else 1)
    assert info[8] == (kind == "cut-short")
    if kind == "cut-short":
        ref = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(J.decode_jpeg_reference(buf), ref)


@pytest.mark.parametrize("kind,code", [("progressive", -2), ("arithmetic", -3), ("lossless", -5), ("12-bit", -4),
                                       ("cmyk", -6), ("no-eoi", -8), ("too-large", -12), ("breaks-off", -15),
                                       ("bad-scan", -14)])
def test_emulated_decoder_refuses(emulator, tmp_path, kind, code):
    """The C parser's codes for the files the port refuses (data/jpeg.py
    ``_ERRORS`` turns each into a ValueError naming the file); "progressive"
    is one whose scans leave coefficients unfinished."""
    if kind in ("breaks-off", "bad-scan"):
        buf = _progressive(_image(np.random.RandomState(13), 48, 64), "420", 90)
        sos = [i for i in range(len(buf)) if buf.startswith(b"\xff\xda", i)]
        if kind == "breaks-off":
            buf = buf[: sos[-1] + (len(buf) - sos[-1]) // 2] + b"\xff\xd9"
        else:
            at = sos[1] + 5 + 2 * buf[sos[1] + 4]
            buf = buf[:at] + b"\x00" + buf[at + 1:]
    elif kind == "no-eoi":
        buf = _write(tmp_path / "a.jpg", _image(np.random.RandomState(3), 16, 16)).read_bytes()[:-2]
    else:
        buf = _refused(tmp_path, kind).read_bytes()
    res, _ = _run(emulator, buf)
    assert res.returncode == 3 and f"fce_jpeg_coefficients {code}" in res.stderr
    with pytest.raises(ValueError, match=r"x\.jpg: .*the port reads baseline"):
        J._check(code, "x.jpg", "fce_jpeg_coefficients")


@pytest.mark.parametrize("sampling", ["420", "444", "gray"])
def test_emulated_decoder_without_huffman_tables(emulator, tmp_path, sampling):
    """Motion-JPEG frames with no DHT: the C decoder takes the Annex K.3
    tables for slots 0 and 1 as the plain path does (equal coefficients and
    pixels, and cv2's bytes); a scan that names slot 2 returns -10."""
    buf = _chip_smoke().strip_dht(_write(tmp_path / "a.jpg", _image(np.random.RandomState(9), 33, 47), sampling, 90,
                                         2).read_bytes())
    _assert_matches_plain(emulator, buf)
    np.testing.assert_array_equal(J.decode_jpeg_reference(buf), cv2.imdecode(np.frombuffer(buf, np.uint8),
                                                                             cv2.IMREAD_COLOR))
    sos = buf.index(b"\xff\xda")
    res, _ = _run(emulator, buf[:sos + 6] + b"\x22" + buf[sos + 7:])
    assert res.returncode == 3 and "fce_jpeg_coefficients -10" in res.stderr


# ------------------------------------------------------------------ the writer
@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    return build(tmp_path_factory.mktemp("jpeg_enc_emu"), "jpeg_enc_main.cpp", "jpeg", _emulated_source())


@pytest.mark.parametrize("quality", [95, 50])
@pytest.mark.parametrize("h,w,c", [(1, 1, 3), (8, 8, 3), (17, 9, 3), (37, 53, 3), (33, 47, 1), (64, 80, 3),
                                   (120, 160, 3)])
def test_emulated_writer_matches_plain(encoder, tmp_path, h, w, c, quality):
    """``jpeg_fdct_kernel`` (through ``fce_jpeg_fdct``) gives
    ``jpeg_fdct_reference``'s coefficients, dummy blocks of the last MCU
    column and row included, and ``fce_jpeg_entropy`` the plain writer's
    file, which is cv2's; it first asks for room without writing."""
    from fce_yolo_tpu_torch.data import jpeg_write as JW

    rng = np.random.RandomState(h * w + quality)
    img = _image(rng, h, w)
    img = img if c == 3 else img[..., 1].copy()
    (tmp_path / "in.raw").write_bytes(img.tobytes())
    res = subprocess.run([str(encoder), str(tmp_path / "in.raw"), str(h), str(w), str(c), str(quality),
                          str(tmp_path / "coef.bin"), str(tmp_path / "out.jpg")],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    np.testing.assert_array_equal(np.fromfile(tmp_path / "coef.bin", np.int16), JW.jpeg_fdct_reference(img, quality))
    buf = (tmp_path / "out.jpg").read_bytes()
    assert buf == JW.encode_jpeg_reference(img, quality)
    assert buf == cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()


@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444", "gray"])
@pytest.mark.parametrize("h,w,quality,restart", [(1, 1, 30, 0), (1, 17, 75, 1), (15, 1, 100, 5), (33, 47, 95, 5),
                                                 (33, 47, 50, 0), (64, 64, 90, 0)])
def test_emulated_decoder_progressive_matches_plain(emulator, tmp_path, sampling, h, w, quality, restart):
    """Progressive files (cv2's: DC and AC successive approximation, EOB
    runs, a Huffman table per scan) through the C host decoder: the same
    coefficients as the Python decoder, no tolerance, and the kernels' pixels
    as the plain path's."""
    img = _image(np.random.RandomState(h * w + quality), h, w)
    _assert_matches_plain(emulator, _progressive(img, sampling, quality, restart))


@pytest.mark.parametrize("kind", ["chip-smoke-420", "chip-smoke-gray", "pil-optimised-exif"])
def test_emulated_decoder_progressive_writers(emulator, tmp_path, kind):
    """chip_smoke.py's progressive writer (restart interval 3, Annex K DC
    tables and one AC table redefined before every AC scan) and PIL's with
    optimised tables and an EXIF orientation."""
    rng = np.random.RandomState(len(kind))
    img = _image(rng, 41, 67)
    if kind.startswith("chip-smoke"):
        buf = _chip_smoke().jpeg_bytes(img[..., 0] if kind.endswith("gray") else img, 90, "420", 3, progressive=True)
    else:
        import io

        from PIL import Image

        b = io.BytesIO()
        ex = Image.Exif()
        ex[0x0112] = 6
        Image.fromarray(img).save(b, "JPEG", quality=85, progressive=True, optimize=True, exif=ex)
        buf = b.getvalue()
    info = _assert_matches_plain(emulator, buf)
    assert info[4] == (6 if kind.startswith("pil") else 1)
