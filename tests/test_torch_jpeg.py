"""The port's baseline JPEG reader (``data/jpeg.py``, plain path) against
the JAX package's ``imread`` (``cv2.imdecode``, libjpeg-turbo) on files
``cv2.imencode`` writes here from a seed, and on files built by hand from
them (Adobe RGB, EXIF orientation, data cut short, refused formats).

Tolerance: none. Every image equals the JAX package's byte for byte.

Progressive files (SOF2) decode bit-equal too: cv2's and PIL's (optimised
Huffman tables redefined between scans), and chip_smoke.py's writer's
(libjpeg's simple progression over a baseline file's coefficients).

Where the port departs from the JAX package on purpose, a test says so:
a file cut short with no EOI marker, a progressive file whose scans leave
coefficients unfinished (libjpeg smooths its blocks), and an arithmetic,
12-bit, lossless or CMYK file, raise ``ValueError`` naming the file (cv2
returns None for the first and decodes the others). A frame over cv2's
2^30 pixels raises where cv2 returns None.
"""

import struct
import sys
import warnings
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from fce_yolo_tpu.utils.patches import imread as jax_imread
from fce_yolo_tpu_torch.data import jpeg as J
from fce_yolo_tpu_torch.data.imread import imread

REPO = Path(__file__).resolve().parent.parent
SIZES = [(1, 1), (1, 17), (15, 1), (3, 4), (33, 47), (120, 160)]
SAMPLING = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}") for s in ("411", "420", "422", "440", "444")}


def _image(rng, h, w):
    """Noise over a smooth ramp, with a flat patch: every coefficient size and long zero runs."""
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 9 % 256], 2)
    img = np.clip(img + rng.randint(-40, 41, img.shape), 0, 255).astype(np.uint8)
    img[h // 2:, : w // 2] = (30, 200, 90)
    return img


def _write(path, img, sampling="420", quality=95, restart=0, optimize=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
    if sampling == "gray":
        img = img[..., 0]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    Path(path).write_bytes(buf.tobytes())
    return path


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def _assert_equal_to_jax(path):
    ref = jax_imread(path)
    out = imread(path, device="cpu")
    assert ref is not None
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("quality", [30, 50, 75, 90, 95, 100])
@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444", "gray"])
def test_jpeg_matches_jax_imread(tmp_path, sampling, quality):
    rng = np.random.RandomState(quality + len(sampling))
    for h, w in SIZES:
        _assert_equal_to_jax(_write(tmp_path / f"{h}x{w}.jpg", _image(rng, h, w), sampling, quality))


@pytest.mark.parametrize("optimize", [False, True], ids=["annex-k", "optimized"])
@pytest.mark.parametrize("restart", [0, 1, 5])
@pytest.mark.parametrize("sampling", ["420", "422", "gray"])
def test_jpeg_restart_and_optimized_tables_match_jax_imread(tmp_path, sampling, restart, optimize):
    rng = np.random.RandomState(restart)
    for h, w in SIZES[3:]:
        _assert_equal_to_jax(_write(tmp_path / f"{h}x{w}.jpg", _image(rng, h, w), sampling, 85, restart, optimize))


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _exif(orientation: int, order: bytes) -> bytes:
    """An APP1 Exif segment whose IFD0 holds an unrelated tag, then the orientation."""
    e = "<" if order == b"II" else ">"
    ifd = struct.pack(e + "H", 2) + struct.pack(e + "HHII", 0x010F, 2, 4, 0x41424300)
    ifd += struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    return _segment(0xE1, b"Exif\x00\x00" + order + struct.pack(e + "HI", 42, 8) + ifd)


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["little-endian", "big-endian"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_matches_jax_imread(tmp_path, orientation, order):
    path = _write(tmp_path / "a.jpg", _image(np.random.RandomState(orientation), 32, 48), "420", 90)
    buf = path.read_bytes()
    path.write_bytes(buf[:2] + _exif(orientation, order) + buf[2:])
    _assert_equal_to_jax(path)
    assert J.decode_jpeg_reference(path.read_bytes()).shape == ((48, 32, 3) if orientation >= 5 else (32, 48, 3))


def _without_app0(buf: bytes) -> bytes:
    assert buf[2:4] == b"\xff\xe0"
    return buf[:2] + buf[4 + struct.unpack(">H", buf[4:6])[0]:]


@pytest.mark.parametrize("kind", ["adobe-transform-0", "rgb-component-ids", "adobe-0-beside-jfif", "adobe-transform-1"])
def test_jpeg_colour_space_rules_match_jax_imread(tmp_path, kind):
    """libjpeg's colour rules for 3 components: JFIF means YCbCr, else an
    Adobe segment's transform (0: RGB), else component ids 'R', 'G', 'B'
    mean RGB. Files built by hand from a 4:4:4 one, so the same data reads
    as RGB or YCbCr."""
    buf = _write(tmp_path / "src.jpg", _image(np.random.RandomState(7), 24, 40), "444", 92).read_bytes()
    adobe = _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0 if kind != "adobe-transform-1" else 1))
    if kind == "adobe-0-beside-jfif":
        buf = buf[:2] + adobe + buf[2:]
    elif kind == "rgb-component-ids":
        buf = _without_app0(buf)
        sof = buf.index(b"\xff\xc0")
        sos = buf.index(b"\xff\xda")
        b = bytearray(buf)
        for i, cid in enumerate(b"RGB"):
            b[sof + 10 + 3 * i] = cid
            b[sos + 5 + 2 * i] = cid
        buf = bytes(b)
    else:
        buf = buf[:2] + adobe + _without_app0(buf)[2:]
    path = tmp_path / "a.jpg"
    path.write_bytes(buf)
    _assert_equal_to_jax(path)
    expected = J.COLOR_YCC if kind in ("adobe-0-beside-jfif", "adobe-transform-1") else J.COLOR_RGB
    assert J.parse_jpeg(buf).color == expected


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("keep", [0.2, 0.5, 0.9])
def test_jpeg_data_cut_short_matches_jax_imread(tmp_path, keep, restart):
    """Entropy data ended early by an EOI marker: cv2 decodes what is there,
    zero-fills the rest (gray) and warns; the port gives the same bytes and
    warns once, naming the file."""
    buf = _write(tmp_path / "src.jpg", _image(np.random.RandomState(3), 64, 80), "420", 90, restart).read_bytes()
    start = buf.index(b"\xff\xda")
    cut = start + int((len(buf) - start) * keep)
    path = tmp_path / "cut.jpg"
    path.write_bytes(buf[:cut] + b"\xff\xd9")
    ref = jax_imread(path)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = imread(path, device="cpu")
    np.testing.assert_array_equal(out, ref)
    assert (ref == 128).all(axis=2).any(), "the zero-filled part is missing: the cut shows nothing"
    msgs = [str(w.message) for w in seen if "cut short" in str(w.message)]
    assert len(msgs) == 1 and str(path) in msgs[0]


def test_jpeg_without_eoi_raises_where_cv2_gives_none(tmp_path):
    """A file that ends without an EOI marker: cv2.imdecode returns None
    (the JAX package's imread too); the port raises, naming the file."""
    buf = _write(tmp_path / "src.jpg", _image(np.random.RandomState(4), 40, 40)).read_bytes()
    for i, cut in enumerate((len(buf) - 2, len(buf) // 2)):
        path = tmp_path / f"cut{i}.jpg"
        path.write_bytes(buf[:cut])
        assert jax_imread(path) is None
        with pytest.raises(ValueError, match=f"cut{i}.jpg.*before the EOI marker"):
            imread(path, device="cpu")


def _refused(tmp_path, kind) -> Path:
    img = _image(np.random.RandomState(5), 16, 24)
    if kind == "progressive":  # cv2's progressive file cut after its second scan: the coefficients stay unfinished
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        buf = buf.tobytes()
        buf = buf[: [i for i in range(len(buf)) if buf.startswith(b"\xff\xda", i)][2]] + b"\xff\xd9"
    else:
        buf = _write(tmp_path / "src.jpg", img).read_bytes()
        sof = buf.index(b"\xff\xc0")
        if kind == "arithmetic":
            buf = buf[:sof] + b"\xff\xc9" + buf[sof + 2:]
        elif kind == "lossless":
            buf = buf[:sof] + b"\xff\xc3" + buf[sof + 2:]
        elif kind == "12-bit":
            buf = buf[:sof + 4] + b"\x0c" + buf[sof + 5:]
        elif kind == "cmyk":
            body = struct.pack(">BHHB", 8, 16, 24, 4) + b"".join(bytes([i + 1, 0x11, 0]) for i in range(4))
            buf = buf[:sof] + _segment(0xC0, body) + b"\xff\xd9"
        elif kind == "too-large":  # gray 65535 x 65535: 2^32 coefficients; the scan holds 16 x 24 of them
            buf = _write(tmp_path / "src.jpg", img, "gray").read_bytes()
            sof = buf.index(b"\xff\xc0")
            buf = buf[:sof + 5] + struct.pack(">HH", 65535, 65535) + buf[sof + 9:]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(buf)
    return path


@pytest.mark.parametrize("kind", ["progressive", "arithmetic", "lossless", "12-bit", "cmyk", "too-large"])
def test_jpeg_outside_baseline_raises_naming_the_file(tmp_path, kind):
    """The files the port refuses; "progressive" is a progressive file whose
    scan script stops before its coefficients are finished, which cv2 reads
    with libjpeg's block smoothing and the port does not."""
    path = _refused(tmp_path, kind)
    with pytest.raises(ValueError, match=f"{kind}.jpg: .*the port reads baseline"):
        imread(path, device="cpu")
    if kind == "progressive":  # cv2 reads it; the port does not
        assert jax_imread(path) is not None
    if kind == "too-large":  # over cv2's 2^30 pixels: it refuses too
        assert jax_imread(path) is None


@pytest.mark.parametrize("factors", [0x12, 0x21, 0x22, 0x41, 0x44])
def test_gray_jpeg_with_sampling_factors_matches_jax_imread(tmp_path, factors):
    """A gray file whose one component carries sampling factors above 1x1
    (as ``jpegtran -grayscale`` leaves a 4:2:0 file's luma): its scan is
    still non-interleaved over the component's own ceil(W/8) x ceil(H/8)
    blocks, while the coefficient plane is padded to whole MCUs of h x v
    blocks. The SOF byte of a cv2 file is patched; the entropy data stays."""
    rng = np.random.RandomState(factors)
    for h, w in SIZES + [(64, 64), (17, 40)]:
        buf = bytearray(_write(tmp_path / "src.jpg", _image(rng, h, w), "gray", 90).read_bytes())
        sof = buf.index(b"\xff\xc0")
        assert buf[sof + 9] == 1 and buf[sof + 11] == 0x11
        buf[sof + 11] = factors
        path = tmp_path / f"{h}x{w}.jpg"
        path.write_bytes(bytes(buf))
        _assert_equal_to_jax(path)


@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444"])
def test_jpeg_with_one_scan_a_component_matches_jax_imread(tmp_path, sampling, restart):
    """Three components, each in a scan of its own (chip_smoke.py's writer;
    cv2 writes one interleaved scan): each scan is non-interleaved over its
    component's own block grid, the luma's at 2x or 4x the chroma's."""
    write = _chip_smoke().jpeg_bytes
    rng = np.random.RandomState(int(sampling) + restart)
    for h, w in SIZES:
        path = tmp_path / f"{h}x{w}.jpg"
        path.write_bytes(write(_image(rng, h, w)[..., ::-1], 90, sampling, restart, interleave=False))
        _assert_equal_to_jax(path)


def test_idct_saturates_as_the_simd_build_cv2_runs(tmp_path):
    """Sample values beyond 0-255 before the range limit: libjpeg's C IDCT
    wraps them mod 1024 first (saturating only within +-512 of the centre),
    the SIMD build cv2 runs saturates. A file whose DC table is scaled up so
    that blocks land beyond +-512: the port equals cv2, and a wrap would not."""
    img = np.zeros((16, 32, 3), np.uint8)
    img[:, 16:] = 255
    buf = bytearray(_write(tmp_path / "src.jpg", img, "444", 100).read_bytes())
    at = 0
    while (at := buf.find(b"\xff\xdb", at) + 1) > 0:  # every 8-bit table's DC entry 1 -> 5: samples past +-512
        end = at + 1 + struct.unpack(">H", buf[at + 1: at + 3])[0]
        for t in range(at + 3, end, 65):
            buf[t + 1] = 5
    path = tmp_path / "hot.jpg"
    path.write_bytes(bytes(buf))
    _assert_equal_to_jax(path)
    hdr = J.parse_jpeg(bytes(buf))
    coef = J.entropy_decode(hdr)[0].astype(np.int32) * hdr.qt[hdr.comps[0].tq]
    d = coef.reshape(-1, 8, 8)
    cols = np.stack(J._idct_1d([d[:, r, :] for r in range(8)], 11), 1)
    raw = np.stack(J._idct_1d([cols[:, :, c] for c in range(8)], 18), 2) + 128
    assert raw.max() - 128 >= 512 and raw.min() - 128 < -512
    x = (raw - 128) & 1023  # the C path's range limit (jdmaster.c): saturates within +-512, wraps beyond
    wrapped = np.where(x < 128, x + 128, np.where(x < 512, 255, np.where(x < 896, 0, x - 896)))
    assert (wrapped != np.clip(raw, 0, 255)).any()


def test_jpeg_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """No hidden fallback: a JPEG asked of the card raises where there is
    none (the default device), and a PNG still reads on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(tmp_path / "a.jpg", _image(np.random.RandomState(6), 8, 8))
    with pytest.raises(RuntimeError, match="a.jpg.*needs CUDA"):
        imread(path)
    cv2.imwrite(str(tmp_path / "a.png"), _image(np.random.RandomState(6), 8, 8))
    np.testing.assert_array_equal(imread(tmp_path / "a.png"), cv2.imread(str(tmp_path / "a.png")))


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411", "gray"])
def test_chip_smoke_jpeg_writer_gives_files_cv2_reads(sampling):
    """chip_smoke.py's writer (the card machine has no encoder): its files
    decode in cv2 to the written image within the quantisation's error, and
    the port's plain path gives cv2's bytes, at every restart interval,
    quality and orientation phase jpeg uses."""
    chip_smoke = _chip_smoke()
    rng = np.random.RandomState(11)
    for (h, w), quality, restart, orientation in [((1, 1), 50, 0, None), ((7, 9), 75, 1, 3),
                                                  ((17, 33), 100, 7, 6), ((40, 56), 95, 0, 8)]:
        rgb = _image(rng, h, w)
        src = rgb[..., 0] if sampling == "gray" else rgb
        buf = chip_smoke.jpeg_bytes(src, quality, "444" if sampling == "gray" else sampling, restart, orientation)
        ref = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(J.decode_jpeg_reference(buf), ref)
        unrotated = J.apply_orientation(ref, {None: 1, 3: 3, 6: 8, 8: 6}[orientation])
        want = np.repeat(src[..., None], 3, 2) if sampling == "gray" else src[..., ::-1]
        assert unrotated.shape == want.shape
        assert np.abs(unrotated.astype(int) - want).mean() < 40


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("sampling", ["420", "444", "gray"])
def test_jpeg_without_huffman_tables_matches_cv2(tmp_path, sampling, restart):
    """A file with no DHT, as Motion-JPEG (AVI1) frames come (cv2 writes the
    Annex K tables, so taking them out with chip_smoke.py's ``strip_dht``
    changes nothing for libjpeg-turbo, which fills slots 0 and 1 with them):
    the port decodes it byte-equal to ``cv2.imdecode`` of the stripped file."""
    rng = np.random.RandomState(int(restart) + len(sampling))
    for h, w in SIZES + [(48, 64)]:
        buf = _write(tmp_path / "src.jpg", _image(rng, h, w), sampling, 90, restart).read_bytes()
        stripped = _chip_smoke().strip_dht(buf)
        assert b"\xff\xc4" not in stripped[:stripped.index(b"\xff\xda")] and len(stripped) < len(buf)
        path = tmp_path / f"{h}x{w}.jpg"
        path.write_bytes(stripped)
        np.testing.assert_array_equal(jax_imread(path), jax_imread(tmp_path / "src.jpg"))
        _assert_equal_to_jax(path)


def test_std_huffman_tables_are_the_ones_cv2_writes(tmp_path):
    """``STD_HUFFMAN`` equals the four DHT tables of a default cv2 file
    (libjpeg-turbo writes Annex K.3's unless asked to optimise)."""
    buf = _write(tmp_path / "a.jpg", _image(np.random.RandomState(7), 16, 16), "420", 90).read_bytes()
    tables, pos = {}, 2
    while buf[pos + 1] != 0xDA:
        end = pos + 2 + struct.unpack(">H", buf[pos + 2: pos + 4])[0]
        if buf[pos + 1] == 0xC4:
            p = pos + 4
            while p < end:
                counts = list(buf[p + 1: p + 17])
                tables[(buf[p] >> 4, buf[p] & 15)] = (counts, buf[p + 17: p + 17 + sum(counts)])
                p += 17 + sum(counts)
        pos = end
    assert tables == J.STD_HUFFMAN


def test_jpeg_slot_2_without_a_table_still_raises(tmp_path):
    """Only slots 0 and 1 have standard tables: a scan that names slot 2
    with no DHT raises, naming the file (cv2 gives None for it)."""
    buf = _chip_smoke().strip_dht(_write(tmp_path / "src.jpg", _image(np.random.RandomState(8), 16, 16), "gray",
                                         90).read_bytes())
    sos = buf.index(b"\xff\xda")
    buf = buf[:sos + 6] + b"\x22" + buf[sos + 7:]  # component 1: DC and AC table 2
    path = tmp_path / "slot2.jpg"
    path.write_bytes(buf)
    assert jax_imread(path) is None
    with pytest.raises(ValueError, match="slot2.jpg: a scan uses a Huffman table"):
        imread(path, device="cpu")


def _progressive(img, sampling="420", quality=95, restart=0, optimize=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL,
              restart, cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
    if sampling == "gray":
        img = img[..., 0]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("restart", [0, 1, 5])
@pytest.mark.parametrize("quality", [30, 75, 95, 100])
@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444", "gray"])
def test_progressive_jpeg_matches_jax_imread(tmp_path, sampling, quality, restart):
    """cv2's progressive files (libjpeg's simple progression: DC and AC
    successive approximation, EOB runs; a Huffman table per scan), every
    sampling, gray, restart intervals, sizes that are not whole MCUs."""
    rng = np.random.RandomState(quality + restart + len(sampling))
    for h, w in SIZES[:5] + [(64, 64)]:
        path = tmp_path / f"{h}x{w}.jpg"
        path.write_bytes(_progressive(_image(rng, h, w), sampling, quality, restart))
        assert J.parse_jpeg(path.read_bytes()).progressive
        _assert_equal_to_jax(path)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("orientation", [1, 6, 8])
def test_progressive_jpeg_from_pil_with_exif_matches_jax_imread(tmp_path, orientation, optimize):
    """PIL's progressive files (optimised tables or not) with an EXIF
    orientation."""
    from PIL import Image

    img = Image.fromarray(_image(np.random.RandomState(orientation), 37, 52))
    ex = Image.Exif()
    ex[0x0112] = orientation
    img.save(tmp_path / "a.jpg", quality=90, progressive=True, optimize=optimize, exif=ex)
    _assert_equal_to_jax(tmp_path / "a.jpg")


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411", "gray"])
def test_chip_smoke_progressive_writer_gives_cv2s_baseline_pixels(sampling):
    """chip_smoke.py's progressive writer codes its baseline output's
    quantised coefficients: cv2 decodes the two files to the same pixels,
    the port's plain path gives cv2's bytes and the same coefficients."""
    chip_smoke = _chip_smoke()
    rng = np.random.RandomState(12)
    for (h, w), quality, restart in [((1, 1), 50, 0), ((7, 9), 75, 1), ((17, 33), 100, 7), ((40, 56), 95, 0),
                                     ((64, 80), 90, 3)]:
        rgb = _image(rng, h, w)
        src = rgb[..., 0] if sampling == "gray" else rgb
        args = (src, quality, "444" if sampling == "gray" else sampling, restart)
        base, prog = chip_smoke.jpeg_bytes(*args), chip_smoke.jpeg_bytes(*args, progressive=True)
        ref = cv2.imdecode(np.frombuffer(base, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(prog, np.uint8), cv2.IMREAD_COLOR), ref)
        np.testing.assert_array_equal(J.decode_jpeg_reference(prog), ref)
        hb, hp = J.parse_jpeg(base), J.parse_jpeg(prog)
        assert hp.progressive and len(hp.scans) == (10 if sampling != "gray" else 6)
        for cb, cp, c in zip(J.entropy_decode(hb), J.entropy_decode(hp), hb.comps):
            rows, cols = -(-c.height // 8), -(-c.width // 8)
            np.testing.assert_array_equal(cb[:rows, :cols], cp[:rows, :cols])


@pytest.mark.parametrize("kind", ["breaks-off", "bad-scan"])
def test_progressive_jpeg_refusals(tmp_path, kind):
    """A progressive file whose data breaks off inside a scan before EOI
    (cv2 reads what is there; the port raises, naming it), and one whose
    scan header breaks the progression rules (cv2 reads none)."""
    buf = _progressive(_image(np.random.RandomState(13), 48, 64), "420", 90)
    sos = [i for i in range(len(buf)) if buf.startswith(b"\xff\xda", i)]
    if kind == "breaks-off":
        buf = buf[: sos[-1] + (len(buf) - sos[-1]) // 2] + b"\xff\xd9"
        match, cv2_reads = "breaks off", True
    else:
        ns = buf[sos[1] + 4]
        at = sos[1] + 5 + 2 * ns  # Ss of the second scan (an AC scan): 0 with Se > 0
        buf = buf[:at] + b"\x00" + buf[at + 1:]
        match, cv2_reads = "bad scan", False
    path = tmp_path / "p.jpg"
    path.write_bytes(buf)
    with pytest.raises(ValueError, match=f"p.jpg: .*{match}"):
        imread(path, device="cpu")
    assert (jax_imread(path) is not None) == cv2_reads
