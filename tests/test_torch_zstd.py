"""The port's zstd decoders (``utils/zstd.py`` in Python, ``csrc/zstd.cu`` as
host C++) against libzstd's frames.

Frames come from tensorstore's zarr driver (``{"id": "zstd", "level": L}``,
the codec orbax writes every chunk with) at levels 1, 3, 9 and 19, over
zeros, runs, random float32, a port model's seeded weights, text, and
inputs whose later blocks have one literal byte; every input is over 128
KiB, so a frame spans several blocks. Both decoders must give the input
back byte for byte. The C++ decoder is built here with g++ and put in place
of ``kbuild.library``, as the TIFF codecs' tests do.

Which kinds the Python decoder met is read from its ``COUNTS``: raw, RLE
and compressed blocks, raw, RLE, compressed and treeless literals in 1 and
4 streams, and predefined, RLE, FSE and repeated sequence tables all come
from tensorstore's frames. What tensorstore never writes (a content size,
a single-segment frame, a content checksum, skippable frames, frames back
to back, a dictionary id) comes from the ``zstandard`` package's libzstd.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from fce_yolo_tpu_torch.cfg.models import MODELS
from fce_yolo_tpu_torch.kernels import build as kbuild
from fce_yolo_tpu_torch.nn.model import build_model, init_weights
from fce_yolo_tpu_torch.utils import zstd

REPO = Path(__file__).resolve().parent.parent
LEVELS = (1, 3, 9, 19)


def _inputs() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    model, _, _ = build_model({**MODELS["yolo11-fce"], "nc": 80}, scale="n", device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    weights = torch.cat([p.detach().reshape(-1) for p in model.parameters()])[:96 << 10].numpy()
    pattern = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    one_literal = pattern + b"".join(pattern[i * 37 % 3000:i * 37 % 3000 + 50] + b"x" * int(rng.integers(1, 20))
                                     for i in range(6000))  # at level 19, blocks of RLE literals
    words = [b"orbax", b"tensor", b"chunk", b"zarr", b"ocdbt", b"kernel", b"bias", b"mean", b"var", b"scale"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 40000))
    return {
        "zeros": bytes(200 << 10),
        "runs": np.repeat(rng.integers(0, 6, 4000, dtype=np.uint8), rng.integers(1, 80, 4000)).tobytes(),
        "random_f32": rng.standard_normal(50000).astype(np.float32).tobytes(),
        "weights": weights.astype(np.float32).tobytes(),
        "text": text,
        "one_literal": one_literal,
    }


def _tensorstore_frame(data: bytes, level: int) -> bytes:
    """The chunk tensorstore's zarr driver writes for ``data`` (one chunk)."""
    arr = np.frombuffer(data, np.uint8)
    t = ts.open({"driver": "zarr", "kvstore": {"driver": "memory"},
                 "metadata": {"shape": [arr.size], "chunks": [arr.size], "dtype": "|u1",
                              "compressor": {"id": "zstd", "level": level}}}, create=True).result()
    t.write(arr).result()
    return t.kvstore.read("0").result().value


@pytest.fixture(scope="module")
def frames():
    """{(level, input name): (frame, input)}."""
    return {(lv, name): (_tensorstore_frame(data, lv), data) for name, data in _inputs().items() for lv in LEVELS}


@pytest.fixture(scope="module")
def python_decodes(frames):
    """Every tensorstore frame decoded once by the Python decoder, and the kinds it met."""
    zstd.COUNTS.clear()
    out = {key: zstd.decompress(frame, "cpu") for key, (frame, _) in frames.items()}
    return out, dict(zstd.COUNTS)


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """``csrc/zstd.cu`` (host C++ only) built here with g++, typed as ``kernels/build.py`` types it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host C++ decoder")
    lib = tmp_path_factory.mktemp("zstd") / "libzstd.so"
    res = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib),
                          str(REPO / "fce_yolo_tpu_torch" / "csrc" / "zstd.cu")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-3000:]
    fn = ctypes.CDLL(str(lib)).fce_zstd_decompress
    fn.argtypes = kbuild.SIGNATURES["fce_zstd_decompress"]
    fn.restype = ctypes.c_int
    return type("Lib", (), {"fce_zstd_decompress": staticmethod(fn)})


@pytest.fixture(params=["cpu", "cuda"], ids=["python", "host-c++"])
def device(request, monkeypatch):
    """Each decoder: the plain Python one, and the C++ one of the card's library (a ``cuda`` device)."""
    if request.param == "cuda":
        lib = request.getfixturevalue("native")
        monkeypatch.setattr(kbuild, "library", lambda: lib)
    return request.param


@pytest.mark.parametrize("name", ["zeros", "runs", "random_f32", "weights", "text", "one_literal"])
@pytest.mark.parametrize("level", LEVELS)
def test_tensorstore_frames_decode_byte_equal(frames, python_decodes, native, monkeypatch, level, name):
    frame, data = frames[(level, name)]
    assert len(data) > 128 << 10
    assert python_decodes[0][(level, name)] == data
    monkeypatch.setattr(kbuild, "library", lambda: native)
    assert zstd.decompress(frame, "cuda", size_hint=len(data)) == data


def test_python_decoder_meets_every_block_literals_and_sequence_kind(python_decodes):
    counts = python_decodes[1]
    kinds = ["block_raw", "block_rle", "block_compressed", "literals_raw", "literals_rle", "literals_compressed",
             "literals_treeless", "literals_1_stream", "literals_4_streams", "sequences_predefined",
             "sequences_rle", "sequences_fse", "sequences_repeat"]
    assert {k: counts.get(k, 0) for k in kinds if not counts.get(k)} == {}
    assert counts["frame"] == 6 * len(LEVELS)
    assert "frame_checksum" not in counts  # tensorstore writes no checksum: the next test covers it


@pytest.mark.parametrize("level", (1, 19))
def test_frame_header_forms_checksum_skippable_and_frames_back_to_back(device, level):
    rng = np.random.default_rng(1)
    data = [rng.integers(0, 8, n, dtype=np.uint8).tobytes() for n in (0, 1, 200, 70000, 300000)]
    zstd.COUNTS.clear()
    for checksum in (False, True):
        c = zstandard.ZstdCompressor(level=level, write_checksum=checksum, write_content_size=True)
        for d in data:
            frame = c.compress(d)
            assert zstd.decompress(frame, device, size_hint=1) == d  # the C++ path grows its room
    # a single-segment frame (the content size stands for the window), then a window descriptor
    small = zstandard.ZstdCompressor(level=level, write_content_size=True).compress(data[2])
    assert small[4] & 0x20
    big = zstandard.ZstdCompressor(level=level, write_content_size=False).compress(data[4])
    assert not big[4] & 0x20
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    both = small + skip + big + zstandard.ZstdCompressor(level=level).compress(b"")
    assert zstd.decompress(both, device) == data[2] + data[4]
    if device == "cpu":
        assert zstd.COUNTS["frame_checksum"] == len(data) and zstd.COUNTS["skippable"] == 1


def test_a_wrong_checksum_raises(device):
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(b"abc" * 1000))
    frame[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(frame), device)


def test_a_frame_that_needs_a_dictionary_names_its_id(device):
    samples = [bytes(np.random.default_rng(i).integers(97, 100, 300, dtype=np.uint8)) for i in range(64)]
    d = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[0])
    with pytest.raises(ValueError, match=f"dictionary {d.dict_id()}"):
        zstd.decompress(frame, device)


@pytest.mark.parametrize("cut", ["magic", "header", "block", "trailing"])
def test_a_malformed_frame_names_the_byte_offset(device, cut):
    frame = zstandard.ZstdCompressor(level=3).compress(np.arange(50000, dtype=np.int32).tobytes())
    bad = {"magic": b"\x00" + frame[1:], "header": frame[:5], "block": frame[:len(frame) // 2],
           "trailing": frame + b"\x28\xb5"}[cut]
    with pytest.raises(ValueError, match=r"malformed frame at byte \d+"):
        zstd.decompress(bad, device)


def test_the_cuda_path_never_falls_back_to_python(monkeypatch):
    """A ``cuda`` device runs the C++ decoder or raises: with the library
    failing to build, the call fails and the Python decoder is not run."""
    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kbuild, "library", no_build)
    monkeypatch.setattr(zstd, "decompress_plain", lambda data: pytest.fail("fell back to Python"))
    with pytest.raises(RuntimeError, match="nvcc"):
        zstd.decompress(zstandard.ZstdCompressor().compress(b"x" * 100), "cuda")


def test_mutated_frames_raise_or_decode_alike_in_both_decoders(native, monkeypatch):
    """Frames with bytes changed, bits flipped, bytes inserted or the end
    cut: each decoder gives the same bytes or raises ``ValueError``, and
    both agree on which (a checkpoint file is outside input)."""
    monkeypatch.setattr(kbuild, "library", lambda: native)
    rng = np.random.default_rng(5)
    data = [rng.integers(0, 4, 5000, dtype=np.uint8).tobytes(), rng.standard_normal(3000).astype(np.float32).tobytes(),
            b"abcabcabd" * 500 + rng.integers(0, 256, 300, dtype=np.uint8).tobytes()]
    frames = [zstandard.ZstdCompressor(level=lv, write_checksum=lv == 3).compress(d) for lv in (1, 3, 19)
              for d in data]
    decoded = 0
    for i in range(300):
        b = bytearray(frames[i % len(frames)])
        kind, p = i % 4, int(rng.integers(4, len(b)))
        if kind == 0:
            b[p] = int(rng.integers(0, 256))
        elif kind == 1:
            b[p] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            b[p:p] = rng.integers(0, 256, int(rng.integers(1, 20)), dtype=np.uint8).tobytes()
        else:
            del b[p:]
        outs = []
        for device in ("cpu", "cuda"):
            try:
                outs.append(zstd.decompress(bytes(b), device))
            except ValueError:
                outs.append(None)
        assert outs[0] == outs[1], i
        decoded += outs[0] is not None
    assert 0 < decoded < 300
