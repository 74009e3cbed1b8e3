"""Video sources in the port (``data/avi.py``, ``data/loaders.py``,
``load_source``, ``YOLO.predict(stream=True)`` and ``YOLO.track`` on an
``.avi`` file) against cv2 and the JAX package.

The AVI files are written here: by ``cv2.VideoWriter`` (FFmpeg's muxer and
MJPEG encoder) and by ``chip_smoke.py::avi_bytes`` (a frame without DHT, a
``LIST rec `` group, an odd-sized chunk, a zero-length chunk, an OpenDML
``RIFF AVIX`` continuation).

Tolerances:
- frames: byte-equal to ``cv2.imdecode`` of each frame chunk (the JAX
  package's ``imread``), and as many, in the same order, as
  ``cv2.VideoCapture`` gives;
- ``cv2.VideoCapture``'s own pixels (what the JAX ``load_source`` yields)
  are FFmpeg's MJPEG decoder and swscale, not libjpeg-turbo: on these drawn
  frames they differ from ``cv2.imdecode``'s by up to 76 levels (the
  ``cv2.VideoWriter`` file) and 89 (the cv2-encoded frames), at the
  rectangles' colour edges, 2.45 and 3.05 on average, on 84% and 82% of the
  pixels (measured with cv2 5.0's FFmpeg backend); the test holds them
  within 96 and a mean of 4;
- predict and track on the file against the JAX facade fed the decoded
  arrays: the JAX facade tests' tolerances (classes and ids equal, boxes
  within 1e-3 px, scores within 1e-5).
"""

import struct
import sys
import threading
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from fce_yolo_tpu.engine.predictor import load_source as jax_load_source
from fce_yolo_tpu_torch.data import avi
from fce_yolo_tpu_torch.data.loaders import LoadScreenshots, LoadStreams, LoadTensor
from fce_yolo_tpu_torch.engine.predictor import load_source
from test_torch_track import _assert_same_tracks, _frames, pair  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
from test_torch_modules import jax_known_strides  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_known_strides")  # no JAX stride probe (test_torch_modules.py)

torch.set_num_threads(1)


def _scene(t: int, h: int = 240, w: int = 320) -> np.ndarray:
    """A gradient with texture and two rectangles that move with ``t``."""
    rng = np.random.RandomState(7)
    y, x = np.mgrid[:h, :w]
    img = np.stack([x * 255 // w, y * 255 // h, (x + y + 5 * t) % 256], 2)
    img = np.clip(img + rng.randint(-30, 31, img.shape), 0, 255).astype(np.uint8)
    img[30:110, 20 + 9 * t: 90 + 9 * t] = (40, 40, 230)
    img[120:200, 200 - 6 * t: 280 - 6 * t] = (40, 230, 40)
    return img


def _jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def _capture(path) -> list[np.ndarray]:
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def _chunk_frames(path) -> list[np.ndarray]:
    """``cv2.imdecode`` of each frame chunk the reader found."""
    raw = Path(path).read_bytes()
    return [cv2.imdecode(np.frombuffer(raw[at: at + n], np.uint8), cv2.IMREAD_COLOR)
            for at, n in avi.read_avi(path).frames]


def _write_kind(tmp_path: Path, kind: str, n: int = 8) -> tuple[Path, int]:
    """An AVI of ``n`` scenes written one way; returns (path, chunks written)."""
    scenes = [_scene(t) for t in range(n)]
    path = tmp_path / f"{kind}.avi"
    if kind == "cv2-writer":
        vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (320, 240))
        for s in scenes:
            vw.write(s)
        vw.release()
        return path, n
    jp = [_jpeg(s) for s in scenes]
    if kind == "hand":  # no DHT on frame 0, frames 1-2 in a rec list, an odd chunk, a dropped frame
        odd = jp[3] if len(jp[3]) % 2 else jp[3] + b"\0"  # a byte after EOI: the chunk is odd-sized
        frames = [chip_smoke.strip_dht(jp[0]), [jp[1], jp[2]], odd, b"", *jp[4:]]
        assert len(odd) % 2
        path.write_bytes(chip_smoke.avi_bytes(frames, 320, 240))
        return path, n + 1
    if kind == "opendml":  # RIFF AVI with 3 frames, no index, then RIFF AVIX with the rest
        first = chip_smoke.avi_bytes(jp[:3], 320, 240, index=False)
        body = b"".join(b"00dc" + struct.pack("<I", len(f)) + f + b"\0" * (len(f) & 1) for f in jp[3:])
        movi = b"LIST" + struct.pack("<I", len(body) + 4) + b"movi" + body
        path.write_bytes(first + b"RIFF" + struct.pack("<I", len(movi) + 4) + b"AVIX" + movi)
        return path, n
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["cv2-writer", "hand", "opendml"])
def test_avi_frames_equal_imdecode_in_videocapture_order(tmp_path, kind):
    """Each frame byte-equal to ``cv2.imdecode`` of its chunk (the frame
    without DHT included); as many frames as ``cv2.VideoCapture`` gives,
    each one nearest to the capture's frame of the same index. The
    zero-length chunk gives no frame in either."""
    path, chunks = _write_kind(tmp_path, kind)
    frames = list(avi.avi_frames(path, "cpu"))
    ref = _chunk_frames(path)
    cap = _capture(path)
    assert len(frames) == len(ref) == len(cap) == 8
    assert chunks - len(frames) == (kind == "hand")
    for f, r in zip(frames, ref):
        np.testing.assert_array_equal(f, r)
    dist = np.array([[np.abs(c.astype(np.int32) - f).mean() for f in frames] for c in cap])
    np.testing.assert_array_equal(dist.argmin(1), np.arange(len(cap)))
    video = avi.read_avi(path)
    assert (video.width, video.height, video.fourcc) == (320, 240, b"MJPG")


def test_videocapture_frames_differ_from_imdecode_within_the_stated_bound(tmp_path):
    """What the JAX package's ``load_source`` yields (``cv2.VideoCapture``:
    FFmpeg's decoder and swscale) is not ``cv2.imdecode``'s: the port's
    frames follow ``imdecode``, and the capture's differ from them by up to
    96 levels, 4 on average (76 / 2.45 and 89 / 3.05 measured), on both
    writers' files."""
    for kind in ("cv2-writer", "hand"):
        path, _ = _write_kind(tmp_path, kind)
        frames = list(avi.avi_frames(path, "cpu"))
        jax_frames = [f for f, _ in jax_load_source(str(path))]
        assert len(jax_frames) == len(frames)
        diff = np.stack([np.abs(j.astype(np.int32) - f) for j, f in zip(jax_frames, frames)])
        assert 0 < diff.max() <= 96 and diff.mean() <= 4.0
        assert (diff > 0).mean() > 0.5


def test_avi_names_match_jax_load_source(tmp_path):
    """``load_source`` on an ``.avi`` names frame i ``<path>#frame<i>``, as the JAX one does."""
    path, _ = _write_kind(tmp_path, "hand")
    names = [n for _, n in load_source(str(path), "cpu")]
    assert names == [n for _, n in jax_load_source(str(path))] == [f"{path}#frame{i}" for i in range(8)]
    assert names == [n for _, n in load_source(path, "cpu")]  # a Path too


def test_avi_reader_refuses(tmp_path):
    """Another codec raises naming its FourCC; another container naming
    itself; a file that is not RIFF AVI, an AVI with no video stream and an
    interlaced Motion-JPEG frame raise; a file cut off inside a frame chunk
    gives the frames before it, with a warning naming the file."""
    jp = [_jpeg(_scene(t)) for t in range(3)]
    xvid = tmp_path / "xvid.avi"
    xvid.write_bytes(chip_smoke.avi_bytes(jp, 320, 240, fourcc=b"XVID"))
    with pytest.raises(NotImplementedError, match="xvid.avi: a video stream coded as 'XVID'"):
        list(load_source(str(xvid), "cpu"))
    for suffix in ("mp4", "mkv", "mov"):
        with pytest.raises(NotImplementedError, match=f"clip.{suffix}: the {suffix} video container"):
            list(load_source(str(tmp_path / f"clip.{suffix}"), "cpu"))
    (tmp_path / "not.avi").write_bytes(b"RIFF\x04\x00\x00\x00WAVE")
    with pytest.raises(ValueError, match="not.avi: not a RIFF AVI file"):
        avi.read_avi(tmp_path / "not.avi")
    audio = bytearray(chip_smoke.avi_bytes(jp, 320, 240))
    at = audio.index(b"strh") + 8
    audio[at: at + 4] = b"auds"
    (tmp_path / "audio.avi").write_bytes(bytes(audio))
    with pytest.raises(ValueError, match="audio.avi: an AVI file with no video stream"):
        avi.read_avi(tmp_path / "audio.avi")
    field = jp[0][:2] + b"\xff\xe0" + struct.pack(">H", 16) + b"AVI1\x00\x01" + b"\x00" * 8 + jp[0][2:]
    (tmp_path / "fields.avi").write_bytes(chip_smoke.avi_bytes([field], 320, 240))
    with pytest.raises(NotImplementedError, match="fields.avi#frame0: an interlaced Motion-JPEG frame"):
        list(avi.avi_frames(tmp_path / "fields.avi", "cpu"))
    whole = chip_smoke.avi_bytes(jp, 320, 240, index=False)
    (tmp_path / "cut.avi").write_bytes(whole[:-len(jp[2]) // 2])
    with pytest.warns(UserWarning, match="cut.avi: the AVI file ends inside a frame chunk"):
        frames = list(avi.avi_frames(tmp_path / "cut.avi", "cpu"))
    assert len(frames) == 2 and len(_capture(tmp_path / "cut.avi")) >= 2


def test_avi_stride_and_directories_skip_video(tmp_path):
    """``avi_frames(stride=3)`` keeps frames 0, 3, 6; a directory with an
    ``.avi`` in it yields its images only, as the JAX ``load_source`` does."""
    path, _ = _write_kind(tmp_path, "hand")
    every = list(avi.avi_frames(path, "cpu"))
    some = list(avi.avi_frames(path, "cpu", stride=3))
    assert len(some) == 3 and all(np.array_equal(a, every[i]) for a, i in zip(some, (0, 3, 6)))
    cv2.imwrite(str(tmp_path / "a.png"), _scene(0))
    assert [n for _, n in load_source(str(tmp_path), "cpu")] == [n for _, n in jax_load_source(str(tmp_path))] \
        == [str(tmp_path / "a.png")]


def test_load_tensor_and_stream(tmp_path):
    """The JAX ``tests/test_data.py::test_load_tensor_and_stream`` checks on
    the port: ``LoadTensor`` on BCHW floats (numpy and torch), un-normalised
    input raising; ``LoadStreams`` on a ``cv2.VideoWriter`` MJPEG file,
    buffered."""
    for t in (np.zeros((2, 3, 32, 32), np.float32), torch.zeros(2, 3, 32, 32)):
        frames = [f for _, (f,) in LoadTensor(t)]
        assert len(frames) == 2 and frames[0].shape == (32, 32, 3) and frames[0].dtype == np.uint8
    x = np.random.RandomState(0).rand(3, 16, 24, 3).astype(np.float32)
    from fce_yolo_tpu.data.loaders import LoadTensor as JaxLoadTensor
    for (n, (a,)), (m, (b,)) in zip(LoadTensor(torch.from_numpy(x)), JaxLoadTensor(x)):
        assert n == m
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        LoadTensor(np.full((1, 3, 8, 8), 7.0, np.float32))
    vid = tmp_path / "s.avi"
    vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 5, (64, 48))
    for i in range(10):
        vw.write(np.full((48, 64, 3), i * 20, np.uint8))
    vw.release()
    streams = LoadStreams(str(vid), buffer=True, device="cpu")
    got = []
    for src, frames in streams:
        assert src == [str(vid)] and frames[0].shape == (48, 64, 3)
        got.append(frames[0])
    streams.close()
    assert len(got) == 10  # buffered: every frame
    for f, r in zip(got, _chunk_frames(vid)):
        np.testing.assert_array_equal(f, r)
    assert not any(t.is_alive() for t in streams.threads)


def test_streams_file_stride_and_a_full_buffer_keeps_every_frame(tmp_path):
    """A ``.streams`` file of two sources gives one frame of each a step
    (``load_source`` names them by source); ``vid_stride`` keeps every n-th
    frame; with ``buffer=True`` and ``max_buffer=2`` a slow consumer still
    gets every frame, in order (the reader waits for room; the reference's
    drops the frame it read)."""
    a, _ = _write_kind(tmp_path, "hand")
    b, _ = _write_kind(tmp_path, "opendml")
    lst = tmp_path / "cams.streams"
    lst.write_text(f"{a}\n\n{b}\n")
    streams = LoadStreams(str(lst), buffer=True, vid_stride=2, max_buffer=2, device="cpu")
    steps = []
    for srcs, frames in streams:
        time.sleep(0.01)
        steps.append(frames)
    assert streams.sources == [str(a), str(b)] and len(steps) == 4
    for k, path in enumerate((a, b)):
        for got, want in zip([s[k] for s in steps], list(avi.avi_frames(path, "cpu"))[::2]):
            np.testing.assert_array_equal(got, want)
    names = [n for _, n in load_source(str(lst), "cpu")]
    assert set(names) == {str(a), str(b)} and len(names) % 2 == 0


def test_streams_the_port_cannot_open(tmp_path):
    """Network streams, webcams and the screen raise NotImplementedError
    (the JAX package opens them through cv2 and mss); a missing stream file
    raises FileNotFoundError."""
    for src in ("rtsp://localhost:8554/cam", "http://localhost/x.mjpg", "0"):
        with pytest.raises(NotImplementedError, match="not read by the port"):
            list(load_source(src, "cpu"))
    with pytest.raises(NotImplementedError, match="screen capture"):
        list(load_source("screen 0", "cpu"))
    with pytest.raises(NotImplementedError, match="screen capture"):
        LoadScreenshots("screen")
    with pytest.raises(FileNotFoundError):
        list(load_source(str(tmp_path / "none.streams"), "cpu"))
    (tmp_path / "x.streams").write_text(str(tmp_path / "none.avi"))
    with pytest.raises(FileNotFoundError, match="none.avi"):
        LoadStreams(str(tmp_path / "x.streams"), device="cpu")


def test_reader_errors_reach_the_consumer(tmp_path):
    """A frame the reader thread cannot decode raises in the consumer."""
    jp = [_jpeg(_scene(t)) for t in range(2)]
    (tmp_path / "bad.avi").write_bytes(chip_smoke.avi_bytes([jp[0], b"\xff\xd8\xff\xe0 broken"], 320, 240))
    streams = LoadStreams(str(tmp_path / "bad.avi"), buffer=True, device="cpu")
    with pytest.raises(ValueError, match="bad.avi#frame1"):
        for _ in streams:
            pass
    assert not any(t.is_alive() for t in streams.threads) and threading.active_count() >= 1


# ------------------------------------------------------------------ the facade
def _frames_avi(tmp_path: Path, n: int = 6) -> tuple[Path, list[np.ndarray]]:
    """``test_torch_track``'s moving rectangles as an MJPEG AVI (quality 95),
    and ``cv2.imdecode`` of its frames (what the port reads)."""
    path = tmp_path / "frames.avi"
    path.write_bytes(chip_smoke.avi_bytes([_jpeg(f, 95) for f in _frames(n)], 128, 96))
    return path, _chunk_frames(path)


def test_predict_and_track_on_avi_match_jax_facade(pair, tmp_path):
    """``predict(stream=True)`` and ``track`` on the file against the JAX
    facade on the decoded arrays: the same detections and tracks, the
    results named ``<path>#frame<i>``."""
    jy, port = pair
    path, arrays = _frames_avi(tmp_path)
    ref = jy.predict(arrays, imgsz=64, batch=2)
    out = port.predict(str(path), imgsz=64, batch=2, stream=True)
    assert not isinstance(out, list)
    out = list(out)
    assert [r.path for r in out] == [f"{path}#frame{i}" for i in range(len(arrays))]
    assert sum(len(r) for r in out) > 0
    for r, o in zip(ref, out):
        assert len(o) == len(r)
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)
    ref = jy.track(arrays, conf=0.25, imgsz=64)
    out = port.track(str(path), conf=0.25, imgsz=64)
    assert len(out) == len(ref) == len(arrays) and sum(len(t) for _, t in out) > 0
    for (_, r_trk), (o_res, o_trk) in zip(ref, out):
        _assert_same_tracks(o_trk, r_trk, atol=1e-3, score_atol=1e-5)


@pytest.fixture(scope="module")
def obb_pair():
    """yolo11n-obb in both packages on the same weights, moved by N(0, 0.05)."""
    import jax

    from fce_yolo_tpu.api import YOLO as JaxYOLO
    from fce_yolo_tpu.nn.model import init_variables
    from fce_yolo_tpu_torch import YOLO

    jy = JaxYOLO("yolo11n-obb.yaml")
    v = jax.jit(lambda k: init_variables(jy.model, k, imgsz=64, bias_prior=False))(jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    v = jax.tree_util.tree_map(np.asarray, v)
    v["params"] = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(a.dtype), v["params"])
    jy.variables = jax.tree_util.tree_map(jax.numpy.asarray, v)
    return jy, YOLO("yolo11n-obb.yaml", device="cpu").load_jax_variables(v)


def test_obb_track_matches_jax_facade(obb_pair, tmp_path):
    """An OBB model tracks the axis-aligned hulls of its rotated boxes, as
    the JAX facade does (the port refused OBB tracking before): the same
    ids and classes every frame, scores within 1e-5 and boxes within 1e-3
    px, on arrays and on the same frames as an AVI."""
    jy, port = obb_pair
    path, arrays = _frames_avi(tmp_path)
    ref = jy.track(arrays, conf=0.25, imgsz=64)
    for src in (arrays, str(path)):
        out = port.track(src, conf=0.25, imgsz=64)
        assert len(out) == len(ref) == len(arrays)
        n = 0
        for (r_res, r_trk), (o_res, o_trk) in zip(ref, out):
            assert o_res.obb is not None and len(o_res) == len(r_res)
            np.testing.assert_allclose(o_res.boxes.xyxy, r_res.boxes.xyxy, rtol=0, atol=1e-3)
            _assert_same_tracks(o_trk, r_trk, atol=1e-3, score_atol=1e-5)
            n += len(o_trk)
        assert n > 0
