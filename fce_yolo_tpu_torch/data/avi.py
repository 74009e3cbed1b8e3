"""Motion-JPEG AVI reading without cv2 (the JAX package reads video with
``cv2.VideoCapture``, ``fce_yolo_tpu/engine/predictor.py:77-88``; the card
machine has no cv2, no video decoder and no torchvision).

``read_avi`` walks the file's RIFF tree: ``hdrl`` (``avih``, and each
``strl``'s ``strh``/``strf``: the streams in order), then every ``movi``
list, those of the ``RIFF AVIX`` continuations of an OpenDML file included,
with the chunks of ``LIST rec `` groups taken in place and the pad byte of
an odd-sized chunk skipped. The frames are the first video stream's ``##dc``
and ``##db`` chunks in file order: ``idx1`` and the OpenDML ``ix##``
indexes are not read (FFmpeg, which cv2 reads video through, falls back to
the same walk when it finds no index). A zero-length chunk (a dropped
frame) gives no frame, as cv2's FFmpeg backend gives none for it.

``avi_frames`` decodes each frame with ``data/jpeg.py::decode_jpeg`` on
``device``: the IDCT and colour kernels on the card, or the plain path on
the CPU, bit-equal to ``cv2.imdecode`` of the chunk (the Annex K.3 Huffman
tables stand in for the DHT that Motion-JPEG frames leave out). cv2's
``VideoCapture`` decodes with FFmpeg's MJPEG decoder and swscale, whose
frames differ from ``cv2.imdecode``'s by tens of levels (more at sharp
colour edges), so no reader can equal both; this one follows ``imdecode``.

What raises: a file that is not RIFF AVI (``ValueError``), an AVI with no
video stream (``ValueError``), a video stream of another codec than
Motion-JPEG (``NotImplementedError`` naming its FourCC), and interlaced
Motion-JPEG, two fields a chunk (``NotImplementedError``). A frame chunk
that runs past the end of the file (a recording cut off) ends the video
with a warning naming the file.
"""

from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Iterator

import numpy as np

from fce_yolo_tpu_torch.data.jpeg import decode_jpeg

__all__ = ["MJPEG_FOURCCS", "AviVideo", "read_avi", "avi_frames"]

# biCompression tags FFmpeg's AVI demuxer maps to its MJPEG decoder that the port reads
MJPEG_FOURCCS = (b"MJPG", b"mjpg", b"AVRN", b"LJPG", b"dmb1")


@dataclass
class AviVideo:
    """The first video stream of an AVI file: its size, codec and its
    frames' chunks as (file offset of the data, size) in file order."""

    path: str
    width: int
    height: int
    fourcc: bytes
    frames: list[tuple[int, int]] = field(default_factory=list)
    cut_short: bool = False  # a frame chunk ran past the end of the file


def _chunks(f: BinaryIO, start: int, end: int) -> Iterator[tuple[bytes, int, int]]:
    """(tag, data offset, data size) of each chunk in [start, end); a list's
    data starts with its 4-byte kind. A size past ``end`` is given as it is."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(8)
        if len(head) < 8:
            return
        tag, size = head[:4], struct.unpack("<I", head[4:])[0]
        yield tag, pos + 8, size
        pos += 8 + size + (size & 1)


def _stream_number(tag: bytes) -> int | None:
    return int(tag[:2]) if tag[:2].isdigit() else None


def read_avi(path: str | Path) -> AviVideo:
    """The first video stream of the AVI file ``path`` and its frame chunks (module docstring)."""
    name = str(path)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        f.seek(0)
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise ValueError(f"{name}: not a RIFF AVI file")
        streams: list[tuple[bytes, bytes, bytes, int, int]] = []  # (type, handler, compression, width, height)
        movis: list[tuple[int, int]] = []
        for riff_tag, riff_at, riff_size in _chunks(f, 0, size):
            f.seek(riff_at)
            kind = f.read(4)
            if riff_tag != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
                break  # trailing bytes after the last RIFF
            for tag, at, n in _chunks(f, riff_at + 4, min(riff_at + riff_size, size)):
                f.seek(at)
                sub = f.read(4)
                if tag == b"LIST" and sub == b"movi":
                    movis.append((at + 4, min(at + n, size)))
                elif tag == b"LIST" and sub == b"hdrl" and kind == b"AVI ":
                    for s_tag, s_at, s_n in _chunks(f, at + 4, min(at + n, size)):
                        f.seek(s_at)
                        if s_tag == b"LIST" and f.read(4) == b"strl":
                            streams.append(_strl(f, s_at + 4, min(s_at + s_n, size)))
        vids = [i for i, s in enumerate(streams) if s[0] == b"vids"]
        if not vids:
            raise ValueError(f"{name}: an AVI file with no video stream")
        number = vids[0]
        _, handler, fourcc, w, h = streams[number]
        if fourcc not in MJPEG_FOURCCS:
            raise NotImplementedError(
                f"{name}: a video stream coded as {fourcc.decode('latin-1')!r} (handler "
                f"{handler.decode('latin-1')!r}); the port reads Motion-JPEG AVI only "
                f"({', '.join(t.decode() for t in MJPEG_FOURCCS)})")
        video = AviVideo(name, w, abs(h), fourcc)
        for start, end in movis:
            _movi(f, start, end, size, number, video)
    if video.cut_short:
        warnings.warn(f"{name}: the AVI file ends inside a frame chunk; the video ends at the frame before it")
    return video


def _strl(f: BinaryIO, start: int, end: int) -> tuple[bytes, bytes, bytes, int, int]:
    """One ``strl`` list -> (fccType, fccHandler, biCompression, width, height)."""
    kind = handler = compression = b""
    w = h = 0
    for tag, at, n in _chunks(f, start, end):
        f.seek(at)
        body = f.read(min(n, 64))
        if tag == b"strh" and len(body) >= 8:
            kind, handler = body[:4], body[4:8]
        elif tag == b"strf" and kind == b"vids" and len(body) >= 20:
            w, h = struct.unpack("<ii", body[4:12])
            compression = body[16:20]
    return kind, handler, compression, w, h


def _movi(f: BinaryIO, start: int, end: int, size: int, number: int, video: AviVideo) -> None:
    """Append the frame chunks of stream ``number`` in one ``movi`` (or ``rec ``) list to ``video``."""
    for tag, at, n in _chunks(f, start, end):
        if video.cut_short:
            return
        if tag == b"LIST":
            f.seek(at)
            if f.read(4) == b"rec ":
                _movi(f, at + 4, min(at + n, end), size, number, video)
        elif tag[2:] in (b"dc", b"db") and _stream_number(tag) == number:
            if at + n > size:
                video.cut_short = True
            elif n:
                video.frames.append((at, n))


def _interlaced(buf: bytes) -> bool:
    """Whether a frame's first segment is an ``AVI1`` APP0 that says it holds two fields."""
    return buf[2:4] == b"\xff\xe0" and buf[6:11] == b"AVI1\x00" and len(buf) > 11 and buf[11] != 0


def avi_frames(path: str | Path, device="cuda", stride: int = 1) -> Iterator[np.ndarray]:
    """Decode every ``stride``-th frame of the MJPEG AVI ``path`` on
    ``device`` (``decode_jpeg``): BGR uint8 (H, W, 3), in file order."""
    video = read_avi(path)
    with open(path, "rb") as f:
        for i, (at, n) in enumerate(video.frames):
            if i % stride:
                continue
            f.seek(at)
            buf = f.read(n)
            if _interlaced(buf):
                raise NotImplementedError(f"{video.path}#frame{i}: an interlaced Motion-JPEG frame (two fields a "
                                          "chunk) is not read by the port")
            yield decode_jpeg(buf, f"{video.path}#frame{i}", device)
