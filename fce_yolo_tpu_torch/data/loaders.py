"""Streaming sources (reference ``fce_yolo_tpu/data/loaders.py``):
``LoadStreams``, ``LoadScreenshots`` and ``LoadTensor``.

``LoadStreams`` reads each source on a reader thread of its own, as the
reference does through ``cv2.VideoCapture``; the port's sources are MJPEG
``.avi`` files (``data/avi.py``, each frame decoded on ``device``) and
``.streams`` files that list them. Network streams (``rtsp://``,
``rtmp://``, ``http(s)://``, ``tcp://``) and webcams (a number) raise
``NotImplementedError``: the port has no network or camera capture, and the
card machine neither. ``LoadScreenshots`` raises: there is no screen.

One difference from the reference, on purpose: with ``buffer=True`` a
reader decodes its next frame only once the buffer has room, so no frame is
lost; the reference reads the frame first and drops it when its buffer is
full (``fce_yolo_tpu/data/loaders.py:70-77``).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np

from fce_yolo_tpu_torch.data.avi import avi_frames, read_avi

__all__ = ["LoadStreams", "LoadScreenshots", "LoadTensor", "STREAM_PREFIXES"]

STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://")
WAIT_S = 5.0  # how long ``__next__`` waits for a source's next frame


def _check_openable(source: str) -> None:
    if source.lower().startswith(STREAM_PREFIXES):
        raise NotImplementedError(f"{source}: network streams are not read by the port (no capture library); "
                                  "it reads MJPEG .avi files")
    if source.isnumeric():
        raise NotImplementedError(f"webcam {source}: cameras are not read by the port (no capture library); "
                                  "it reads MJPEG .avi files")
    if Path(source).suffix.lower() != ".avi":
        raise NotImplementedError(f"{source}: a stream source must be an MJPEG .avi file in the port")
    if not Path(source).is_file():
        raise FileNotFoundError(f"stream source not found: {source}")
    read_avi(source)  # a file that is not MJPEG AVI raises here, as the reference's open check does


class LoadStreams:
    """Threaded multi-source frame loader (reference ``LoadStreams``).

    ``sources``: one source, a list, or a ``.streams`` file of one a line.
    Each source has a daemon reader thread. Iteration yields (sources,
    frames), one frame a source: each source's latest frame (``buffer=False``,
    older ones are dropped) or its oldest buffered one (``buffer=True``, at
    most ``max_buffer`` held). ``vid_stride`` keeps every n-th frame. The
    iteration ends when a source has ended or gives no frame for
    ``WAIT_S`` seconds; ``close`` stops the threads.
    """

    def __init__(self, sources, buffer: bool = False, vid_stride: int = 1, max_buffer: int = 30,
                 device="cuda"):
        if isinstance(sources, (str, Path)) and str(sources).endswith(".streams"):
            sources = [s.strip() for s in Path(sources).read_text().splitlines() if s.strip()]
        elif not isinstance(sources, (list, tuple)):
            sources = [sources]
        self.sources = [str(s) for s in sources]
        for s in self.sources:
            _check_openable(s)
        self.buffer = buffer
        self.vid_stride = vid_stride
        self.max_buffer = max_buffer
        self.device = device
        self.running = True
        self.frames: list[list[np.ndarray]] = [[] for _ in self.sources]
        self.locks = [threading.Lock() for _ in self.sources]
        self.finished = [False] * len(self.sources)
        self.errors: list[BaseException | None] = [None] * len(self.sources)
        self.threads = [threading.Thread(target=self._reader, args=(i,), daemon=True)
                        for i in range(len(self.sources))]
        for t in self.threads:
            t.start()

    def _reader(self, i: int) -> None:
        try:
            for frame in avi_frames(self.sources[i], self.device, self.vid_stride):
                while self.buffer and self.running:
                    with self.locks[i]:
                        if len(self.frames[i]) < self.max_buffer:
                            break
                    time.sleep(0.005)
                if not self.running:
                    return
                with self.locks[i]:
                    if self.buffer:
                        self.frames[i].append(frame)
                    else:
                        self.frames[i] = [frame]
        except Exception as e:  # the consumer re-raises it: a reader thread has nowhere else to report
            self.errors[i] = e
        finally:
            self.finished[i] = True

    def __iter__(self):
        return self

    def __next__(self) -> tuple[list[str], list[np.ndarray]]:
        out = []
        for i in range(len(self.sources)):
            frame = None
            deadline = time.time() + WAIT_S
            while frame is None:
                done = self.finished[i]  # read before the frames: a reader sets it after its last frame
                with self.locks[i]:
                    if self.frames[i]:
                        frame = self.frames[i].pop(0)
                if frame is None:
                    if self.errors[i] is not None:
                        self.close()
                        raise self.errors[i]
                    if done or time.time() > deadline:
                        self.close()
                        raise StopIteration
                    time.sleep(0.002)
            out.append(frame)
        return self.sources, out

    def __len__(self) -> int:
        return len(self.sources)

    def close(self) -> None:
        self.running = False
        for t in self.threads:
            t.join(timeout=WAIT_S)


class LoadScreenshots:
    """Screen capture (reference ``LoadScreenshots``, through ``mss``): the
    port has no screen to read, so it raises, naming the source."""

    def __init__(self, source: str = "screen"):
        raise NotImplementedError(f"{source!r}: screen capture needs a display and the 'mss' package, which the "
                                  "port does not use (the card machine has no screen)")


class LoadTensor:
    """In-memory images (reference ``LoadTensor``): numpy arrays or torch
    tensors, HWC or BHWC, or CHW / BCHW (transposed to HWC); uint8 as it is,
    floats must lie in [0, 1] and become ``(x * 255).astype(uint8)``. Yields
    (["tensor<i>"], [HWC uint8 image])."""

    def __init__(self, tensor):
        if hasattr(tensor, "detach"):  # a torch tensor, on any device
            tensor = tensor.detach().cpu().numpy()
        arr = np.asarray(tensor)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4:
            raise ValueError(f"expected a 3D or 4D tensor, got shape {arr.shape}")
        if arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):  # BCHW -> BHWC
            arr = arr.transpose(0, 2, 3, 1)
        if arr.dtype != np.uint8:
            if arr.max() > 1.0 + 1e-3:
                raise ValueError("float tensor inputs must be normalized to [0, 1] (reference LoadTensor contract)")
            arr = (arr * 255).astype(np.uint8)
        self.arr = arr

    def __iter__(self):
        self._i = 0
        return self

    def __next__(self) -> tuple[list[str], list[np.ndarray]]:
        if self._i >= len(self.arr):
            raise StopIteration
        im = self.arr[self._i]
        self._i += 1
        return [f"tensor{self._i - 1}"], [im]

    def __len__(self) -> int:
        return len(self.arr)
