"""Python client for a remote inference server (reference
``fce_yolo_tpu/utils/remote.py``): a ``tcp://host:port`` model string routes
inference to a serving process (``fce_yolo_tpu_torch.serve.InferenceServer``
or the JAX package's ``serve.InferenceServer``: one wire protocol) instead of
a local graph. The server owns the pipeline (letterbox, forward, NMS, box
rescale); the client sends raw BGR frames and receives final detection rows,
so it needs neither torch nor the model.

Wire protocol (little-endian, one request per frame):
  request:  u32 height, u32 width, then h*w*3 bytes (BGR u8)
  response: u32 n, then n x 6 f32 rows [x1, y1, x2, y2, conf, cls]
"""

from __future__ import annotations

import socket
import struct

import numpy as np

__all__ = ["RemoteModel"]


class RemoteModel:
    """Persistent-connection client: ``RemoteModel("tcp://host:port")(img)``.

    The connection opens lazily on the first call and is reused across
    frames; one transparent reconnect is attempted if the server dropped an
    idle connection.
    """

    def __init__(self, url: str, timeout: float = 60.0):
        if url.startswith("tcp://"):
            url = url[len("tcp://"):]
        host, _, port = url.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"remote model URL must be tcp://host:port, got {url!r}")
        self.host, self.port = host, int(port)
        self.timeout = timeout
        self._sock: socket.socket | None = None

    # ----------------------------------------------------------- transport
    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port), timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("inference server closed the connection")
            buf += chunk
        return buf

    def _roundtrip(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        self._connect().sendall(struct.pack("<II", h, w) + img.tobytes())
        (n,) = struct.unpack("<I", self._recv_exact(4))
        rows = np.frombuffer(self._recv_exact(n * 24), "<f4").reshape(n, 6)
        return rows.copy()  # writable, detached from the recv buffer

    # ------------------------------------------------------------ inference
    def infer(self, img: np.ndarray) -> np.ndarray:
        """One BGR uint8 frame -> (N, 6) float32 [x1, y1, x2, y2, conf, cls]
        in the frame's own pixel coordinates."""
        img = np.ascontiguousarray(img, dtype=np.uint8)
        assert img.ndim == 3 and img.shape[2] == 3, f"expected HxWx3 BGR, got {img.shape}"
        try:
            return self._roundtrip(img)
        except (ConnectionError, OSError):
            self.close()  # stale connection: reconnect once
            return self._roundtrip(img)

    __call__ = infer

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "RemoteModel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"RemoteModel(tcp://{self.host}:{self.port})"
