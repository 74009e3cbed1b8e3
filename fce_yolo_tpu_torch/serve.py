"""Minimal binary inference server for native clients (reference
``fce_yolo_tpu/serve.py``): the process holds the model on the card and
answers the JAX server's wire protocol, so its clients
(``utils/remote.py::RemoteModel``, ``YOLO("tcp://host:port")``,
``examples/cpp_client``) work unchanged. One request is one image: the
server letterboxes it, runs ``YOLO.predict`` (the stem and NMS kernels on
the card) and sends the boxes back in the image's pixels.

Wire protocol (little-endian):
  request:  u32 height, u32 width, then h*w*3 bytes (BGR u8)
  response: u32 n, then n x 6 f32 rows [x1, y1, x2, y2, conf, cls]

A connection is closed on ``h == 0``, ``w == 0`` or ``h * w > 64e6``. Each
connection has its own thread, as in the JAX server; the device calls are
taken one at a time under a lock (``predict`` keeps one folded copy of the
model, made on first use), and each is one image, as the JAX code does.

    python -m fce_yolo_tpu_torch.serve --model yolo11s-fce.yaml --port 8500
"""

from __future__ import annotations

import socket
import struct
import threading
from pathlib import Path

import numpy as np

__all__ = ["InferenceServer", "main"]


class InferenceServer:
    """Serve ``model`` (a model name, YAML, checkpoint or ``.pt`` built on
    ``device``, or a ``YOLO``) on ``host:port`` (0: a free port, then in
    ``self.port``). The model is warmed up before connections are taken."""

    def __init__(self, model="yolo11n.yaml", host: str = "127.0.0.1", port: int = 0, conf: float = 0.25,
                 iou: float = 0.7, imgsz: int = 640, nc: int | None = None, device: str = "cuda"):
        from fce_yolo_tpu_torch.api import YOLO

        self.model = YOLO(model, device=device, nc=nc) if isinstance(model, (str, Path)) else model
        self.conf, self.iou, self.imgsz = conf, iou, imgsz
        self._lock = threading.Lock()  # one device call at a time
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.predict(np.zeros((64, 64, 3), np.uint8))  # fold, build and load the kernels before any request

    def predict(self, img: np.ndarray) -> np.ndarray:
        """One BGR image -> its (n, 6) float32 rows, under the device lock."""
        with self._lock:
            results = self.model.predict(img, imgsz=self.imgsz, conf=self.conf, iou=self.iou)
        return results[0].boxes.data.astype("<f4")

    # --------------------------------------------------------------- io
    @staticmethod
    def _recv_exact(conn, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _handle(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                hdr = self._recv_exact(conn, 8)
                if hdr is None:
                    return
                h, w = struct.unpack("<II", hdr)
                if h == 0 or w == 0 or h * w > 64_000_000:
                    return
                raw = self._recv_exact(conn, h * w * 3)
                if raw is None:
                    return
                rows = self.predict(np.frombuffer(raw, np.uint8).reshape(h, w, 3))
                conn.sendall(struct.pack("<I", len(rows)) + rows.tobytes())
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    # ------------------------------------------------------------- run
    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def start(self) -> "InferenceServer":
        """Accept connections on a background thread."""
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="fce-yolo-tpu inference server (PyTorch + CUDA port)")
    p.add_argument("--model", default="yolo11n.yaml")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = p.parse_args(argv)
    srv = InferenceServer(args.model, port=args.port, imgsz=args.imgsz, conf=args.conf, device=args.device)
    print(f"serving on :{srv.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
