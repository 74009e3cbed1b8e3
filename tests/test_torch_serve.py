"""The port's inference server (``serve.py``) and its client
(``utils/remote.py``, ``YOLO("tcp://host:port")``) on the CPU, against the
JAX package's ``serve.InferenceServer`` on the same weights (yolo11n, 3
classes, 64 px, the class convs spread as in ``test_torch_export.py``):

- over raw sockets, the two servers' rows for the same requests: the same
  count and classes, boxes and scores within 1e-4 (two frameworks' float32
  forwards; the images need no resize, only the letterbox's padding);
- ``RemoteModel`` and ``YOLO("tcp://...")`` give the server's rows, from two
  connections at once too; a client whose socket died reconnects once;
- a URL without a port raises; a header with ``h == 0`` or ``h * w > 64e6``
  closes the connection and the server goes on serving.
"""

import socket
import struct
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fce_yolo_tpu.nn.model as jax_model
from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.serve import InferenceServer as JaxInferenceServer
from fce_yolo_tpu_torch.api import YOLO
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables
from fce_yolo_tpu_torch.serve import InferenceServer
from fce_yolo_tpu_torch.utils.remote import RemoteModel
from test_torch_export import IMGSZ, noise, spread_head

SHAPES = [(64, 64), (48, 64), (64, 40)]  # (h, w): at most the model's size, so the letterbox only pads


@pytest.fixture(scope="module")
def servers():
    """(port server, JAX server) on 127.0.0.1, free ports, the same weights."""
    yolo = YOLO("yolo11n.yaml", device="cpu", nc=3)
    spread_head(yolo, noise(1)[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "resolve_strides", lambda spec: (8, 16, 32))  # no stride probe
        jy = JaxYOLO("yolo11n.yaml", nc=3)
    jy.variables = jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(yolo.model))
    ours = InferenceServer(yolo, imgsz=IMGSZ, device="cpu").start()
    theirs = JaxInferenceServer(jy, imgsz=IMGSZ).start()
    yield ours, theirs
    ours.stop()
    theirs.stop()


def images() -> list[np.ndarray]:
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, (h, w, 3), np.uint8) for h, w in SHAPES]


def recv_exact(s: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        assert chunk, "the server closed the connection"
        buf += chunk
    return buf


def raw_requests(port: int, imgs: list[np.ndarray]) -> list[np.ndarray]:
    """The wire protocol by hand, one connection, one request an image."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        for img in imgs:
            s.sendall(struct.pack("<II", *img.shape[:2]) + img.tobytes())
            (n,) = struct.unpack("<I", recv_exact(s, 4))
            out.append(np.frombuffer(recv_exact(s, 24 * n), "<f4").reshape(n, 6))
    return out


def test_rows_match_the_jax_server(servers):
    ours, theirs = servers
    imgs = images()
    got, ref = raw_requests(ours.port, imgs), raw_requests(theirs.port, imgs)
    assert sum(len(r) for r in ref) > 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.array_equal(g[:, 5], r[:, 5])
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)


def test_remote_clients(servers):
    ours, _ = servers
    imgs = images()
    want = raw_requests(ours.port, imgs)
    url = f"tcp://127.0.0.1:{ours.port}"
    results: dict = {}

    def client(k: int) -> None:
        with RemoteModel(url) as rm:
            results[k] = [rm(img) for img in imgs]

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]  # two connections at once
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for k in range(2):
        assert all(np.array_equal(a, b) for a, b in zip(results[k], want))

    rm = RemoteModel(url)
    assert np.array_equal(rm(imgs[0]), want[0])
    rm._sock.close()  # a dead connection: one reconnect
    assert np.array_equal(rm(imgs[1]), want[1])
    rm.close()

    facade = YOLO(url, device="cpu")
    assert facade.task == "detect" and facade.remote is not None and facade.model is None
    res = facade.predict(imgs)
    assert [r.orig_shape for r in res] == [img.shape[:2] for img in imgs]
    assert all(np.array_equal(r.boxes.data, w) for r, w in zip(res, want))
    assert res[0].names == {i: f"class_{i}" for i in range(80)}
    with pytest.raises(NotImplementedError, match="predicts only"):
        facade.val(data="x.yaml")


def test_bad_url_and_malformed_headers(servers):
    ours, _ = servers
    for url in ("tcp://127.0.0.1", "tcp://127.0.0.1:http", "127.0.0.1"):
        with pytest.raises(ValueError, match="tcp://host:port"):
            RemoteModel(url)
    with pytest.raises(ValueError, match="tcp://host:port"):
        YOLO("tcp://localhost", device="cpu")
    for h, w in ((0, 64), (64, 0), (8001, 8000)):
        with socket.create_connection(("127.0.0.1", ours.port), timeout=60) as s:
            s.sendall(struct.pack("<II", h, w))
            assert s.recv(1) == b""  # closed without a response
    assert len(raw_requests(ours.port, images()[:1])) == 1  # still serving
