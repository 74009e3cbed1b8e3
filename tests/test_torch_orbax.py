"""The port's orbax reader without orbax: ``utils/ocdbt.py`` (the OCDBT
key-value store), ``utils/zarr.py`` (zarr v2 arrays) and
``utils/checkpoint.py::load_jax_checkpoint``, against tensorstore and the
JAX package's ``load_checkpoint``; and the committed fixture
``tests/fixtures/jax_checkpoint`` (``make_jax_checkpoint.py``) read and run.

Every comparison of bytes or leaves is exact (bfloat16 leaves as their bit
patterns). The fixture's predictions: the same detection counts and
classes, boxes within 1e-3 px and scores within 1e-5 of the JAX facade's
stored ones, raw head outputs within 1e-5 of their largest magnitude
(float32 in both, summation order only).
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch

from fce_yolo_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.data.augment import letterbox
from fce_yolo_tpu_torch.kernels import build as kbuild
from fce_yolo_tpu_torch.utils import ocdbt, zarr
from fce_yolo_tpu_torch.utils.checkpoint import is_checkpoint, is_jax_checkpoint, load_jax_checkpoint
from test_torch_zstd import native  # noqa: F401  (the g++-built C++ decoder)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_checkpoint"
PREDICTIONS = REPO / "tests" / "fixtures" / "jax_checkpoint_predictions.npz"
SMALL_NODES = {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 64, "version_tree_arity_log2": 1,
               "compression": {"id": "zstd", "level": 5}}

torch.set_num_threads(1)


@pytest.fixture(params=["cpu", "cuda"], ids=["python", "host-c++"])
def device(request, monkeypatch):
    if request.param == "cuda":
        lib = request.getfixturevalue("native")
        monkeypatch.setattr(kbuild, "library", lambda: lib)
    return request.param


def _bits(x) -> np.ndarray:
    """A leaf as comparable numpy: bfloat16 (ml_dtypes or torch) as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same_trees(ref: dict, got: dict) -> int:
    """Leaf-for-leaf equality (paths, dtypes, shapes, values); returns the leaf count."""
    a = jax.tree_util.tree_flatten_with_path(ref)[0]
    b = jax.tree_util.tree_flatten_with_path(got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        x, y = _bits(x), _bits(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), path
    return len(a)


# ------------------------------------------------------------------ the store
ARRAYS = {  # name: (values, chunks, compressor, zarr dtype, fill value)
    "f4": (np.arange(37 * 23, dtype=np.float32).reshape(37, 23) / 7, [8, 10], {"id": "zstd", "level": 5}, "<f4",
           None),
    "f8": (np.linspace(-1, 1, 5), [2], None, "<f8", None),
    "f2": (np.arange(60, dtype=np.float16).reshape(3, 4, 5), [3, 4, 5], {"id": "zstd", "level": 1}, "<f2", None),
    "i4": (np.arange(100, dtype=np.int32), [30], {"id": "zstd", "level": 3}, "<i4", 7),
    "i8": (np.array(-3, np.int64), [], {"id": "zstd", "level": 1}, "<i8", None),
    "u4": (np.arange(9, dtype=np.uint32) * 0x10001, [4], None, "<u4", None),
    "u1": (np.arange(200, dtype=np.uint8), [64], {"id": "zstd", "level": 9}, "|u1", None),
    "b1": (np.arange(17) % 3 == 0, [5], {"id": "zstd", "level": 1}, "|b1", None),
    "bf16": (np.arange(12, dtype=np.float32).reshape(3, 4) - 5.5, [2, 3], {"id": "zstd", "level": 1}, "bfloat16",
             None),
}


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    """An OCDBT store of 400-byte nodes (interior nodes) and 64-byte inline
    values, holding zarr arrays of every dtype the reader takes, chunk grids
    with edge chunks, and (``i4``) chunks never written (the fill value)."""
    root = tmp_path_factory.mktemp("store")
    base = {"driver": "ocdbt", "base": f"file://{root}/", "config": SMALL_NODES}
    for name, (values, chunks, comp, dt, fill) in ARRAYS.items():
        t = ts.open({"driver": "zarr", "kvstore": {**base, "path": f"{name}/"},
                     "metadata": {"shape": list(values.shape), "chunks": chunks, "dtype": dt, "compressor": comp,
                                  "fill_value": fill}}, create=True).result()
        sl = slice(0, 30) if name == "i4" else ...
        t[sl] = values[sl].astype(t.dtype.numpy_dtype)
    return root


def test_store_lists_and_reads_what_tensorstore_does(small_store, device):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{small_store}/"}).result()
    keys = [k.decode() for k in kv.list().result()]
    store = ocdbt.OcdbtStore(small_store, device)
    assert store.list() == sorted(keys)
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    assert store.nodes_read > 3  # interior nodes
    kinds = {v[0] for v in store._values.values()}
    assert kinds == {"inline", "file"}
    with pytest.raises(KeyError, match="nope"):
        store.read("nope")


@pytest.mark.parametrize("name", list(ARRAYS))
def test_zarr_arrays_read_what_tensorstore_does(small_store, device, name):
    store = ocdbt.OcdbtStore(small_store, device)
    ref = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{small_store}/",
                                                 "path": f"{name}/"}}).result().read().result()
    got = zarr.read_array(store, name, device)
    if name == "bf16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), ref.view(np.uint16))
    else:
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    if name == "i4":
        assert (got[30:] == 7).all()


def test_the_newest_version_from_the_version_tree_nodes(small_store, tmp_path):
    """A manifest whose inline versions are taken out: the reader walks the
    version tree nodes down to their newest generation, which tensorstore
    opens by number."""
    root = tmp_path / "store"
    shutil.copytree(small_store, root)
    store = ocdbt.OcdbtStore.__new__(ocdbt.OcdbtStore)
    store.root, store.device = root, torch.device("cpu")
    r = store._piece("manifest", (root / "manifest.ocdbt").read_bytes(), ocdbt.MANIFEST_MAGIC)
    r.take(16)
    r.varint(), r.varint(), r.varint(), r.u8()
    if r.varint() == 1:
        r.take(4)
    files = ocdbt._data_files(r)
    cut = r.pos
    inline = ocdbt.OcdbtStore._versions(r, files)
    body = r.buf[:cut] + b"\x00" + r.buf[r.pos:]  # no inline versions, the version tree's nodes kept
    piece = ocdbt.MANIFEST_MAGIC.to_bytes(4, "big") + (len(body) + 18).to_bytes(8, "little") + b"\x00\x00" + body
    (root / "manifest.ocdbt").write_bytes(piece + ocdbt.crc32c(piece).to_bytes(4, "little"))
    newest_in_nodes = min(gen for gen, _, _ in inline) - 1
    assert newest_in_nodes > 1
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{small_store}/", "version": newest_in_nodes}).result()
    got = ocdbt.OcdbtStore(root)
    assert got.nodes_read > 2 and got.list() == sorted(k.decode() for k in kv.list().result())
    assert all(got.read(k.decode()) == kv.read(k).result().value for k in kv.list().result())


def test_unsupported_codecs_and_layouts_raise_naming_them(tmp_path):
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    for name, meta in (("blosc", {"compressor": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}}),
                       ("zlib", {"compressor": {"id": "zlib", "level": 1}}),
                       ("fortran", {"compressor": None, "order": "F"})):
        t = ts.open({"driver": "zarr", "kvstore": {**base, "path": f"{name}/"},
                     "metadata": {"shape": [4, 3], "chunks": [4, 3], "dtype": "<f4", **meta}}, create=True).result()
        t[...] = np.ones((4, 3), np.float32)
    store = ocdbt.OcdbtStore(tmp_path)
    for name, what in (("blosc", "compressor 'blosc'"), ("zlib", "compressor 'zlib'"), ("fortran", "order 'F'")):
        with pytest.raises(ValueError, match=what):
            zarr.read_array(store, name)


# ------------------------------------------------------------------ checkpoints
@pytest.fixture(scope="module")
def fixture_tree():
    """The committed fixture as the JAX package reads it (orbax)."""
    return load_checkpoint(str(FIXTURE))


def test_fixture_reads_leaf_for_leaf_as_orbax_does(fixture_tree):
    ref, meta = fixture_tree
    assert is_checkpoint(FIXTURE) and is_jax_checkpoint(FIXTURE)
    got, got_meta = load_jax_checkpoint(FIXTURE, collections=None, device="cpu")
    assert got_meta == meta and meta["cfg_yaml"] == "tests/fixtures/yolo11-fce-narrow.yaml"
    assert _same_trees(ref, got) > 300
    assert got["params"]["layers_0"]["conv"]["kernel"].dtype == torch.bfloat16  # a bfloat16 params tree


def test_fixture_predicts_what_the_jax_facade_stored(monkeypatch):
    monkeypatch.chdir(REPO)  # meta.json names its user YAML by a path relative to the repo
    ref = np.load(PREDICTIONS)
    rng = np.random.RandomState(int(ref["seed"]))
    imgs = [rng.randint(0, 256, tuple(s), np.uint8) for s in ref["shapes"]]
    yolo = YOLO(FIXTURE, device="cpu")
    assert yolo.names == {0: "red", 1: "green", 2: "blue"} and not yolo.folded
    res = yolo.predict(imgs, imgsz=int(ref["imgsz"]), conf=float(ref["conf"]), batch=len(imgs))
    assert [len(r) for r in res] == ref["det_counts"].tolist()
    det = np.concatenate([np.concatenate([r.boxes.xyxy, r.boxes.conf[:, None], r.boxes.cls[:, None]], 1)
                          for r in res])
    np.testing.assert_array_equal(det[:, 5], ref["det"][:, 5])
    np.testing.assert_allclose(det[:, :4], ref["det"][:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(det[:, 4], ref["det"][:, 4], rtol=0, atol=1e-5)
    x = np.stack([letterbox(im, int(ref["imgsz"]), scaleup=False)[0][..., ::-1] for im in imgs])
    with torch.no_grad():
        preds = yolo.model.eval()(torch.from_numpy(x.astype(np.float32) / 255).permute(0, 3, 1, 2))["preds"]
    assert np.abs(preds.numpy() - ref["preds"]).max() <= 1e-5 * np.abs(ref["preds"]).max()
    again = YOLO("tests/fixtures/yolo11-fce-narrow.yaml", device="cpu").fuse().load(FIXTURE)
    assert not again.folded  # a folded facade takes an unfolded tree by building anew
    assert all(torch.equal(a, b) for a, b in zip(again.model.state_dict().values(), yolo.model.state_dict().values()))


@pytest.fixture(scope="module")
def last_style(fixture_tree, tmp_path_factory):
    """A ``last``-style checkpoint as ``YOLO.train`` writes it
    (``fce_yolo_tpu/api.py:835-841``): params, batch_stats and the flattened
    train state (AdamW moments in float32, int32 step counts, scalars), of
    the fixture's first six layers."""
    import optax

    tree, meta = fixture_tree
    keep = [f"layers_{i}" for i in range(6)]
    params = {k: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree["params"][k]) for k in keep}
    stats = {k: tree["batch_stats"][k] for k in keep if k in tree["batch_stats"]}
    state = optax.adamw(1e-3).init(params)
    flat = jax.tree_util.tree_leaves((params, state, np.float32(0.5), np.int32(3)))
    path = tmp_path_factory.mktemp("last") / "last"
    save_checkpoint(str(path), {"params": params, "batch_stats": stats,
                                "train_state_leaves": {str(i): x for i, x in enumerate(flat)}}, meta)
    return path


def test_last_style_tree_reads_leaf_for_leaf(last_style, monkeypatch):
    ref, _ = load_checkpoint(str(last_style))
    got, _ = load_jax_checkpoint(last_style, collections=None, device="cpu")
    assert _same_trees(ref, got) > 100
    assert {np.asarray(x).dtype for x in ref["train_state_leaves"].values()} >= {np.dtype(np.int32)}
    read = []
    real = zarr.read_array
    monkeypatch.setattr(zarr, "read_array", lambda store, name, device="cpu": read.append(name) or
                        real(store, name, device))
    params_only, _ = load_jax_checkpoint(last_style, device="cpu")
    assert set(params_only) == {"params", "batch_stats"}
    assert read and not any(n.startswith("train_state_leaves") for n in read)  # never decoded
    _same_trees({k: ref[k] for k in ("params", "batch_stats")}, params_only)


@pytest.mark.parametrize("where", ["manifest", "root node", "process 0 manifest"])
def test_one_corrupted_byte_raises_naming_the_file(tmp_path, where):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(FIXTURE, ckpt)
    tree = ckpt / "tree"
    target = {"manifest": tree / "manifest.ocdbt", "root node": next((tree / "d").iterdir()),
              "process 0 manifest": tree / "ocdbt.process_0" / "manifest.ocdbt"}[where]
    data = bytearray(target.read_bytes())
    data[len(data) // 2] ^= 0x10
    target.write_bytes(bytes(data))
    store_root = target.parent if where != "root node" else tree
    with pytest.raises(ValueError, match=rf"{target.name}.*CRC-32C mismatch"):
        ocdbt.OcdbtStore(store_root)
    if where != "process 0 manifest":  # the process database is not on the checkpoint's read path
        with pytest.raises(ValueError, match="CRC-32C mismatch"):
            load_jax_checkpoint(ckpt, device="cpu")


def test_a_zarr3_tree_raises_naming_it(tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(FIXTURE, ckpt)
    md = json.loads((ckpt / "tree" / "_METADATA").read_text())
    md["use_zarr3"] = True
    (ckpt / "tree" / "_METADATA").write_text(json.dumps(md))
    with pytest.raises(ValueError, match="zarr3"):
        load_jax_checkpoint(ckpt, device="cpu")
