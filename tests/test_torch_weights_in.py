"""Weights in: ``YOLO(path)`` and ``YOLO.load(path)`` of the port on the JAX
package's orbax checkpoint directories and on Ultralytics-layout ``.pt``
files, against the JAX facade opening the same files
(``fce_yolo_tpu/api.py:115-170``).

The checkpoints are the JAX facade's own ``save`` of weights seeded in the
port (bridged by ``nn/weights.py::state_dict_to_variables``, BatchNorm
statistics drawn around their usual values), so no flax init runs. The JAX
facades here build with the known strides (8, 16, 32) instead of their
``eval_shape`` stride probe (the port's probe is held to them in
``test_torch_parser.py``), and the JAX ``.pt`` importer takes its shape
template from ``jax.eval_shape`` of the init it runs; both are test-side
speed-ups that change no value.

Tolerance, as ``test_torch_predict.py``: counts and classes exact, boxes,
keypoints and rotated boxes within 1e-3 px, scores within 1e-5, class
probabilities within 1e-5; mask pixels equal but for at most 0.1% (the
0.5 threshold on probabilities float32 rounds apart). Leaves of a checkpoint
are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fce_yolo_tpu.nn.import_torch as jax_import
import fce_yolo_tpu.nn.model as jax_model
from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.utils.checkpoint import load_checkpoint
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.nn.import_torch import import_torch_state_dict, load_pt_state_dict
from fce_yolo_tpu_torch.nn.model import init_weights
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables
from fce_yolo_tpu_torch.utils.checkpoint import load_jax_checkpoint
from test_torch_orbax import REPO, _same_trees

torch.set_num_threads(1)
NAMES = {0: "arm", 1: "gripper", 2: "part"}
JAX_CFG = REPO / "fce_yolo_tpu" / "cfg" / "models"


def _jax_import_with_eval_shape(path_or_sd, model, imgsz: int = 64) -> dict:
    """``import_torch_checkpoint`` (``fce_yolo_tpu/nn/import_torch.py:274``)
    with the template's shapes from ``jax.eval_shape`` of the same init."""
    sd = jax_import.load_pt_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    x = jnp.zeros((1, imgsz, imgsz, 3), jnp.float32)
    template = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=True))
    return jax_import.state_dict_to_variables(sd, template=template)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_facades():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_model, "resolve_strides", lambda spec: () if spec.task == "classify" else (8, 16, 32))
    mp.setattr(jax_import, "import_torch_checkpoint", _jax_import_with_eval_shape)
    yield
    mp.undo()


def _seeded(port: YOLO, seed: int = 0) -> YOLO:
    """Seeded weights without the class prior (scores near 0.5, so NMS has
    work), BatchNorm statistics drawn around their usual values."""
    g = torch.Generator().manual_seed(seed)
    init_weights(port.model, g, bias_prior=False)
    with torch.no_grad():
        for m in port.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
    return port


def _images(seed: int = 0) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, s, np.uint8) for s in ((48, 64, 3), (64, 40, 3))]


def _same_results(ref, out, task: str = "detect") -> None:
    assert len(out) == len(ref) > 0
    for r, o in zip(ref, out):
        if task == "classify":
            np.testing.assert_allclose(o.probs.data, r.probs.data, rtol=0, atol=1e-5)
            continue
        assert len(o) == len(r) > 0
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-5)
        if task == "pose":
            assert o.keypoints.data.shape == r.keypoints.data.shape
            np.testing.assert_allclose(o.keypoints.data, r.keypoints.data, rtol=0, atol=1e-3)
        if task == "obb":
            np.testing.assert_allclose(o.obb.data, r.obb.data, rtol=0, atol=1e-3)
        if task == "segment":
            assert o.masks.data.shape == r.masks.data.shape and r.masks.data.any()
            assert (o.masks.data != r.masks.data).mean() <= 1e-3


# ------------------------------------------------------------------ JAX checkpoints
@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """The JAX facade's ``save`` of yolo11n-fce (3 classes), the same after
    the JAX ``fuse()``, and of a yolo11n-pose rebuilt with a data YAML's
    ``kpt_shape`` (``yaml_overrides``, as ``YOLO.train`` records it)."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    port = _seeded(YOLO("yolo11n-fce.yaml", device="cpu", nc=3))
    jy = JaxYOLO("yolo11n-fce.yaml", nc=3)
    jy.variables = jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(port.model))
    jy.names = dict(NAMES)
    jy.save(str(root / "detect"))
    jy.fuse()
    jy.save(str(root / "fused"))

    pose = YOLO("yolo11n-pose.yaml", device="cpu")
    pose._build("yolo11-pose.yaml", "n", 2, {"kpt_shape": [4, 2]})
    _seeded(pose, 1)
    jp = JaxYOLO(str(JAX_CFG / "yolo11-pose.yaml"))
    jp.scale = "n"
    jp.model, jp.spec, jp.strides = jax_model.build_model({**jp.spec.yaml_dict, "nc": 2, "kpt_shape": [4, 2]},
                                                          scale="n")
    jp.yaml_overrides = {"kpt_shape": [4, 2]}
    jp.names = {0: "a", 1: "b"}
    jp.variables = jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(pose.model))
    jp.save(str(root / "pose"))
    return root


def test_yolo_save_reads_leaf_for_leaf_as_orbax_does(jax_checkpoints):
    ref, meta = load_checkpoint(str(jax_checkpoints / "detect"))
    got, got_meta = load_jax_checkpoint(jax_checkpoints / "detect", collections=None, device="cpu")
    assert got_meta == meta and meta["cfg_yaml"].endswith("fce_yolo_tpu/cfg/models/yolo11-fce.yaml")
    assert _same_trees(ref, got) > 400


def test_jax_checkpoint_predicts_as_the_jax_facade_from_the_same_directory(jax_checkpoints):
    d = str(jax_checkpoints / "detect")
    port = YOLO(d, device="cpu")
    jy = JaxYOLO(d)
    assert (port.cfg_yaml, port.scale, port.nc, port.names) == ("yolo11-fce.yaml", "n", 3, NAMES)
    assert port.ckpt_meta == jy.ckpt_meta and not port.folded
    _same_results(jy.predict(_images(), imgsz=64, batch=2), port.predict(_images(), imgsz=64, batch=2))


def test_load_of_a_checkpoint_saved_after_the_jax_fuse_folds_first(jax_checkpoints):
    """The tree after the JAX ``fuse()`` has conv biases and no ``bn``:
    ``YOLO.load`` folds the model, then loads it; the facade built from the
    directory is folded too."""
    d = str(jax_checkpoints / "fused")
    port = YOLO("yolo11n-fce.yaml", device="cpu", nc=3).load(d)
    assert port.folded and port.names == NAMES
    jy = JaxYOLO(d)
    _same_results(jy.predict(_images(), imgsz=64, batch=2), port.predict(_images(), imgsz=64, batch=2))


def test_pose_checkpoint_with_yaml_overrides(jax_checkpoints):
    d = str(jax_checkpoints / "pose")
    port = YOLO(d, device="cpu")
    jy = JaxYOLO(d)
    assert port.yaml_overrides == jy.yaml_overrides == {"kpt_shape": [4, 2]} and port.task == "pose"
    out = port.predict(_images(), imgsz=64, batch=2)
    assert out[0].keypoints.data.shape[1:] == (4, 2)
    _same_results(jy.predict(_images(), imgsz=64, batch=2), out, "pose")


# ------------------------------------------------------------------ .pt files
def _pt(path, port: YOLO, form: str, flip_upsample: bool = False) -> str:
    """An Ultralytics-layout ``.pt`` of ``port``'s weights: ``{"model": state_dict}``
    or the trainer's ``{"model": fp16, "ema": fp32, ...}``; with a Detect
    head's ``dfl.conv.weight`` and the ``num_batches_tracked`` buffers."""
    sd = {k: v.clone() for k, v in port.model.state_dict().items()}
    head = len(port.model.model) - 1
    if port.task != "classify":
        sd[f"model.{head}.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).view(1, 16, 1, 1)
    if flip_upsample:  # what the JAX reader needs to compute torch's Proto (queue 3, item 14)
        key = f"model.{head}.proto.upsample.weight"
        sd[key] = sd[key].flip(2, 3)
    if form == "model":
        ckpt = {"model": sd}
    else:
        half = {k: v.half() if v.is_floating_point() else v for k, v in sd.items()}
        ckpt = {"model": half, "ema": sd, "epoch": 3, "train_args": {"imgsz": 64}}
    torch.save(ckpt, path)
    return str(path)


PT_MODELS = [("yolo11n-fce", "detect", "model"), ("yolo11n-fce", "detect", "ema"), ("yolo11n-pose", "pose", "ema"),
             ("yolo11n-obb", "obb", "model"), ("yolo11n-cls", "classify", "ema"), ("yolov10n", "detect", "ema")]


@pytest.mark.parametrize("name,task,form", PT_MODELS, ids=[f"{n}-{f}" for n, _, f in PT_MODELS])
def test_pt_file_predicts_as_the_jax_facade(tmp_path, monkeypatch, name, task, form):
    nc = 3 if name == "yolov10n" else None
    port_src = _seeded(YOLO(f"{name}.yaml", device="cpu", nc=nc))
    path = _pt(tmp_path / f"{name}.pt", port_src, form)
    port = YOLO(path, device="cpu", nc=nc)
    assert port.task == task
    ema = port_src.model.state_dict()
    got = port.model.state_dict()
    assert all(torch.equal(got[k], ema[k]) for k in got if not k.endswith("num_batches_tracked"))
    if name == "yolov10n":
        monkeypatch.chdir(JAX_CFG)  # the JAX facade resolves yolov10n.yaml only as a file in the cwd
    jy = JaxYOLO(path, nc=nc)
    kw = {"imgsz": 64, "batch": 2, **({"conf": 0.5} if name == "yolov10n" else {})}
    _same_results(jy.predict(_images(), **kw), port.predict(_images(), **kw), task)


def test_segment_pt_is_read_unflipped_where_jax_needs_the_flip(tmp_path):
    """Queue 3, item 14: the port reads the ``.pt``'s ConvTranspose kernel
    as torch lays it out. The JAX reader gives the same masks only when fed
    the kernel flipped on both spatial axes; fed the file as it is, its
    Proto computes other prototypes (over 1% of their largest value off)."""
    src = _seeded(YOLO("yolo11n-seg.yaml", device="cpu"))
    port = YOLO(_pt(tmp_path / "yolo11n-seg.pt", src, "ema"), device="cpu")
    flipped = tmp_path / "flipped"
    flipped.mkdir()
    jax_flipped = JaxYOLO(_pt(flipped / "yolo11n-seg.pt", src, "ema", flip_upsample=True))
    _same_results(jax_flipped.predict(_images(), imgsz=64, batch=2), port.predict(_images(), imgsz=64, batch=2),
                  "segment")
    as_is = JaxYOLO(str(tmp_path / "yolo11n-seg.pt")).variables
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    proto = jax.jit(lambda v, x: jax_flipped.model.apply(v, x, train=False)["proto"])
    with torch.no_grad():
        ours = port.model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))["proto"].permute(0, 2, 3, 1).numpy()
    ref, other = np.asarray(proto(jax_flipped.variables, x)), np.asarray(proto(as_is, x))
    scale = float(np.abs(ref).max())
    assert np.abs(ours - ref).max() <= 1e-5 * scale
    assert np.abs(other - ref).max() > 1e-2 * scale


def test_bare_state_dict_loads_where_the_jax_reader_raises(tmp_path):
    """Queue 3, item 29: ``torch.save(model.state_dict())`` (no ``model`` /
    ``ema`` entry). The JAX reader's ``ckpt.get("ema") or ckpt.get("model")``
    gives None and ``.items()`` raises; the port loads it."""
    src = _seeded(YOLO("yolo11n-fce.yaml", device="cpu"))
    path = tmp_path / "yolo11n-fce.pt"
    torch.save(src.model.state_dict(), path)
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'items'"):
        jax_import.load_pt_state_dict(str(path))
    sd = load_pt_state_dict(str(path))
    assert all(v.dtype == torch.float32 for v in sd.values())
    port = YOLO(str(path), device="cpu")
    got = port.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in src.model.state_dict().items() if v.is_floating_point())
    again = YOLO("yolo11n-fce.yaml", device="cpu").fuse().load(str(path))
    assert not again.folded and torch.equal(again.model.state_dict()["model.0.conv.weight"],
                                            src.model.state_dict()["model.0.conv.weight"])


def test_pt_refusals_match_the_jax_reader(tmp_path):
    """A file of module objects needs ``allow_unsafe`` (the JAX reader's
    text); keys the port has no module for, or shapes it does not take,
    fail the strict load by name; a ``module.`` prefix is stripped."""
    src = YOLO("yolo11n-fce.yaml", device="cpu")
    unsafe = tmp_path / "module.pt"
    torch.save({"model": torch.nn.Conv2d(3, 4, 1)}, unsafe)
    for reader in (load_pt_state_dict, jax_import.load_pt_state_dict):
        with pytest.raises(ValueError, match="needs full \\(unsafe\\) unpickling"):
            reader(str(unsafe))
    assert set(load_pt_state_dict(str(unsafe), allow_unsafe=True)) == {"weight", "bias"}
    sd = {f"module.{k}": v for k, v in src.model.state_dict().items()}
    model = YOLO("yolo11n-fce.yaml", device="cpu").model
    import_torch_state_dict(sd, model)
    extra = {**src.model.state_dict(), "model.26.dec_score_head.0.weight": torch.zeros(3)}
    with pytest.raises(ValueError, match=r"weight import incomplete; missing=\[\] mismatched=\[\] "
                                         r"unexpected=\['model.26.dec_score_head.0.weight'\]"):
        import_torch_state_dict(extra, model)
    wrong = {**src.model.state_dict(), "model.0.conv.weight": torch.zeros(8, 3, 3, 3)}
    del wrong["model.1.conv.weight"]
    with pytest.raises(ValueError, match=r"missing=\['model.1.conv.weight'\] mismatched=\['model.0.conv.weight"):
        import_torch_state_dict(wrong, model)
