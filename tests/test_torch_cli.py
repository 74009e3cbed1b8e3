"""The port's command line (``fce_yolo_tpu_torch/cfg/__init__.py::entrypoint``,
``python -m fce_yolo_tpu_torch``) against the JAX package's
(``fce_yolo_tpu/cfg/__init__.py:226-373``), on the CPU (``device=cpu``).

- val and predict on the JAX facade's ``save`` of seeded weights (a narrow
  yolo11-fce, ``tests/fixtures/yolo11-fce-narrow.yaml``; the head's DFL bin
  2 and classes 0-2 raised so that boxes match the labels): the same
  metrics within 1e-4, the same detections (classes equal, scores within
  1e-4, boxes within 1e-3 px), the same files written, and ``save_txt``
  labels with the same rows (classes equal, normalised coordinates within
  1e-5: they are printed to 6 digits from boxes 1e-4 px apart);
- track with ``save=True`` (the same tracks, one annotated frame each);
- a five-task train -> val -> predict matrix through the port's CLI at 64
  px, one epoch (``tests/test_cli.py:32-77``'s, for the port);
- ROADMAP queue 3, item 30: the train branch passes ``resume``, ``freeze``,
  ``exist_ok``, ``time``, ``plots`` and ``copy_paste``, which the JAX CLI
  accepts and drops;
- the grammar (help, a bad argument, no mode, bare bool flags, ``cfg=``
  files), the special commands, ``benchmark`` (the native row, the
  ``torch_export`` row and the TensorFlow rows ``FAILED``), and the
  refusals: ``export`` to a TensorFlow format, more than one card, the card
  without CUDA (``solutions`` too; the mode itself is held against the JAX
  CLI in ``tests/test_torch_solutions.py``).

The JAX facades build with the known strides (8, 16, 32) instead of their
stride probe, a test-side speed-up that changes no value.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fce_yolo_tpu.nn.model as jax_model
import fce_yolo_tpu_torch
import fce_yolo_tpu_torch.utils.settings as port_settings
from fce_yolo_tpu.api import YOLO as JaxYOLO
from fce_yolo_tpu.cfg import HELP_MSG as JAX_HELP
from fce_yolo_tpu.cfg import entrypoint as jax_entrypoint
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.cfg import DEFAULT_CFG_PATH, HELP_MSG, entrypoint
from fce_yolo_tpu_torch.data.imread import imread
from fce_yolo_tpu_torch.nn.model import init_weights
from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables
from test_torch_data import png_copy

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
NARROW = str(REPO / "tests" / "fixtures" / "yolo11-fce-narrow.yaml")
NAMES = {0: "circle", 1: "square", 2: "tri"}  # tiny_dataset's


@pytest.fixture(scope="module", autouse=True)
def known_strides():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_model, "resolve_strides", lambda spec: () if spec.task == "classify" else (8, 16, 32))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The JAX facade's ``save`` of the narrow model with seeded weights
    (``test_torch_weights_in.py::_seeded``), its head raised so that some
    boxes match tiny_dataset's labels (mAP above zero)."""
    port = YOLO(NARROW, device="cpu", nc=3)
    g = torch.Generator().manual_seed(0)
    init_weights(port.model, g, bias_prior=False)
    with torch.no_grad():
        for m in port.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
        for branch in port.model.detect.cv2:
            branch[-1].bias[2::16] += 6.0  # sides ~2 strides
        for branch in port.model.detect.cv3:
            branch[-1].bias[:3] += 1.0
    jy = JaxYOLO(NARROW, nc=3)
    jy.variables = jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(port.model))
    jy.names = dict(NAMES)
    d = tmp_path_factory.mktemp("cli_ckpt") / "narrow"
    jy.save(str(d))
    return str(d)


def _val_dir(data: str) -> Path:
    from fce_yolo_tpu_torch.utils.yaml_read import read_yaml

    d = read_yaml(Path(data).read_text())
    return Path(d["path"]) / d["val"]


# ------------------------------------------------------------------ parity with the JAX CLI
def test_val_matches_the_jax_cli(jax_ckpt, tiny_dataset):
    args = ["detect", "val", f"model={jax_ckpt}", f"data={tiny_dataset}", "imgsz=128", "batch=4", "verbose=False",
            "device=cpu"]
    ref, out = jax_entrypoint(args), entrypoint(args)
    assert list(out) == list(ref) and ref["metrics/mAP50(B)"] > 0
    for k in ref:
        assert abs(out[k] - ref[k]) <= 1e-4, (k, out[k], ref[k])


def _labels(path: Path) -> list[np.ndarray]:
    return [np.array(line.split(), float) for line in path.read_text().splitlines()]


def test_predict_with_saves_matches_the_jax_cli(jax_ckpt, tiny_dataset, tmp_path):
    src = _val_dir(tiny_dataset)
    common = ["detect", "predict", f"model={jax_ckpt}", f"source={src}", "imgsz=128", "conf=0.75", "verbose=False",
              "save=True", "save_txt", "save_crop=True", "name=p"]
    ref = jax_entrypoint([*common, f"project={tmp_path / 'jax'}"])
    out = entrypoint([*common, f"project={tmp_path / 'port'}", "device=cpu"])
    assert len(out) == len(ref) == 4
    for r, o in zip(ref, out):
        assert o.path == r.path and len(o) == len(r) > 0
        np.testing.assert_array_equal(o.boxes.cls, r.boxes.cls)
        np.testing.assert_allclose(o.boxes.conf, r.boxes.conf, rtol=0, atol=1e-4)
        np.testing.assert_allclose(o.boxes.xyxy, r.boxes.xyxy, rtol=0, atol=1e-3)
    jax_dir, port_dir = tmp_path / "jax" / "p", tmp_path / "port" / "p"
    files = sorted(str(p.relative_to(jax_dir)) for p in jax_dir.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(port_dir)) for p in port_dir.rglob("*") if p.is_file())
    assert len(files) == 4 + 4 + sum(len(r) for r in ref)  # plots, labels, crops
    for f in files:
        if f.endswith(".txt"):
            a, b = _labels(jax_dir / f), _labels(port_dir / f)
            assert len(a) == len(b) > 0
            for ra, rb in zip(a, b):
                assert ra[0] == rb[0] and np.abs(ra[1:] - rb[1:]).max() <= 1e-5, (f, ra, rb)
        else:
            import cv2

            assert imread(port_dir / f, device="cpu").shape == cv2.imread(str(jax_dir / f)).shape, f


def test_track_save_matches_the_jax_cli(jax_ckpt, tiny_dataset, tmp_path):
    common = ["detect", "track", f"model={jax_ckpt}", f"source={_val_dir(tiny_dataset)}", "imgsz=128",
              "conf=0.75", "save=True", "name=t"]
    ref = jax_entrypoint([*common, f"project={tmp_path / 'jax'}"])
    out = entrypoint([*common, f"project={tmp_path / 'port'}", "device=cpu"])
    assert len(out) == len(ref) == 4
    for (_, a), (_, b) in zip(ref, out):
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_array_equal(a[:, [4, 6]], b[:, [4, 6]])  # ids and classes
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
    frames = sorted(p.name for p in (tmp_path / "port" / "t").glob("*.jpg"))
    assert frames == sorted(p.name for p in (tmp_path / "jax" / "t").glob("*.jpg")) == [f"{i:06d}.jpg" for i in range(4)]
    drawn = imread(tmp_path / "port" / "t" / frames[0], device="cpu")
    assert drawn.shape == out[0][0].orig_img.shape and (np.abs(drawn.astype(int) - out[0][0].orig_img).max() > 100)


# ------------------------------------------------------------------ the port's CLI, every task
@pytest.fixture(scope="module")
def task_data(tiny_dataset, tiny_seg_dataset, tiny_pose_dataset, tiny_obb_dataset, tiny_cls_dataset,
              tmp_path_factory):
    return {"detect": png_copy(tiny_dataset, tmp_path_factory.mktemp("cli_det")),
            "segment": png_copy(tiny_seg_dataset, tmp_path_factory.mktemp("cli_seg")),
            "pose": png_copy(tiny_pose_dataset, tmp_path_factory.mktemp("cli_pose")),
            "obb": png_copy(tiny_obb_dataset, tmp_path_factory.mktemp("cli_obb")),
            "classify": tiny_cls_dataset}


@pytest.mark.parametrize("task", ["detect", "segment", "pose", "obb", "classify"])
def test_train_val_predict(task, task_data, tmp_path):
    data = task_data[task]
    out = entrypoint([task, "train", f"data={data}", "epochs=1", "batch=4", "imgsz=64", "workers=0", "val=True",
                      "verbose=False", "plots=False", "max_labels=8", f"project={tmp_path}/runs", "device=cpu"])
    assert out["epochs_run"] == 1
    assert not list(Path(out["save_dir"]).glob("*.png")) and not list(Path(out["save_dir"]).glob("*.jpg"))
    best, last = Path(out["save_dir"]) / "weights" / "best", Path(out["save_dir"]) / "weights" / "last"
    ckpt = best if best.exists() else last
    assert (ckpt / "meta.json").exists()

    res = entrypoint([task, "val", f"model={ckpt}", f"data={data}", "imgsz=64", "batch=4", "workers=0",
                      "verbose=False", "device=cpu"])
    assert res and all(isinstance(v, float) for v in res.values())

    img_dir = next(p for p in sorted(Path(data).glob("val/*")) if p.is_dir()) if task == "classify" else \
        _val_dir(data)
    src = sorted(p for p in img_dir.iterdir() if p.suffix in (".jpg", ".png"))[0]
    results = entrypoint([task, "predict", f"model={ckpt}", f"source={src}", "imgsz=64", "conf=0.01",
                          f"project={tmp_path}/runs", "save=True", "save_txt=True", "save_crop=True", "device=cpu"])
    assert len(results) == 1
    r = results[0]
    if task == "classify":
        assert r.probs is not None and 0 <= r.probs.top1 < 2
    else:
        out_dir = tmp_path / "runs" / "predict"
        assert (out_dir / f"{src.stem}.jpg").exists() and (out_dir / "labels" / f"{src.stem}.txt").exists()
        assert len(list((out_dir / "crops").rglob("*.jpg"))) == len(r.boxes)


ITEM30 = ["resume=True", "freeze=3", "exist_ok", "time=0.5", "plots=False", "copy_paste=0.25"]


def test_train_passes_what_the_jax_cli_drops(tiny_dataset, tmp_path, monkeypatch):
    """ROADMAP queue 3, item 30: the JAX CLI's train branch drops six keys
    its ``YOLO.train`` takes; the port passes them (``time`` as
    ``time_limit_hours``) and every other argument as the JAX CLI does."""
    seen = {}
    monkeypatch.setattr(JaxYOLO, "train", lambda self, **kw: seen.setdefault("jax", kw))
    monkeypatch.setattr(YOLO, "train", lambda self, **kw: seen.setdefault("port", kw))
    args = ["detect", "train", f"model={NARROW}", f"data={tiny_dataset}", "lr0=0.02", *ITEM30,
            f"project={tmp_path}"]
    jax_entrypoint(args)
    entrypoint([*args, "device=cpu"])
    ref, out = seen["jax"], seen["port"]
    assert {k: out[k] for k in ref} == ref and ref["lr0"] == 0.02
    assert {k: out[k] for k in set(out) - set(ref)} == {
        "resume": True, "freeze": 3, "exist_ok": True, "time_limit_hours": 0.5, "plots": False, "copy_paste": 0.25}


def test_resume_continues_the_run(task_data, tmp_path):
    common = ["detect", "train", f"model={NARROW}", f"data={task_data['detect']}", "imgsz=64", "batch=4",
              "workers=0", "val=False", "plots=False", "verbose=False", f"project={tmp_path}", "name=r", "device=cpu"]
    first = entrypoint([*common, "epochs=1"])
    again = entrypoint([*common, "epochs=2", "resume"])
    assert again["save_dir"] == first["save_dir"] == str(tmp_path / "r")
    assert [row["epoch"] for row in first["results"]] == [0] and [row["epoch"] for row in again["results"]] == [1]


# ------------------------------------------------------------------ grammar and special commands
def test_help_and_usage_errors(capsys):
    for argv in ([], ["help"], ["-h"], ["--help"]):
        entrypoint(argv)
        assert capsys.readouterr().out.strip() == HELP_MSG.strip()
    assert "yolo-tpu-torch TASK MODE" in HELP_MSG and HELP_MSG != JAX_HELP
    for argv in (["detect", "train", "bogus-token"], ["detect"], ["segment", "epochs=3"]):
        with pytest.raises(SyntaxError) as ref:
            jax_entrypoint(argv)
        with pytest.raises(SyntaxError) as out:
            entrypoint(argv)
        assert str(out.value).split("\n")[0] == str(ref.value).split("\n")[0]
    with pytest.raises(SyntaxError, match="did you mean 'epochs'"):
        entrypoint(["detect", "train", "epoch=3", "device=cpu"])


def test_bare_bool_flags_and_cfg_file(tiny_dataset, tmp_path):
    """``save`` and ``verbose`` bare set True; ``cfg=`` overrides the defaults
    (reference entrypoint:873-900)."""
    img = sorted(_val_dir(tiny_dataset).glob("*.jpg"))[0]
    custom = tmp_path / "custom.yaml"
    custom.write_text("imgsz: 64\nconf: 0.9\nsave: False\n")
    results = entrypoint(["detect", "predict", f"model={NARROW}", f"source={img}", f"cfg={custom}", "verbose",
                          f"project={tmp_path}/runs", "save", "device=cpu"])
    assert len(results) == 1 and results[0].orig_shape == imread(img, device="cpu").shape[:2]
    assert [p.name for p in (tmp_path / "runs" / "predict").glob("*.jpg")] == [f"{img.stem}.jpg"]


def test_special_commands(tmp_path, monkeypatch, capsys):
    assert entrypoint(["version"]) == entrypoint(["--version"]) == fce_yolo_tpu_torch.__version__ == "0.1.0"
    assert capsys.readouterr().out.split() == ["0.1.0", "0.1.0"]
    entrypoint(["cfg"])
    assert capsys.readouterr().out.strip() == DEFAULT_CFG_PATH.read_text().strip()
    monkeypatch.chdir(tmp_path)
    entrypoint(["copy-cfg"])
    assert (tmp_path / "default_copy.yaml").read_text() == DEFAULT_CFG_PATH.read_text()

    monkeypatch.setattr(port_settings, "SETTINGS", port_settings.SettingsManager(tmp_path / "settings.json"))
    assert entrypoint(["settings", "runs_dir=elsewhere", "sync=False"])["runs_dir"] == "elsewhere"
    assert entrypoint(["setting"])["runs_dir"] == "elsewhere"  # persisted; the singular alias
    assert json.loads((tmp_path / "settings.json").read_text())["runs_dir"] == "elsewhere"
    assert entrypoint(["--settings", "reset"])["runs_dir"] == "runs"
    with pytest.raises(KeyError, match="unknown settings"):
        entrypoint(["settings", "bogus=1"])

    info = entrypoint(["checks"])
    assert info["torch"] == torch.__version__ and info["version"] == "0.1.0" and "jax" not in info
    assert info["devices"] == "none (torch.cuda.is_available() is False)" and info["numpy"] == np.__version__
    assert entrypoint(["check"])["cpu"] == info["cpu"]


@pytest.mark.parametrize("mode", ["train", "val", "predict", "track", "benchmark"])
def test_without_device_the_card_is_asked_for(mode):
    with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
        entrypoint(["detect", mode, "model=yolo11n.yaml", "data=x.yaml", "source=x.jpg"])


def test_export_and_solutions_raise_naming_their_items():
    """The refusals that name what they need; ``solutions`` is ported and,
    without ``device=``, asks for the card as every mode does."""
    with pytest.raises(NotImplementedError, match="'tflite' needs TensorFlow"):
        entrypoint(["detect", "export", f"model={NARROW}", "format=tflite", "device=cpu"])
    with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
        entrypoint(["solutions", "count", "source=x.mp4"])
    with pytest.raises(NotImplementedError, match="item 11"):
        entrypoint(["detect", "val", "device=0,1"])


def test_benchmark_mode(capsys):
    rows = entrypoint(["detect", "benchmark", f"model={NARROW}", "imgsz=64", "batch=2", "device=cpu"])
    assert [r["format"] for r in rows] == ["torch (native)", "torch_export", "saved_model", "tflite"]
    assert rows[0]["status"] == "OK" and rows[0]["batch"] == 2 and rows[0]["images/sec"] > 0
    assert rows[1]["status"] == "OK" and rows[1]["batch"] == 1 and rows[1]["images/sec"] > 0
    assert all(r["status"].startswith(f"FAILED: NotImplementedError: '{r['format']}' needs TensorFlow")
               for r in rows[2:])
    assert "torch (native)" in capsys.readouterr().out


def test_python_m_without_jax_or_cv2(tmp_path):
    """``python -m fce_yolo_tpu_torch version`` with JAX, cv2, PIL and pyyaml
    blocked, as on the card machine, and ``cfg`` read without pyyaml."""
    code = textwrap.dedent("""
        import runpy, sys
        for m in ("jax", "jaxlib", "flax", "cv2", "PIL", "yaml", "matplotlib", "fce_yolo_tpu"):
            sys.modules[m] = None
        sys.argv = ["fce_yolo_tpu_torch", "version"]
        runpy.run_module("fce_yolo_tpu_torch", run_name="__main__", alter_sys=True)
        from fce_yolo_tpu_torch.cfg import get_cfg
        print(get_cfg({"epochs": "3"}).epochs)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["0.1.0", "3"]
