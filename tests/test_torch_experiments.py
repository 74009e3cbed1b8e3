"""The port's experiment layer and what it stands on, against the JAX
package: parameter and FLOP counts, the dataset-name registry, the
experiment registry, analysis, packing and weight inspection, and a micro
two-stage ablation of all four variants on the CPU.

Tolerances: parameter counts, tables, zip members and verdicts exact; the
FLOP count within 1% of XLA's cost analysis at 640 px (the two count
different elementwise work; 0.73% apart for yolo11n-fce); inspected
weights and statistics within 1e-6. Training trajectories are not compared
with JAX (AdamW's sign flips on near-zero moments send them apart).
"""

import json
import shutil
import subprocess
import sys
import textwrap
import zipfile
from dataclasses import asdict, replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fce_yolo_tpu.data.dataset import _resolve_dataset_yaml as jax_resolve_dataset_yaml
from fce_yolo_tpu.data.dataset import check_det_dataset as jax_check_det_dataset
from fce_yolo_tpu.experiments import analysis as jax_analysis
from fce_yolo_tpu.experiments import config as jax_config
from fce_yolo_tpu.experiments import inspect_weights as jax_inspect
from fce_yolo_tpu.experiments.pack import pack_results as jax_pack_results
from fce_yolo_tpu.nn.import_torch import state_dict_to_variables
from fce_yolo_tpu.nn.model import estimate_flops as jax_estimate_flops
from fce_yolo_tpu.nn.model import init_variables
from fce_yolo_tpu.nn.model import param_count as jax_param_count
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch import api
from fce_yolo_tpu_torch.data.dataset import REGISTRY, check_det_dataset, resolve_dataset_yaml
from fce_yolo_tpu_torch.experiments import (ABLATION_ORDER, DATASET_PRESETS, MODEL_CONFIGS, StageConfig, TrainConfig,
                                            ablation_table, apply_overrides, best_epoch, detect_stale_runs,
                                            format_table, get_model_config, inspect_checkpoint, inspect_state_dict,
                                            load_results, run_ablation, validate_run)
from fce_yolo_tpu_torch.experiments import config as port_config
from fce_yolo_tpu_torch.experiments.__main__ import main as cli_main
from fce_yolo_tpu_torch.experiments.figures import model_complexity, produce_report
from fce_yolo_tpu_torch.experiments.pack import pack_results
from fce_yolo_tpu_torch.nn.model import build_model, estimate_flops, init_weights, param_count
from test_torch_data import png_copy
from test_torch_modules import jax_detection_model

REPO = Path(__file__).resolve().parent.parent
JAX_DATASETS = REPO / "fce_yolo_tpu" / "cfg" / "datasets"
FAMILIES = ["yolo11", "yolo11-fce", "yolo11-bifpn"]
# the JAX package's dataset YAMLs the port leaves out until it has their heads or channel counts
NOT_DETECT = {"DOTAv1", "DOTAv1.5", "dota8", "ImageNet", "carparts-seg", "coco128-seg", "coco8-seg", "crack-seg",
              "package-seg", "coco-pose", "coco8-pose", "dog-pose", "hand-keypoints", "tiger-pose",
              "coco8-multispectral", "dota8-multispectral", "coco8-grayscale"}

torch.set_num_threads(1)


# ------------------------------------------------------------ counts
@pytest.mark.parametrize("scale", ["n", "s"])
@pytest.mark.parametrize("name", FAMILIES + ["yolo11-seg", "yolo11-pose", "yolo11-obb"])
def test_param_count_matches_jax(name, scale):
    jmodel, _, _ = jax_detection_model(str(REPO / "fce_yolo_tpu" / "cfg" / "models" / f"{name}.yaml"), scale=scale)
    shapes = jax.eval_shape(lambda k: init_variables(jmodel, k, imgsz=64), jax.random.PRNGKey(0))
    model, _, _ = build_model(f"{name}.yaml", scale=scale, device="meta")
    assert param_count(model) == jax_param_count(shapes)


def test_estimate_flops_matches_jax():
    """yolo11n-fce at 640 px: FlopCounterMode on the meta device vs XLA's
    cost analysis (one compile); ``YOLO.info`` reports the same count."""
    jmodel, _, _ = jax_detection_model(str(REPO / "fce_yolo_tpu" / "cfg" / "models" / "yolo11-fce.yaml"), scale="n")
    ref = jax_estimate_flops(jmodel, imgsz=640)
    info = YOLO("yolo11n-fce.yaml", device="cpu").info(flops=True, imgsz=640)
    model, _, _ = build_model("yolo11n-fce.yaml", device="meta")
    assert info["gflops"] == estimate_flops(model, imgsz=640) / 1e9
    assert abs(info["gflops"] * 1e9 - ref) <= 0.01 * ref, (info["gflops"], ref / 1e9)
    assert info["params"] == param_count(model) and info["nc"] == 80 and info["strides"] == (8, 16, 32)


# ------------------------------------------------------------ dataset registry
def test_registry_holds_the_detect_datasets():
    assert {p.stem for p in REGISTRY.glob("*.yaml")} == {p.stem for p in JAX_DATASETS.glob("*.yaml")} - NOT_DETECT


@pytest.mark.parametrize("path", sorted(REGISTRY.glob("*.yaml")), ids=lambda p: p.stem)
def test_registry_copies_are_byte_equal(path):
    assert path.read_bytes() == (JAX_DATASETS / path.name).read_bytes()


def test_dataset_name_resolution(tmp_path):
    """A name, a name.yaml and a path give the same file (the JAX resolver's
    rule); an existing path wins over the registry; an unknown name lists
    the registry."""
    want = resolve_dataset_yaml(REGISTRY / "coco8.yaml")
    assert resolve_dataset_yaml("coco8") == resolve_dataset_yaml("coco8.yaml") == want == REGISTRY / "coco8.yaml"
    assert jax_resolve_dataset_yaml("coco8").read_bytes() == want.read_bytes()
    local = tmp_path / "coco8.yaml"
    local.write_text("path: x\n")
    assert resolve_dataset_yaml(local) == local
    with pytest.raises(FileNotFoundError, match=r"packaged registry \(.*VOC.*coco8"):
        check_det_dataset("no-such-dataset")


@pytest.mark.parametrize("name", ["coco8", "VOC"])
def test_missing_data_raises_without_downloading(name, tmp_path, monkeypatch):
    """Missing data raises with the path to fill under $FY_DATASETS_DIR and
    the YAML's download source (a URL, or VOC's script), as the JAX
    package's message does; no socket is opened."""
    import socket

    def no_network(*a, **k):
        raise AssertionError("check_det_dataset opened a socket")

    monkeypatch.setattr(socket, "socket", no_network)
    monkeypatch.setenv("FY_DATASETS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError) as ref:
        jax_check_det_dataset(name)
    with pytest.raises(FileNotFoundError) as out:
        check_det_dataset(name)
    assert str(out.value) == str(ref.value)
    assert str(tmp_path / name) in str(out.value) and "original source: " in str(out.value)


def test_datasets_dir_default_and_local_data(tmp_path, monkeypatch):
    """Unset $FY_DATASETS_DIR: ``datasets`` in the working directory; data
    next to the YAML wins."""
    monkeypatch.delenv("FY_DATASETS_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "datasets" / "coco8" / "images" / "train").mkdir(parents=True)
    (tmp_path / "datasets" / "coco8" / "images" / "val").mkdir(parents=True)
    d = check_det_dataset("coco8")
    assert d["path"] == str(tmp_path / "datasets" / "coco8") and d["nc"] == 80
    (tmp_path / "mine" / "coco8" / "images" / "val").mkdir(parents=True)
    (tmp_path / "mine" / "coco8" / "images" / "train").mkdir(parents=True)
    shutil.copy(REGISTRY / "coco8.yaml", tmp_path / "mine" / "coco8.yaml")
    assert check_det_dataset(tmp_path / "mine" / "coco8.yaml")["path"] == str(tmp_path / "mine" / "coco8")


# ------------------------------------------------------------ experiment registry, analysis, pack
def test_config_matches_jax():
    assert list(MODEL_CONFIGS) == ABLATION_ORDER == jax_config.ABLATION_ORDER
    for name, mc in MODEL_CONFIGS.items():
        ref = jax_config.get_model_config(name)
        assert {k: v for k, v in asdict(mc).items() if k != "display_name"} == \
            {k: v for k, v in asdict(ref).items() if k != "display_name"}
        for scale in "nsmlx":
            assert mc.get_display_name(scale) == ref.get_display_name(scale)
            for stage in (None, 1, 2):
                assert mc.get_result_path(scale, stage) == ref.get_result_path(scale, stage)
    for name, preset in DATASET_PRESETS.items():
        assert preset.to_train_kwargs() == jax_config.get_dataset_preset(name).to_train_kwargs()
    overrides = {"batch": 64, "lr0": 0.005, "epochs": 10, "custom_flag": 1, "imgsz": None}
    for stage1 in (None, StageConfig(epochs=50)):
        out = apply_overrides(replace(DATASET_PRESETS["coco"], stage1=stage1), overrides)
        ref = jax_config.apply_overrides(replace(jax_config.DATASET_PRESETS["coco"], stage1=stage1), overrides)
        assert asdict(out) == asdict(ref)
    with pytest.raises(ValueError, match="unknown model type"):
        get_model_config("nope")


def _write_runs(root: Path) -> dict:
    """Three runs' results.csv in the port trainer's columns, seeded values."""
    rng = np.random.RandomState(0)
    runs = {}
    for name, n in (("baseline", 4), ("bifpn", 3), ("fce", 5)):
        run = root / name
        (run / "weights" / "best").mkdir(parents=True)
        (run / "weights" / "best" / "meta.json").write_text(json.dumps({"train_args": {"iou_type": "CIoU"}}))
        (run / "weights" / "best" / "tensors.pt").write_bytes(b"x" * 16)
        rows = ["epoch,time,train/box_loss,metrics/precision(B),metrics/recall(B),metrics/mAP50(B),"
                "metrics/mAP50-95(B),fitness"]
        for e in range(n):
            p, r, m50, m = rng.uniform(0, 1, 4)
            rows.append(f"{e},{e * 1.5 + 0.25},{rng.uniform(1, 3)},{p},{r},{m50},{m},{0.1 * m50 + 0.9 * m}")
        (run / "results.csv").write_text("\n".join(rows) + "\n")
        runs[name] = run
    return runs


def test_analysis_and_format_table_match_jax(tmp_path):
    runs = _write_runs(tmp_path)
    for run in runs.values():
        rows = load_results(run)
        assert rows == jax_analysis.load_results(run)
        assert best_epoch(rows) == jax_analysis.best_epoch(rows)
    for base in (None, "bifpn"):
        table = ablation_table(runs, baseline=base)
        assert table == jax_analysis.ablation_table(runs, baseline=base)
        assert format_table(table) == jax_analysis.format_table(table)
    assert format_table([]) == jax_analysis.format_table([])


@pytest.mark.parametrize("include_weights", [False, True])
def test_pack_matches_jax(tmp_path, include_weights):
    runs = _write_runs(tmp_path / "runs")
    runs["missing"] = tmp_path / "runs" / "missing"
    out = pack_results(runs, tmp_path / "port.zip", include_weights=include_weights)
    ref = jax_pack_results(runs, tmp_path / "jax.zip", include_weights=include_weights)
    with zipfile.ZipFile(out) as a, zipfile.ZipFile(ref) as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for m in a.namelist():
            assert a.read(m) == b.read(m), m


# ------------------------------------------------------------ inspect
@pytest.mark.parametrize("name", ["yolo11-fce", "yolo11-bifpn"])
def test_inspect_matches_jax(name):
    """On the same bridged weights: BiFPN fusion weights, their deviation and
    verdicts as JAX's; BiCoordCrossAtt statistics as JAX's ``_tensor_stats``
    of the same kernels (the JAX report itself finds no such layer: it looks
    for ``out_h/kernel`` where its tree holds ``out_h/conv2d/kernel``)."""
    model, _, _ = build_model(f"{name}.yaml", scale="n", device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # fusion weights of every kind: near-uniform, slight and strong preference, a negative
        for i, w in enumerate(p for k, p in model.named_parameters() if k.endswith(".w")):
            w.copy_(1.0 + torch.tensor([0.01, 0.2, 3.0, -0.5])[i % 4] * torch.rand(w.shape, generator=gen))
    sd = model.state_dict()
    v = state_dict_to_variables({k: t.numpy() for k, t in sd.items()})
    rep, ref = inspect_state_dict(sd), jax_inspect.inspect_variables(v)

    assert len(rep["bifpn"]) == 4
    assert {k.replace("model.", "layers_").replace(".w", "/w") for k in rep["bifpn"]} == set(ref["bifpn"])
    for key, info in rep["bifpn"].items():
        r = ref["bifpn"][key.replace("model.", "layers_").replace(".w", "/w")]
        assert info["verdict"] == r["verdict"]
        for k in ("raw", "normalized"):
            np.testing.assert_allclose(info[k], r[k], rtol=0, atol=1e-6)
        assert abs(info["max_dev_from_uniform"] - r["max_dev_from_uniform"]) <= 1e-6
    assert {i["verdict"].split()[0] for i in rep["bifpn"].values()} >= {"strong", "≈"}

    assert ref["bicoord"] == {}
    flat = {layer: {tag: {"kernel": t["conv2d"]["kernel"]} for tag, t in sub.items()
                    if isinstance(t, dict) and "conv2d" in t}
            for layer, sub in v["params"].items()}
    want = jax_inspect.bicoord_gate_stats(flat)
    assert len(rep["bicoord"]) == len(want) == (2 if name == "yolo11-fce" else 0)
    for layer, stats in rep["bicoord"].items():
        r = want[layer.replace("model.", "layers_")]
        assert stats.keys() == r.keys()
        for tag, s in stats.items():
            o, i, kh, kw = s["shape"]
            assert r[tag]["shape"] == [kh, kw, i, o]
            for k in ("mean", "std", "l2"):
                assert abs(s[k] - r[tag][k]) <= 1e-6, (layer, tag, k)


# ------------------------------------------------------------ the fold repair with training
@pytest.fixture(scope="module")
def png_dataset(tiny_dataset, tmp_path_factory):
    return png_copy(tiny_dataset, tmp_path_factory.mktemp("tinydet_png"))


def test_predict_then_train_keeps_batchnorm(png_dataset, tmp_path):
    """``predict`` leaves the facade's model unfolded, so a later ``train``
    trains the graph with BatchNorm (its running statistics move) and the
    checkpoints hold it; a folded facade refuses to train."""
    y = YOLO("yolo11n-fce.yaml", device="cpu")
    y.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64)
    assert not y.folded
    var0 = y.model.model[0].bn.running_var.clone()
    res = y.train(png_dataset, epochs=1, batch=4, imgsz=64, mosaic=0.0, warmup_epochs=0.0, val=False,
                  project=str(tmp_path), verbose=False)
    assert isinstance(y.model.model[0].bn, torch.nn.BatchNorm2d)
    assert not torch.equal(y.model.model[0].bn.running_var, var0)
    last = YOLO(str(Path(res["save_dir"]) / "weights" / "last"), device="cpu")
    assert not last.folded and any(".bn." in k for k in last.model.state_dict())
    with pytest.raises(RuntimeError, match="folded"):
        y.fuse().train(png_dataset, epochs=1, batch=4, imgsz=64, project=str(tmp_path), verbose=False)


# ------------------------------------------------------------ the micro ablation
MICRO = dict(stage1=StageConfig(epochs=1, patience=50, lr0=0.001, cos_lr=True, close_mosaic=0),
             stage2=StageConfig(epochs=1, patience=50, lr0=0.001, cos_lr=True, close_mosaic=0))


@pytest.fixture(scope="module")
def ablation(png_dataset, tmp_path_factory):
    """All four variants at n, 64 px, B=4, stage 1 + stage 2 of one epoch
    each, on the tiny PNG dataset (8 train, 4 val images), after a stale
    directory is planted. Records each stage-2 model's state_dict as
    ``YOLO.train`` starts."""
    project = tmp_path_factory.mktemp("ablation")
    stale = project / "fce_n_stage1"
    stale.mkdir()
    (stale / "leftover.txt").write_text("stale")
    cfg = TrainConfig(data=png_dataset, batch=4, imgsz=64, workers=2, project=str(project), verbose=False,
                      extra_args={"mosaic": 0.0, "warmup_epochs": 0.0})
    starts, real_train = {}, api.YOLO.train

    def recording_train(self, *args, **kw):
        if kw["name"].endswith("_stage2"):
            starts[kw["name"]] = {k: t.clone() for k, t in self.model.state_dict().items()}
        return real_train(self, *args, **kw)

    mp = pytest.MonkeyPatch()
    try:
        for name in ABLATION_ORDER:
            mp.setitem(port_config.MODEL_CONFIGS, name, replace(MODEL_CONFIGS[name], **MICRO))
        mp.setattr(api.YOLO, "train", recording_train)
        found = detect_stale_runs(project, ["fce_n_stage1", "fce_n_stage2"])
        report = run_ablation(cfg, scale="n", clean=True, verbose=False, device="cpu")
        again = run_ablation(cfg, scale="n", verbose=False, device="cpu")  # every run reused
    finally:
        mp.undo()
    return {"project": project, "report": report, "again": again, "starts": starts, "stale_found": found}


def test_ablation_runs_the_two_stage_recipe(ablation):
    project, report = ablation["project"], ablation["report"]
    assert ablation["stale_found"] == [str(project / "fce_n_stage1")]
    assert not (project / "fce_n_stage1" / "leftover.txt").exists()  # cleaned before training
    assert report["problems"] == [] and ablation["again"]["problems"] == []
    assert set(report["summaries"]) == set(ABLATION_ORDER) and ablation["again"]["summaries"] == {}
    for name in ABLATION_ORDER:
        mc = MODEL_CONFIGS[name]
        for stage in (1, 2):
            run = project / mc.get_result_path("n", stage=stage)
            assert report["summaries"][name][f"stage{stage}"]["save_dir"] == str(run)
            assert len(load_results(run)) == 1 and (run / "weights" / "best" / "meta.json").exists()
        assert report["runs"][name] == str(project / mc.get_result_path("n"))
        meta = json.loads((project / mc.get_result_path("n") / "weights" / "best" / "meta.json").read_text())
        assert meta["train_args"]["iou_type"] == ("WIoU" if name == "fce_wiou" else "CIoU")
        assert meta["cfg_yaml"] == f"yolo11n{mc.yaml_path.removeprefix('yolo11')}"
        assert validate_run(project / mc.get_result_path("n"), 1, mc.iou_type) == []
    assert validate_run(project / "baseline_yolo11n_stage2", 1, "WIoU")[0].endswith("expected WIoU")
    saved = json.loads((project / "ablation_n.json").read_text())
    assert len(saved["table"]) == 4 and saved["table"] == report["table"]


def test_stage2_starts_bit_equal_from_stage1_best(ablation):
    from fce_yolo_tpu_torch.utils.checkpoint import load_checkpoint

    project = ablation["project"]
    assert set(ablation["starts"]) == {MODEL_CONFIGS[n].get_result_path("n") for n in ABLATION_ORDER}
    for name in ABLATION_ORDER:
        mc = MODEL_CONFIGS[name]
        best, _ = load_checkpoint(project / mc.get_result_path("n", stage=1) / "weights" / "best")
        start = ablation["starts"][mc.get_result_path("n")]
        assert start.keys() == best["model"].keys()
        for k, t in best["model"].items():
            assert torch.equal(start[k], t), (name, k)


def test_ablation_table_matches_jax(ablation):
    runs = ablation["report"]["runs"]
    assert ablation["report"]["table"] == jax_analysis.ablation_table(runs, baseline="baseline")
    assert [r["model"] for r in ablation["report"]["table"]] == ABLATION_ORDER


def test_inspect_checkpoint_of_the_ablation(ablation, capsys):
    """The CLI's ``inspect`` on fce's and bifpn's best: every BiFPN_Concat
    layer's fusion weights finite."""
    project = ablation["project"]
    for name, n_bicoord in (("fce", 2), ("bifpn", 0)):
        path = project / MODEL_CONFIGS[name].get_result_path("n") / "weights" / "best"
        rep = cli_main(["inspect", str(path)])
        assert rep == inspect_checkpoint(str(path), verbose=False)
        assert len(rep["bifpn"]) == 4 and len(rep["bicoord"]) == n_bicoord
        assert all(np.isfinite(i["raw"]).all() for i in rep["bifpn"].values())
        assert rep["meta"]["epoch"] == 0 and rep["meta"]["scale"] == "n"
    assert "[BiFPN]" in capsys.readouterr().out


def test_report_tables_and_figures(ablation, tmp_path):
    """The tables (params and GFLOPs filled from each variant's YAML) and
    the three figures; ``model_complexity`` counts as ``param_count`` and
    ``estimate_flops`` do."""
    runs = ablation["report"]["runs"]
    out = produce_report(runs, tmp_path, langs=("en",), scale="n", imgsz=64, verbose=False)
    assert out["skipped"] == {}
    assert {Path(p).name for p in out["written"]} == {"ablation_table_en.md", "metric_panels_en.png",
                                                      "ablation_bars.png", "training_curves.png"}
    assert all(Path(p).stat().st_size > 0 for p in out["written"])
    rows = (tmp_path / "ablation_table_en.csv").read_text(encoding="utf-8-sig").splitlines()
    assert len(rows) == 5 and "N/A" not in "".join(rows)
    cx = model_complexity({"bifpn": "yolo11-bifpn.yaml"}, scale="n", imgsz=64)[0]
    model, _, _ = build_model("yolo11n-bifpn.yaml", device="meta")
    assert cx == {"model": "bifpn", "params_M": param_count(model) / 1e6,
                  "GFLOPs": estimate_flops(model, imgsz=64) / 1e9}


def test_cli_without_jax_matplotlib_or_pil(ablation, tmp_path):
    """As on the card machine (no jax, cv2, PIL, yaml or matplotlib): the
    experiments modules import, ``figures`` writes both tables, the four
    paper figures and each run's ``results.png``, and skips nothing;
    ``train`` on the default device raises without CUDA."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "jaxlib", "flax", "cv2", "PIL", "yaml", "matplotlib", "fce_yolo_tpu"):
            sys.modules[m] = None
        import torch
        torch.set_num_threads(1)  # one thread, as in the test workers
        from fce_yolo_tpu_torch.experiments.__main__ import main
        rep = main(["figures", "--project", sys.argv[1], "--scale", "n", "--out", sys.argv[2]])
        names = sorted(p.rsplit("/", 1)[1] for p in rep["written"])
        assert names == sorted(["ablation_table_cn.md", "ablation_table_en.md", "metric_panels_en.png",
                                "metric_panels_cn.png", "ablation_bars.png", "training_curves.png"]
                               + ["results.png"] * (len(names) - 6)), names
        assert len(names) > 6 and rep["skipped"] == {}
        try:
            main(["train", "fce", "--data", "coco8"])
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("train ran without CUDA")
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code, str(ablation["project"]), str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "did not draw" not in out.stdout and out.stdout.strip().endswith("ok")
