"""The port's hyperparameter evolution (``fce_yolo_tpu_torch/engine/tuner.py``)
against the JAX package's (``fce_yolo_tpu/engine/tuner.py:48-161``): from
the same seed and the same fitness function (``tests/test_tuner.py``'s
``quadratic_fitness``), the same ``tune_results.csv`` row for row and the
same ``best_hyperparameters.yaml``, a resumed search continuing the same
way, a failed run scored 0; then ``YOLO.tune`` and one real short training
of the port on the CPU."""

from pathlib import Path

import pytest

from fce_yolo_tpu.engine.tuner import DEFAULT_SPACE as JAX_SPACE
from fce_yolo_tpu.engine.tuner import Tuner as JaxTuner
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.engine import tuner as T
from test_tuner import quadratic_fitness

NARROW = str(Path(__file__).resolve().parent / "fixtures" / "yolo11-fce-narrow.yaml")
SPACES = {"two_genes": {"lr0": (1e-5, 1e-1), "mosaic": (0.0, 1.0)}, "default": T.DEFAULT_SPACE}


def test_default_space_equals_the_jax_one():
    assert T.DEFAULT_SPACE == JAX_SPACE


@pytest.mark.parametrize("space,seed,iterations", [("two_genes", 0, 25), ("default", 7, 12)])
def test_csv_row_for_row_as_the_jax_tuner(space, seed, iterations, tmp_path):
    out = {}
    for name, cls in (("jax", JaxTuner), ("port", T.Tuner)):
        t = cls(space=SPACES[space], tune_dir=str(tmp_path / name), train_fn=quadratic_fitness, seed=seed,
                base_args={"lr0": 0.0005, "mosaic": 0.1})
        out[name] = t(iterations=iterations, verbose=False)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    rows = (port_dir / "tune_results.csv").read_text().splitlines()
    assert rows == (jax_dir / "tune_results.csv").read_text().splitlines() and len(rows) == 1 + iterations
    assert (port_dir / "best_hyperparameters.yaml").read_text() == (jax_dir / "best_hyperparameters.yaml").read_text()
    assert out["port"]["best_fitness"] == out["jax"]["best_fitness"] > quadratic_fitness({"lr0": 0.0005, "mosaic": 0.1})
    assert out["port"]["best_hyp"] == out["jax"]["best_hyp"]
    assert sorted(Path(p).name for p in out["port"]["plots"]) == ["tune_fitness.png", "tune_scatter_plots.png"]
    assert all(Path(p).stat().st_size > 1000 for p in out["port"]["plots"])

    # resumable: a second tuner of another seed continues from each CSV
    for name, cls in (("jax", JaxTuner), ("port", T.Tuner)):
        cls(space=SPACES[space], tune_dir=str(tmp_path / name), train_fn=quadratic_fitness, seed=1)(
            iterations=3, verbose=False)
    rows = (port_dir / "tune_results.csv").read_text().splitlines()
    assert rows == (jax_dir / "tune_results.csv").read_text().splitlines() and len(rows) == 1 + iterations + 3


def test_failed_run_scores_zero_and_the_search_goes_on(tmp_path):
    def boom(hyp):
        raise RuntimeError("x")

    out = {}
    for name, cls in (("jax", JaxTuner), ("port", T.Tuner)):
        out[name] = cls(space={"lr0": (1e-5, 1e-1)}, tune_dir=str(tmp_path / name), train_fn=boom)(
            iterations=2, verbose=False)
    assert out["port"]["best_fitness"] == out["jax"]["best_fitness"] == 0.0
    assert (tmp_path / "port" / "tune_results.csv").read_text() == (tmp_path / "jax" / "tune_results.csv").read_text()


def test_facade_tune_passes_model_data_and_device(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the tuner writes runs/tune under the working directory
    seen = {}

    def fake_train_once(self, hyp, it, cleanup):
        seen.update(self.base_args)
        return 1.0 - abs(hyp["lr0"] - 0.01)

    monkeypatch.setattr(T.Tuner, "_train_once", fake_train_once)
    y = YOLO("yolo11n.yaml", device="cpu", nc=3)
    out = y.tune(data="fake.yaml", space={"lr0": (1e-4, 1e-1)}, iterations=3, epochs=1)
    assert out["best_fitness"] > 0 and (tmp_path / "runs" / "tune" / "tune_results.csv").exists()
    assert seen == {"model": "yolo11n.yaml", "data": "fake.yaml", "device": y.device, "epochs": 1}


def test_one_real_training_iteration(tiny_dataset, tmp_path, monkeypatch):
    """``_train_once``: the port's ``YOLO.train`` of the base model on the
    CPU with the mutated genes, run to its end (the tuner would score a
    failed run 0 and go on); the run directory is removed after."""
    from test_torch_data import png_copy

    runs = []
    real = YOLO.train
    monkeypatch.setattr(YOLO, "train", lambda self, *a, **kw: runs.append((kw, real(self, *a, **kw))) or runs[-1][1])
    data = png_copy(tiny_dataset, tmp_path / "data")
    t = T.Tuner(space={"lr0": (1e-5, 1e-1), "mosaic": (0.0, 1.0)}, tune_dir=str(tmp_path / "tune"),
                base_args={"model": NARROW, "data": data, "epochs": 1, "imgsz": 64, "batch": 4, "workers": 0,
                           "plots": False, "device": "cpu"})
    out = t(iterations=1, verbose=False)
    rows = (tmp_path / "tune" / "tune_results.csv").read_text().splitlines()
    assert rows[0] == "fitness,lr0,mosaic" and len(rows) == 2 and 0 <= out["best_fitness"] <= 1
    (kw, res), = runs
    assert res["epochs_run"] == 1 and float(rows[1].split(",")[0]) == round(max(res["best_fitness"], 0.0), 5)
    assert (kw["lr0"], kw["mosaic"]) == (out["best_hyp"]["lr0"], out["best_hyp"]["mosaic"]) == (0.050005, 0.5)
    assert not (tmp_path / "tune" / "iter0").exists()


def test_run_ray_tune_without_ray():
    try:
        import ray  # noqa: F401
        pytest.skip("ray is installed")
    except ImportError:
        pass
    with pytest.raises(ModuleNotFoundError, match="built-in"):
        T.run_ray_tune(model=None)
    with pytest.raises(ModuleNotFoundError, match="built-in"):
        YOLO("yolo11n.yaml", device="cpu").tune(data="x.yaml", use_ray=True)
