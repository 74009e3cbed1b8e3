"""Mutation-based hyperparameter evolution (reference
``fce_yolo_tpu/engine/tuner.py:48-199``): the same genetics from the same
``np.random.default_rng(seed)`` and the same ``tune_results.csv`` layout.

A bounded search space with per-gene gains, fitness-weighted parent
selection from the top-k results, Gaussian mutation with a mutation
probability, resumable CSV state (fitness, then one column per gene). The
train runs are short trainings of the port's ``YOLO`` on its device (the
card unless ``base_args`` names ``device``); fitness is the run's
``best_fitness`` (0.1 mAP50 + 0.9 mAP50-95).
"""

from __future__ import annotations

import csv
import shutil
from pathlib import Path
from typing import Callable

import numpy as np

__all__ = ["Tuner", "DEFAULT_SPACE"]

# key: (min, max[, gain]) — reference engine/tuner.py:91-118
DEFAULT_SPACE: dict[str, tuple] = {
    "lr0": (1e-5, 1e-1),
    "lrf": (0.0001, 0.1),
    "momentum": (0.7, 0.98, 0.3),
    "weight_decay": (0.0, 0.001),
    "warmup_epochs": (0.0, 5.0),
    "warmup_momentum": (0.0, 0.95),
    "box": (1.0, 20.0),
    "cls": (0.1, 4.0),
    "dfl": (0.4, 6.0),
    "hsv_h": (0.0, 0.1),
    "hsv_s": (0.0, 0.9),
    "hsv_v": (0.0, 0.9),
    "degrees": (0.0, 45.0),
    "translate": (0.0, 0.9),
    "scale": (0.0, 0.95),
    "shear": (0.0, 10.0),
    "perspective": (0.0, 0.001),
    "flipud": (0.0, 1.0),
    "fliplr": (0.0, 1.0),
    "mosaic": (0.0, 1.0),
    "mixup": (0.0, 1.0),
    "cutmix": (0.0, 1.0),
}


class Tuner:
    """Evolves hyperparameters over repeated short trainings.

    Args:
        space: {gene: (min, max[, gain])}.
        tune_dir: state directory; tune_results.csv accumulates and makes the
            search resumable (reference tuner.py:252-264).
        train_fn: optional custom (hyp dict) -> fitness float. Defaults to a
            facade training run using base_args.
    """

    def __init__(
        self,
        space: dict | None = None,
        tune_dir: str = "runs/tune",
        train_fn: Callable[[dict], float] | None = None,
        base_args: dict | None = None,
        seed: int = 0,
    ):
        self.space = space or dict(DEFAULT_SPACE)
        self.tune_dir = Path(tune_dir)
        self.tune_csv = self.tune_dir / "tune_results.csv"
        self.train_fn = train_fn
        self.base_args = base_args or {}
        self.rng = np.random.default_rng(seed)

    # ----------------------------------------------------------- genetics
    def _load_results(self) -> np.ndarray:
        """(n, 1 + ngenes) rows [fitness, genes...] from the CSV."""
        if not self.tune_csv.exists():
            return np.zeros((0, 1 + len(self.space)))
        rows = list(csv.reader(self.tune_csv.read_text().splitlines()))[1:]
        return np.array(rows, float) if rows else np.zeros((0, 1 + len(self.space)))

    def _append_result(self, fitness: float, hyp: dict):
        new = not self.tune_csv.exists()
        self.tune_dir.mkdir(parents=True, exist_ok=True)
        with open(self.tune_csv, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["fitness", *self.space.keys()])
            w.writerow([round(fitness, 5), *[hyp[k] for k in self.space]])

    def _crossover(self, x: np.ndarray, k: int = 5) -> np.ndarray:
        """Fitness-weighted BLX crossover of up to top-k parents
        (reference tuner.py:266-276)."""
        n = min(k, len(x))
        order = np.argsort(-x[:, 0])[:n]
        top = x[order]
        w = top[:, 0] - top[:, 0].min() + 1e-6
        w = w / w.sum()
        idxs = self.rng.choice(n, size=min(2, n), replace=False, p=w)
        parents = top[idxs, 1:]
        alpha = self.rng.uniform(-0.1, 1.1, parents.shape[1])
        return parents[0] * alpha + parents[-1] * (1 - alpha)

    def _mutate(self, mutation: float = 0.9, sigma: float = 0.2) -> dict:
        """Next candidate genes (reference tuner.py:278-344)."""
        x = self._load_results()
        keys = list(self.space.keys())
        lows = np.array([v[0] for v in self.space.values()])
        highs = np.array([v[1] for v in self.space.values()])
        gains = np.array([v[2] if len(v) > 2 else 1.0 for v in self.space.values()])

        if len(x) == 0:
            genes = np.array([self.base_args.get(k, (lo + hi) / 2) for k, lo, hi in zip(keys, lows, highs)])
        else:
            genes = self._crossover(x)
            mask = self.rng.random(len(genes)) < mutation
            step = self.rng.standard_normal(len(genes)) * sigma * gains
            genes = np.where(mask, genes * (1 + step), genes)
        genes = np.clip(genes, lows, highs)
        return {k: float(round(g, 6)) for k, g in zip(keys, genes)}

    # -------------------------------------------------------------- main
    def __call__(self, iterations: int = 10, cleanup: bool = True, verbose: bool = True) -> dict:
        """Run the evolution loop; returns {'best_fitness', 'best_hyp', 'csv'}."""
        best_fit, best_hyp = -1.0, {}
        for it in range(iterations):
            hyp = self._mutate()
            try:
                fitness = self._train_once(hyp, it, cleanup)
            except Exception as e:  # a failed run scores 0 (reference behavior)
                if verbose:
                    print(f"tuner iteration {it} failed: {e}")
                fitness = 0.0
            self._append_result(fitness, hyp)
            if fitness > best_fit:
                best_fit, best_hyp = fitness, hyp
            if verbose:
                print(f"tune {it + 1}/{iterations}: fitness={fitness:.4f} best={best_fit:.4f}")
        (self.tune_dir / "best_hyperparameters.yaml").write_text(
            "\n".join(f"{k}: {v}" for k, v in best_hyp.items()) + "\n"
        )
        from fce_yolo_tpu_torch.utils.plotting import plot_tune_results

        plots = plot_tune_results(self.tune_csv)
        return {"best_fitness": best_fit, "best_hyp": best_hyp,
                "csv": str(self.tune_csv), "plots": plots}

    def _train_once(self, hyp: dict, iteration: int, cleanup: bool) -> float:
        if self.train_fn is not None:
            return float(self.train_fn(hyp))
        from fce_yolo_tpu_torch.api import YOLO

        args = dict(self.base_args)
        model_name = args.pop("model", "yolo11n.yaml")
        device = args.pop("device", "cuda")
        args.update({k: v for k, v in hyp.items() if k not in ("box", "cls", "dfl")})
        run_dir = self.tune_dir / f"iter{iteration}"
        model = YOLO(model_name, device=device)
        out = model.train(project=str(run_dir.parent), name=run_dir.name, verbose=False, **args)
        if cleanup:
            shutil.rmtree(run_dir, ignore_errors=True)
        return max(out.get("best_fitness", 0.0), 0.0)


def run_ray_tune(model, space: dict | None = None, grace_period: int = 10,
                 gpu_per_trial: int | None = None, max_samples: int = 10,
                 **train_args):
    """Ray Tune bridge (reference utils/tuner.py:9 run_ray_tune).

    When the `ray` package is installed, runs an ASHA-scheduled search over
    `space` by calling `model.train(**hyp, **train_args)` per trial. Without
    ray (the normal case in this environment) it raises ModuleNotFoundError
    pointing at the built-in genetic `Tuner` — the same contract the
    reference has when `check_requirements("ray[tune]")` cannot install.
    """
    try:
        from ray import tune
        from ray.air import RunConfig
        from ray.tune.schedulers import ASHAScheduler
    except ImportError as e:
        raise ModuleNotFoundError(
            "run_ray_tune needs the `ray[tune]` package, which is not "
            "available in this environment. Use the built-in evolutionary "
            "tuner instead: YOLO(...).tune(data=..., iterations=N)") from e

    space = space or {k: tune.uniform(t[0], t[1]) for k, t in DEFAULT_SPACE.items()}

    def trainable(hyp):
        res = model.train(**{**train_args, **hyp})
        tune.report({"fitness": float(res.get("fitness", 0.0))})

    scheduler = ASHAScheduler(metric="fitness", mode="max",
                              grace_period=grace_period)
    tuner = tune.Tuner(
        trainable,
        param_space=space,
        tune_config=tune.TuneConfig(scheduler=scheduler, num_samples=max_samples),
        run_config=RunConfig(name="tune"),
    )
    return tuner.fit()
