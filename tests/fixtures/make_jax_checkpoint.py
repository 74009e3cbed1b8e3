"""Write the committed JAX checkpoint fixture: ``tests/fixtures/jax_checkpoint/``
(the JAX package's own ``save_checkpoint``: ``meta.json`` and an orbax
``tree/``) and ``jax_checkpoint_predictions.npz`` (the JAX facade's
predictions from it). The port's tests and ``chip_smoke.py`` read both
without JAX; nothing regenerates them.

The model is ``yolo11-fce-narrow.yaml`` (a user YAML: yolo11-fce's graph at
16-128 channels) with seeded weights: BatchNorm scales, shifts and running
statistics drawn around their usual values, the class bias without its
prior, so scores spread around 0.5. Its params are stored in bfloat16 (a
mixed-precision tree; its ``batch_stats`` stay float32), which keeps the
fixture under 2 MB. The tree also holds a ``bench`` collection, one array
of float32 values drawn like trained conv weights (per-block scales
0.005-0.1): the largest chunk, on which ``chip_smoke.py`` times the zstd
decoders.

    python tests/fixtures/make_jax_checkpoint.py   (from the repo root; needs JAX, flax, orbax)
"""

from __future__ import annotations

import os
import shutil
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
YAML = "tests/fixtures/yolo11-fce-narrow.yaml"  # relative: meta.json keeps the path as given
OUT = REPO / "tests" / "fixtures" / "jax_checkpoint"
PREDICTIONS = REPO / "tests" / "fixtures" / "jax_checkpoint_predictions.npz"
SEED = 7
IMGSZ = 128
CONF = 0.25
SHAPES = ((96, 128, 3), (128, 80, 3), (120, 128, 3))  # no larger than IMGSZ: the letterbox only pads
BENCH_VALUES = 3 << 15  # float32 values of the bench array (384 KiB)
NAMES = {0: "red", 1: "green", 2: "blue"}


def images(seed: int = SEED) -> list:
    """The seeded BGR images the predictions are of (``chip_smoke.py`` and
    the tests draw them the same way)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, s, np.uint8) for s in SHAPES]


def bench_array(rng: np.random.RandomState) -> np.ndarray:
    scales = np.exp(rng.uniform(np.log(0.005), np.log(0.1), BENCH_VALUES // 4096))
    return (rng.standard_normal(BENCH_VALUES) * np.repeat(scales, 4096)).astype(np.float32)


def main() -> None:
    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from fce_yolo_tpu.api import YOLO
    from fce_yolo_tpu.data.augment import letterbox
    from fce_yolo_tpu.nn.model import init_variables
    from fce_yolo_tpu.utils.checkpoint import save_checkpoint

    jy = YOLO(YAML)
    variables = jax.jit(lambda k: init_variables(jy.model, k, imgsz=64, bias_prior=False))(jax.random.PRNGKey(SEED))
    rng = np.random.RandomState(SEED)

    def draw(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        if name in ("mean", "bias") and any(getattr(p, "key", "") == "bn" for p in path):
            return rng.normal(0.0, 0.2, x.shape).astype(x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(lambda p, x: jnp.asarray(draw(p, x), jnp.bfloat16),
                                              variables["params"])
    stats = jax.tree_util.tree_map_with_path(lambda p, x: jnp.asarray(draw(p, x)), variables["batch_stats"])
    if OUT.exists():
        shutil.rmtree(OUT)
    meta = {"cfg_yaml": jy.cfg_yaml, "scale": jy.scale, "nc": jy.nc, "names": NAMES}
    save_checkpoint(str(OUT), {"params": params, "batch_stats": stats,
                               "bench": {"weights": jnp.asarray(bench_array(rng))}}, meta)

    ref = YOLO(str(OUT))
    imgs = images()
    res = ref.predict(imgs, imgsz=IMGSZ, conf=CONF, batch=len(imgs))
    batch = np.stack([letterbox(im, IMGSZ, scaleup=False)[0][..., ::-1] for im in imgs]).astype(np.float32) / 255.0
    preds = ref.model.apply(ref.variables, jnp.asarray(batch), train=False)["preds"]
    det = np.concatenate([np.concatenate([r.boxes.xyxy, r.boxes.conf[:, None], r.boxes.cls[:, None]], 1)
                          for r in res]).astype(np.float32)
    np.savez_compressed(PREDICTIONS, seed=SEED, imgsz=IMGSZ, conf=CONF, shapes=np.array(SHAPES),
                        preds=np.asarray(preds, np.float32), det=det,
                        det_counts=np.array([len(r) for r in res]))
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file()) + PREDICTIONS.stat().st_size
    print(f"{OUT}: {size} bytes with the predictions; detections {[len(r) for r in res]}; "
          f"preds {tuple(preds.shape)}")


if __name__ == "__main__":
    main()
