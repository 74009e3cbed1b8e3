"""The training slice on the CPU beside the step parity of
``test_torch_train_step.py``: BatchNorm's running statistics against flax's,
NaN rollback, gradient accumulation, checkpoints, ``YOLO.train`` with
``resume``, and the train path without JAX, cv2, PIL or pyyaml.

Tolerances: the BatchNorm module on one input within 1e-5 of flax's output
and 1e-6 relative on its running statistics (torch's own ``nn.BatchNorm2d``
is shown to differ by the n / (n - 1) the port removes); everything else
exact (rollback, accumulation against a hand-summed step, checkpoints, and
resume bit for bit).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.nn.modules import BN_EPS, BN_MOMENTUM, BatchNorm2d
from fce_yolo_tpu_torch.train import loss as ploss
from fce_yolo_tpu_torch.train import optim as popt
from fce_yolo_tpu_torch.train import trainer as ptrainer
from fce_yolo_tpu_torch.utils.checkpoint import is_checkpoint, load_checkpoint, save_checkpoint
from test_torch_data import png_copy

torch.set_num_threads(1)
IMGSZ, B, M, STEPS = 64, 2, 8, 3
REPO = Path(__file__).resolve().parent.parent


def to_flax(model: torch.nn.Module) -> dict:
    """The port's weights as flax variables (numpy, conv kernels HWIO)."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        coll = "batch_stats" if name.rsplit(".", 1)[-1].startswith("running") else "params"
        *keys, leaf = popt.flax_path(model, name).split("/")
        node = out[coll]
        for k in keys:
            node = node.setdefault(k, {})
        a = t.detach().numpy().copy()
        node[leaf] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return out


def make_batches(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        cls, boxes, mask = np.zeros((B, M), np.float32), np.zeros((B, M, 4), np.float32), np.zeros((B, M), bool)
        for i in range(B):
            k = rng.randint(1, 4)
            cls[i, :k] = rng.randint(0, 80, k)
            boxes[i, :k] = np.concatenate([rng.uniform(0.3, 0.7, (k, 2)), rng.uniform(0.1, 0.4, (k, 2))], 1)
            mask[i, :k] = True
        out.append({"img": rng.randint(0, 256, (B, IMGSZ, IMGSZ, 3), np.uint8), "cls": cls, "bboxes": boxes,
                    "mask": mask})
    return out


def test_batchnorm_running_stats_match_flax():
    """One training-mode call on the same input (n = 2 x 3 x 3 per channel):
    output and running statistics as flax's; torch's own BatchNorm2d keeps
    the unbiased variance, n / (n - 1) = 18 / 17 larger on the batch term."""
    rng = np.random.RandomState(0)
    x = rng.normal(0.5, 2.0, (2, 3, 3, 16)).astype(np.float32)
    scale, bias = rng.normal(1, 0.1, 16).astype(np.float32), rng.normal(0, 0.1, 16).astype(np.float32)
    mean0, var0 = rng.normal(0, 0.1, 16).astype(np.float32), rng.uniform(0.5, 2, 16).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=1 - BN_MOMENTUM, epsilon=BN_EPS)
    fvars = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    ref, upd = bn.apply(fvars, jnp.asarray(x), mutable=["batch_stats"])
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    for cls in (BatchNorm2d, torch.nn.BatchNorm2d):
        m = cls(16, eps=BN_EPS, momentum=BN_MOMENTUM).train()
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
            m.running_mean.copy_(torch.from_numpy(mean0))
            m.running_var.copy_(torch.from_numpy(var0))
            out = m(xt).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
        np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6,
                                   atol=1e-7)
        rv_ref = np.asarray(upd["batch_stats"]["var"])
        if cls is BatchNorm2d:
            np.testing.assert_allclose(m.running_var.numpy(), rv_ref, rtol=1e-6)
        else:
            batch_var = (rv_ref - (1 - BN_MOMENTUM) * var0) / BN_MOMENTUM
            expected = (1 - BN_MOMENTUM) * var0 + BN_MOMENTUM * batch_var * 18 / 17
            np.testing.assert_allclose(m.running_var.numpy(), expected, rtol=1e-5)
            assert np.abs(m.running_var.numpy() - rv_ref).max() > 1e-3



@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last],
                         ids=["contiguous", "channels_last"])
def test_batchnorm_matches_float64_on_flat_input(memory_format):
    """A training-mode call on a near-flat input (mean 3, spread 1e-2, n =
    36,864 a channel), as deep maps of flat-colour images are: output,
    gradients and running statistics within 2e-6 of the float64 module's,
    in either memory format. (torch's CPU kernel sums a channels-last input
    in float32, ~1e-5 off here; the module makes it contiguous.)"""
    g = torch.Generator().manual_seed(0)
    x = (3.0 + 1e-2 * torch.randn(4, 8, 96, 96, generator=g)).double()
    x[..., :10] += 1.0
    gy = torch.randn(x.shape, generator=g, dtype=torch.float64)
    w, b = 1 + 0.1 * torch.randn(8, generator=g, dtype=torch.float64), 0.1 * torch.randn(8, generator=g,
                                                                                          dtype=torch.float64)

    def run(dtype, fmt):
        m = BatchNorm2d(8, eps=BN_EPS, momentum=BN_MOMENTUM).to(dtype).train()
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
        xi = x.to(dtype).contiguous(memory_format=fmt).detach().requires_grad_()
        y = m(xi)
        y.backward(gy.to(dtype).contiguous(memory_format=fmt))
        return [t.double() for t in (y.detach(), xi.grad, m.weight.grad, m.bias.grad, m.running_mean,
                                     m.running_var)]

    ref = run(torch.float64, torch.contiguous_format)
    out = run(torch.float32, memory_format)
    for name, a, r in zip(("y", "dx", "dw", "db"), out, ref):
        assert float((a - r).abs().max()) <= 2e-6 * float(r.abs().max()), name
    assert float((out[4] - ref[4]).abs().max()) <= 2e-6 * float(ref[5].sqrt().min())
    assert float(((out[5] - ref[5]).abs() / ref[5]).max()) <= 2e-6

# ------------------------------------------------------------------ port only
def _small_state(accumulate: int, frozen_bn: bool = False, boundaries=None):
    port = YOLO("yolo11n-fce.yaml", device="cpu")
    cfg = popt.OptimCfg(optimizer="SGD", lr0=0.01, batch_size=B, epochs=2, steps_per_epoch=4, nc=80,
                        warmup_epochs=0.0, nbs=B * accumulate)
    opt = popt.Optimizer(cfg, port.model)
    state = ptrainer.create_train_state(port.model, opt, accumulate=accumulate)
    lcfg = ploss.DetectionLossCfg(nc=80, strides=tuple(port.strides), iou_type="WIoU")
    step = ptrainer.make_train_step(port.model, opt, lcfg, accumulate=accumulate, frozen_bn=frozen_bn,
                                    boundaries=boundaries)
    return port, state, step


def _snapshot(state) -> dict:
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "opt": [t.clone() for ts in state.optimizer.state.values() for t in ts],
            "ema": [t.clone() for t in state.ema.params], "loss": state.loss_state.wiou_loss_mean.clone(),
            "accum": [t.clone() for t in state.grad_accum or []]}


def _assert_same(a: dict, b: dict) -> None:
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for name in ("opt", "ema", "accum"):
        assert len(a[name]) == len(b[name]) and all(torch.equal(x, y) for x, y in zip(a[name], b[name])), name
    assert torch.equal(a["loss"], b["loss"])


def _torch_batch(b: dict, nan: bool = False) -> dict:
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if nan:
        out["img"] = out["img"].float() / 255
        out["img"][0, 10, 10, 0] = float("nan")
    return out


@pytest.mark.parametrize("accumulate", [1, 3])
def test_nan_step_rolls_back_everything(accumulate):
    """A non-finite loss keeps the parameters, the BN running buffers (which
    the training-mode forward had moved), the optimizer state and its count,
    the EMA parameters, the WIoU mean and the gradient buffer; ``step`` and,
    on a boundary, the EMA's update count still advance."""
    bounds = np.array([False, True, True, True]) if accumulate > 1 else None
    _, state, step = _small_state(accumulate, boundaries=bounds)
    batches = make_batches(2, seed=2)
    state, m = step(state, _torch_batch(batches[0]))  # finite; with accumulation it only fills the buffer
    assert m["finite"]
    before, count, updates = _snapshot(state), state.optimizer.count, state.ema.updates
    if accumulate > 1:
        assert any(float(t.abs().max()) > 0 for t in state.grad_accum)
    state, m = step(state, _torch_batch(batches[1], nan=True))
    assert not m["finite"] and not np.isfinite(float(m["loss"]))
    _assert_same(before, _snapshot(state))
    assert state.step == 2 and state.optimizer.count == count and state.ema.updates == updates + 1
    state, m = step(state, _torch_batch(batches[1]))  # the next finite boundary step updates again
    assert m["finite"] and state.optimizer.count == count + 1


def test_accumulation_sums_gradients_and_fires_on_boundaries():
    """Three micro-batches with boundaries (F, F, T) give the parameters of
    one optimizer step on the summed gradients of the three."""
    port, state, step = _small_state(3, frozen_bn=True, boundaries=np.array([False, False, True]))
    ref_port, ref_state, _ = _small_state(3, frozen_bn=True)
    batches = make_batches(3, seed=3)
    p0 = [p.clone() for p in state.params]
    for i, b in enumerate(batches):
        state, m = step(state, _torch_batch(b))
        assert state.optimizer.count == (1 if i == 2 else 0)
        if i < 2:
            assert all(torch.equal(p, q) for p, q in zip(state.params, p0))
    model = ref_port.model.train()
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.eval()
    lcfg = ploss.DetectionLossCfg(nc=80, strides=tuple(ref_port.strides), iou_type="WIoU")
    total_grads, ls = None, ref_state.loss_state
    for b in batches:
        model.zero_grad(set_to_none=True)
        tb = _torch_batch(b)
        feats = model(tb["img"].permute(0, 3, 1, 2).float() / 255.0)["feats"]
        loss, _, ls = ploss.detection_loss(feats, tb, lcfg, ls)
        loss.backward()
        grads = [p.grad.clone() for p in ref_state.params]
        total_grads = grads if total_grads is None else [a + g for a, g in zip(total_grads, grads)]
    ref_state.optimizer.step(ref_state.params, total_grads)
    for p, q in zip(state.params, ref_state.params):
        assert torch.equal(p, q)
    assert state.ema.updates == 1 and all(float(t.abs().max()) == 0 for t in state.grad_accum)


def test_checkpoint_round_trip_is_exact(tmp_path):
    _, state, step = _small_state(2, boundaries=np.array([True, False, True]))
    for b in make_batches(2, seed=4):
        state, _ = step(state, _torch_batch(b))
    save_checkpoint(tmp_path / "last", {"train_state": state.state_dict()}, {"epoch": 3, "names": {0: "a"}})
    assert is_checkpoint(tmp_path / "last") and not is_checkpoint(tmp_path)
    tree, meta = load_checkpoint(tmp_path / "last")
    assert meta == {"epoch": 3, "names": {"0": "a"}}
    _, fresh, _ = _small_state(2)
    fresh.load_state_dict(tree["train_state"])
    _assert_same(_snapshot(state), _snapshot(fresh))
    assert (fresh.step, fresh.optimizer.count, fresh.ema.updates) == (state.step, state.optimizer.count,
                                                                       state.ema.updates)
    yolo = YOLO("yolo11n-fce.yaml", device="cpu")
    yolo.names = {0: "x", 1: "y"}
    yolo.save(tmp_path / "best", {"epoch": 1, "fitness": 0.5})
    again = YOLO(tmp_path / "best", device="cpu")
    assert again.names == yolo.names and again.scale == "n" and again.ckpt_meta["fitness"] == 0.5
    sd = again.model.state_dict()
    for k, v in yolo.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    jax_meta_keys = {"cfg_yaml", "scale", "nc", "names", "epoch", "fitness"}  # the JAX facade's save + train meta
    assert jax_meta_keys <= set(again.ckpt_meta)


@pytest.fixture(scope="module")
def png_dataset(tiny_dataset, tmp_path_factory):
    return png_copy(tiny_dataset, tmp_path_factory.mktemp("tinydet_png_train"))



FLAT_OPT = dict(optimizer="SGD", batch_size=2, nbs=2, epochs=2, steps_per_epoch=2, nc=80, warmup_epochs=0.0)


def flat_mosaic_batch(data_yaml: str) -> dict:
    """A train-mode mosaic batch (160 px, B=2) of the tiny dataset's flat-colour
    images (grey fill and solid rectangles), as CPU tensors."""
    from fce_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from fce_yolo_tpu_torch.data.loader import DataLoader

    d = check_det_dataset(data_yaml)
    batch = next(iter(DataLoader(YOLODataset(d["train"], imgsz=160, mode="train", nc=3), batch_size=2, workers=1)))
    batch = {k: torch.from_numpy(batch[k]) for k in ("img", "cls", "bboxes", "mask")}
    img = batch["img"]
    assert (img[:, :, 1:] == img[:, :, :-1]).all(-1).float().mean() > 0.8  # flat: most pixels repeat their left
    return batch


def float64_step(sd0: dict, batch: dict) -> tuple[dict, dict]:
    """One FLAT_OPT step of yolo11n-fce with training BatchNorm in float64
    from the weights ``sd0``: (state_dict after it, loss parts)."""
    port = YOLO("yolo11n-fce.yaml", device="cpu")
    port.model.load_state_dict(sd0)
    model = port.model.double().train()
    lcfg = ploss.DetectionLossCfg(nc=80, strides=tuple(port.strides), tal_dtype="float32")
    feats = model(batch["img"].permute(0, 3, 1, 2).double() / 255.0)["feats"]
    total, parts, _ = ploss.detection_loss(feats, {**batch, "bboxes": batch["bboxes"].double()}, lcfg,
                                           ploss.LossState.init("cpu"))
    total.backward()
    params = [q for _, q in model.named_parameters()]
    popt.Optimizer(popt.OptimCfg(**FLAT_OPT), model).step(params, [q.grad for q in params])
    return {k: v.detach() for k, v in model.state_dict().items()}, {k: float(v) for k, v in parts.items()}


def step_distance(got: dict, ref: dict, sd0: dict) -> tuple[float, float]:
    """How far the state_dict ``got`` is from ``ref``: the largest parameter
    difference over ref's largest update from ``sd0``, and the largest BN
    difference (running means over the running standard deviation, running
    variances relative)."""
    weights = [k for k in ref if "running" not in k and "num_batches" not in k]
    dp = max(float((ref[k] - sd0[k].double()).abs().max()) for k in weights)
    du = max(float((got[k].double() - ref[k]).abs().max()) for k in weights) / dp
    bn = 0.0
    for k in ref:
        if k.endswith("running_mean"):
            bn = max(bn, float((got[k].double() - ref[k]).abs().max() / ref[k.replace("mean", "var")].sqrt().min()))
        elif k.endswith("running_var"):
            bn = max(bn, float(((got[k].double() - ref[k]).abs() / ref[k]).max()))
    return du, bn


def test_training_bn_step_on_flat_images_matches_float64(png_dataset):
    """One SGD step with training BatchNorm, float32 on the CPU, against the
    same step in float64, on a flat-colour mosaic batch: loss parts within
    1e-4 relative, updates within 3e-4 of the largest, running statistics
    within 1e-5 (the mean in units of the running standard deviation);
    ~2e-5, 4e-5 and 2e-6 are seen. A channels-last BatchNorm summed in
    float32 put this step 2e-3, 5e-3 and 3e-4 away."""
    batch = flat_mosaic_batch(png_dataset)
    port = YOLO("yolo11n-fce.yaml", device="cpu")
    sd0 = {k: v.clone() for k, v in port.model.state_dict().items()}
    lcfg = ploss.DetectionLossCfg(nc=80, strides=tuple(port.strides), tal_dtype="float32")
    opt = popt.Optimizer(popt.OptimCfg(**FLAT_OPT), port.model)
    _, m = ptrainer.make_train_step(port.model, opt, lcfg)(ptrainer.create_train_state(port.model, opt), batch)
    assert m["finite"] and opt.count == 1
    ref, parts = float64_step(sd0, batch)
    for k in ("box", "cls", "dfl"):
        assert abs(float(m[k]) - parts[k]) <= 1e-4 * abs(parts[k]), k
    du, bn = step_distance(port.model.state_dict(), ref, sd0)
    assert du <= 3e-4 and bn <= 1e-5, (du, bn)


def test_train_resume_is_bit_equal(png_dataset, tmp_path):
    """2 epochs straight against 1 epoch (a zero time limit stops it) plus
    ``resume``: the whole train state of ``weights/last`` bit for bit, and
    the second epoch's row of results.csv."""
    kw = dict(epochs=2, batch=4, imgsz=64, workers=2, close_mosaic=1, verbose=False, name="run")
    a = YOLO("yolo11n-fce.yaml", device="cpu").train(png_dataset, project=str(tmp_path / "a"), **kw)
    b1 = YOLO("yolo11n-fce.yaml", device="cpu").train(png_dataset, project=str(tmp_path / "b"),
                                                       time_limit_hours=0.0, **kw)
    assert b1["epochs_run"] == 1
    b2 = YOLO("yolo11n-fce.yaml", device="cpu").train(png_dataset, project=str(tmp_path / "b"), resume=True, **kw)
    assert a["epochs_run"] == 2 and b2["epochs_run"] == 1 and b2["save_dir"] == b1["save_dir"]
    ta, ma = load_checkpoint(Path(a["save_dir"]) / "weights" / "last")
    tb, mb = load_checkpoint(Path(b2["save_dir"]) / "weights" / "last")
    assert ma["epoch"] == mb["epoch"] == 1

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    la, lb = dict(leaves(ta)), dict(leaves(tb))
    assert la.keys() == lb.keys() and len(la) > 1000
    for k, v in la.items():
        assert (torch.equal(v, lb[k]) if isinstance(v, torch.Tensor) else v == lb[k]), k
    row_a, row_b = a["results"][1], b2["results"][0]
    assert {k: v for k, v in row_a.items() if k != "time"} == {k: v for k, v in row_b.items() if k != "time"}
    assert (Path(a["save_dir"]) / "results.csv").read_text().count("\n") == 3
    assert is_checkpoint(Path(a["save_dir"]) / "weights" / "best")


def test_train_modules_import_and_train_without_jax_cv2_pil(tmp_path):
    """Every port module imports, and a CPU ``YOLO.train`` (one epoch, mosaic,
    val on the EMA model, checkpoints), a reload of ``best`` and an OBB
    ``YOLO.val`` run, with jax, flax, optax, orbax, cv2, PIL, yaml and the
    JAX package blocked."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "yaml", "fce_yolo_tpu"):
            sys.modules[m] = None
        import torch
        torch.set_num_threads(1)  # one thread, as in the test workers
        import importlib, pkgutil, struct, zlib
        from pathlib import Path
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import fce_yolo_tpu_torch
        for info in pkgutil.walk_packages(fce_yolo_tpu_torch.__path__, "fce_yolo_tpu_torch."):
            importlib.import_module(info.name)
        from fce_yolo_tpu_torch import YOLO

        root = Path(sys.argv[1])
        def chunk(kind, body):
            return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))
        for split in ("train", "val"):
            (root / "images" / split).mkdir(parents=True)
            (root / "labels" / split).mkdir(parents=True)
            for i, (h, w) in enumerate([(40, 56), (64, 48), (52, 52), (60, 44)]):
                rgb = np.full((h, w, 3), 60, np.uint8)
                rgb[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = (255, 80, 80)
                raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], 1).tobytes()
                (root / "images" / split / f"{i}.png").write_bytes(
                    b"\\x89PNG\\r\\n\\x1a\\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
                (root / "labels" / split / f"{i}.txt").write_text("1 0.5 0.5 0.5 0.5\\n")
        (root / "data.yaml").write_text(f"path: {root}\\ntrain: images/train\\nval: images/val\\n"
                                        "names:\\n  0: a\\n  1: b\\n")
        res = YOLO("yolo11n-fce.yaml", device="cpu").train(str(root / "data.yaml"), epochs=1, batch=2, imgsz=64,
                                                           workers=1, project=str(root / "runs"), verbose=False)
        best = Path(res["save_dir"]) / "weights" / "best"
        out = YOLO(str(best), device="cpu").val(str(root / "data.yaml"), imgsz=64, batch=2, verbose=False)
        assert abs(out["metrics/mAP50-95(B)"] - res["results"][0]["metrics/mAP50-95(B)"]) <= 1e-9
        for i in range(4):  # the same images as an OBB dataset: the rectangle's four corners
            (root / "labels" / "val" / f"{i}.txt").write_text("0 0.25 0.25 0.75 0.25 0.75 0.75 0.25 0.75\\n")
        obb = YOLO("yolo11n-obb.yaml", device="cpu", nc=2).val(str(root / "data.yaml"), imgsz=64, batch=2,
                                                               verbose=False)
        assert 0 <= obb["metrics/mAP50-95(B)"] <= 1 and len(obb["metrics"].stats["conf"]) == 4
        print("ok", res["epochs_run"])
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok 1")
