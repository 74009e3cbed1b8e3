"""Fused stem (ops/stem.py) vs the JAX package's pallas_stem on CPU, plus
the CUDA kernel vs its plain version where a card is present.

Tolerances:
- stem_reference vs stem_reference_jnp: 1e-5 * max|ref| (both f32 convs,
  summation order only);
- stem_reference vs the Pallas kernel in interpret mode: 0.02 * max|ref|
  with a uniform per-row error (the JAX kernel test's bound,
  tests/test_pallas_stem.py:59-63: the kernel rounds to bf16 between stages);
- fold_stem_params: one bf16 ulp (rsqrt and products round differently
  before the final bf16 cast).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.nn.parser import load_model_yaml as jax_load_model_yaml
from fce_yolo_tpu.ops import pallas_stem as PS
from fce_yolo_tpu.nn.import_torch import state_dict_to_variables
from fce_yolo_tpu_torch.nn.model import build_model, fold_conv_bn, init_weights
from fce_yolo_tpu_torch.nn.parser import load_model_yaml
from fce_yolo_tpu_torch.ops import stem as S

CFG_DIR = Path(__file__).resolve().parent.parent / "fce_yolo_tpu" / "cfg" / "models"
SHAPES = [  # the JAX kernel test's five shapes (test_pallas_stem.py:41-47)
    (64, 64, False, 1),  # single tile, Bottleneck inner (n/s form)
    (64, 64, True, 1),  # C3k inner (m/l/x form)
    (128, 128, False, 1),  # several tiles
    (128, 192, False, 2),  # rectangular, 2 repeats
    (128, 128, True, 2),  # C3k x2 (x-scale form)
]

torch.set_num_threads(1)


def _rand_folded(rng, spec: S.StemSpec) -> list[np.ndarray]:
    """Random folded weights in fold_stem_params layout, rounded to bf16."""
    def rw(*s):
        return np.array(jnp.asarray(rng.normal(0, 0.1, s), jnp.bfloat16).astype(jnp.float32))

    ch, c_ = spec.ch, spec.ch // 2
    out = [rw(27, spec.c0), rw(1, spec.c0), rw(9 * spec.c0, spec.c1), rw(1, spec.c1),
           rw(spec.c1, 2 * ch), rw(1, 2 * ch)]
    for _ in range(spec.n):
        if spec.c3k:
            out += [rw(ch, c_), rw(1, c_), rw(ch, c_), rw(1, c_)]
            for _ in range(2):
                out += [rw(9 * c_, c_), rw(1, c_), rw(9 * c_, c_), rw(1, c_)]
            out += [rw(2 * c_, ch), rw(1, ch)]
        else:
            out += [rw(9 * ch, c_), rw(1, c_), rw(9 * c_, ch), rw(1, ch)]
    out += [rw((2 + spec.n) * ch, spec.c2), rw(1, spec.c2)]
    return out


def _case(H, W, c3k, n):
    spec = S.StemSpec(H=H, W=W, c0=16, c1=32, c2=64, ch=16, n=n, c3k=c3k)
    rng = np.random.RandomState(0)
    folded = _rand_folded(rng, spec)
    x = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    return spec, folded, x


def _port(folded, x):
    return [torch.from_numpy(w).to(torch.bfloat16) for w in folded], torch.from_numpy(x)


@pytest.mark.parametrize("H,W,c3k,n", SHAPES)
def test_reference_matches_jnp_reference(H, W, c3k, n):
    spec, folded, x = _case(H, W, c3k, n)
    jspec = PS.StemSpec(H=H, W=W, c0=16, c1=32, c2=64, ch=16, n=n, c3k=c3k)
    ref = np.asarray(PS.stem_reference_jnp(jnp.asarray(x), [jnp.asarray(w, jnp.bfloat16) for w in folded], jspec))
    out = S.stem_reference(*_port(folded, x)[::-1], spec).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("H,W,c3k,n", SHAPES)
def test_reference_matches_pallas_kernel(H, W, c3k, n):
    """The plain version against the TPU kernel itself (interpret mode):
    the bf16 chain bound, and a per-row error with no edge or tile spike."""
    spec, folded, x = _case(H, W, c3k, n)
    jspec = PS.StemSpec(H=H, W=W, c0=16, c1=32, c2=64, ch=16, n=n, c3k=c3k, tile_h=16 if n == 1 or c3k else 8)
    kern = np.asarray(PS.fused_stem(jnp.asarray(x), [jnp.asarray(w, jnp.bfloat16) for w in folded], jspec,
                                    interpret=True), np.float32)
    wt, xt = _port(folded, x)
    out = S.fused_stem(xt, S.stem_weights(wt, spec), spec)  # CPU tensors: the plain version, in bf16
    assert out.dtype == torch.bfloat16
    ref = S.stem_reference(xt, wt, spec).numpy()
    np.testing.assert_array_equal(out.float().numpy(), torch.from_numpy(ref).to(torch.bfloat16).float().numpy())
    scale = np.abs(ref).max()
    d = np.abs(kern - ref)
    assert d.max() / scale < 0.02
    per_row = d.max(axis=(0, 2, 3)) / scale
    assert per_row.max() < 3 * max(np.median(per_row), 1e-6)


def _seeded_model(name: str, scale: str | None = None, seed: int = 0):
    model, spec, _ = build_model(name, scale=scale)
    init_weights(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
    return model, spec


@pytest.mark.parametrize("name,scale", [("yolo11-fce", "s"), ("yolo11", "m")])
def test_fold_stem_params_matches_jax(name, scale):
    model, spec = _seeded_model(f"{name}.yaml", scale)
    ss = S.stem_spec_from_model(spec, (640, 640))
    variables = state_dict_to_variables({k: t.numpy() for k, t in model.state_dict().items()})
    jspec = PS.stem_spec_from_model(jax_load_model_yaml(CFG_DIR / f"{name}.yaml", scale=scale), (640, 640))
    ref = [np.asarray(a.astype(jnp.float32)) for a in PS.fold_stem_params(variables, jspec)]
    out = S.fold_stem_params(model, ss)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        o = o.float().numpy()
        assert o.shape == r.shape
        ulp = np.abs(r) * 2.0**-7  # one bf16 ulp (8 significant bits) at |r|
        assert (np.abs(o - r) <= ulp + 1e-30).all()
    fold_conv_bn(model)  # already-folded modules pass their conv weights through
    again = S.fold_stem_params(model, ss)
    for a, b in zip(out, again):
        assert (a.float() - b.float()).abs().max() <= 2.0**-7 * a.float().abs().max()


@pytest.mark.parametrize("name,scale", [("yolo11", s) for s in "nsmlx"] + [("yolo11-fce", s) for s in "nsm"])
@pytest.mark.parametrize("imgsz", [(640, 640), (1280, 1280), (642, 640), (480, 640)])
def test_stem_spec_matches_jax(name, scale, imgsz):
    jspec = jax_load_model_yaml(CFG_DIR / f"{name}.yaml", scale=scale)
    spec = load_model_yaml(f"{name}.yaml", scale=scale)
    ref = PS.stem_spec_from_model(jspec, imgsz)
    out = S.stem_spec_from_model(spec, imgsz)
    assert (out is None) == (ref is None)
    if ref is not None:
        for f in ("H", "W", "c0", "c1", "c2", "ch", "n", "c3k", "halo"):
            assert getattr(out, f) == getattr(ref, f), f


def test_apply_with_fused_stem_matches_plain_forward():
    """s scale at 160 px through the real graph: the stem's bf16 output
    resumes at layer 3 and the decoded preds agree with the plain f32
    forward (the JAX test's bound, test_pallas_stem.py:99-100)."""
    model, spec = _seeded_model("yolo11s-fce.yaml")
    fold_conv_bn(model)
    ss = S.stem_spec_from_model(spec, (160, 160))
    assert ss is not None and not ss.c3k and ss.c2 == 128
    img = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 160, 160, 3)).astype(np.uint8))
    with torch.no_grad():
        base = model(img.permute(0, 3, 1, 2).float() / 255.0)["preds"].numpy()
        fused = S.apply_with_fused_stem(model, img, ss, S.stem_weights(S.fold_stem_params(model, ss), ss))
        fused = fused["preds"].numpy()
    assert np.abs(base - fused).max() <= 0.02 * max(np.abs(base).max(), 1.0)
    assert np.corrcoef(base.ravel(), fused.ravel())[0, 1] > 0.9999


def test_fused_stem_rejects_bad_inputs():
    spec, folded, x = _case(64, 64, False, 1)
    wt, xt = _port(folded, x)
    weights = S.stem_weights(wt, spec)
    with pytest.raises(ValueError):
        S.fused_stem(xt.float(), weights, spec)
    with pytest.raises(ValueError):
        S.fused_stem(xt[:, :32], weights, spec)
    with pytest.raises(ValueError):
        S.stem_weights([w.float() for w in wt], spec)
    with pytest.raises(ValueError):
        S.stem_weights(wt[:-1], spec)
    with pytest.raises(ValueError):  # weights on another device than the images
        S.fused_stem(xt, S.stem_weights([w.to("meta") for w in wt], spec), spec)


@pytest.mark.parametrize("H,W,c3k,n", SHAPES)
def test_stem_weights_packing(H, W, c3k, n):
    """The kernel's packed buffer, element by element: per conv the weight
    as [cout][k*k][cin padded to 16] with zero padding (L0: [cout][(tap,
    rgb + 0) = 36 padded to 48]), then the bias; also when packed under
    ``inference_mode``, as the predictor does."""
    spec, folded, _ = _case(H, W, c3k, n)
    assert S.folded_shapes(spec) == [w.shape for w in folded]
    wt = [torch.from_numpy(w).to(torch.bfloat16) for w in folded]
    packed = S.stem_weights(wt, spec).packed.float().numpy()
    expected = []
    for i, (k, cin, cout) in enumerate(S._conv_shapes(spec)):
        w, b = folded[2 * i], folded[2 * i + 1]
        if i == 0:
            blk = np.zeros((cout, 48), np.float32)
            for t in range(9):
                blk[:, 4 * t:4 * t + 3] = w[3 * t:3 * t + 3].T
        else:
            blk = np.zeros((cout, k * k, -(-cin // 16) * 16), np.float32)
            for t in range(k * k):
                blk[:, t, :cin] = w[t * cin:(t + 1) * cin].T
        expected += [blk.ravel(), b.ravel()]
    np.testing.assert_array_equal(packed, np.concatenate(expected))
    with torch.inference_mode():
        again = S.stem_weights([w.clone() for w in wt], spec).packed
    np.testing.assert_array_equal(again.float().numpy(), packed)


def test_stem_spec_default_rules():
    """The JAX default rules at 640 px: s takes the Bottleneck form, m the
    C3k form; n fails c2 % 128, l and x have n = 2, and m at 1280 px has
    C3k above 640 px."""
    s = S.stem_spec_from_model(load_model_yaml("yolo11s-fce.yaml"), (640, 640))
    assert s == S.StemSpec(H=640, W=640, c0=32, c1=64, c2=128, ch=32, n=1, c3k=False)
    m = S.stem_spec_from_model(load_model_yaml("yolo11m.yaml"), (640, 640))
    assert m == S.StemSpec(H=640, W=640, c0=64, c1=128, c2=256, ch=64, n=1, c3k=True)
    for name, imgsz in [("yolo11n.yaml", 640), ("yolo11l.yaml", 640), ("yolo11x.yaml", 640),
                        ("yolo11m.yaml", 1280)]:
        assert S.stem_spec_from_model(load_model_yaml(name), (imgsz, imgsz)) is None, name
