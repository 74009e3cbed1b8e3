"""The blocks of the v3, v5, v6, v8, v9 and yolo12 families, and the v8-era
(``legacy``) Detect head on four levels, each against its flax twin in
float32 on the same bridged weights (``variables_to_state_dict``) and
seeded inputs, at narrow widths. The legacy Segment, Pose and OBB heads are
held to JAX in the whole-model forwards of ``test_torch_families_models.py``.

Tolerance: max|port - jax| <= 1e-5 * max|jax|, as ``test_torch_modules.py``:
both sides compute in f32 and differ only in summation order. ``CBFuse``'s
resize and the pad + pool pair move values without arithmetic and are
bit-equal. In bfloat16, RepConv and the blocks on it stay within
0.02 * max|f32| of float32, the bound of the card's bf16 checks.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fce_yolo_tpu.nn import modules as JM
from fce_yolo_tpu_torch.cfg.models import load_model_dict
from fce_yolo_tpu_torch.nn import modules as PM
from fce_yolo_tpu_torch.nn.model import build_model, init_weights
from test_torch_modules import _close, _nchw_to_nhwc, _pair, _x

torch.set_num_threads(1)

CASES = {
    "c2f": (lambda: JM.C2f(16, 32, n=2, shortcut=True), lambda: PM.C2f(16, 32, n=2, shortcut=True), (1, 9, 7, 16)),
    "c2f_no_shortcut": (lambda: JM.C2f(32, 32, n=1), lambda: PM.C2f(32, 32, n=1), (2, 6, 8, 32)),
    "c2": (lambda: JM.C2(32, 32, n=2), lambda: PM.C2(32, 32, n=2), (1, 6, 5, 32)),
    "bottleneck_yaml": (lambda: JM.Bottleneck(16, 32, False), lambda: PM.Bottleneck(16, 32, False), (1, 7, 6, 16)),
    "bottleneck_add": (lambda: JM.Bottleneck(16, 16), lambda: PM.Bottleneck(16, 16), (1, 7, 6, 16)),
    "c3": (lambda: JM.C3(16, 32, n=2, shortcut=False), lambda: PM.C3(16, 32, n=2, shortcut=False), (1, 8, 6, 16)),
    "spp": (lambda: JM.SPP(16, 32, (5, 9, 13)), lambda: PM.SPP(16, 32, (5, 9, 13)), (1, 11, 9, 16)),
    "dwconv_s2": (lambda: JM.DWConvBNAct.make(16, 32, 3, 2), lambda: PM.DWConvBNAct(16, 32, 3, 2), (1, 9, 8, 16)),
    "ghostconv": (lambda: JM.GhostConv(16, 32, 3, 2), lambda: PM.GhostConv(16, 32, 3, 2), (1, 9, 10, 16)),
    "ghostbottleneck_s1": (lambda: JM.GhostBottleneck(16, 16), lambda: PM.GhostBottleneck(16, 16), (1, 7, 6, 16)),
    "ghostbottleneck_s2": (lambda: JM.GhostBottleneck(16, 32, 3, 2), lambda: PM.GhostBottleneck(16, 32, 3, 2),
                           (1, 9, 8, 16)),
    "c3ghost": (lambda: JM.C3Ghost(16, 32, n=2), lambda: PM.C3Ghost(16, 32, n=2), (1, 6, 7, 16)),
    "resnetblock_s2": (lambda: JM.ResNetBlock(16, 8, 2), lambda: PM.ResNetBlock(16, 8, 2), (1, 9, 8, 16)),
    "resnetblock_id": (lambda: JM.ResNetBlock(32, 8, 1), lambda: PM.ResNetBlock(32, 8, 1), (1, 5, 6, 32)),
    "resnetlayer_stem": (lambda: JM.ResNetLayer(3, 16, 1, True, 1), lambda: PM.ResNetLayer(3, 16, 1, True, 1),
                         (2, 19, 14, 3)),
    "resnetlayer": (lambda: JM.ResNetLayer(16, 8, 2, False, 3), lambda: PM.ResNetLayer(16, 8, 2, False, 3),
                    (1, 8, 9, 16)),
    "repconv": (lambda: JM.RepConv(16, 32), lambda: PM.RepConv(16, 32), (1, 7, 9, 16)),
    "repbottleneck": (lambda: JM.RepBottleneck(16, 16), lambda: PM.RepBottleneck(16, 16), (1, 6, 6, 16)),
    "repcsp": (lambda: JM.RepCSP(16, 32, n=2), lambda: PM.RepCSP(16, 32, n=2), (1, 6, 5, 16)),
    "repncspelan4": (lambda: JM.RepNCSPELAN4(16, 32, 32, 16, 2), lambda: PM.RepNCSPELAN4(16, 32, 32, 16, 2),
                     (1, 7, 6, 16)),
    "elan1": (lambda: JM.ELAN1(16, 32, 32, 16), lambda: PM.ELAN1(16, 32, 32, 16), (1, 7, 6, 16)),
    "aconv": (lambda: JM.AConv(16, 32), lambda: PM.AConv(16, 32), (1, 9, 12, 16)),
    "adown": (lambda: JM.ADown(16, 32), lambda: PM.ADown(16, 32), (1, 10, 13, 16)),
    "adown_odd_c1": (lambda: JM.ADown(15, 16), lambda: PM.ADown(15, 16), (1, 9, 9, 15)),
    "sppelan": (lambda: JM.SPPELAN(32, 32, 16), lambda: PM.SPPELAN(32, 32, 16), (1, 9, 7, 32)),
    "aattn_area4": (lambda: JM.AAttn(64, 2, 4), lambda: PM.AAttn(64, 2, 4), (2, 8, 4, 64)),
    "aattn_area1": (lambda: JM.AAttn(64, 2, 1), lambda: PM.AAttn(64, 2, 1), (1, 3, 5, 64)),
    "ablock": (lambda: JM.ABlock(64, 2, 1.2, 4), lambda: PM.ABlock(64, 2, 1.2, 4), (1, 4, 6, 64)),
    "a2c2f_area4": (lambda: JM.A2C2f(32, 64, 1, True, 4), lambda: PM.A2C2f(32, 64, 1, True, 4), (2, 8, 4, 32)),
    "a2c2f_residual": (lambda: JM.A2C2f(64, 64, 1, True, 1, True, 1.2),
                       lambda: PM.A2C2f(64, 64, 1, True, 1, True, 1.2), (1, 5, 3, 64)),
    "a2c2f_c3k": (lambda: JM.A2C2f(32, 64, 1, False, -1), lambda: PM.A2C2f(32, 64, 1, False, -1), (1, 6, 5, 32)),
    "convtranspose2d_p0": (lambda: JM.ConvTranspose2d(8, 16, 2, 2, 0), lambda: PM.ConvTranspose2d(8, 16, 2, 2, 0),
                           (1, 5, 4, 8)),
    "convtranspose2d_p1": (lambda: JM.ConvTranspose2d(8, 16, 3, 2, 1), lambda: PM.ConvTranspose2d(8, 16, 3, 2, 1),
                           (1, 5, 4, 8)),
    "maxpool": (lambda: JM.MaxPool2d(2, 2, 0), lambda: PM.MaxPool2d(2, 2, 0), (1, 9, 8, 4)),
    "identity": (lambda: JM.Identity(), lambda: torch.nn.Identity(), (1, 3, 3, 4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_flax(case):
    jf, pf, shape = CASES[case]
    ref, out = _pair(jf(), pf(), [_x(shape, 1)])
    _close(ref, _nchw_to_nhwc(out))


@pytest.mark.parametrize("hw", [(13, 13), (640 // 32, 640 // 32), (7, 10)])
def test_zeropad_then_maxpool_keeps_the_jax_size(hw):
    """yolov3-tiny's (0, 1, 0, 1) pad before a k2 s1 pool keeps (H, W), as
    JAX's; bit-equal at 640 px's P5 and at odd sizes."""
    x = _x((1, *hw, 8), 2)
    ref = JM.MaxPool2d(2, 1, 0).apply({}, JM.ZeroPad2d((0, 1, 0, 1)).apply({}, jnp.asarray(x)))
    pool = torch.nn.Sequential(PM.ZeroPad2d([0, 1, 0, 1]), PM.MaxPool2d(2, 1, 0))
    out = _nchw_to_nhwc(pool(torch.from_numpy(x).permute(0, 3, 1, 2))).numpy()
    assert out.shape == ref.shape == (1, *hw, 8)
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("src,dst", [((4, 6), (8, 12)), ((5, 3), (20, 15)), ((8, 12), (5, 7)), ((9, 4), (4, 9))])
def test_resize_nearest_is_jax_image_resize(src, dst):
    """Half-pixel centres: equal to ``jax.image.resize(method="nearest")``
    for an upscale and a downscale; torch's default rule differs on the
    non-integer ones."""
    x = _x((2, *src, 3), 4)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), method="nearest"))
    out = _nchw_to_nhwc(PM.resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), dst)).numpy()
    np.testing.assert_array_equal(out, ref)
    if (dst[0] % src[0] or dst[1] % src[1]) and (5, 3) != src:
        plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="nearest")
        assert not np.array_equal(_nchw_to_nhwc(plain).numpy(), ref)


@pytest.mark.parametrize("target", [(8, 12), (3, 5)])
def test_cblinear_then_cbfuse_matches_flax(target):
    """Two CBLinear tuples (splits 8 + 16 and 16 + 8 + 16 channels) indexed
    and summed onto a target map, upscaled to it and downscaled to it."""
    srcs = [(JM.CBLinear(16, (8, 16)), PM.CBLinear(16, (8, 16)), _x((1, 4, 6, 16), 5)),
            (JM.CBLinear(8, (16, 8, 16)), PM.CBLinear(8, (16, 8, 16)), _x((1, 8, 12, 8), 6))]
    jouts, pouts = [], []
    for jm, pm, x in srcs:
        ref, out = _pair(jm, pm, [x])
        assert isinstance(out, tuple) and len(out) == len(ref)
        for r, o in zip(ref, out):
            _close(r, _nchw_to_nhwc(o))
        jouts.append(ref)
        pouts.append(tuple(o.detach() for o in out))
    t = _x((1, *target, 16), 7)
    ref = JM.CBFuse((1, 2)).apply({}, [*jouts, jnp.asarray(t)])
    out = PM.CBFuse((1, 2))([*pouts, torch.from_numpy(t).permute(0, 3, 1, 2)])
    _close(ref, _nchw_to_nhwc(out))


def test_aattn_area_split_is_row_major():
    """Area 4 on an 8x4 grid: slabs of two rows each. Shuffling whole rows
    within a slab leaves the slab's attention to itself unchanged, moving a
    row across slabs does not; and a grid that does not split raises."""
    m = PM.AAttn(64, 2, 4).eval()
    x = torch.from_numpy(_x((1, 8, 4, 64), 8)).permute(0, 3, 1, 2)
    with torch.no_grad():
        swap_in = x[:, :, [1, 0, 2, 3, 4, 5, 6, 7]]
        swap_out = x[:, :, [2, 1, 0, 3, 4, 5, 6, 7]]
        m.pe.conv.weight.zero_()  # attention alone (the 7x7 pe mixes neighbours whatever the slabs)
        ref = m(x)
        assert torch.allclose(m(swap_in)[:, :, [1, 0, 2, 3, 4, 5, 6, 7]], ref, atol=1e-5)
        assert not torch.allclose(m(swap_out)[:, :, [2, 1, 0, 3, 4, 5, 6, 7]], ref, atol=1e-3)
    with pytest.raises(ValueError, match="does not split into 4 areas"):
        m(torch.zeros(1, 64, 5, 5))


def test_a2c2f_gamma_residual_starts_at_0p01():
    """yolo12 l/x: ``gamma`` (0.01 a channel, as the JAX param init) on the
    area-attention A2C2f layers only, also after ``init_weights``."""
    d, _ = load_model_dict("yolo12l.yaml")
    d["scales"]["l"] = [0.5, 0.25, 1024]  # narrowed: A2C2f hidden widths 64 and 128
    model, spec, _ = build_model(d, scale="l", device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, PM.A2C2f) and m.gamma is not None:
                m.gamma.zero_()
    init_weights(model, torch.Generator().manual_seed(0))
    gammas = {i: m.gamma for i, m in enumerate(model.model) if isinstance(m, PM.A2C2f) and m.gamma is not None}
    assert sorted(gammas) == [6, 8]  # a2=True; the head's A2C2f (a2=False) takes no gamma
    assert all(torch.equal(g.detach(), torch.full_like(g, 0.01)) for g in gammas.values())
    assert PM.A2C2f(64, 64, 1, True, 1).gamma is None


CH4, STRIDES4 = (16, 32, 32, 64), (4, 8, 16, 32)
LEVELS4 = [(2, 8, 6, 16), (2, 4, 3, 32), (2, 2, 2, 32), (2, 1, 1, 64)]


def _levels():
    return [_x(s, i + 1) for i, s in enumerate(LEVELS4)]


def test_legacy_detect_matches_flax_on_four_levels():
    """The v8-era cls branch (two 3x3 convs) on a P2 head's four levels."""
    jmod = JM.Detect(nc=5, ch=CH4, strides=STRIDES4, legacy=True)
    pmod = PM.Detect(nc=5, ch=CH4, strides=STRIDES4, legacy=True)
    assert isinstance(pmod.cv3[0][0], PM.ConvBNAct) and pmod.cv3[0][0].conv.kernel_size == (3, 3)
    ref, out = _pair(jmod, pmod, _levels())
    _close(ref["preds"], out["preds"])
    for rf, of in zip(ref["feats"], out["feats"]):
        _close(rf, _nchw_to_nhwc(of))


@pytest.mark.parametrize("block", ["repconv", "repncspelan4", "a2c2f_area4"])
def test_bf16_stays_within_the_stems_bound_of_float32(block):
    """RepConv's two branches summed before SiLU (3x3 first, as JAX sums
    them), and the blocks built on it, in bfloat16 against the same weights
    in float32: within 0.02 * max|f32|, the bound the card holds the bf16
    stem and kernel paths to."""
    _, pf, shape = CASES[block]
    torch.manual_seed(0)
    m = pf().eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_var.uniform_(0.5, 1.5)
                mod.running_mean.normal_(0.0, 0.1)
        x = torch.from_numpy(_x(shape, 3)).permute(0, 3, 1, 2)
        ref = m(x)
        out = copy.deepcopy(m).to(torch.bfloat16)(x.to(torch.bfloat16)).float()
    assert float((out - ref).abs().max()) <= 0.02 * float(ref.abs().max())
