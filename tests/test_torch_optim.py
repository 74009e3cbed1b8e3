"""The port's optimizer, schedules, parameter groups, freeze mask and EMA
against the JAX package's optax chain (``fce_yolo_tpu/train/optim.py``) on
the same synthetic parameters and gradients (numpy, from a seed), on the
CPU in float32. No network runs: the parameters carry yolo11n-fce's names
and shapes.

Tolerances: the per-step updates within 1e-6 of each leaf's largest update
(elementwise float32 in the same order; the global norm is summed in
another order), 1e-2 with the momentum stored in bfloat16 (a state value
may round to the other bfloat16 neighbour, 2^-8 relative), EMA within 1e-7 absolute (stored in bfloat16: within one
bfloat16 ulp, as a float32 ulp before the cast can round either way), the LR and momentum schedules
equal to the reference's jitted ones (within 8 float32 ulps where a cosine
enters: XLA's cos is not numpy's), and everything discrete (groups, masks,
the accumulate ramp) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fce_yolo_tpu.train import optim as jopt
from fce_yolo_tpu_torch.nn.model import build_model
from fce_yolo_tpu_torch.nn.weights import flax_path_to_key, variables_to_state_dict
from fce_yolo_tpu_torch.train import optim as popt

torch.set_num_threads(1)
LAYERS = (0, 2, 5, 14, 25)  # Conv, C3k2, BiCoordCrossAtt (bare convs), BiFPN (w), Detect


@pytest.fixture(scope="module")
def full_model():
    return build_model("yolo11n-fce.yaml", device="cpu")[0]


def _nest(tree: dict, path: str, value) -> None:
    *keys, leaf = path.split("/")
    for k in keys:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def flax_tree(model: nn.Module, rng: np.random.RandomState, scale: float, buffers: bool = False) -> dict:
    """Random arrays in the flax layout (conv kernels HWIO) under the flax paths of ``model``'s tensors."""
    tree: dict = {}
    items = model.state_dict().items() if buffers else model.named_parameters()
    for name, t in items:
        if name.endswith("num_batches_tracked"):
            continue
        shape = tuple(t.shape)
        if t.ndim == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])
        _nest(tree, popt.flax_path(model, name), rng.normal(0, scale, shape).astype(np.float32))
    return tree


@pytest.fixture(scope="module")
def sub_model(full_model):
    """Five layers of yolo11n-fce under their own names (``model.{i}...``)."""
    m = nn.Module()
    m.model = nn.ModuleDict({str(i): full_model.model[i] for i in LAYERS})
    return m


def test_flax_paths_invert_the_bridge(full_model):
    names = [n for n in full_model.state_dict() if not n.endswith("num_batches_tracked")]
    for name in names:
        path = popt.flax_path(full_model, name)
        coll = "batch_stats" if name.rsplit(".", 1)[-1].startswith("running") else "params"
        assert flax_path_to_key(coll, tuple(path.split("/"))) == name
    assert popt.flax_path(full_model, "model.25.cv2.0.2.weight") == "layers_25/cv2_0_2/conv2d/kernel"
    assert popt.flax_path(full_model, "model.0.bn.weight") == "layers_0/bn/scale"


def test_param_groups_and_freeze_masks_match_jax(full_model):
    tree = flax_tree(full_model, np.random.RandomState(0), 0.1)
    decay, norm, bias = jopt._param_group_masks(tree)
    groups = popt.param_groups(full_model)
    for tag, mask in (("decay", decay), ("norm", norm), ("bias", bias)):
        sd = variables_to_state_dict({"params": jax.tree_util.tree_map(lambda b: np.array(b, np.float32), mask)})
        for key, flag in sd.items():
            assert (groups[key] == tag) == bool(flag), (key, tag)
    assert set(groups.values()) == {"decay", "norm", "bias"}
    for freeze in (3, [0, 5], ["cv3", 12], ["except:cv2_"]):
        mask = jopt.freeze_mask(tree, freeze)
        sd = variables_to_state_dict({"params": jax.tree_util.tree_map(lambda b: np.array(b, np.float32), mask)})
        ours = popt.freeze_mask(full_model, freeze)
        assert {k: bool(v) for k, v in sd.items()} == ours
        assert 0 < sum(ours.values()) < len(ours)


CFGS = [
    dict(epochs=3, steps_per_epoch=40, warmup_epochs=1.0),
    dict(epochs=3, steps_per_epoch=40, warmup_epochs=1.0, cos_lr=True, nbs=60, batch_size=8),
    dict(epochs=5, steps_per_epoch=7, warmup_epochs=0.0, lrf=0.2, batch_size=12),
    dict(epochs=400, steps_per_epoch=40, warmup_epochs=2.0, cos_lr=True),
]


@pytest.mark.parametrize("kw", CFGS)
def test_schedules_match_jax(kw):
    cfg = jopt.OptimCfg(**kw)
    pcfg = popt.OptimCfg(**kw)
    b, m = jopt.boundary_schedule(cfg)
    pb, pm = popt.boundary_schedule(pcfg)
    np.testing.assert_array_equal(pb, b)
    np.testing.assert_array_equal(pm, m)
    ni = jnp.arange(0, cfg.epochs * cfg.steps_per_epoch + 5, 3)
    for bias in (False, True):
        ref = np.asarray(jax.jit(jax.vmap(jopt.lr_schedule(cfg, bias=bias)))(ni))
        out = np.array([popt.lr_schedule(pcfg, bias=bias)(int(i)) for i in ni])
        if cfg.cos_lr:  # XLA's float32 cos is not numpy's
            np.testing.assert_array_max_ulp(out, ref, maxulp=8)
        else:
            np.testing.assert_array_equal(out, ref)
    ref = np.asarray(jax.jit(jax.vmap(jopt.momentum_schedule(cfg)))(ni))
    np.testing.assert_array_equal(np.array([popt.momentum_schedule(pcfg)(int(i)) for i in ni]), ref)
    for opt, nc in (("auto", 80), ("auto", 3), ("SGD", 80)):
        assert popt.resolve_auto(pcfg._replace(optimizer=opt, nc=nc))._asdict() == \
            jopt.resolve_auto(cfg._replace(optimizer=opt, nc=nc))._asdict()


OPTIMIZERS = [
    ("SGD", None, dict(batch_size=16), True),  # warmup with the accumulate ramp
    ("SGD", [0, 5], dict(batch_size=16, cos_lr=True), False),
    ("AdamW", None, dict(batch_size=16), True),
    ("Adam", [0], dict(batch_size=16), True),
    ("RMSProp", None, dict(batch_size=16), True),
    ("AdamW", ["except:cv3"], dict(batch_size=8, warmup_epochs=0.0), True),  # no warmup, 8 micro-batches a step
    ("SGD", None, dict(batch_size=16, state_bf16=True), True),  # momentum stored in bfloat16
    ("AdamW", None, dict(batch_size=16, state_bf16=True), True),
]


@pytest.mark.parametrize("name,freeze,kw,ramp", OPTIMIZERS, ids=lambda v: str(v))
def test_optimizer_matches_optax(sub_model, name, freeze, kw, ramp):
    """Five steps; the gradients' global norm is below the clip on even
    steps and above it on odd ones."""
    rng = np.random.RandomState(1)
    tree = flax_tree(sub_model, rng, 0.1)
    cfg = jopt.OptimCfg(optimizer=name, lr0=0.01, epochs=3, steps_per_epoch=40, nc=3, **{"warmup_epochs": 1.0, **kw})
    ni_map = jopt.boundary_schedule(cfg)[1] if ramp else None
    tx = jopt.build_optimizer(cfg, tree, freeze=freeze, ni_map=ni_map)
    jstate = tx.init(tree)
    update = jax.jit(tx.update)
    names = [n for n, _ in sub_model.named_parameters()]
    sub_model.load_state_dict(variables_to_state_dict({"params": tree}), strict=False)
    params = [p for _, p in sub_model.named_parameters()]
    opt = popt.Optimizer(popt.OptimCfg(**cfg._asdict()), sub_model, freeze=freeze, ni_map=ni_map)
    n_elem = sum(p.numel() for p in params)
    jparams = tree
    for step in range(5):
        scale = (5.0 if step % 2 else 20.0) / np.sqrt(n_elem)  # norm ~5, then ~20
        grads = jax.tree_util.tree_map(lambda x: rng.normal(0, scale, x.shape).astype(np.float32), tree)
        ref, jstate = update(grads, jstate, jparams)
        ref = jax.tree_util.tree_map(np.asarray, ref)
        jparams = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), jparams, ref)
        gsd, rsd = variables_to_state_dict({"params": grads}), variables_to_state_dict({"params": ref})
        out = opt.update(params, [gsd[n] for n in names])
        with torch.no_grad():
            torch._foreach_add_(params, out)
        for n, u in zip(names, out):
            r = rsd[n].numpy()
            # bfloat16 state: a float32 ulp before the state's cast can round to the other
            # bfloat16 neighbour (2^-8 relative), which the next steps carry
            bound = (1e-2 if cfg.state_bf16 else 1e-6) * np.abs(r).max()
            assert np.abs(u.numpy() - r).max() <= bound, (step, n, np.abs(u.numpy() - r).max(), bound)
    assert opt.count == 5
    if cfg.state_bf16:
        assert all(t.dtype == torch.bfloat16 for t in opt.state["trace" if name == "SGD" else "mu"])


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_ema_matches_jax(sub_model, dtype):
    rng = np.random.RandomState(2)
    tree = flax_tree(sub_model, rng, 0.1)
    jema = jopt.EMA.create(tree, dtype=getattr(jnp, dtype) if dtype else None)
    sub_model.load_state_dict(variables_to_state_dict({"params": tree}), strict=False)
    names = [n for n, _ in sub_model.named_parameters()]
    ema = popt.EMA([p for _, p in sub_model.named_parameters()], dtype=getattr(torch, dtype) if dtype else None)
    jupdate = jax.jit(lambda e, p: e.update(p, decay=0.9999))
    for _ in range(5):
        new = jax.tree_util.tree_map(lambda x: rng.normal(0, 0.1, x.shape).astype(np.float32), tree)
        jema = jupdate(jema, new)
        nsd = variables_to_state_dict({"params": new})
        ema.update([nsd[n] for n in names], decay=0.9999)
    assert ema.updates == int(jema.updates) == 5
    ref = variables_to_state_dict({"params": jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jema.params)})
    for n, e in zip(names, ema.params):
        assert e.dtype == (torch.bfloat16 if dtype else torch.float32)
        if dtype:  # one bfloat16 ulp: the float32 value before the cast may sit a float32 ulp away
            ulps = (e.view(torch.int16).int() - ref[n].to(torch.bfloat16).view(torch.int16).int()).abs()
            assert int(ulps.max()) <= 1, n
        else:
            np.testing.assert_allclose(e.numpy(), ref[n].numpy(), rtol=0, atol=1e-7)
