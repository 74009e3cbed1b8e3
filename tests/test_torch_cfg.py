"""The port's run configuration (``fce_yolo_tpu_torch/cfg``) against the JAX
package's (``fce_yolo_tpu/cfg/__init__.py:18-130``): the same default dict
read without pyyaml, the same namespaces from the same overrides and
``cfg=`` files, and the same exception type and message for unknown keys
and bad values."""

import pytest

import fce_yolo_tpu.cfg as jax_cfg
import fce_yolo_tpu_torch.cfg as port_cfg


def test_default_cfg_equals_the_jax_one():
    port, ref = port_cfg.load_default_cfg(), jax_cfg.load_default_cfg()
    assert list(port) == list(ref) and len(port) == 87
    assert {k: (type(v), v) for k, v in port.items()} == {k: (type(v), v) for k, v in ref.items()}
    assert port_cfg.DEFAULT_CFG_PATH.parent.parent.name == "fce_yolo_tpu_torch"


OVERRIDES = {
    "numbers": {"epochs": "50", "lr0": "0.02", "batch": "-1", "time": "1.5", "warmup_epochs": "2"},
    "bools": {"cos_lr": "true", "save": "False", "rect": "TRUE", "val": False},
    "none": {"conf": "none", "tracker": "None", "line_width": "NONE"},
    "lists": {"classes": "0,2", "freeze": "1,2,3", "imgsz": "320,640"},
    "strings": {"iou_type": "WIoU", "optimizer": "AdamW", "device": "cpu", "name": "run1"},
    "ints_from_floats": {"epochs": 3.0, "max_det": "100.0", "freeze": "10"},
    "typed": {"epochs": 7, "lr0": 0.5, "save_txt": True, "device": 0},
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_get_cfg_namespace_equals_the_jax_one(case):
    over = OVERRIDES[case]
    port, ref = vars(port_cfg.get_cfg(dict(over))), vars(jax_cfg.get_cfg(dict(over)))
    assert {k: (type(v), v) for k, v in port.items()} == {k: (type(v), v) for k, v in ref.items()}


CFG_FILES = {
    "plain": "imgsz: 64\nconf: 0.9\nepochs: 5\n",
    "flow_list_and_null": "classes: [0, 1]\nmodel:\nsave: False\niou_type: GIoU # a comment\n",
    "floats": "lr0: 1.0e-3\nmomentum: .9\nhsv_h: 0.015\n",
}


@pytest.mark.parametrize("case", sorted(CFG_FILES))
def test_get_cfg_from_a_cfg_file_equals_the_jax_one(case, tmp_path):
    f = tmp_path / "custom.yaml"
    f.write_text(CFG_FILES[case])
    over = {"epochs": "2"} if case == "plain" else None
    port, ref = vars(port_cfg.get_cfg(over, cfg=str(f))), vars(jax_cfg.get_cfg(over, cfg=str(f)))
    assert {k: (type(v), v) for k, v in port.items()} == {k: (type(v), v) for k, v in ref.items()}
    as_dict = {"imgsz": 96, "cos_lr": True}
    assert vars(port_cfg.get_cfg(cfg=as_dict)) == vars(jax_cfg.get_cfg(cfg=as_dict))


BAD = {
    "unknown_key_suggestion": ({"epoch": 3}, None),
    "unknown_keys_two": ({"lr": 0.1, "zzz_qq": 1}, None),
    "fraction_out_of_range": ({"lr0": 5.0}, None),
    "fraction_from_cli": ({"iou": "1.5"}, None),
    "not_a_number": ({"box": "big"}, None),
    "not_an_int": ({"epochs": "abc"}, None),
    "not_an_int_float": ({"patience": "2.5"}, None),
    "not_a_bool": ({"save": "maybe"}, None),
    "cfg_file_unknown_key": (None, "epochz: 3\n"),
    "cfg_file_bad_type": (None, "mosaic: 2.0\n"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_overrides_raise_as_the_jax_cfg_does(case, tmp_path):
    over, text = BAD[case]
    cfg = None
    if text is not None:
        cfg = tmp_path / "bad.yaml"
        cfg.write_text(text)
        cfg = str(cfg)
    with pytest.raises(Exception) as ref:
        jax_cfg.get_cfg(dict(over) if over else None, cfg=cfg)
    with pytest.raises(Exception) as port:
        port_cfg.get_cfg(dict(over) if over else None, cfg=cfg)
    assert type(port.value) is type(ref.value) and str(port.value) == str(ref.value)
    if case.startswith("unknown_key_"):
        assert "did you mean" in str(port.value)


def test_key_sets_and_task_models_equal_the_jax_ones():
    for name in ("CFG_FLOAT_KEYS", "CFG_FRACTION_KEYS", "CFG_INT_KEYS", "CFG_BOOL_KEYS", "TASKS", "MODES",
                 "TASK2MODEL"):
        assert getattr(port_cfg, name) == getattr(jax_cfg, name), name
    from fce_yolo_tpu_torch import YOLO

    for task, model in port_cfg.TASK2MODEL.items():
        assert YOLO(model, device="cpu").task == task, model
