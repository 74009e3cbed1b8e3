"""The port's tooling against the JAX package's, on the CPU: ``check_imgsz``,
``check_version``, the settings file (the port's own), ``Profile``,
``SystemLogger``, ``trace_profile``, ``TQDM`` (the same lines on a fake
clock), ``colorstr``, ``GitRepo``/``CPUInfo``, the usage-event spool,
``autobatch``'s rule on stubbed measurements, ``check_numeric_stability``,
``collect_system_info``, and the benchmark table: ``profile_inference``
and ``benchmark`` with JAX's keys, the ``stablehlo`` row as the port's
``torch_export`` and a ``FAILED`` row naming TensorFlow for the others,
``ProfileModels``."""

import io
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fce_yolo_tpu.utils.autobatch as jax_autobatch
import fce_yolo_tpu.utils.benchmarks as jax_bench
import fce_yolo_tpu.utils.checks as jax_checks
import fce_yolo_tpu.utils.logger as jax_logger
import fce_yolo_tpu.utils.settings as jax_settings
import fce_yolo_tpu.utils.sysinfo as jax_sysinfo
import fce_yolo_tpu.utils.tqdm as jax_tqdm
from fce_yolo_tpu.utils.events import Events as JaxEvents
from fce_yolo_tpu_torch import YOLO
from fce_yolo_tpu_torch.utils import autobatch, benchmarks, checks, logger, settings, sysinfo
from fce_yolo_tpu_torch.utils import tqdm as port_tqdm
from fce_yolo_tpu_torch.utils.events import Events

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
NARROW = str(REPO / "tests" / "fixtures" / "yolo11-fce-narrow.yaml")


@pytest.mark.parametrize("args", [(640,), (641,), ([100, 200],), (10,), ([100],), (33, 16), ([50], 32, 2),
                                  (70, 32, 1, 96)])
def test_check_imgsz_as_jax(args, capsys):
    out = checks.check_imgsz(*args)
    port_out = capsys.readouterr().out
    assert out == jax_checks.check_imgsz(*args) and port_out == capsys.readouterr().out


@pytest.mark.parametrize("current,required", [("2.1.0", ">=2.0"), ("1.9", ">=2.0"), ("1.2.3", "==1.2.3"),
                                              ("1.2.3", ""), ("2.13.0+cpu", "<3"), ("1.10", "!=1.10.0"),
                                              ("0.9.1", "0.9")])
def test_check_version_as_jax(current, required):
    assert checks.check_version(current, required) == jax_checks.check_version(current, required)


def test_settings_file_is_the_ports_own(tmp_path, monkeypatch):
    assert settings.DEFAULTS == jax_settings.DEFAULTS
    monkeypatch.delenv("FCE_YOLO_TORCH_CONFIG_DIR", raising=False)
    monkeypatch.delenv("FCE_YOLO_CONFIG_DIR", raising=False)
    assert settings._config_dir().name == "fce_yolo_tpu_torch" and jax_settings._config_dir().name == "fce_yolo_tpu"
    monkeypatch.setenv("FCE_YOLO_TORCH_CONFIG_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("FCE_YOLO_CONFIG_DIR", str(tmp_path / "jax"))
    s = settings.SettingsManager()
    assert s.path == tmp_path / "port" / "settings.json" and s.path.exists()
    s.update(runs_dir="elsewhere")
    assert not (tmp_path / "jax").exists()
    j = jax_settings.SettingsManager()
    assert j["runs_dir"] == "runs" and settings.SettingsManager()["runs_dir"] == "elsewhere"


def test_settings_rules_as_jax(tmp_path):
    """The same load, update, reset and version rules, step for step."""
    out = {}
    for name, cls in (("jax", jax_settings.SettingsManager), ("port", settings.SettingsManager)):
        p = tmp_path / name / "settings.json"
        steps = [dict(cls(p))]
        s = cls(p)
        s.update(runs_dir="elsewhere", sync=True)
        steps.append(dict(cls(p)))
        with pytest.raises(KeyError) as e:
            s.update(bogus=1)
        steps.append(str(e.value))
        p.write_text(json.dumps({"settings_version": "1.0", "weights_dir": "w2", "extra": 1}))
        steps.append(dict(cls(p)))
        p.write_text(json.dumps({"settings_version": "0.1", "weights_dir": "old"}))
        steps.append((dict(cls(p)), json.loads(p.read_text())))
        p.write_text("{not json")
        steps.append((dict(cls(p)), p.read_text()))
        out[name] = steps
    assert out["port"] == out["jax"]


def test_profile_system_logger_and_trace(tmp_path):
    import time

    with logger.Profile() as t:
        time.sleep(0.01)
    with logger.Profile(t.t) as t2:
        time.sleep(0.01)
    assert 0.005 < t.t < 1.0 and t2.t > t.t and str(t2).endswith("s")
    snap, ref = logger.SystemLogger().snapshot(), jax_logger.SystemLogger().snapshot()
    assert {"time", "ram_used_frac"} <= set(snap) and set(snap) == set(ref) - {"device_mem_used", "device_mem_limit"}
    with logger.trace_profile(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 100
    assert logger.colorstr("red", "bold", "x") == jax_logger.colorstr("red", "bold", "x")
    assert logger.colorstr("hi") == jax_logger.colorstr("hi")
    assert logger.LOGGER.name == "fce_yolo_tpu_torch"


def test_tqdm_lines_as_jax(monkeypatch):
    """The same bar text as the JAX ``TQDM`` on a log file and on a tty,
    with both modules on one fake clock."""
    def run(mod, tty: bool) -> str:
        clock = iter(np.arange(0.0, 1000.0, 0.7))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(clock)))
        f = io.StringIO()
        f.isatty = lambda: tty
        for _ in mod.TQDM(range(37), desc="scan", unit="img", file=f):
            pass
        with mod.TQDM(total=5000, desc="bytes", file=f) as bar:
            bar.set_postfix(loss=0.5)
            for _ in range(20):
                bar.update(250)
        for _ in mod.TQDM(iter(range(3)), file=f):
            pass
        return f.getvalue()

    for tty in (False, True):
        ref, out = run(jax_tqdm, tty), run(port_tqdm, tty)
        assert out == ref and out.count("scan") >= 2


def test_gitrepo_and_cpuinfo_as_jax(tmp_path):
    for path in (REPO / "fce_yolo_tpu_torch", None):
        a, b = sysinfo.GitRepo(path), jax_sysinfo.GitRepo(path)
        assert (a.root, a.gitdir, a.branch, a.commit, a.origin) == (b.root, b.gitdir, b.branch, b.commit, b.origin)
    assert a.is_repo and len(a.commit) == 40
    g = tmp_path / "proj" / ".git"
    (g / "refs" / "heads").mkdir(parents=True)
    (g / "HEAD").write_text("ref: refs/heads/dev\n")
    (g / "packed-refs").write_text("# pack-refs with: peeled\nabc123 refs/heads/dev\n")
    (g / "config").write_text('[remote "origin"]\n\turl = https://example.com/x.git\n')
    repo = sysinfo.GitRepo(tmp_path / "proj" / "src")
    assert (repo.branch, repo.commit, repo.origin) == ("dev", "abc123", "https://example.com/x.git")
    assert sysinfo.CPUInfo.name() == jax_sysinfo.CPUInfo.name()
    assert sysinfo.CPUInfo._clean("Intel(R) Xeon(R) CPU @ 2.20GHz") == "Intel Xeon 2.20GHz"
    assert not hasattr(sysinfo, "TPUInfo")


def test_events_spool_as_jax(tmp_path):
    assert not Events(path=tmp_path / "off.jsonl").enabled  # sync off, and under pytest
    lines = {}
    for name, cls in (("jax", JaxEvents), ("port", Events)):
        ev = cls(path=tmp_path / f"{name}.jsonl")
        ev({"task": "detect", "mode": "train", "model": "m"})
        assert not (tmp_path / f"{name}.jsonl").exists()
        ev.enabled, ev.rate_limit = True, 0.0
        ev({"task": "segment", "mode": "val", "model": "yolo11n-seg"}, device="cpu")
        ev(SimpleNamespace(task="alchemy", mode="transmute", model=None), device="cpu")
        ev.rate_limit = 3600.0
        ev({"task": "detect", "mode": "train"})
        assert len(ev.events) == 1
        lines[name] = [json.loads(x) for x in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
    for a, b in zip(lines["jax"], lines["port"]):
        for e in (a, b):
            del e["params"]["session_id"], e["params"]["version"], e["params"]["cli"]
        assert a == b
    assert [e["name"] for e in lines["port"]] == ["val", "other"]
    assert Events().path == settings._config_dir() / "events.jsonl"


@pytest.mark.parametrize("mem,total,probe,fraction,max_batch", [
    (2 << 30, 80 << 30, 8, 0.8, 1024), (2 << 30, 80 << 30, 8, 0.8, 16), (100 << 30, 80 << 30, 8, 0.8, 1024),
    (3 << 20, 16 << 30, 4, 0.5, 1024), (123456789, 80 << 30, 16, 0.9, 1024), (1, 80 << 30, 8, 0.8, 1 << 20)])
def test_autobatch_rule_as_jax(mem, total, probe, fraction, max_batch, monkeypatch):
    """Both packages' rule on the same measurement: the port's probe call
    (``_measure``) and the JAX compile's memory analysis stubbed to ``mem``
    bytes of a ``total``-byte device."""
    class Compiled:
        def memory_analysis(self):
            return SimpleNamespace(temp_size_in_bytes=mem, argument_size_in_bytes=0, output_size_in_bytes=0,
                                   generated_code_size_in_bytes=0)

    import jax

    fake_jit = lambda fn: SimpleNamespace(lower=lambda *a: SimpleNamespace(compile=Compiled))  # noqa: E731
    monkeypatch.setattr(jax, "jit", fake_jit)
    monkeypatch.setattr(jax_autobatch, "device_memory_bytes", lambda: total)
    monkeypatch.setattr(autobatch, "_measure", lambda fn, args: (mem, total))
    kw = dict(probe_batch=probe, fraction=fraction, max_batch=max_batch)
    ref = jax_autobatch.autobatch(lambda b: None, lambda b: (), **kw)
    assert autobatch.autobatch(lambda b: None, lambda b: (), **kw) == ref and ref & (ref - 1) == 0


def test_autobatch_on_the_cpu_keeps_the_probe_batch():
    calls = []

    def make_fn(b):
        return lambda x: calls.append(x.shape) or x.sum()

    assert autobatch.autobatch(make_fn, lambda b: (torch.zeros(b, 8),), probe_batch=4) == 4 and calls == []
    assert autobatch._measure(make_fn(4), (torch.zeros(4, 8),)) is None


def test_checks_on_the_cpu():
    assert checks.cuda_is_available() is False
    yolo = YOLO(NARROW, device="cpu", nc=3)
    before = {k: v.clone() for k, v in yolo.model.state_dict().items()}
    yolo.model.train()
    assert checks.check_numeric_stability(yolo.model, imgsz=64) is True
    assert next(yolo.model.parameters()).dtype == torch.float32 and yolo.model.training
    assert all(torch.equal(before[k], v) for k, v in yolo.model.state_dict().items())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checks.check_numeric_stability()


def test_profile_inference_and_benchmark_rows_as_jax(monkeypatch, capsys):
    """The JAX table's keys (its ``profile_inference`` run on the JAX
    facade, its ``benchmark`` with the export stubbed to fail), and the
    port's rows: the native row first, then the ``stablehlo`` row as the
    port's ``torch_export`` (exported, read back and timed) and a ``FAILED``
    row naming TensorFlow for each of the other export formats."""
    import jax
    import jax.numpy as jnp

    import fce_yolo_tpu.engine.exporter as jax_exporter
    import fce_yolo_tpu.nn.model as jax_model
    from fce_yolo_tpu.api import YOLO as JaxYOLO
    from fce_yolo_tpu_torch.nn.weights import state_dict_to_variables

    monkeypatch.setattr(jax_model, "resolve_strides", lambda spec: (8, 16, 32))
    yolo = YOLO(NARROW, device="cpu")
    jy = JaxYOLO(NARROW)
    jy.variables = jax.tree_util.tree_map(jnp.asarray, state_dict_to_variables(yolo.model))  # no flax init
    ref_prof = jax_bench.profile_inference(jy, imgsz=32, batch=1, iters=1, warmup=1)
    prof = benchmarks.profile_inference(yolo, imgsz=64, batch=2, iters=2, warmup=1)
    assert list(prof) == list(ref_prof) and prof["batch"] == 2 and prof["imgsz"] == 64
    assert prof["images_per_sec"] > 0 and abs(prof["ms_per_batch"] - 2 * prof["ms_per_image"]) < 1e-9
    assert next(yolo.model.parameters()).dtype == torch.float32  # the facade's model is left as it was

    def fail(*a, **kw):
        raise NotImplementedError("item 10 (deployment) is not ported")

    monkeypatch.setattr(jax_bench, "profile_inference", lambda *a, **kw: ref_prof)
    monkeypatch.setattr(jax_exporter, "export_model", fail)
    ref = jax_bench.benchmark(jy, imgsz=32, batch=1, verbose=False)
    capsys.readouterr()
    rows = yolo.benchmark(imgsz=64, batch=2)
    assert [list(r) for r in rows] == [list(r) for r in ref] and [r["format"] for r in ref[1:]] == [
        "stablehlo", "saved_model", "tflite"]
    assert [r["format"] for r in rows[1:]] == ["torch_export", "saved_model", "tflite"]
    assert rows[0]["format"] == "torch (native)" and ref[0]["format"] == "jax (native)"
    assert rows[1]["status"] == "OK" and rows[1]["imgsz"] == 64 and rows[1]["batch"] == 1
    assert rows[1]["ms/img"] > 0 and rows[1]["images/sec"] > 0 and rows[1]["mAP50-95"] is None
    for r, j in zip(rows[2:], ref[2:]):
        assert r["status"].startswith(f"FAILED: NotImplementedError: '{r['format']}' needs TensorFlow")
        assert j["status"].startswith("FAILED: NotImplementedError: item 10")
        assert {k: v for k, v in r.items() if k != "status"} == {k: v for k, v in j.items() if k != "status"} | {
            "imgsz": 64}
    assert "torch (native)" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="'saved_model' needs TensorFlow"):
        yolo.export(format="saved_model")


def test_profile_models(tmp_path, capsys):
    art = tmp_path / "m_64.tflite"
    art.write_bytes(b"x")
    (tmp_path / "narrow.yaml").write_text(Path(NARROW).read_text())
    rows = benchmarks.ProfileModels([str(tmp_path)], num_timed_runs=2, num_warmup_runs=1, min_time=0.0, imgsz=64,
                                    device="cpu").run()
    assert [r["name"] for r in rows] == ["narrow", "m_64"]
    assert list(rows[0]) == ["name", "runtime", "imgsz", "ms/img", "ms_std", "params(M)", "FLOPs(B)"]
    assert rows[0]["runtime"] == "torch (native)" and rows[0]["ms/img"] > 0 and rows[0]["params(M)"] > 0
    assert rows[1]["runtime"] == "FAILED" and "needs TensorFlow or JAX" in rows[1]["error"]
    assert "| narrow" in capsys.readouterr().out
    clipped = benchmarks.ProfileModels.iterative_sigma_clipping(np.array([1.0] * 20 + [100.0]))
    assert np.array_equal(clipped, jax_bench.ProfileModels.iterative_sigma_clipping(np.array([1.0] * 20 + [100.0])))
