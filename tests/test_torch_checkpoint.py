"""The port's checkpoints, metrics log and NaN guard, held to the JAX package's.

- `training/checkpoint.py`: one score sequence through JAX's
  `CheckpointManager` and the port's gives the same best/last choices, the
  same `meta.json` and `config.json`, and the same hook calls, a failing
  hook included; the superset restore, the shape-mismatch error and the
  slim-checkpoint restore behave as JAX's; everything loads under
  `torch.load(..., weights_only=True)`.
- `run._resolve_resume` maps 1/true, best, last, a path and `required=True`
  as JAX's does.
- `utils/logging.py`: `MetricsLogger` writes JAX's records (apart from
  `time`) and isolates a failing sink; `Profiler` gives JAX's summary keys
  and writes a Chrome trace; `nan_guard` raises JAX's error.
- `Optimizer.state_dict()` carries Adam's moments and step counts and the
  StepLR schedule's count: a restored optimizer continues bitwise.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("orbax.checkpoint")

from trafficbots_tpu import run as JR  # noqa: E402
from trafficbots_tpu.training.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from trafficbots_tpu.utils import logging as JL  # noqa: E402
from trafficbots_tpu_torch import run as TR  # noqa: E402
from trafficbots_tpu_torch.training import checkpoint as TC  # noqa: E402
from trafficbots_tpu_torch.training.checkpoint import CheckpointManager as TCkpt  # noqa: E402
from trafficbots_tpu_torch.utils import logging as TL  # noqa: E402

SCORES = [0.5, 0.3, 0.4, 0.1, 0.1, 0.2, -0.7]
CONFIG = {"seed": 3, "model": {"hidden_dim": 64}}


def drive(cls, directory, state, mode="min", fail_at=None):
    """Feed SCORES into a manager; -> (improved flags, meta.json after each
    step, hook calls as (name, step, score, is_best), warnings)."""
    calls = []

    def hook(path, step, score, is_best):
        if len(calls) == fail_at:
            calls.append(("raised",))
            raise RuntimeError("uploader down")
        calls.append((os.path.basename(path), step, score, is_best))

    ckpt = cls(directory, mode=mode, config=CONFIG, hook=hook)
    improved, metas = [], []
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for step, score in enumerate(SCORES):
            metrics = {"val/loss": score, "val/other": 2.0 * step}
            ckpt.save_last(state, step, metrics)
            improved.append(ckpt.save_if_best(state, step, metrics))
            with open(os.path.join(directory, "meta.json")) as f:
                metas.append(json.load(f))
    sidecars = {n: json.load(open(os.path.join(directory, n, "config.json"))) for n in ("best", "last")}
    return improved, metas, calls, sidecars, [str(x.message) for x in w if "hook" in str(x.message)], ckpt


@pytest.mark.parametrize("mode,fail_at", [("min", None), ("max", None), ("min", 3)])
def test_best_last_meta_config_and_hooks_match_jax(tmp_path, mode, fail_at):
    j = drive(JCkpt, str(tmp_path / "j"), {"params": {"w": np.ones(3, np.float32)}}, mode, fail_at)
    t = drive(TCkpt, str(tmp_path / "t"), {"params": {"w": torch.ones(3)}}, mode, fail_at)
    for a, b in zip(j[:5], t[:5]):
        assert a == b
    assert any(j[0]) and not all(j[0])
    if fail_at is not None:
        assert t[2][fail_at] == ("raised",) and len(t[2]) == fail_at + 1 and t[5].hook is None
        assert len(t[4]) == 1 and "checkpoint hook failed" in t[4][0]
    # a new manager over the same directory picks up the best score
    assert TCkpt(str(tmp_path / "t"), mode=mode).best_score == JCkpt(str(tmp_path / "j"), mode=mode).best_score


def test_env_hook_loads_and_a_bad_spec_warns(tmp_path, monkeypatch):
    import sys
    import types

    env_calls = []
    mod = types.ModuleType("_fake_port_ckpt_mod")
    mod.on_checkpoint = lambda *a: env_calls.append(a)
    monkeypatch.setitem(sys.modules, "_fake_port_ckpt_mod", mod)
    monkeypatch.setenv("TB_CKPT_HOOK", "_fake_port_ckpt_mod")
    TCkpt(str(tmp_path / "a")).save_last({"params": {"w": torch.ones(2)}}, 1, {"val/loss": 1.0})
    assert len(env_calls) == 1 and env_calls[0][1:] == (1, 1.0, False)
    monkeypatch.setenv("TB_CKPT_HOOK", "_no_such_module:nope")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert TCkpt(str(tmp_path / "b")).hook is None
    assert any("failed to load" in str(x.message) for x in w)


def test_layout_and_weights_only_loading(tmp_path):
    """A directory a checkpoint, one torch.save file and config.json; the
    file loads with weights_only=True."""
    ckpt = TCkpt(str(tmp_path / "ckpt"), config=CONFIG)
    gen = torch.Generator().manual_seed(5)
    ckpt._save("last", {"params": {"w": torch.arange(3.0)}, "epoch": 2, "global_step": 7,
                        "rng": gen.get_state(), "name": "x"})
    assert sorted(os.listdir(tmp_path / "ckpt" / "last")) == ["config.json", TC.STATE_FILE]
    state = torch.load(tmp_path / "ckpt" / "last" / TC.STATE_FILE, weights_only=True)
    assert torch.equal(state["params"]["w"], torch.arange(3.0)) and state["epoch"] == 2 and state["name"] == "x"
    assert torch.equal(state["rng"], gen.get_state())
    assert ckpt.exists("last") and not ckpt.exists("best")


def test_restore_superset_fallback_and_shape_mismatch(tmp_path):
    """As the JAX test of the same name: params alone from a checkpoint that
    holds more; a target of other shapes fails at restore."""
    for cls, arr in ((JCkpt, lambda *s: np.ones(s, np.float32)), (TCkpt, lambda *s: torch.ones(s))):
        ckpt = cls(str(tmp_path / cls.__module__))
        ckpt._save("last", {"params": {"w": arr(3, 4)}, "extra": arr(2)})
        got = ckpt.restore("last", {"params": {"w": 0 * arr(3, 4)}})
        np.testing.assert_array_equal(np.asarray(got["params"]["w"]), np.ones((3, 4)))
        assert list(got) == ["params"]
        with pytest.raises(ValueError, match="incompatible"):
            ckpt.restore("last", {"params": {"w": arr(3, 8)}})
    ckpt = TCkpt(str(tmp_path / "keys"))
    ckpt._save("last", {"params": {"w": torch.ones(2)}})
    with pytest.raises(ValueError, match="incompatible"):
        ckpt.restore("last", {"params": {"w": torch.ones(2), "b": torch.ones(2)}})
    with pytest.raises(ValueError, match="holds no"):
        ckpt.restore("last", {"opt_state": {}})


def test_restore_trainer_state_reads_a_slim_checkpoint(tmp_path):
    """A {params, opt_state} checkpoint restores with the target's counters
    (epoch 0), as JAX's restore_trainer_state does; a full one restores all."""
    ckpt = TCkpt(str(tmp_path / "ckpt"))
    ckpt._save("last", {"params": {"w": torch.ones(3)}, "opt_state": {"m": torch.zeros(3)}})
    gen_state = torch.Generator().manual_seed(1).get_state()
    target = {"params": {"w": torch.zeros(3)}, "opt_state": {"m": torch.ones(3)}, "epoch": 0, "global_step": 0,
              "rng": gen_state}
    out = ckpt.restore_trainer_state("last", target)
    assert torch.equal(out["params"]["w"], torch.ones(3)) and torch.equal(out["opt_state"]["m"], torch.zeros(3))
    assert out["epoch"] == 0 and out["global_step"] == 0 and torch.equal(out["rng"], gen_state)
    ckpt._save("last", dict(target, epoch=4, global_step=9))
    out = ckpt.restore_trainer_state("last", target)
    assert out["epoch"] == 4 and out["global_step"] == 9


def test_resolve_resume_matches_jax(tmp_path):
    ext = {}
    results = {}
    for name, cls, state in (("jax", JCkpt, {"params": {"w": np.ones(3, np.float32)}}),
                             ("port", TCkpt, {"params": {"w": torch.ones(3)}})):
        resolve = {"jax": JR._resolve_resume, "port": TR._resolve_resume}[name]
        ckpt = cls(str(tmp_path / name / "ckpt"))
        row = [resolve(ckpt, v, default="last") for v in ("last", "1", "best")]
        ckpt._save("last", state)
        ckpt._save("best", state)
        row += [resolve(ckpt, v, default=d) for v, d in (("1", "last"), ("true", "best"), ("True", "last"),
                                                          ("yes", "best"), ("best", "last"), ("last", "best"))]
        ext[name] = str(tmp_path / name / "elsewhere")
        cls(ext[name])._save("last", state)
        path = os.path.join(ext[name], "last")
        row.append(resolve(ckpt, path, default="last") == path)
        row.append(resolve(ckpt, str(tmp_path / "missing"), default="last"))
        with pytest.raises(SystemExit, match="no such checkpoint"):
            resolve(cls(str(tmp_path / name / "empty")), "best", default="best", required=True)
        with pytest.raises(SystemExit, match="no such checkpoint"):
            resolve(ckpt, str(tmp_path / "missing"), default="best", required=True)
        results[name] = row
    assert results["port"] == results["jax"]
    assert results["port"][:3] == [None] * 3 and results["port"][-2:] == [True, None]


def test_metrics_logger_records_match_jax(tmp_path):
    rec = {"jax": [], "port": []}
    metrics = {"loss": torch.tensor(1.5), "grad_norm": np.float32(2.0), "n": 3, "name": "skipped",
               "vec": torch.ones(2), "lst": [1, 2]}
    for name, mod in (("jax", JL), ("port", TL)):
        logger = mod.MetricsLogger(str(tmp_path / name), sink=rec[name].append)
        logger.log(metrics, 5)
        logger.log({"val/loss": 0.25}, 6, phase="val")
    files = {n: [json.loads(line) for line in open(tmp_path / n / "metrics.jsonl")] for n in rec}
    for n in rec:
        assert files[n] == rec[n]
        for r in files[n]:
            r.pop("time")
    assert files["port"] == files["jax"] == [{"step": 5, "phase": "train", "loss": 1.5, "grad_norm": 2.0, "n": 3.0},
                                             {"step": 6, "phase": "val", "val/loss": 0.25}]


def test_metrics_sink_failure_is_isolated(tmp_path, monkeypatch):
    def boom(rec):
        raise RuntimeError("sink down")

    logger = TL.MetricsLogger(str(tmp_path), sink=boom)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        logger.log({"loss": 1.0}, 0)
        logger.log({"loss": 2.0}, 1)
    assert logger.sink is None and sum("metrics sink failed" in str(x.message) for x in w) == 1
    assert len(open(logger.path).readlines()) == 2
    monkeypatch.setenv("TB_METRICS_HOOK", "_no_such_module:nope")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert TL.MetricsLogger(str(tmp_path / "b")).sink is None
    assert any("failed to load" in str(x.message) for x in w)


def test_profiler_summary_keys_and_chrome_trace(tmp_path):
    summaries = []
    for mod in (JL, TL):
        prof = mod.Profiler()
        for name in ("train_step", "train_step", "val_step"):
            with prof.phase(name):
                pass
        summaries.append(prof.summary())
    assert summaries[0].keys() == summaries[1].keys() == {"time/train_step_mean_s", "time/val_step_mean_s"}
    with TL.Profiler().device_trace("off"):  # no trace_dir: a no-op
        torch.ones(2).sum()
    with TL.Profiler(trace_dir=str(tmp_path)).device_trace("step"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = json.load(open(tmp_path / "step" / "trace.json"))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_nan_guard_matches_jax():
    tree = {"b": np.array([1.0, np.nan]), "a": {"x": np.float32(np.inf), "y": np.arange(3)},
            "c": [np.zeros(2), np.array([-np.inf])], "d": np.ones(2)}
    msgs = []
    for guard in (JL.nan_guard, TL.nan_guard):
        with pytest.raises(FloatingPointError) as e:
            guard(tree, "state")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "non-finite values in state: [\"['a']['x']\", \"['b']\", \"['c'][1]\"]"
    t = {f"p{i}": torch.full((2,), float("nan")) for i in range(7)}
    t["ok"] = torch.ones(2)
    t["int"] = torch.arange(3)
    with pytest.raises(FloatingPointError) as e:
        TL.nan_guard({"grads": t})
    assert str(e.value) == "non-finite values in tree: " + str([f"['grads']['p{i}']" for i in range(5)])
    assert TL.nan_guard({"m": torch.ones(3), "g": None, "i": torch.arange(2)})


def test_optimizer_state_dict_resumes_bitwise():
    """Two Adam steps straight through, against one step, a state_dict
    round trip through torch.save / weights_only load into a new optimizer
    (and a new model holding the first's weights), and the second step."""
    import io

    from trafficbots_tpu_torch.config import ExperimentConfig, OptimizerConfig
    from trafficbots_tpu_torch.training.train import Optimizer

    cfg = ExperimentConfig(optimizer=OptimizerConfig(scheduler_step_size=1, scheduler_gamma=0.5))

    def model():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))

    def step(m, opt, i):
        m.zero_grad()
        m(torch.full((5, 4), float(i + 1))).square().sum().backward()
        opt.step()

    a = model()
    oa = Optimizer(cfg, a, steps_per_epoch=1)
    step(a, oa, 0)
    buf = io.BytesIO()
    torch.save({"params": a.state_dict(), "opt_state": oa.state_dict()}, buf)
    step(a, oa, 1)

    b = model()
    ob = Optimizer(cfg, b, steps_per_epoch=1)
    buf.seek(0)
    state = torch.load(buf, weights_only=True)
    b.load_state_dict(state["params"])
    ob.load_state_dict(state["opt_state"])
    step(b, ob, 1)
    assert [g["lr"] for g in ob.adam.param_groups] == [g["lr"] for g in oa.adam.param_groups]
    assert oa.adam.param_groups[0]["lr"] == cfg.optimizer.lr * 0.25  # StepLR went on counting
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
