"""The port's CLI runner (`python -m trafficbots_tpu_torch.run`) on the CPU at tiny widths.

- `parse_args` gives JAX's config (`config_to_dict`) and runner values for
  a list of argvs: overrides, ablations, a snapshot plus resume with
  overrides on top (and the loud warning without one); an unknown key
  raises on both sides. `_mean_metrics` equals JAX's.
- `action=fit` for 2 epochs equals 1 epoch plus a 1-epoch `resume=last`,
  bitwise: every parameter, Adam's state, the schedule, the epoch, the
  global step and the generator state (the JAX package holds the same with
  rtol 0, tests/test_resume.py).
- `validate` and `test` run from the `best` checkpoint; the test action's
  submission decodes (tests/test_submission.py's `decode_fields`) to one
  scenario prediction per scene.
- One epoch of `fit` reads a packed h5 with `bucket_capacity=true`, the
  batches sliced; `debug_nans=true` stops a run whose step goes non-finite;
  a 1-epoch fit at `n_video_batch=1` writes its validation media under
  `run_dir/videos/epoch0`; an unknown action and a missing CUDA device
  raise.
"""
import json
import os
import tarfile

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from trafficbots_tpu import run as JR  # noqa: E402
from trafficbots_tpu.config import config_to_dict as j_config_to_dict  # noqa: E402
from trafficbots_tpu_torch import run as TR  # noqa: E402
from trafficbots_tpu_torch.config import config_to_dict  # noqa: E402
from trafficbots_tpu_torch.training.checkpoint import STATE_FILE  # noqa: E402

from test_resume import TINY_OVERRIDES as JAX_TINY  # noqa: E402
from test_submission import decode_fields  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

# tests/test_resume.py's tiny run at batch 2 (no 8-device mesh here) and 1 step an
# epoch, on the CPU
TINY = [o for o in JAX_TINY if not o.startswith(("data.batch_size", "steps_per_epoch"))] + [
    "data.batch_size=2", "steps_per_epoch=1", "device=cpu"]


def run(argv):
    TR.main(argv)


def load_state(run_dir, name="last"):
    return torch.load(os.path.join(run_dir, "ckpt", name, STATE_FILE), weights_only=True)


ARGVS = [
    ["action=validate", "model.hidden_dim=64", "optimizer.lr=0.001", "post_processing.k_pred=2",
     "data.n_agent=16", "n_epochs=3", "steps_per_epoch=7", "val_batches=2", "synthetic=1"],
    ["ablation=simnet", "model.pe_dim=16"],
    ["ablation=trafficsim", "ablation=no_goal", "seed=7", "action=test", "run_dir=x/y"],
    ["tf_training.prob_forcing_agent=0.25", "model.map_encoder.node_encoder_impl=hybrid",
     "data.bucket_capacity=true", "limit_train_batches=0.5"],
]


def parse_both(argv):
    j = JR.parse_args(argv)
    t = TR.parse_args(argv + ["device=cpu"])
    return j, t


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: a[0])
def test_parse_args_matches_jax(argv):
    j, t = parse_both(argv)
    assert config_to_dict(t[1]) == j_config_to_dict(j[1])
    assert (t[0],) + t[2:8] == (j[0],) + j[2:8]
    assert t[8:] == ("cpu", False)


def test_parse_args_snapshot_resume_and_unknown_key(tmp_path, capsys):
    run_dir = str(tmp_path / "run")
    _, cfg, *_ = TR.parse_args(["model.hidden_dim=64", "ablation=bc", "seed=11"])
    TR.snapshot_config(cfg, run_dir)
    argv = [f"run_dir={run_dir}", "resume=last", "model.pe_dim=16", "action=validate"]
    j, t = parse_both(argv)
    assert config_to_dict(t[1]) == j_config_to_dict(j[1])
    assert t[1].model.hidden_dim == 64 and t[1].model.pe_dim == 16 and t[1].seed == 11
    out = capsys.readouterr().out
    assert out.count("config loaded from snapshot") == 2 and "(+1 CLI overrides on top)" in out
    # an explicit checkpoint path: the sidecar inside it wins
    ckpt_dir = tmp_path / "handed" / "best"
    ckpt_dir.mkdir(parents=True)
    _, cfg2, *_ = TR.parse_args(["model.hidden_dim=32"])
    (ckpt_dir / "config.json").write_text(json.dumps(config_to_dict(cfg2)))
    j, t = parse_both([f"resume={ckpt_dir}"])
    assert t[1].model.hidden_dim == 32 and config_to_dict(t[1]) == j_config_to_dict(j[1])
    # no snapshot: the loud warning on stderr, on both sides
    capsys.readouterr()
    parse_both([f"run_dir={tmp_path / 'none'}", "resume=best"])
    assert capsys.readouterr().err.count("WARNING: resume=best: no config.json snapshot") == 2
    for parse in (JR.parse_args, TR.parse_args):
        with pytest.raises(AttributeError):
            parse(["model.no_such_key=1"])
        with pytest.raises(SystemExit, match="expected key=value"):
            parse(["action"])


def test_mean_metrics_matches_jax():
    import jax.numpy as jnp

    raw = {"loss": 2.5, "err_sum": 6.0, "err_count": 4.0, "zero_sum": 3.0, "zero_count": 0.0, "lonely_sum": 5.0}
    j = JR._mean_metrics({k: jnp.float32(v) for k, v in raw.items()})
    t = TR._mean_metrics({k: torch.tensor(v) for k, v in raw.items()})
    assert t == j == {"loss": 2.5, "err": 1.5, "zero": 3.0, "lonely": 5.0}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Run A: fit 2 epochs. Run B: fit 1 epoch, then resume=last to 2."""
    root = tmp_path_factory.mktemp("cli")
    a, b = str(root / "a"), str(root / "b")
    run(["action=fit", f"run_dir={a}", "n_epochs=2"] + TINY)
    run(["action=fit", f"run_dir={b}", "n_epochs=1"] + TINY)
    after_one = load_state(b)
    run(["action=fit", f"run_dir={b}", "n_epochs=2", "resume=last"] + TINY)
    return dict(a=a, b=b, after_one=after_one)


def test_resumed_fit_equals_the_uninterrupted_fit_bitwise(fits):
    sa, sb = load_state(fits["a"]), load_state(fits["b"])
    assert fits["after_one"]["epoch"] == 1 and fits["after_one"]["global_step"] == 1
    assert sa["epoch"] == sb["epoch"] == 2 and sa["global_step"] == sb["global_step"] == 2
    assert torch.equal(sa["rng"], sb["rng"])
    assert sa["params"].keys() == sb["params"].keys()
    for k in sa["params"]:
        assert torch.equal(sa["params"][k], sb["params"][k]), k
    assert any(not torch.equal(fits["after_one"]["params"][k], sa["params"][k]) for k in sa["params"])
    oa, ob = sa["opt_state"], sb["opt_state"]
    assert oa["schedule"] == ob["schedule"] and oa["adam"]["param_groups"] == ob["adam"]["param_groups"]
    for i, s in oa["adam"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["adam"]["state"][i][k]), (i, k)
    # the metrics log: the same validation records, B's split over two runs
    recs = {r: [json.loads(line) for line in open(os.path.join(fits[r], "metrics.jsonl"))] for r in ("a", "b")}
    vals = {r: [{k: v for k, v in x.items() if k != "time"} for x in recs[r] if x["phase"] == "val"] for r in recs}
    assert vals["a"] == vals["b"] and len(vals["a"]) == 2
    prof = [x for x in recs["b"] if x["phase"] == "profile"]
    assert len(prof) == 2 and {"time/train_step_mean_s", "time/val_step_mean_s", "time/ckpt_save_mean_s"} <= set(
        prof[0]) and "time/ckpt_restore_mean_s" in prof[1]
    meta = json.load(open(os.path.join(fits["a"], "ckpt", "meta.json")))
    assert meta["step"] == 2 and meta["best_score"] == min(v["val/loss"] for v in vals["a"])


def test_validate_and_test_from_the_best_checkpoint(fits, tmp_path, monkeypatch):
    """The best checkpoint of run A in a run directory of its own: its
    config.json sidecar gives the config."""
    import shutil

    out = str(tmp_path / "run")
    shutil.copytree(os.path.join(fits["a"], "ckpt", "best"), os.path.join(out, "ckpt", "best"))
    monkeypatch.setenv("WRITE_SUBMISSIONS", "1")
    runner = ["synthetic=true", "val_batches=1", "device=cpu"]  # not in the config tree
    run(["action=validate", f"run_dir={out}", "resume=best"] + runner)
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["phase"] for r in recs] == ["val", "profile"] and np.isfinite(recs[0]["val/loss"])
    assert "time/ckpt_restore_mean_s" in recs[1] and "time/val_step_mean_s" in recs[1]
    subs = sorted(os.listdir(os.path.join(out, "submission")))
    assert "womd_trafficbots_tpu_rr_K1.tar.gz" in subs and "womd_trafficbots_tpu_jf_K6.tar.gz" in subs
    shutil.rmtree(os.path.join(out, "submission"))
    monkeypatch.delenv("WRITE_SUBMISSIONS")
    run(["action=test", f"run_dir={out}", "resume=best"] + runner)
    n_scene = 2  # data.batch_size, val_batches=1
    tars = sorted(os.listdir(os.path.join(out, "submission")))
    assert [t for t in tars if t.endswith(".tar.gz")] == [f"womd_trafficbots_tpu_K{k}.tar.gz" for k in range(1, 7)]
    with tarfile.open(os.path.join(out, "submission", "womd_trafficbots_tpu_K6.tar.gz")) as tar:
        name = next(n for n in tar.getnames() if n.endswith(".bin"))
        fields = decode_fields(tar.extractfile(name).read())
    scenarios = [v for f, _, v in fields if f == 6]
    assert len(scenarios) == n_scene
    for s in scenarios:
        sc = decode_fields(s)
        assert sc[0][0] == 1 and len(sc[0][2]) > 0  # scenario_id
        pset = decode_fields(next(v for f, _, v in sc if f == 2))  # single_predictions
        assert len(pset) > 0 and all(f == 1 for f, _, _ in pset)
        pred = decode_fields(pset[0][2])  # object_id, then K = 6 scored trajectories
        assert pred[0][:2] == (1, 0) and sum(f == 2 for f, _, _ in pred) == 6
    # a missing checkpoint is an error for validate and test
    with pytest.raises(SystemExit, match="no such checkpoint"):
        run(["action=test", f"run_dir={tmp_path / 'empty'}", "resume=best"] + TINY)


@pytest.fixture(scope="module")
def h5_dir(tmp_path_factory):
    pytest.importorskip("h5py")
    from trafficbots_tpu_torch.data.packing import pack_scenario, write_h5
    from trafficbots_tpu_torch.data.synthetic_scenario import synthetic_scenario

    d = tmp_path_factory.mktemp("h5")
    small = dict(n_pl=64, n_tl=6, n_tl_stop=6, n_agent=4, n_agent_no_sim=8)
    for split, n in (("training", 4), ("validation", 3), ("testing", 2)):
        write_h5([pack_scenario(synthetic_scenario(seed=s), split, seed=s, **small) for s in range(n)],
                 str(d / f"{split}.h5"))
    return str(d)


def test_fit_reads_a_packed_h5_with_bucketing(h5_dir, tmp_path, monkeypatch):
    from trafficbots_tpu_torch.data import bucketing

    shapes = []
    real = bucketing.bucket_slice

    def recording(batch, *a):
        out, buckets = real(batch, *a)
        shapes.append((batch["map/valid"].shape[1], out["map/valid"].shape[1], buckets))
        return out, buckets

    monkeypatch.setattr(bucketing, "bucket_slice", recording)
    tiny = [o for o in TINY if o.split("=")[0] not in (
        "synthetic", "data.n_step", "data.n_pl", "data.n_pl_node", "time_step_end", "time_step_gt")]
    run_dir = str(tmp_path / "run")
    run(["action=fit", f"run_dir={run_dir}", f"data.data_dir={h5_dir}", "data.n_step=91", "data.n_pl=64",
         "data.n_pl_node=20", "time_step_end=90", "time_step_gt=90", "data.bucket_capacity=true",
         "data.bucket_pl_multiple=16", "data.bucket_agent_multiple=4"] + tiny)
    state = load_state(run_dir)
    assert state["epoch"] == 1 and state["global_step"] == 1  # limit_train_batches 0.15 of 2 batches: 1
    assert len(shapes) == 2 and all(full == 64 and sliced < 64 for full, sliced, _ in shapes)
    recs = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    val = next(r for r in recs if r["phase"] == "val")
    assert np.isfinite(val["val/loss"]) and "joint_future_pred/mean_average_precision" in val


def test_debug_nans_stops_a_non_finite_step(tmp_path):
    """A NaN clip threshold turns the first update's parameters into NaN;
    with debug_nans=true the second step raises before its update."""
    argv = ["action=fit", f"run_dir={tmp_path}", "optimizer.gradient_clip_val=nan", "debug_nans=true"] + TINY + [
        "steps_per_epoch=2"]
    with pytest.raises(FloatingPointError, match="non-finite values in the training step"):
        run(argv)
    assert not os.path.exists(os.path.join(tmp_path, "ckpt", "last"))


def test_refusals(tmp_path):
    # the validation media, once refused, render where cv2 is installed
    from trafficbots_tpu_torch.utils.vis import _HAS_CV2

    run(["action=fit", f"run_dir={tmp_path}", "n_epochs=1"] + TINY + ["n_video_batch=1"])
    videos = tmp_path / "videos" / "epoch0"
    if not _HAS_CV2:
        assert not videos.exists()
    else:
        media = sorted(os.listdir(videos))
        assert "reactive_replay_0-0.mp4" in media and "attn_pl_0-1.mp4" in media and "dest_prob_0-0.png" in media
        assert all(os.path.getsize(videos / m) > 0 for m in media)
    with pytest.raises(SystemExit, match="unknown action"):
        run(["action=serve", f"run_dir={tmp_path}"] + TINY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run([f"run_dir={tmp_path}"] + [o for o in TINY if o != "device=cpu"])
