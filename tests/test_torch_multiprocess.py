"""The port's counterpart of tests/test_multiprocess.py: two gloo processes on
the CPU run `trafficbots_tpu_torch.run.main` end to end (the rank function
is tests/torch_dp_worker.py's `cli_main`): a fit at the challenge horizon
(91 steps, so the WOMD metrics run) at tiny widths on synthetic data, the
global batch of 8 split 4 and 4; an h5 validate of 12 scenarios at global
batch 8, where the second global batch is padded with 4 repeated scenes
and rank 1's slice of it is all pads, writing both submissions; and an h5
test. Only rank 0 may write under the run directory or print the epoch
line, and no rank renders validation media (`n_video_batch=1`, as in the
JAX package: media only in a one-process run); each scenario must be in each submission exactly once; val/loss is
-mAP; the two ranks' trained parameters are equal to the bit. Then the
multi-process dry run (`parallel.dryrun`) at the model's real widths.
"""
import json
import os
import tarfile

import h5py
import numpy as np
import pytest

from trafficbots_tpu_torch.config import DataConfig
from trafficbots_tpu_torch.data.h5_loader import tensor_size_test, tensor_size_train, tensor_size_val
from trafficbots_tpu_torch.data.synthetic import synthetic_episode_batch
from trafficbots_tpu_torch.parallel.launch import launch

N_SCENARIO = 12


def write_h5(data_dir):
    d = DataConfig(n_agent=4, n_agent_no_sim=4, n_pl=16, n_pl_node=10, n_tl=4, n_tl_stop=4, batch_size=8)
    eps = synthetic_episode_batch(d, n_scene=N_SCENARIO, seed=7, with_history=True, with_agent_no_sim=True)
    for fname, sizes in (("training", tensor_size_train(d)), ("validation", tensor_size_val(d)),
                         ("testing", tensor_size_test(d))):
        with h5py.File(os.path.join(data_dir, f"{fname}.h5"), "w") as hf:
            hf.attrs["data_len"] = N_SCENARIO
            for i in range(N_SCENARIO):
                g = hf.create_group(str(i))
                for k in sizes:
                    g.create_dataset(k, data=eps[k][i])
                g.attrs["scenario_id"] = f"scn{i}"
                g.attrs["scenario_center"] = np.zeros(2, np.float32)
                g.attrs["scenario_yaw"] = 0.0
                g.attrs["with_map"] = True


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("cli")
    data_dir = work / "data"
    data_dir.mkdir()
    write_h5(str(data_dir))
    outs, results = launch("torch_dp_worker:cli_main", 2, dict(workdir=str(work), data_dir=str(data_dir)),
                           timeout_s=400)
    return dict(work=work, outs=outs, results=results)


def scenario_counts(tar_path):
    with tarfile.open(tar_path) as tar:
        body = tar.extractfile(next(n for n in tar.getnames() if n.endswith(".bin"))).read()
    counts = {i: body.count(b"scn%d" % i) for i in range(N_SCENARIO)}
    for i in range(10, N_SCENARIO):  # "scn1" also prefixes "scn10" and "scn11"
        counts[1] -= counts[i]
    return counts


def test_only_rank_0_writes_the_host_artifacts_and_prints(run):
    w0, w1 = (res["written"] for res in run["results"])
    assert w1 == []
    for name in ("config.json", "metrics.jsonl", "ckpt/last/state.pt", "ckpt/best/state.pt", "ckpt/meta.json",
                 "ckpt/last/config.json"):
        assert any(p == name or p.startswith(name + ".") for p in w0), (name, w0)
    assert any(p.startswith("submission/") for p in w0)
    # n_video_batch=1, but no rank renders media in a multi-process run
    assert not any(p.startswith("videos") for p in w0)
    assert "epoch 0 val/loss=" in run["outs"][0] and "epoch 0 val/loss=" not in run["outs"][1]
    assert "backend gloo" in run["outs"][0] and "backend gloo" in run["outs"][1]


def test_the_metrics_log_holds_one_process_records(run):
    recs = [json.loads(line) for line in open(run["work"] / "run" / "metrics.jsonl")]
    # fit: the step-0 training record, one validation, the profile; validate:
    # its validation and profile; test: the profile
    assert [r["phase"] for r in recs] == ["train", "val", "profile", "val", "profile", "profile"]


def test_val_loss_is_minus_the_map_and_the_same_on_both_ranks(run):
    for key in ("fit_val", "val"):
        a, b = (res[key] for res in run["results"])
        assert a["val/loss"] == -a["joint_future_pred/mean_average_precision"]
        assert a == b or all(a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in a)


def test_each_scenario_is_in_each_submission_once(run):
    sub = run["work"] / "run" / "submission"
    paths = [sub / "womd_trafficbots_tpu_rr_K1.tar.gz", sub / "womd_trafficbots_tpu_jf_K6.tar.gz"]
    paths += [os.path.join(p) for p in run["results"][0]["test_paths"]]
    assert run["results"][1]["test_paths"] == [] and len(run["results"][0]["test_paths"]) == 6
    for path in paths:
        counts = scenario_counts(path)
        assert all(c == 1 for c in counts.values()), (path, counts)


def test_the_ranks_trained_parameters_are_bitwise_equal(run):
    assert run["results"][0]["params_sha1"] == run["results"][1]["params_sha1"]


def test_dryrun_multiprocess_at_the_real_widths():
    from trafficbots_tpu_torch.parallel.dryrun import dryrun_multiprocess

    res = dryrun_multiprocess(2)
    assert np.isfinite(res["loss"]) and res["val_loss"] <= 0
