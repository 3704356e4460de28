"""The port's validation metrics and their host-side copies against the JAX
package's.

- The metric sums (`eval.metrics`: error and rule updates with and without
  the K axis, both teacher-forcing rules, `add_metric_sums`, the computes)
  on seeded inputs: atol = rtol = 1e-5 (fp32 sums in another order), counts
  exactly.
- The numpy copies: `eval.womd.WOMDMetrics` over `eval.motion_metrics` on
  the same packed inputs gives the same numbers as the JAX package's, to
  the bit (one numpy program), in both challenge layouts.
- The native engine (`eval.native_metrics`, the port's default): the JAX
  package's native engine's numbers to the bit, the numpy engine's within
  tests/test_native_metrics.py's tolerance; an engine that cannot be built
  raises instead of falling back to numpy.
- `eval.submission.SubWOMD` (over the `eval.proto_wire` copy) writes the
  same bytes as the JAX writer where the rotation back to the global frame
  is exact (yaw 0); with random yaws the two frameworks' fp32 sin/cos differ
  by an ulp, so the payloads are held equal field by field with the
  coordinates within 1e-4 m.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from trafficbots_tpu.config import DataConfig  # noqa: E402
from trafficbots_tpu.data.synthetic import synthetic_episode_batch  # noqa: E402
from trafficbots_tpu.eval import metrics as jm  # noqa: E402
from trafficbots_tpu.eval.submission import SubWOMD as JSub  # noqa: E402
from trafficbots_tpu.eval.womd import WOMDMetrics as JWOMD  # noqa: E402
from trafficbots_tpu_torch.eval import metrics as tm  # noqa: E402
from trafficbots_tpu_torch.eval.submission import SubWOMD as TSub  # noqa: E402
from trafficbots_tpu_torch.eval.womd import WOMDMetrics as TWOMD  # noqa: E402

from test_submission import decode_fields  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
B, A, K, S = 3, 6, 4, 20


def rollout_like(rs, with_k):
    kshape = (B, A, K, S) if with_k else (B, A, S)
    return dict(
        valid=rs.rand(*kshape) < 0.8,
        preds=(rs.normal(size=kshape + (4,)) * [5, 5, 3, 2]).astype(np.float32),
        override=rs.rand(*kshape) < 0.3,
        violations={k: rs.rand(*kshape) < 0.2 for k in tm.RULE_KEYS},
        gt_valid=rs.rand(B, A, S) < 0.85,
        gt_states=(rs.normal(size=(B, A, S, 4)) * [5, 5, 3, 2]).astype(np.float32),
        role=rs.rand(B, A, 3) < 0.4,
        agent_type=np.eye(3, dtype=bool)[rs.randint(0, 3, size=(B, A))],
    )


def _sums(mod, x, to, tf):
    err = mod.error_metrics_update(to(x["valid"]), to(x["preds"]), to(x["gt_valid"]), to(x["gt_states"]),
                                   to(x["override"]), to(x["role"]), loss_for_teacher_forcing=tf)
    rule = mod.rule_metrics_update(to(x["valid"]), to(x["override"]), {k: to(v) for k, v in x["violations"].items()},
                                   to(x["agent_type"]), loss_for_teacher_forcing=tf)
    return err, rule


@pytest.mark.parametrize("with_k", [False, True])
@pytest.mark.parametrize("tf", [False, True])
def test_metric_sums_and_computes_match_jax(with_k, tf):
    rs = np.random.RandomState(int(with_k) + 2 * int(tf))
    x1, x2 = rollout_like(rs, with_k), rollout_like(rs, with_k)
    acc_j, acc_t = ({}, {}), ({}, {})
    for x in (x1, x2):
        je, jr = _sums(jm, x, jnp.asarray, tf)
        te, tr = _sums(tm, x, torch.from_numpy, tf)
        assert te.keys() == je.keys() and tr.keys() == jr.keys()
        for k in je:
            np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]), err_msg=k, **TOL)
        for k in jr:
            np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]), err_msg=k)
        acc_j = (jm.add_metric_sums(acc_j[0], jax.tree_util.tree_map(np.asarray, je)),
                 jm.add_metric_sums(acc_j[1], jax.tree_util.tree_map(np.asarray, jr)))
        acc_t = (tm.add_metric_sums(acc_t[0], {k: v.numpy() for k, v in te.items()}),
                 tm.add_metric_sums(acc_t[1], {k: v.numpy() for k, v in tr.items()}))
    for jc, tc in ((jm.error_metrics_compute(acc_j[0], "p/"), tm.error_metrics_compute(acc_t[0], "p/")),
                   (jm.rule_metrics_compute(acc_j[1], "p/"), tm.rule_metrics_compute(acc_t[1], "p/"))):
        assert tc.keys() == jc.keys()
        for k in jc:
            np.testing.assert_allclose(tc[k], jc[k], err_msg=k, **TOL)
    assert tm.error_metrics_compute({}) == {} and tm.rule_metrics_compute({}) == {}


def packed_case(seed, n_k, n_predict):
    data = DataConfig(n_agent=8, n_pl=16, n_pl_node=10, n_tl=6, n_tl_stop=6)
    batch = synthetic_episode_batch(data, n_scene=3, seed=seed)
    batch["agent/role"] = batch["agent/role"].copy()
    batch["agent/role"][:, :, 2] = False
    batch["agent/role"][:, :n_predict, 2] = True
    rs = np.random.RandomState(seed)
    future = batch["agent/pos"][:, 11:91][:, :, :, None, :]
    pred = (future + rs.normal(scale=1.5, size=future.shape[:3] + (n_k, 2))).astype(np.float32)
    scores = rs.dirichlet(np.ones(n_k), size=pred.shape[::2][:2]).astype(np.float32)  # [B, A, K]
    return batch, pred, scores


@pytest.mark.parametrize("interactive", [False, True])
def test_womd_metrics_copy_gives_the_same_numbers(interactive):
    outs = []
    for cls in (JWOMD, TWOMD):
        w = cls("joint_future_pred", interactive_challenge=interactive, use_native=False)
        w.reset()
        for seed in (0, 1):
            # the interactive challenge predicts two agents a scene
            w.update(*packed_case(seed, 6, 2 if interactive else 3))
        w.sync()
        outs.append(w.compute())
    assert outs[0].keys() == outs[1].keys() and "joint_future_pred/mean_average_precision" in outs[1]
    for k, v in outs[0].items():
        assert outs[1][k] == v or (np.isnan(v) and np.isnan(outs[1][k])), k
    assert 0 < outs[1]["joint_future_pred/min_ade"] < 10


def test_womd_metrics_refuses_the_native_engine(monkeypatch):
    """The port takes the native engine by default and refuses to fall back
    to numpy quietly (the JAX class does): an engine that cannot be built
    raises."""
    import subprocess

    from trafficbots_tpu_torch.eval import native_metrics as N

    def failed_build():
        raise subprocess.CalledProcessError(1, ["g++"])

    monkeypatch.setattr(N, "library_path", lambda: N.BUILD / "libmotion_metrics-missing.so")
    monkeypatch.setattr(N, "_build_library", failed_build)
    with pytest.raises(subprocess.CalledProcessError):
        TWOMD("reactive_replay")
    from trafficbots_tpu_torch.eval.motion_metrics import MotionMetrics

    assert isinstance(TWOMD("reactive_replay", use_native=False).engine, MotionMetrics)


# the native engine against the numpy one: tests/test_native_metrics.py's tolerance
NATIVE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("interactive", [False, True])
def test_native_engine_gives_the_jax_native_and_the_numpy_numbers(interactive):
    """The port's native engine (its own copy of the C++ source, built into
    the port's build directory) gives the JAX package's native engine's
    numbers to the bit, and the port's numpy engine's within NATIVE_TOL,
    on the same packed inputs."""
    from trafficbots_tpu.eval.native_metrics import NativeMotionMetrics as JNative
    from trafficbots_tpu_torch.eval.motion_metrics import MotionMetrics
    from trafficbots_tpu_torch.eval.native_metrics import NativeMotionMetrics

    outs = []
    for cls, native in ((TWOMD, True), (JWOMD, True), (TWOMD, False)):
        w = cls("joint_future_pred", interactive_challenge=interactive, use_native=native)
        assert isinstance(w.engine, (NativeMotionMetrics, JNative) if native else MotionMetrics)
        for seed in (0, 1):
            w.update(*packed_case(seed, 6, 2 if interactive else 3))
        outs.append(w.compute())
    assert outs[0].keys() == outs[1].keys() == outs[2].keys()
    assert outs[0] == outs[1]
    for k, v in outs[2].items():
        np.testing.assert_allclose(outs[0][k], v, err_msg=k, **NATIVE_TOL)
    assert 0 < outs[0]["joint_future_pred/min_ade"] < 10


def _submission(cls, yaw, k_futures=3):
    rs = np.random.RandomState(4)
    n_b, n_a, n_k = 3, 5, 6
    sub = cls(k_futures=k_futures, activate=True, method_name="m")
    for _ in range(2):
        sub.add_to_submissions(
            waymo_trajs=(rs.normal(size=(n_b, 80, n_a, n_k, 2)) * 30).astype(np.float32),
            waymo_scores=rs.dirichlet(np.ones(n_k), size=(n_b, n_a)).astype(np.float32),
            mask_pred=rs.rand(n_b, n_a) < 0.6,
            object_id=rs.randint(0, 1000, size=(n_b, n_a)),
            scenario_center=rs.normal(size=(n_b, 2)) * 500,
            scenario_yaw=yaw(rs, n_b),
            scenario_id=[f"s{i}" for i in range(n_b)],
        )
    sub.sync()
    return sub


def test_submission_bytes_equal_the_jax_writer(tmp_path):
    jsub, tsub = (_submission(c, lambda rs, n: np.zeros(n)) for c in (JSub, TSub))
    assert tsub.scenario_payloads == jsub.scenario_payloads
    jp, tp = jsub.save_sub_files(str(tmp_path / "j")), tsub.save_sub_files(str(tmp_path / "t"))
    assert len(tp) == len(jp) == 3
    for a, b in zip(jp, tp):
        bin_a = a[: -len(".tar.gz")] + "/" + a.split("/")[-1][: -len(".tar.gz")] + ".bin"
        bin_b = b[: -len(".tar.gz")] + "/" + b.split("/")[-1][: -len(".tar.gz")] + ".bin"
        assert open(bin_a, "rb").read() == open(bin_b, "rb").read()


def decode_scenario(buf: bytes):
    """A ChallengeScenarioPredictions of single predictions -> its fields in
    order: the scenario id, then per object its id and per trajectory the
    confidence and the x and y coordinates."""
    out = []
    for f, _, v in decode_fields(buf):
        if f == 1:
            out.append(("scenario", v))
            continue
        for _, _, pred in decode_fields(v):  # PredictionSet.predictions
            for f2, _, v2 in decode_fields(pred):
                if f2 == 1:
                    out.append(("object", v2))
                    continue
                for f3, _, v3 in decode_fields(v2):  # ScoredTrajectory
                    if f3 == 1:
                        out.append(("confidence", v3))
                        continue
                    for f4, _, v4 in decode_fields(v3):  # Trajectory center_x, center_y
                        out.append((f"center_{'xy'[f4 - 1]}", np.frombuffer(v4, "<f4")))
    return out


def test_submission_with_rotations_matches_the_jax_writer():
    jsub, tsub = (_submission(c, lambda rs, n: rs.uniform(-np.pi, np.pi, n)) for c in (JSub, TSub))
    assert sum(name == "center_x" for p in tsub.scenario_payloads[3] for name, _ in decode_scenario(p)) > 20
    for k in jsub.scenario_payloads:
        assert len(tsub.scenario_payloads[k]) == len(jsub.scenario_payloads[k])
        for a, b in zip(jsub.scenario_payloads[k], tsub.scenario_payloads[k]):
            fa, fb = decode_scenario(a), decode_scenario(b)
            assert [n for n, _ in fa] == [n for n, _ in fb]
            for (name, va), (_, vb) in zip(fa, fb):
                if name.startswith("center"):
                    np.testing.assert_allclose(vb, va, atol=1e-4, rtol=1e-6)
                else:
                    assert va == vb
