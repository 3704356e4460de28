"""The port's copy of the media rasterizer (`trafficbots_tpu_torch/utils/vis.py`)
against the JAX package's `trafficbots_tpu/utils/vis.py`.

- The copy's code equals the original's: both parsed with `ast` and
  compared without their docstrings (comments never reach the tree).
- On the same synthetic scene (numpy only), the copy's frames equal the
  original's bitwise: `VisScene.render_frame` with and without the optional
  layers (traffic lights, violations, goal markers), the frames of a
  prediction video (the GT before the current step, a prediction after,
  the caption), of an attention video, and the destination-probability
  image read back from its PNG. The videos' frames are taken at
  `save_video`, before the lossy mp4 encoding.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from trafficbots_tpu.config import DataConfig  # noqa: E402
from trafficbots_tpu.data.synthetic import synthetic_episode_batch  # noqa: E402
from trafficbots_tpu.utils import vis as JV  # noqa: E402
from trafficbots_tpu_torch.utils import vis as TV  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
T, STEP_CURRENT = 20, 10


def code_of(path: Path) -> str:
    """ast.dump of the module without its docstrings."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.fixture(scope="module")
def scene():
    data = DataConfig(n_agent=8, n_pl=16, n_pl_node=10, n_tl=6, n_tl_stop=6)
    b = {k: v[0] for k, v in synthetic_episode_batch(data, n_scene=1, seed=3).items() if not isinstance(v, list)}
    rng = np.random.RandomState(0)
    return dict(b=b, rng=rng, data=data)


def both(scene):
    b = scene["b"]
    args = (b["map/valid"], b["map/type"], b["map/pos"], b["map/boundary"])
    return JV.VisScene(*args), TV.VisScene(*args)


def frames_of(vs, monkeypatch, call):
    """The frames `call(vs)` hands to save_video."""
    got = []
    monkeypatch.setattr(vs, "save_video", lambda path, frames, fps=10: got.extend(f.copy() for f in frames) or path)
    call(vs)
    return got


def test_vis_copy_code_equals_the_original():
    assert code_of(ROOT / "trafficbots_tpu_torch/utils/vis.py") == code_of(ROOT / "trafficbots_tpu/utils/vis.py")


@pytest.mark.parametrize("layers", ["agents only", "every layer"])
def test_render_frame_equals_jax_bitwise(scene, layers):
    b, t = scene["b"], 15
    kw = dict(agent_valid=b["agent/valid"][t], agent_pos=b["agent/pos"][t], agent_yaw=b["agent/yaw_bbox"][t, :, 0],
              agent_size=b["agent/size"])
    if layers == "every layer":
        A = b["agent/valid"].shape[1]
        kw.update(agent_type=b["agent/type"], agent_role=b["agent/role"],
                  violations=scene["rng"].rand(A) < 0.3, tl_valid=b["tl_stop/valid"][t],
                  tl_pos=b["tl_stop/pos"][t], tl_state=b["tl_stop/state"][t], goal_xy=b["agent/goal"][:, :2])
    j, p = (vs.render_frame(**kw) for vs in both(scene))
    assert j.dtype == p.dtype == np.uint8 and j.shape == p.shape
    assert np.array_equal(j, p) and (j != 30).any()


def test_prediction_video_frames_equal_jax_bitwise(scene, monkeypatch, tmp_path):
    b = scene["b"]
    episode = {k: b[k] for k in ("agent/valid", "agent/pos", "agent/yaw_bbox", "agent/size", "agent/type",
                                 "agent/role", "tl_stop/valid", "tl_stop/pos", "tl_stop/state")}
    pred = {"agent/valid": b["agent/valid"][STEP_CURRENT + 1:T],
            "agent/pos": b["agent/pos"][STEP_CURRENT + 1:T] + 1.5,
            "agent/yaw_bbox": b["agent/yaw_bbox"][STEP_CURRENT + 1:T],
            "violations": scene["rng"].rand(T - STEP_CURRENT - 1, b["agent/valid"].shape[1]) < 0.2}
    j, p = (frames_of(vs, monkeypatch, lambda vs: vs.save_prediction_video(
        str(tmp_path / "v.mp4"), episode, pred, step_current=STEP_CURRENT, title="joint_future K=1 score=0.250"))
        for vs in both(scene))
    assert len(j) == len(p) == T
    assert all(np.array_equal(x, y) for x, y in zip(j, p))


def test_attention_video_frames_equal_jax_bitwise(scene, monkeypatch, tmp_path):
    b, data = scene["b"], scene["data"]
    attn = scene["rng"].rand(data.n_agent, T, data.n_pl).astype(np.float32)
    j, p = (frames_of(vs, monkeypatch, lambda vs: vs.save_attention_video(
        str(tmp_path / "a.mp4"), b["map/valid"], b["map/pos"], b["agent/valid"][:T], b["agent/pos"][:T],
        b["agent/yaw_bbox"][:T, :, 0], b["agent/size"], attn, agent_idx=1)) for vs in both(scene))
    assert len(j) == len(p) == T
    assert all(np.array_equal(x, y) for x, y in zip(j, p))


def test_dest_prob_image_equals_jax_bitwise(scene, tmp_path):
    b, data = scene["b"], scene["data"]
    probs = scene["rng"].rand(data.n_agent, data.n_pl).astype(np.float32)
    j, p = (cv2.imread(vs.save_dest_prob_image(str(tmp_path / f"{name}.png"), b["map/valid"], b["map/pos"], probs,
                                               agent_idx=2))
            for name, vs in zip(("jax", "port"), both(scene)))
    assert j is not None and np.array_equal(j, p)
