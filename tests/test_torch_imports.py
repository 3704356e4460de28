"""Import hygiene of the PyTorch port: no JAX, no flax/optax, no trafficbots_tpu.

Parses every .py file of `trafficbots_tpu_torch/` and `chip_smoke.py` with
`ast` (nothing is imported or executed) and fails on an import of a banned
top-level package, including relative imports that climb out of the port.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "trafficbots_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "trafficbots_tpu"}


def _port_files():
    files = [p for p in PORT.rglob("*.py") if "build" not in p.relative_to(PORT).parts]
    return sorted(files) + [ROOT / "chip_smoke.py"]


def banned_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    depth = len(path.relative_to(ROOT).parts) - 1  # package depth of the file
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level and node.level > depth:
                bad.append(f"relative import climbing out of the port: level {node.level}")
                continue
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in BANNED]
    return bad


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    assert path.exists(), path
    assert banned_imports(path) == [], path


def test_checker_catches_banned_imports(tmp_path):
    """The checker itself: each banned form is reported, allowed ones are not."""
    pkg = tmp_path / "trafficbots_tpu_torch"
    pkg.mkdir()
    f = pkg / "m.py"
    f.write_text(
        "import jax.numpy as jnp\nfrom flax import linen\nfrom trafficbots_tpu.config import X\n"
        "import torch\nfrom . import ops\n"
    )
    global ROOT
    saved, ROOT = ROOT, tmp_path
    try:
        assert banned_imports(f) == ["jax.numpy", "flax", "trafficbots_tpu.config"]
    finally:
        ROOT = saved


def test_port_has_the_slice_modules():
    for rel in (
        "config.py", "geometry.py", "distributions.py", "orchestration.py", "weights.py",
        "data/synthetic.py", "data/preprocessing.py",
        "models/modules.py", "models/map_encoder.py", "models/latent_encoder.py",
        "models/goal_manager.py", "models/traffic_bots.py",
        "ops/fused_attention.py", "ops/node_encoder.py", "ops/cuda_build.py",
        "ops/dropout.py", "ops/attention_train.py", "ops/node_encoder_train.py",
        "sim/dynamics.py", "sim/teacher_forcing.py", "sim/rules.py", "sim/rewards.py", "sim/rollout.py",
        "sim/interactive.py",
        "training/loss.py", "training/train.py",
        "csrc/fused_attention.cu", "csrc/node_encoder.cu",
        "csrc/philox.cuh", "csrc/dropout.cu", "csrc/attention_train.cu", "csrc/node_encoder_train.cu",
        "run.py", "training/checkpoint.py", "utils/logging.py", "eval/native_metrics.py", "native/motion_metrics.cc",
        "data/synthetic_scenario.py", "data/packing.py", "data/womd_adapter.py", "data/bucketing.py",
        "data/h5_loader.py", "parallel/mesh.py", "parallel/launch.py", "parallel/dryrun.py",
    ):
        assert (PORT / rel).is_file(), rel
