"""The bf16 configurations through the port's entry points, on the CPU at the
tests/tiny.py widths: `precision="bf16"`, `model.map_encoder.
kernel_matmul_bf16=true` and both together through `orchestration.
eval_rollout`, `training.train.make_train_step` and `evaluation_loop.
Validator`, the node-stack switch under both node encoders; and `run.py`
with both overrides: a 2-epoch fit equals a 1-epoch fit resumed from its
bf16 checkpoint bitwise, and `validate` and `test` run from `best`.

What the bf16 paths compute is held against the JAX package in
tests/test_torch_bf16.py (the model), tests/test_torch_kernels.py and
tests/test_torch_block_attn.py (the kernels' functions); here they run.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from trafficbots_tpu.config import config_to_dict  # noqa: E402
from trafficbots_tpu_torch import evaluation_loop as EL  # noqa: E402
from trafficbots_tpu_torch import orchestration as TO  # noqa: E402
from trafficbots_tpu_torch import run as TR  # noqa: E402
from trafficbots_tpu_torch.config import config_from_dict  # noqa: E402
from trafficbots_tpu_torch.training import train as TT  # noqa: E402
from trafficbots_tpu_torch.training.checkpoint import STATE_FILE  # noqa: E402

from test_torch_cli import TINY  # noqa: E402
from tiny import tiny_batch, tiny_config  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

BF16 = ["precision=bf16", "model.map_encoder.kernel_matmul_bf16=true"]


def config(precision: str, matmul_bf16: bool, impl: str = "fused"):
    cfg = config_from_dict(config_to_dict(tiny_config()))
    me = dataclasses.replace(cfg.model.map_encoder, kernel_matmul_bf16=matmul_bf16, node_encoder_impl=impl)
    return dataclasses.replace(cfg, precision=precision, model=dataclasses.replace(cfg.model, map_encoder=me))


@pytest.mark.parametrize("precision,matmul_bf16,impl", [
    ("bf16", False, "fused"), ("fp32", True, "fused"), ("bf16", True, "fused"), ("bf16", True, "hybrid")])
def test_entry_points_run_the_bf16_configurations(precision, matmul_bf16, impl):
    """eval_rollout, one make_train_step update and one Validator step:
    finite, the parameters fp32 and moved by the update, the bf16 compute
    dtype where `precision` asks for it."""
    cfg = config(precision, matmul_bf16, impl)
    batch = tiny_batch(tiny_config(), n_scene=2, seed=0)
    model = TO.make_model(cfg, device="cpu", seed=0)
    assert model.compute_dtype == (torch.bfloat16 if precision == "bf16" else torch.float32)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = TO.eval_rollout(cfg, model, batch, device="cpu")
    assert torch.isfinite(out.preds).all() and out.preds.dtype == torch.float32
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = TT.make_train_step(cfg, model, TT.make_optimizer(cfg, model))(batch, seed=1)
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())
    model.eval()
    val = EL.Validator(cfg, model, device="cpu")
    val.step(batch, torch.Generator().manual_seed(2))
    assert np.isfinite(val.epoch_end()["val/loss"])


def load_state(run_dir, name="last"):
    return torch.load(os.path.join(run_dir, "ckpt", name, STATE_FILE), weights_only=True)


def test_run_fit_resume_validate_test_under_bf16(tmp_path, monkeypatch):
    """run.py with both bf16 overrides: fit 2 epochs (A) equals fit 1 epoch,
    then resume=last to 2 (B), bitwise; the snapshot keeps the overrides;
    validate and test from `best`."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    TR.main(["action=fit", f"run_dir={a}", "n_epochs=2"] + TINY + BF16)
    TR.main(["action=fit", f"run_dir={b}", "n_epochs=1"] + TINY + BF16)
    TR.main(["action=fit", f"run_dir={b}", "n_epochs=2", "resume=last"] + TINY)  # the snapshot's overrides
    sa, sb = load_state(a), load_state(b)
    assert sa["epoch"] == sb["epoch"] == 2 and torch.equal(sa["rng"], sb["rng"])
    for k in sa["params"]:
        assert sa["params"][k].dtype == torch.float32 and torch.equal(sa["params"][k], sb["params"][k]), k
    for i, s in sa["opt_state"]["adam"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["opt_state"]["adam"]["state"][i][k]), (i, k)
    snap = TR.parse_args([f"run_dir={b}", "resume=last", "device=cpu"])[1]
    assert snap.precision == "bf16" and snap.model.map_encoder.kernel_matmul_bf16
    monkeypatch.setenv("WRITE_SUBMISSIONS", "1")
    TR.main(["action=validate", f"run_dir={a}", "resume=best", "val_batches=1", "synthetic=true", "device=cpu"])
    TR.main(["action=test", f"run_dir={a}", "resume=best", "val_batches=1", "synthetic=true", "device=cpu"])
    assert any(name.endswith(".tar.gz") for name in os.listdir(os.path.join(a, "submission")))
