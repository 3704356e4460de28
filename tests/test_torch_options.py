"""The port's answer to the JAX config fields that select TPU kernels or
their tilings, on the CPU at the tests/tiny.py widths.

- `map_encoder.fused_train_kernel`: True sends the training node stack to
  K4 (`ops.node_encoder_train.node_encoder_train`, which on a CPU tensor
  takes its plain version); False to the plain version under autograd, as
  the JAX package then runs its XLA stack. Both give the same loss here.
- `model.attn_row_block >= 0` (K1's dead-query-row skip, not ported yet)
  raises NotImplementedError naming ROADMAP Queue 2.
- `fused_block_pl`, `fused_pipeline_blocks`, `fused_skip_invalid_blocks`
  are TPU tilings, bit-identical at any value: an eval rollout and a
  training step's loss and gradients are bitwise the same at non-default
  values.
"""
import dataclasses

import pytest
import torch

from trafficbots_tpu.config import config_to_dict
from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.config import config_from_dict
from trafficbots_tpu_torch.data.preprocessing import to_torch
from trafficbots_tpu_torch.models import map_encoder as TME

from tiny import tiny_batch, tiny_config


def port_config(**map_encoder):
    cfg = config_from_dict(config_to_dict(tiny_config(n_step=31, time_step_end=20)))
    me = dataclasses.replace(cfg.model.map_encoder, **map_encoder)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, map_encoder=me))


def train_loss_and_grads(cfg, batch):
    model = TO.make_model(cfg, device="cpu", seed=0)
    loss, _ = TO.training_step(cfg, model, to_torch(batch, "cpu"), torch.Generator().manual_seed(3))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("fused", [True, False])
def test_fused_train_kernel_routes_the_training_node_stack(monkeypatch, fused):
    calls = {"kernel": 0, "plain": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(TME, "node_encoder_train", spy("kernel", TME.node_encoder_train))
    monkeypatch.setattr(TME, "node_encoder_train_plain", spy("plain", TME.node_encoder_train_plain))
    cfg = port_config(fused_train_kernel=fused)
    batch = tiny_batch(cfg, n_scene=2, seed=0)
    loss, _ = train_loss_and_grads(cfg, batch)
    assert calls == ({"kernel": 1, "plain": 0} if fused else {"kernel": 0, "plain": 1})
    # on CPU tensors the K4 wrapper is the plain version: the two routes agree
    assert loss == train_loss_and_grads(port_config(fused_train_kernel=not fused), batch)[0]


@pytest.mark.parametrize("row_block", [0, 16])
def test_attn_row_block_is_refused(row_block):
    cfg = port_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attn_row_block=row_block))
    with pytest.raises(NotImplementedError, match="Queue 2"):
        TO.make_model(cfg, device="cpu", seed=0)


def test_tpu_tilings_leave_results_unchanged():
    base = port_config()
    tiled = port_config(fused_block_pl=16, fused_pipeline_blocks=1, fused_skip_invalid_blocks=False)
    batch = tiny_batch(base, n_scene=2, seed=0)
    a = TO.eval_rollout(base, TO.make_model(base, device="cpu", seed=0), batch, device="cpu")
    b = TO.eval_rollout(tiled, TO.make_model(tiled, device="cpu", seed=0), batch, device="cpu")
    assert torch.equal(a.preds, b.preds) and torch.equal(a.valid, b.valid)
    la, ga = train_loss_and_grads(base, batch)
    lb, gb = train_loss_and_grads(tiled, batch)
    assert la == lb and ga.keys() == gb.keys()
    assert all(torch.equal(ga[n], gb[n]) for n in ga)
