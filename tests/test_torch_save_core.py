"""`remat_policy="save_core"` in the port's training rollout, on the CPU at
the tests/tiny.py widths, dropout live.

"save_core" runs "save_attn"'s path: each checkpointed step keeps its
training attention cores (`ops.dropout.SavedCores`) and its recompute
replays them. The JAX policy also keeps the step's featurization, the GRU
output and the action head's input; torch's checkpoint re-runs the modules
that make them all the same (sim/rollout.py), so the port keeps no more.
The loss and every gradient equal "save_attn"'s (and "none"'s) bit for
bit: the seeds are drawn outside the checkpointed body. Both give each
checkpointed step a store of attention cores.
"""
import dataclasses

import pytest
import torch

from trafficbots_tpu.config import config_to_dict
from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.config import config_from_dict
from trafficbots_tpu_torch.data.preprocessing import to_torch
from trafficbots_tpu_torch.ops import dropout as TDO

from tiny import tiny_batch, tiny_config
from torch_one_thread import one_torch_thread  # noqa: E402,F401


def loss_and_grads(policy, batch):
    cfg = config_from_dict(config_to_dict(tiny_config(n_step=31, time_step_end=20)))
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    model = TO.make_model(cfg, device="cpu", seed=0)
    loss, _ = TO.training_step(cfg, model, to_torch(batch, "cpu"), torch.Generator().manual_seed(3))
    loss.backward()
    return cfg, loss.item(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def test_save_core_equals_save_attn_and_keeps_its_values(monkeypatch):
    batch = tiny_batch(tiny_config(n_step=31, time_step_end=20), n_scene=2, seed=0)
    stores = {"save_attn": 0, "save_core": 0}
    policy = ["save_attn"]
    init = TDO.SavedCores.__init__

    def spy(self):
        stores[policy[0]] += 1
        init(self)

    monkeypatch.setattr(TDO.SavedCores, "__init__", spy)
    cfg, loss_attn, grads_attn = loss_and_grads("save_attn", batch)
    policy[0] = "save_core"
    _, loss_core, grads_core = loss_and_grads("save_core", batch)
    assert stores["save_core"] == stores["save_attn"] == cfg.time_step_end  # one store a checkpointed step
    assert loss_core == loss_attn
    assert grads_core.keys() == grads_attn.keys()
    assert all(torch.equal(grads_core[n], grads_attn[n]) for n in grads_attn)
    monkeypatch.undo()
    _, loss_none, grads_none = loss_and_grads("none", batch)
    assert loss_none == loss_attn and all(torch.equal(grads_none[n], grads_attn[n]) for n in grads_attn)


def test_unknown_remat_policy_raises():
    batch = tiny_batch(tiny_config(n_step=31, time_step_end=20), n_scene=1, seed=0)
    with pytest.raises(ValueError, match="remat_policy"):
        loss_and_grads("save_everything", batch)
