"""The port's answer to the JAX config fields that select TPU kernels or
their tilings, on the CPU at the tests/tiny.py widths.

- `map_encoder.fused_train_kernel`: True sends the training node stack to
  K4 (`ops.node_encoder_train.node_encoder_train`, which on a CPU tensor
  takes its plain version); False to the plain version under autograd, as
  the JAX package then runs its XLA stack. Both give the same loss here.
- `model.attn_row_block` (the dead-query-row skip): with spies on the
  model's K1 and K3 wrappers, an eval rollout's K1 calls carry
  `src_invalid` (the query rows' padding mask) at the rollout as2pl and
  the latent as2pl exactly when the value is >= 0, never at the map
  self-attention; a training step's K3 calls carry it at every site,
  whatever the value, as in the JAX package. 32 agents over 64 polylines
  make the as2pl sites K1 sites; 256 polylines make every training site a
  K3 site. These run over a few steps of one scene.
- `fused_block_pl`, `fused_pipeline_blocks`, `fused_skip_invalid_blocks`
  are TPU tilings, bit-identical at any value: an eval rollout and a
  training step's loss and gradients are bitwise the same at non-default
  values.

The file runs on one torch thread. The training steps at the default
config, with `fused_train_kernel` off and at the non-default tilings are
computed once and shared (`train_runs`).
"""
import dataclasses

import pytest
import torch

from trafficbots_tpu.config import config_to_dict
from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.config import config_from_dict
from trafficbots_tpu_torch.data.preprocessing import to_torch
from trafficbots_tpu_torch.models import map_encoder as TME
from trafficbots_tpu_torch.models import modules as TM

from tiny import tiny_batch, tiny_config
from torch_one_thread import one_torch_thread  # noqa: E402,F401


def port_config(**map_encoder):
    cfg = config_from_dict(config_to_dict(tiny_config(n_step=31, time_step_end=20)))
    me = dataclasses.replace(cfg.model.map_encoder, **map_encoder)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, map_encoder=me))


def train_loss_and_grads(cfg, batch):
    model = TO.make_model(cfg, device="cpu", seed=0)
    loss, _ = TO.training_step(cfg, model, to_torch(batch, "cpu"), torch.Generator().manual_seed(3))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


TRAIN_CONFIGS = {"fused": dict(fused_train_kernel=True), "unfused": dict(fused_train_kernel=False),
                 "tiled": dict(fused_block_pl=16, fused_pipeline_blocks=1, fused_skip_invalid_blocks=False)}


@pytest.fixture(scope="module")
def train_runs():
    """One training step at each of TRAIN_CONFIGS (tests/tiny.py widths, the
    same batch and seeds), shared by the tests below: its loss, gradients
    and the calls of the training node stack's two routes."""
    runs = {}
    for name, fields in TRAIN_CONFIGS.items():
        calls = {"kernel": 0, "plain": 0}

        def spy(route, fn):
            def wrapped(*a, **kw):
                calls[route] += 1
                return fn(*a, **kw)
            return wrapped

        mp = pytest.MonkeyPatch()
        mp.setattr(TME, "node_encoder_train", spy("kernel", TME.node_encoder_train))
        mp.setattr(TME, "node_encoder_train_plain", spy("plain", TME.node_encoder_train_plain))
        try:
            cfg = port_config(**fields)
            loss, grads = train_loss_and_grads(cfg, tiny_batch(cfg, n_scene=2, seed=0))
        finally:
            mp.undo()
        runs[name] = dict(calls=calls, loss=loss, grads=grads)
    return runs


@pytest.mark.parametrize("fused", [True, False])
def test_fused_train_kernel_routes_the_training_node_stack(train_runs, fused):
    run, other = (train_runs["fused"], train_runs["unfused"]) if fused else (train_runs["unfused"],
                                                                              train_runs["fused"])
    assert run["calls"] == ({"kernel": 1, "plain": 0} if fused else {"kernel": 0, "plain": 1})
    # on CPU tensors the K4 wrapper is the plain version: the two routes agree
    assert run["loss"] == other["loss"]


def kernel_site_config(row_block, n_pl):
    """32 agents over n_pl polylines, 16 steps: with n_pl >= 64 the rollout
    as2pl, the latent as2pl and the map self-attention are K1 sites in
    eval, with n_pl >= 256 K3 sites in training."""
    cfg = config_from_dict(config_to_dict(tiny_config(n_step=16, time_step_end=15)))
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, n_agent=32, n_pl=n_pl),
                               model=dataclasses.replace(cfg.model, attn_row_block=row_block))


def spy_sites(monkeypatch, name):
    """Replace models.modules' `name` wrapper by one that records each
    call's (S, T, whether src_invalid was passed)."""
    calls, fn = [], getattr(TM, name)

    def spy(q, k, *a, src_invalid=None, **kw):
        calls.append((q.shape[1], k.shape[1], src_invalid is not None))
        return fn(q, k, *a, src_invalid=src_invalid, **kw)

    monkeypatch.setattr(TM, name, spy)
    return calls


@pytest.mark.parametrize("row_block", [-1, 0, 16])
def test_attn_row_block_routes_src_invalid_to_k1(monkeypatch, row_block):
    cfg = kernel_site_config(row_block, n_pl=64)
    calls = spy_sites(monkeypatch, "fused_attention_core")
    TO.eval_rollout(cfg, TO.make_model(cfg, device="cpu", seed=0), tiny_batch(cfg, n_scene=1, seed=0), device="cpu")
    n_pl, n_agent = cfg.data.n_pl, cfg.data.n_agent
    as2pl = [c for c in calls if c[:2] == (n_agent, n_pl)]
    latent = [c for c in calls if c[0] not in (n_agent, n_pl)]
    assert len(as2pl) == cfg.time_step_end and len(latent) == 1  # one layer each, at tiny widths
    assert latent[0][0] % n_agent == 0 and latent[0][1] == n_pl
    assert [c for c in calls if c[0] == n_pl] == [(n_pl, n_pl, False)]  # the map self-attention: never
    assert all(skip == (row_block >= 0) for _, _, skip in as2pl + latent)


def test_training_routes_src_invalid_to_every_k3_site(monkeypatch):
    cfg = kernel_site_config(-1, n_pl=256)
    calls = spy_sites(monkeypatch, "attention_train")
    model = TO.make_model(cfg, device="cpu", seed=0)
    loss, _ = TO.training_step(cfg, model, to_torch(tiny_batch(cfg, n_scene=1, seed=0), "cpu"),
                               torch.Generator().manual_seed(3))
    loss.backward()
    sites = {(s, t) for s, t, _ in calls}
    n_pl, n_agent = cfg.data.n_pl, cfg.data.n_agent
    latent = {s for s, _ in sites if s not in (n_agent, n_pl)}  # the posterior's and the prior's as2pl
    assert {(n_pl, n_pl), (n_agent, n_pl)} <= sites and latent and all(s % n_agent == 0 for s in latent)
    assert all(skip for _, _, skip in calls)


def test_tpu_tilings_leave_results_unchanged(train_runs):
    base = port_config()
    tiled = port_config(**TRAIN_CONFIGS["tiled"])
    assert base.model.map_encoder.fused_train_kernel  # the default: train_runs["fused"] is base's step
    batch = tiny_batch(base, n_scene=2, seed=0)
    a = TO.eval_rollout(base, TO.make_model(base, device="cpu", seed=0), batch, device="cpu")
    b = TO.eval_rollout(tiled, TO.make_model(tiled, device="cpu", seed=0), batch, device="cpu")
    assert torch.equal(a.preds, b.preds) and torch.equal(a.valid, b.valid)
    ra, rb = train_runs["fused"], train_runs["tiled"]
    assert ra["loss"] == rb["loss"] and ra["grads"].keys() == rb["grads"].keys()
    assert all(torch.equal(ra["grads"][n], rb["grads"][n]) for n in ra["grads"])
