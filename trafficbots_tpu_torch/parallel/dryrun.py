"""Multi-process dry run: the data-parallel training step and the sharded
Validator over n gloo ranks on the CPU.

    python -m trafficbots_tpu_torch.parallel.dryrun 2

The counterpart of the JAX package's `dryrun_multichip`: the model's real
widths (`ModelConfig()`: hidden 128, 3 + 3 attention layers, the 3-layer
GRU) at the challenge horizon (91 steps, so the WOMD metrics run and
val/loss = -mAP), only the entity counts of a scene cut (4 agents, 16
polylines of 10 nodes, 4 traffic lights), one scene a rank. Each rank runs
one training step on its scene and one Validator step plus `epoch_end`;
the ranks' parameters must then be equal to the bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import sys
from typing import Dict

TIMEOUT_S = 900.0


def _config(n_rank: int):
    from ..config import ExperimentConfig

    cfg = ExperimentConfig(n_video_batch=0)
    data = dataclasses.replace(cfg.data, n_step=91, n_step_history=11, n_agent=4, n_agent_no_sim=4, n_pl=16,
                               n_pl_node=10, n_tl=4, n_tl_stop=4, batch_size=n_rank)
    return dataclasses.replace(cfg, data=data)


def rank_main() -> Dict[str, object]:
    """One rank of the dry run (under `launch`): -> its metrics and the
    SHA-1 of its parameters after the step."""
    import torch

    from .. import orchestration as O
    from ..data.synthetic import synthetic_episode_batch
    from ..evaluation_loop import Validator
    from ..training.train import make_optimizer, make_train_step
    from . import mesh

    created = mesh.init_from_env("cpu")
    try:
        n, r = mesh.world_size(), mesh.rank()
        cfg = _config(n)
        batch = synthetic_episode_batch(cfg.data, n_scene=n, seed=0, with_history=True)
        local = {k: v[r:r + 1] for k, v in batch.items()}
        model = O.make_model(cfg, device="cpu", seed=0)
        step = make_train_step(cfg, model, make_optimizer(cfg, model))
        metrics = {k: float(v) for k, v in step(local, seed=1).items()}
        gsub = {k: v for k, v in metrics.items() if k.startswith("grad_norm/")}
        if not (math.isfinite(metrics["loss"]) and gsub and all(math.isfinite(v) for v in gsub.values())):
            raise FloatingPointError(f"rank {r}: loss {metrics['loss']}, module grad norms {gsub}")

        validator = Validator(cfg, model, device="cpu")
        if not validator.womd_jf.enabled:
            raise RuntimeError("the WOMD metrics are off at the challenge horizon")
        validator.step(local, torch.Generator().manual_seed(2))
        val = validator.epoch_end()
        mAP = val["joint_future_pred/mean_average_precision"]
        if not (math.isfinite(mAP) and val["val/loss"] == -mAP):
            raise RuntimeError(f"rank {r}: val/loss {val['val/loss']}, mAP {mAP}")
        digest = hashlib.sha1()
        for p in model.parameters():
            digest.update(p.detach().numpy().tobytes())
        return dict(loss=metrics["loss"], grad_norm=metrics["grad_norm"], val_loss=val["val/loss"],
                    err_pos=val["reactive_replay/err/pos_meter"], params_sha1=digest.hexdigest())
    finally:
        if created:
            mesh.destroy()


def dryrun_multiprocess(n: int = 2) -> Dict[str, object]:
    """Run the dry run on n ranks; raises when a rank fails or the ranks'
    parameters differ. -> rank 0's result."""
    from .launch import launch

    _, results = launch("trafficbots_tpu_torch.parallel.dryrun:rank_main", n, timeout_s=TIMEOUT_S)
    digests = {res["params_sha1"] for res in results}
    if len(digests) != 1:
        raise RuntimeError(f"the {n} ranks' parameters differ after the step: {digests}")
    losses = {res["val_loss"] for res in results}
    if len(losses) != 1:
        raise RuntimeError(f"the {n} ranks computed different val/loss: {losses}")
    res = results[0]
    print(f"dryrun_multiprocess({n}): loss={res['loss']:.4f} grad_norm={res['grad_norm']:.4f} "
          f"val_err_pos={res['err_pos']:.4f} womd_mAP={-res['val_loss']:.4f}, parameters equal on every rank")
    return res


if __name__ == "__main__":
    dryrun_multiprocess(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
