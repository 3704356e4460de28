"""Rank functions of the port's data-parallel tests (run by
`trafficbots_tpu_torch.parallel.launch`, one gloo process a rank on the CPU).

Imports the port alone (no JAX): the tests hand over the JAX side's weights,
batches and noise as .npz files and compare what each rank returns.
"""
import json
import os

import numpy as np
import torch

import trafficbots_tpu_torch.distributions as TD
from trafficbots_tpu_torch import orchestration as TO
from trafficbots_tpu_torch.config import config_from_dict
from trafficbots_tpu_torch.parallel import mesh
from trafficbots_tpu_torch.weights import load_jax_params


def collectives(seed):
    """The mesh functions on two ranks: ragged unions, the gradient mean,
    the metric sum, the rank seeds. -> what each produced on this rank."""
    from trafficbots_tpu_torch.eval.submission import SubWOMD
    from trafficbots_tpu_torch.eval.womd import WOMDMetrics

    r = mesh.rank()
    out = {"rank": r, "world": mesh.world_size(), "is_main": mesh.is_main()}
    # ragged on purpose: after the pad rows are dropped the ranks hold
    # different numbers of batches of different sizes (rank 1 may hold none)
    out["gathered"] = mesh.allgather_pyobj([np.arange(3)] * 2 if r == 0 else {"b": np.ones((2, 5))})

    wm = WOMDMetrics("sync_test", step_gt=90, step_current=10, use_native=False)
    wm.engine._batches = ([{"a": np.full((4, 3), 0.0, np.float32)}, {"a": np.full((3, 3), 0.5, np.float32)}]
                          if r == 0 else [{"a": np.full((2, 3), 1.0, np.float32)}])
    wm.sync()
    out["womd_rows"] = [[b["a"].shape[0], float(b["a"][0, 0])] for b in wm.engine._batches]
    wm.sync()  # a second sync gathers nothing
    out["womd_rows_again"] = [b["a"].shape[0] for b in wm.engine._batches]

    sub = SubWOMD(k_futures=2, activate=True)
    for k in sub.scenario_payloads:
        sub.scenario_payloads[k] = [b"p0a", b"p0b"] if r == 0 else [b"p1a"]
    sub.sync()
    out["payloads"] = dict(sub.scenario_payloads)
    sub.sync()
    out["payloads_again"] = dict(sub.scenario_payloads)

    params = [torch.nn.Parameter(torch.zeros(3, 4)), torch.nn.Parameter(torch.zeros(5)),
              torch.nn.Parameter(torch.zeros(2, 2))]
    gen = torch.Generator().manual_seed(seed + r)
    params[0].grad = torch.randn(3, 4, generator=gen)
    params[1].grad = torch.randn(5, generator=gen) if r == 1 else None  # None counts as zeros
    mesh.all_reduce_mean_(params)
    out["grads"] = [p.grad.clone() for p in params]
    out["sum"] = {k: v.item() for k, v in mesh.all_reduce_sum({"x": torch.tensor(1.5 + r), "n": torch.tensor(2.0)}).items()}
    out["rank_seed"] = mesh.rank_seed(seed)
    mesh.barrier()
    return out


def dp_train(workdir, n_steps):
    """make_train_step on this rank's slice of the global batch in
    workdir/batch.npz, from the weights in workdir/params.npz, the latent
    noise workdir/eps.npy injected (the same on every rank: each rank's
    sample is mean + std * eps). -> each step's metrics and the final
    parameters."""
    from trafficbots_tpu_torch.training import train as TT

    with open(os.path.join(workdir, "cfg.json")) as f:
        cfg = config_from_dict(json.load(f))
    eps = torch.from_numpy(np.load(os.path.join(workdir, "eps.npy")))
    TD.DiagGaussian.sample = (
        lambda self, generator=None, deterministic=True:
        self.mean if deterministic is True else self.mean + self.stddev * eps)
    n, r = mesh.world_size(), mesh.rank()
    with np.load(os.path.join(workdir, "batch.npz")) as z:
        per = z["agent/valid"].shape[0] // n
        batch = {k: z[k][r * per:(r + 1) * per] for k in z.files}
    model = TO.make_model(cfg, device="cpu")
    with np.load(os.path.join(workdir, "params.npz")) as z:
        load_jax_params(model, {k: z[k] for k in z.files})
    step = TT.make_train_step(cfg, model, TT.make_optimizer(cfg, model))
    metrics = [{k: v.item() for k, v in step(batch, seed=i).items()} for i in range(n_steps)]
    return {"metrics": metrics, "params": {k: v.detach().clone() for k, v in model.named_parameters()}}


def rank_main(workdir, seed=0, n_steps=2):
    created = mesh.init_from_env("cpu")
    try:
        return {"collectives": collectives(seed), "train": dp_train(workdir, n_steps)}
    finally:
        if created:
            mesh.destroy()


def dp_validate(workdir):
    """The Validator on this rank's slice of the global batch in
    workdir/val_batch.npz, from the weights in workdir/val_params.npz, with
    JAX's global draws (workdir/draws.npz) handed to `distributions._draw`
    as the global batch's noise: the rank draw context keeps the rank's
    rows. -> epoch_end's metrics and the rank's rows of the noise."""
    from trafficbots_tpu_torch import evaluation_loop as TE

    with open(os.path.join(workdir, "val_cfg.json")) as f:
        cfg = config_from_dict(json.load(f))
    n, r = mesh.world_size(), mesh.rank()
    with np.load(os.path.join(workdir, "draws.npz")) as z:
        gumbel, normal = z["gumbel"], z["normal"]
    seen = []

    def injected(arr):
        def draw(shape, dtype, device, generator=None):
            def global_noise(s, dtype, device, generator):
                assert tuple(s) == arr.shape, (tuple(s), arr.shape)  # the global batch's draw
                return torch.tensor(arr, dtype=dtype, device=device)
            x = TD._draw(global_noise, shape, dtype, device, generator)
            seen.append(x.clone())
            return x
        return draw

    TD.standard_gumbel, TD.standard_normal = injected(gumbel), injected(normal)
    with np.load(os.path.join(workdir, "val_batch.npz")) as z:
        per = z["agent/valid"].shape[0] // n
        batch = {k: z[k][r * per:(r + 1) * per] for k in z.files}
    model = TO.make_model(cfg, device="cpu")
    with np.load(os.path.join(workdir, "val_params.npz")) as z:
        load_jax_params(model, {k: z[k] for k in z.files})
    val = TE.Validator(cfg, model, device="cpu")
    val.step(batch, torch.Generator().manual_seed(0))
    return {"metrics": val.epoch_end(), "noise": seen}


def validate_main(workdir):
    created = mesh.init_from_env("cpu")
    try:
        return dp_validate(workdir)
    finally:
        if created:
            mesh.destroy()


TINY = [
    "data.batch_size=8", "data.n_agent=4", "data.n_agent_no_sim=4", "data.n_pl=16", "data.n_pl_node=10",
    "data.n_tl=4", "data.n_tl_stop=4", "model.hidden_dim=64", "model.pe_dim=32", "model.tf_cfg.d_model=64",
    "model.tf_cfg.n_head=2", "model.tf_cfg.d_feedforward=64", "model.n_layer_tf_as2pl=1",
    "model.n_layer_tf_as2tl=1", "model.latent_encoder.latent_dim=8", "model.agent_temporal.num_layers=1",
    "model.agent_interaction.n_layer=1", "model.goal_manager.goal_predictor.n_layer_gru=1",
    "n_video_batch=1", "device=cpu",
]


def cli_main(workdir, data_dir):
    """run.main on this rank: fit (synthetic, 91 steps, tiny widths), an h5
    validate with the submissions, an h5 test. -> the files this rank
    wrote under the run directory, the fit's parameters' SHA-1 and what
    each action returned."""
    import hashlib

    from trafficbots_tpu_torch import run as RUN
    from trafficbots_tpu_torch.parallel.launch import audit_writes

    run_dir = os.path.join(workdir, "run")
    for hook in ("TB_CKPT_HOOK", "TB_METRICS_HOOK"):
        os.environ.pop(hook, None)
    created = mesh.init_from_env("cpu")
    try:
        with audit_writes(run_dir) as written:
            fit = RUN.main(["action=fit", "synthetic=true", "n_epochs=1", "steps_per_epoch=2", "val_batches=1",
                            f"run_dir={run_dir}"] + TINY)
            digest = hashlib.sha1()
            for p in fit["model"].parameters():
                digest.update(p.detach().numpy().tobytes())
            os.environ["WRITE_SUBMISSIONS"] = "1"
            val = RUN.main(["action=validate", f"run_dir={run_dir}", "resume=last",
                            f"data.data_dir={data_dir}"] + TINY)
            test = RUN.main(["action=test", f"run_dir={run_dir}", "resume=last", f"data.data_dir={data_dir}"] + TINY)
        return {"written": written, "params_sha1": digest.hexdigest(), "fit_val": fit["val_metrics"],
                "val": val["val_metrics"], "test_paths": test["submission"]}
    finally:
        if created:
            mesh.destroy()
