"""CLI entry: fit / validate / test, with dotted-path config overrides.

Counterpart of `trafficbots_tpu/run.py`:

    python -m trafficbots_tpu_torch.run action=fit data.data_dir=/data/h5_womd \\
        model.hidden_dim=128 ablation=simnet resume=runs/x/ckpt/last
    torchrun --standalone --nproc_per_node 8 -m trafficbots_tpu_torch.run action=fit ...

Overrides are `key=value` pairs navigating the frozen dataclass tree
(dataclasses.replace under the hood); `ablation=<name>` applies a preset
from config.ablation. Runner keys besides the config tree: `action`
(fit | validate | test), `run_dir`, `resume` (1/true, best, last or a
checkpoint directory), `synthetic`, `n_epochs`, `steps_per_epoch`,
`val_batches`, `debug_nans` (fail fast on a non-finite value in a training
step's metrics or gradients) and `device` (`cuda`, the default, or `cpu`;
without CUDA and without `device=cpu` the run raises).

Random draws: one CPU `torch.Generator` seeded with `cfg.seed` stands in
for the JAX package's PRNG key and its splits. The model's init seed, each
training step's seed (`make_train_step`), each validation and test step's
generator and each epoch's validation-media seed are drawn from it, and a
checkpoint carries its state, so a resumed fit continues the same stream.

Validation media (`n_video_batch > 0`, 3 by default): after each epoch's
validation in `fit` (under `run_dir/videos/epoch<n>`) and after `validate`
(under `run_dir/videos`), `evaluation_loop.render_validation_media` writes
the videos and images of the first `n_video_batch` validation batches, as
the JAX package does: on rank 0 of a one-process run only, nothing without
`cv2`. `fit` draws the media seed every epoch on every rank whether or not
media render, as the JAX package splits its key, so a resume stays exact.

Data parallel: under `torchrun` (the layout comes from its environment,
`parallel.mesh.init_from_env`: NCCL when each rank has a card of its own,
gloo on the CPU or when ranks share a card) every process is one rank
with its slice of every global batch (`data.batch_size` is the global
batch; the world size must divide it). Every rank draws the run's seed
stream identically, so the stream, the parameters and Adam's state stay
replicated and a checkpoint holds them once: a resume on N ranks is exact.
Rank 0 alone writes `config.json`, the metrics log, the checkpoints and the
submissions, and prints the progress lines; `bucket_capacity` is off (each
rank's maxima would give the ranks different shapes); no rank renders
validation media.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch


def _coerce(val: str, current: Any) -> Any:
    if isinstance(current, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(val)
    if isinstance(current, float):
        return float(val)
    if current is None:
        for cast in (int, float):
            try:
                return cast(val)
            except ValueError:
                pass
        if val.lower() in ("none", "null"):
            return None
        return val
    if isinstance(current, tuple):
        if val in ("[]", "()"):
            return ()
        return tuple(float(x) for x in val.strip("[]()").split(",") if x)
    return val


def apply_override(cfg, dotted: str, val: str):
    parts = dotted.split(".")
    if len(parts) == 1:
        current = getattr(cfg, parts[0])
        return dataclasses.replace(cfg, **{parts[0]: _coerce(val, current)})
    sub = getattr(cfg, parts[0])
    new_sub = apply_override(sub, ".".join(parts[1:]), val)
    return dataclasses.replace(cfg, **{parts[0]: new_sub})


def _find_config_snapshot(run_dir: Optional[str], resume: Optional[str]) -> Optional[str]:
    """Locate the config.json snapshot for a resume.

    Candidates, most specific first: INSIDE the checkpoint directory itself
    (CheckpointManager writes a config.json sidecar into every best/last
    save, so a checkpoint copied out of its run keeps its hyperparameters),
    then the run_dir, then, for an explicit path like
    `resume=runs/x/ckpt/last`, the checkpoint's parent directories.
    """
    cands = []
    if resume and resume not in ("1", "true", "True", "yes", "best", "last"):
        r = os.path.abspath(resume)
        cands.append(os.path.join(r, "config.json"))
    if run_dir:
        cands.append(os.path.join(run_dir, "config.json"))
        # resume=best/last resolve inside run_dir's ckpt dir
        if resume in ("1", "true", "True", "yes", "best", "last"):
            name = resume if resume in ("best", "last") else "last"
            cands.append(os.path.join(run_dir, "ckpt", name, "config.json"))
    if resume and resume not in ("1", "true", "True", "yes", "best", "last"):
        d = os.path.dirname(os.path.abspath(resume))
        cands += [os.path.join(d, "config.json"),
                  os.path.join(os.path.dirname(d), "config.json")]
    for p in cands:
        if os.path.isfile(p):
            return p
    return None


def snapshot_config(cfg, run_dir: str):
    """Persist the resolved experiment config into the run directory:
    `action=validate resume=best run_dir=X` later reproduces the training
    config with zero re-typed flags, with CLI overrides applied on top."""
    import json

    from .config import config_to_dict

    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "config.json")
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)
    return path


def parse_args(argv: List[str]):
    """-> (action, cfg, run_dir, resume, synthetic, n_epochs,
    steps_per_epoch, val_batches, device, debug_nans)."""
    import json

    from .config import ExperimentConfig, ablation, config_from_dict

    action = "fit"
    run_dir = None
    resume = None
    synthetic = False
    debug_nans = False
    device = "cuda"
    n_epochs = 1
    steps_per_epoch = None  # default: loader length (real data) or 100 (synthetic)
    val_batches = -1
    overrides = []
    ablations = []
    # pre-scan for run_dir/resume so a config snapshot (written at fit time)
    # can serve as the BASE config, with CLI overrides applied on top
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got {arg}")
        k, v = arg.split("=", 1)
        if k == "run_dir":
            run_dir = v
        elif k == "resume":
            resume = v
    cfg = ExperimentConfig()
    loaded_from = None
    if resume:
        snap = _find_config_snapshot(run_dir, resume)
        if snap is not None:
            with open(snap) as f:
                cfg = config_from_dict(json.load(f))
            loaded_from = snap
        else:
            # resuming without the training config silently falls back to
            # defaults: at best a shape error, at worst a silently wrong
            # ablation if shapes agree. Be loud (stderr so it survives in
            # captured logs); every flag must then be re-passed by hand.
            print(
                f"WARNING: resume={resume}: no config.json snapshot found in "
                "the checkpoint/run directory — using DEFAULT config plus CLI "
                "overrides. If this checkpoint was trained with non-default "
                "flags you must re-pass all of them.",
                file=sys.stderr,
            )
    for arg in argv:
        k, v = arg.split("=", 1)
        if k == "action":
            action = v
        elif k == "ablation":
            cfg = ablation(v, cfg)
            ablations.append(v)
        elif k == "run_dir":
            run_dir = v
        elif k == "resume":
            resume = v
        elif k == "synthetic":
            synthetic = v.lower() in ("1", "true")
        elif k == "debug_nans":
            debug_nans = v.lower() in ("1", "true")
        elif k == "device":
            device = v
        elif k == "n_epochs":
            n_epochs = int(v)
        elif k == "steps_per_epoch":
            steps_per_epoch = int(v)
        elif k == "val_batches":
            val_batches = int(v)
        else:
            overrides.append((k, v))
    for k, v in overrides:
        cfg = apply_override(cfg, k, v)
    if run_dir is None:
        run_dir = os.path.join("runs", time.strftime("%Y%m%d_%H%M%S"))
    if loaded_from is not None:
        n_over = len(overrides) + len(ablations)
        print(f"config loaded from snapshot {loaded_from}"
              + (f" (+{n_over} CLI overrides on top)" if n_over else ""))
    return (action, cfg, run_dir, resume, synthetic, n_epochs, steps_per_epoch, val_batches, device,
            debug_nans)


def synthetic_loader(cfg, n_batches: int, seed: int = 0):
    """Synthetic global batches; with several ranks, each rank's contiguous
    slice of each (every rank makes the same global batch)."""
    from .data.synthetic import synthetic_episode_batch
    from .parallel import mesh

    n_rank, r = mesh.world_size(), mesh.rank()
    if cfg.data.batch_size % n_rank:
        raise ValueError(f"data.batch_size={cfg.data.batch_size} is not divisible by the {n_rank} ranks")
    per = cfg.data.batch_size // n_rank

    def it(epoch: int = 0):
        for i in range(n_batches):
            batch = synthetic_episode_batch(
                cfg.data, n_scene=cfg.data.batch_size,
                seed=seed + epoch * n_batches + i, with_history=True,
            )
            if n_rank > 1:
                batch = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
            yield batch

    return it


def _mean_metrics(metrics) -> Dict[str, float]:
    """Collapse `*_sum`/`*_count` pairs to per-element means for logging
    (the upstream logs per-step means, not batch-scaled raw sums)."""
    m = {k: float(v) for k, v in metrics.items()}
    out: Dict[str, float] = {}
    for k, v in m.items():
        if k.endswith("_count"):
            continue
        if k.endswith("_sum"):
            name = k[: -len("_sum")]
            out[name] = v / max(m.get(f"{name}_count", 1.0), 1.0)
        else:
            out[k] = v
    return out


def _resolve_resume(ckpt, resume: str, default: str, required: bool = False):
    """Map the CLI `resume=` value to a checkpoint name or explicit path.

    `resume=1/true` restores `default`; `resume=best|last` picks that
    checkpoint; any other value is a path to a checkpoint directory.

    `required=True` (validate/test): an explicitly requested checkpoint that
    cannot be found is an ERROR: evaluating or submitting from randomly
    initialized weights because of a typo'd path must not happen silently.
    Fit keeps resume-if-available semantics (idempotent restart scripts) but
    the caller warns when nothing was found."""
    if resume in ("1", "true", "True", "yes"):
        resume = default
    if resume in ("best", "last"):
        found = resume if ckpt.exists(resume) else None
    else:
        found = resume if os.path.isdir(resume) else None
    if found is None and required:
        raise SystemExit(f"resume={resume}: no such checkpoint (looked in {ckpt.directory})")
    return found


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run one action; -> what it produced, for a caller in the same process:
    fit: the last epoch's validation metrics, the global step and the
    trained model; validate:
    the metrics and the `Validator` (its WOMD engines hold the accumulated
    inputs); test: the submission files (rank 0's; none on the others).
    Under `torchrun` it joins the process group first (unless the caller
    already has) and leaves it on exit."""
    (action, cfg, run_dir, resume, synthetic, n_epochs, steps_per_epoch, val_batches, device,
     debug_nans) = parse_args(argv if argv is not None else sys.argv[1:])
    if action not in ("fit", "validate", "test"):
        raise SystemExit(f"unknown action {action}")
    from .parallel import mesh

    created = mesh.init_from_env(device)  # before anything touches the device
    try:
        return _run(action, cfg, run_dir, resume, synthetic, n_epochs, steps_per_epoch, val_batches, device,
                    debug_nans)
    finally:
        if created:
            mesh.destroy()


def _run(action, cfg, run_dir, resume, synthetic, n_epochs, steps_per_epoch, val_batches, device, debug_nans):
    from . import distributions as D
    from . import orchestration as O
    from .config import config_to_dict
    from .data.preprocessing import to_torch
    from .eval.submission import SubWOMD
    from .evaluation_loop import Validator, pack_test_submission, render_validation_media, test_step_device
    from .parallel import mesh
    from .training.checkpoint import CheckpointManager
    from .training.train import make_optimizer, make_train_step
    from .utils.logging import MetricsLogger, Profiler, nan_guard

    device = O.resolve_device(device)
    n_rank, is_main = mesh.world_size(), mesh.is_main()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # shape-bucketed batches (data/bucketing.py): slice the fixed map/agent
    # capacities to each batch's real maximum before the device sees them
    bucket = None
    if cfg.data.bucket_capacity and n_rank > 1:
        if is_main:
            print("bucket_capacity disabled: multi-process run (per-process maxima would desynchronize shapes)")
    elif cfg.data.bucket_capacity:
        from .data.bucketing import bucket_slice

        bucket = lambda b: bucket_slice(  # noqa: E731
            b, cfg.data.bucket_pl_multiple, cfg.data.bucket_agent_multiple
        )[0]

    gen = torch.Generator().manual_seed(cfg.seed)

    def draw() -> int:
        """The next seed of the run's stream (the JAX package's key split)."""
        return int(torch.randint(0, 2**62, (), generator=gen))

    logger = MetricsLogger(run_dir)
    prof = Profiler()
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"), config=config_to_dict(cfg))

    # data
    if synthetic:
        if steps_per_epoch is None:
            steps_per_epoch = 100
        train_iter_fn = synthetic_loader(cfg, steps_per_epoch)
        val_iter_fn = synthetic_loader(cfg, max(val_batches, 1), seed=10_000)
    else:
        from .data.h5_loader import make_loaders

        # sub-epoch cadence: an "epoch" is limit_train_batches of the packed
        # file, and the LR schedule's epoch accounting uses the REAL loader
        # length, not a CLI default
        train_loader, val_loader, test_loader = make_loaders(
            cfg.data, cfg.seed, limit_train_batches=cfg.limit_train_batches,
            shard_index=mesh.rank(), shard_count=n_rank,
        )
        if steps_per_epoch is None:
            steps_per_epoch = len(train_loader)

        def train_iter_fn(epoch: int = 0):
            train_loader.set_epoch(epoch)
            return iter(train_loader)

        def val_iter_fn(epoch: int = 0):
            return iter(val_loader)

    model = O.make_model(cfg, device=device, seed=draw())
    n_params = sum(p.numel() for p in model.parameters())
    if is_main:
        print(f"model initialized: {n_params/1e6:.2f}M params, run_dir={run_dir}")

    def restore_params(target: str) -> None:
        with prof.phase("ckpt_restore"):
            params = ckpt.restore(target, {"params": model.state_dict()}, map_location=device)["params"]
            model.load_state_dict(params)
            sync()

    def host_batch(batch_np):
        if bucket is not None:
            batch_np = bucket(batch_np)
        return batch_np

    def media(seed: int, out_dir: str):
        """The validation media, where the JAX package renders them: on rank
        0 of a one-process run."""
        if not (is_main and n_rank == 1 and cfg.n_video_batch > 0):
            return []
        with prof.phase("media"):
            paths = render_validation_media(cfg, model, val_iter_fn, torch.Generator().manual_seed(seed), out_dir)
            sync()
        return paths

    if action == "fit":
        if is_main:
            snapshot_config(cfg, run_dir)
        optimizer = make_optimizer(cfg, model, steps_per_epoch)
        # full trainer state resume: weights, optimizer, epoch, global step
        # and the generator: teacher forcing's epoch schedule, the LR
        # schedule, the data order and the seed stream continue exactly
        start_epoch, global_step = 0, 0
        target = _resolve_resume(ckpt, resume, default="last") if resume else None
        if resume and target is None and is_main:
            print(f"resume={resume}: no checkpoint found, starting fresh")
        if target is not None:
            with prof.phase("ckpt_restore"):
                restored = ckpt.restore_trainer_state(
                    target,
                    {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                     "epoch": 0, "global_step": 0, "rng": gen.get_state()},
                    map_location=device,
                )
                model.load_state_dict(restored["params"])
                optimizer.load_state_dict(restored["opt_state"])
                start_epoch = int(restored["epoch"])
                global_step = int(restored["global_step"])
                gen.set_state(restored["rng"].cpu())
                sync()
            if is_main:
                print(f"resumed from {target} at epoch {start_epoch}, step {global_step}")
        guard = (lambda tree: nan_guard(tree, "the training step")) if debug_nans else None
        step_fn = make_train_step(cfg, model, optimizer, guard=guard)
        validator = Validator(cfg, model, device=device)

        val_metrics = None
        for epoch in range(start_epoch, n_epochs):
            for batch_np in train_iter_fn(epoch):
                batch_np = {k: v for k, v in host_batch(batch_np).items() if not isinstance(v, list)}
                seed = draw()
                with prof.phase("train_step"):
                    metrics = step_fn(batch_np, seed, epoch)
                    sync()
                if global_step % 50 == 0 and is_main:
                    m = _mean_metrics(metrics)
                    logger.log(m, global_step)
                    print(f"epoch {epoch} step {global_step} loss={m['loss']:.4f}")
                global_step += 1

            # validation
            validator.reset()
            for i, batch_np in enumerate(val_iter_fn()):
                if 0 <= val_batches <= i:
                    break
                g = torch.Generator().manual_seed(draw())
                with prof.phase("val_step"):
                    validator.step(host_batch(batch_np), g)
                    sync()
            val_metrics = validator.epoch_end()
            # every rank draws the media seed, whether or not it renders
            written = media(draw(), os.path.join(run_dir, "videos", f"epoch{epoch}"))
            if written:
                print(f"validation media written: {len(written)} files")
            logger.log(val_metrics, global_step, phase="val")
            state = {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                     "epoch": epoch + 1, "global_step": global_step, "rng": gen.get_state()}
            with prof.phase("ckpt_save"):
                ckpt.save_last(state, global_step, val_metrics)
            ckpt.save_if_best(state, global_step, val_metrics)
            if is_main:
                print(f"epoch {epoch} val/loss={val_metrics['val/loss']:.4f}")
        logger.log(prof.summary(), global_step, phase="profile")
        return {"val_metrics": val_metrics, "global_step": global_step, "model": model}

    elif action == "validate":
        target = _resolve_resume(ckpt, resume, default="best", required=True) if resume else None
        if target is not None:
            restore_params(target)
        # submission writing during validation: both the reactive-replay
        # (K=1) and the joint-future (K=6) files
        write_subs = os.environ.get("WRITE_SUBMISSIONS", "0").lower() in ("1", "true")
        sub_rr = SubWOMD(k_futures=1, interactive_challenge=cfg.interactive_challenge,
                         activate=write_subs, method_name="trafficbots_tpu_rr")
        sub_jf = SubWOMD(k_futures=cfg.n_joint_future,
                         interactive_challenge=cfg.interactive_challenge,
                         activate=write_subs, method_name="trafficbots_tpu_jf")
        validator = Validator(cfg, model, sub_rr=sub_rr, sub_jf=sub_jf, device=device)
        for i, batch_np in enumerate(val_iter_fn()):
            if 0 <= val_batches <= i:
                break
            g = torch.Generator().manual_seed(draw())
            with prof.phase("val_step"):
                validator.step(host_batch(batch_np), g)
                sync()
        val_metrics = validator.epoch_end()
        logger.log(val_metrics, 0, phase="val")
        for k, v in sorted(val_metrics.items()):
            if "/" in k and "waymo_metrics" not in k and is_main:
                print(f"{k}: {v:.4f}")
        for p in media(draw(), os.path.join(run_dir, "videos")):
            print(f"media written: {p}")
        if write_subs and is_main:
            for p in sub_rr.save_sub_files(os.path.join(run_dir, "submission")):
                print(f"submission written: {p}")
            for p in sub_jf.save_sub_files(os.path.join(run_dir, "submission")):
                print(f"submission written: {p}")
        logger.log(prof.summary(), 0, phase="profile")
        return {"val_metrics": val_metrics, "validator": validator}

    else:  # test
        # the test split has no GT: prior latent + predicted goal,
        # submission files only
        target = _resolve_resume(ckpt, resume, default="best", required=True) if resume else None
        if target is not None:
            restore_params(target)
        if synthetic:
            test_iter_fn = synthetic_loader(cfg, max(val_batches, 1), seed=20_000)
        else:
            test_iter_fn = lambda: iter(test_loader)  # noqa: E731

        sub = SubWOMD(
            k_futures=cfg.n_joint_future,
            interactive_challenge=cfg.interactive_challenge,
            activate=True,
        )
        for i, batch_np in enumerate(test_iter_fn()):
            if 0 <= val_batches <= i:
                break
            batch_np = host_batch(batch_np)
            batch = to_torch({k: v for k, v in batch_np.items() if not isinstance(v, list)}, device)
            g = torch.Generator().manual_seed(draw())
            with prof.phase("test_step"), D.global_batch_draws(mesh.rank(), n_rank):
                pred = test_step_device(cfg, model, batch, g)
                sync()
            pack_test_submission(sub, pred, batch_np)
        # each rank packed its own scenes: the union before rank 0's write
        sub.sync()
        paths = sub.save_sub_files(os.path.join(run_dir, "submission")) if is_main else []
        for p in paths:
            print(f"submission written: {p}")
        logger.log(prof.summary(), 0, phase="profile")
        return {"submission": paths}


if __name__ == "__main__":
    main()
