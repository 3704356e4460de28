"""Declarative configuration for the PyTorch port.

A copy of `trafficbots_tpu/config.py`: the dataclasses are identical field
for field (tests/test_torch_config.py asserts `dataclasses.asdict` equality),
so one experiment description drives both packages. The port keeps its own
copy instead of importing the JAX package.

The field comments are carried over unchanged. Where they quote timings or
memory figures (ms, GB, agent-steps/s), those were measured for the JAX
package on a TPU v5e and say nothing about this port on the GPU; the port's
own numbers are in PERF.md. Switches that only steer how a TPU kernel is
blocked (block sizes, pipelined sub-blocks, row blocking, padding skips)
have no counterpart here and are read but ignored. `node_encoder_impl`
selects the eval node stack as in the JAX package ("fused": K2; "hybrid":
matmuls around the attention core K6); `kernel_matmul_bf16` takes their
bf16-operand variants, and `precision="bf16"` the bf16 compute dtype of the
encoders (models/modules.py).

Mirrors the capability surface of the upstream Hydra tree
(configs/model/traffic_bots.yaml and configs/**): every switch used by the
paper's ablations exists here, and `ablation()` reproduces the recipes of
the upstream docs/ablation_models.md (SimNet, TrafficSim, positional-encoding
variants, BC baselines).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Data contract (scale facts; ref data_h5_womd.py:78-84)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    n_step: int = 91
    n_step_history: int = 11
    n_agent: int = 64
    n_agent_no_sim: int = 256
    n_pl: int = 1024
    n_pl_node: int = 20
    n_pl_type: int = 11
    n_tl: int = 100
    n_tl_stop: int = 40
    n_tl_state: int = 5
    n_agent_type: int = 3
    n_cmd: int = 8
    batch_size: int = 4
    # slice the fixed map/agent capacities down to each batch's real maximum,
    # rounded to (bucket_pl_multiple, bucket_agent_multiple) — every dense op
    # shrinks with the real scene content, at the cost of one XLA recompile
    # per distinct bucket tuple (see data/bucketing.py). Single-process only
    # (per-process maxima would desynchronize the global program).
    bucket_capacity: bool = False
    bucket_pl_multiple: int = 128
    bucket_agent_multiple: int = 16
    data_dir: str = "data/h5_womd"
    filename_train: str = "training"
    filename_val: str = "validation"
    filename_test: str = "testing"

    @property
    def agent_attr_dim(self) -> int:
        # vel(2) + spd(1) + yaw_rate(1) + acc(1) + size(3) + type(3); ref sc_input.py:21-28
        return 11

    @property
    def map_attr_dim(self) -> int:
        # type one-hot(11) + node one-hot(n_pl_node); ref sc_input.py:31-32
        return self.n_pl_type + self.n_pl_node

    @property
    def tl_attr_dim(self) -> int:
        return self.n_tl_state


@dataclass(frozen=True)
class TransformerConfig:
    """ref configs/model/traffic_bots.yaml:41-49."""

    d_model: int = 128
    n_head: int = 4
    dropout_p: float = 0.1
    norm_first: bool = True
    bias: bool = True
    activation: str = "relu"
    d_feedforward: int = 128
    out_layernorm: bool = False


@dataclass(frozen=True)
class InputPeEncoderConfig:
    """ref configs/model/traffic_bots.yaml:50-54."""

    pe_mode: str = "cat"  # input, cat, add
    n_layer: int = 2
    mlp_dropout_p: float = 0.1
    mlp_use_layernorm: bool = False


@dataclass(frozen=True)
class MapEncoderConfig:
    """ref configs/model/traffic_bots.yaml:55-60."""

    pool_mode: str = "max"  # max, mean, first
    densetnt_vectornet: bool = True
    n_layer: int = 3
    mlp_dropout_p: float = 0.1
    mlp_use_layernorm: bool = False
    # polylines per score-phase block in the fused node-encoder Pallas
    # kernel; with pipeline_blocks, (8, 2) is the round-4 hardware winner:
    # same grid count and wide-matmul width as the old (16, 1) default but
    # HALF the block-diagonal score redundancy (2x[160,160] score matrices
    # instead of [320,320]) — eval kernel 122.3 vs 137.8 ms at batch 128,
    # train step neutral (668.8 vs 672.2 ms); bit-identical outputs
    # (port: a TPU tiling, bit-identical at any value; the CUDA kernels K2/K4
    # choose their own blocking and do not read it)
    fused_block_pl: int = 8
    # block_pl-sized sub-blocks per grid step whose LN/projection/FFN
    # matmuls run as ONE wide matmul over the concatenated rows while the
    # score phase stays per-sub so block-diagonal redundancy doesn't grow;
    # bit-identical at any value (the eval kernel only; the train kernel
    # pair keys off block_pl alone)
    # (port: a TPU tiling, bit-identical at any value; not read)
    fused_pipeline_blocks: int = 2
    # training path: custom-VJP fused kernels with in-kernel dropout
    # (ops/node_encoder_train.py) instead of the XLA stack + autodiff
    # (port: K4 on the card when True; False runs the node stack's plain
    # version under autograd, models/map_encoder.py)
    fused_train_kernel: bool = True
    # bf16 matmul operands inside the node kernel (fp32 accumulation);
    # ~8% kernel-local, off by default to keep exact fp32 parity
    kernel_matmul_bf16: bool = False
    # skip the node-kernel layer chain for grid steps whose polylines are
    # all padding (scalar-prefetched any-valid flag): the 1024-polyline map
    # capacity is a fixed-shape ceiling, real scenes fill a variable prefix.
    # Bit-exact (all-invalid blocks pool to exactly _NEG either way).
    # (port: a TPU tiling, bit-identical at any value; K2/K4 always skip
    # all-padding polylines, and do not read it)
    fused_skip_invalid_blocks: bool = True
    # "fused": the whole 3-layer stack + pool in one VMEM-resident kernel
    # (fastest measured: 155 ms vs 290 hybrid vs 354 XLA at batch 128 —
    # intermediate HBM round-trips dominate the alternatives);
    # "hybrid": projections/FFN as big XLA matmuls + Pallas score core only
    node_encoder_impl: str = "fused"


@dataclass(frozen=True)
class GoalPredictorConfig:
    """ref configs/model/traffic_bots.yaml:63-68."""

    mode: str = "mlp"  # transformer, transformer_aggr, mlp, attn
    n_layer_gru: int = 3
    use_layernorm: bool = True
    res_add_gru: bool = True
    detach_features: bool = True


@dataclass(frozen=True)
class GoalManagerConfig:
    """ref configs/model/traffic_bots.yaml:61-71."""

    disable_if_reached: bool = True
    goal_predictor: GoalPredictorConfig = field(default_factory=GoalPredictorConfig)
    goal_attr_mode: str = "dest"  # dest, goal_xy, dummy
    goal_in_local: bool = True
    dest_detach_map_feature: bool = False


@dataclass(frozen=True)
class DistEncoderConfig:
    """ref configs/model/traffic_bots.yaml:77-86."""

    dist_type: str = "diag_gaus"  # dummy, std_gaus, diag_gaus, cat
    n_cat: int = 8
    log_std: Optional[float] = -1.0  # None => learned per-element log_std MLP
    use_layernorm: bool = False


@dataclass(frozen=True)
class LatentEncoderConfig:
    """ref configs/model/traffic_bots.yaml:72-86."""

    latent_dim: int = 16
    temporal_down_sample_rate: int = 5
    shared_post_prior_net: bool = False
    shared_transformer_as: bool = True
    latent_prior: DistEncoderConfig = field(default_factory=DistEncoderConfig)
    latent_post: DistEncoderConfig = field(default_factory=DistEncoderConfig)


@dataclass(frozen=True)
class AgentTemporalConfig:
    """ref configs/model/traffic_bots.yaml:89-92."""

    kind: str = "gru_loop"  # gru_loop, gru_unmasked (TrafficSim), dummy
    num_layers: int = 3
    dropout: float = 0.1


@dataclass(frozen=True)
class AgentInteractionConfig:
    """ref configs/model/traffic_bots.yaml:93-97."""

    n_layer: int = 3
    mask_self_agent: bool = True
    detach_tgt: bool = False
    attn_to_map_aware_feature: bool = True


@dataclass(frozen=True)
class AddLatentGoalConfig:
    """ref configs/model/traffic_bots.yaml:98-119."""

    mode: str = "cat"  # add, mul, cat
    res_cat: bool = False
    res_add: bool = True
    n_layer_mlp_in: int = 2
    n_layer_mlp_out: int = 2
    mlp_in_use_layernorm: bool = False
    mlp_out_use_layernorm: bool = False
    dropout_p: float = 0.1


@dataclass(frozen=True)
class ActionHeadConfig:
    """ref configs/model/traffic_bots.yaml:135-138."""

    log_std: Optional[float] = -2.0
    branch_type: bool = True
    use_layernorm: bool = False


@dataclass(frozen=True)
class DynamicsTypeConfig:
    kind: str = "multipathpp"  # multipathpp, state_integrator
    max_acc: float = 5.0
    max_yaw_rate: float = 1.5
    disable_neg_spd: bool = False
    max_v: float = 3.0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class DynamicsConfig:
    """ref configs/model/traffic_bots.yaml:140-155."""

    use_veh_dynamics_for_all: bool = False
    dt: float = 0.1
    veh: DynamicsTypeConfig = field(default_factory=lambda: DynamicsTypeConfig(max_acc=5, max_yaw_rate=1.5))
    cyc: DynamicsTypeConfig = field(default_factory=lambda: DynamicsTypeConfig(max_acc=6, max_yaw_rate=3))
    ped: DynamicsTypeConfig = field(default_factory=lambda: DynamicsTypeConfig(max_acc=7, max_yaw_rate=7))


@dataclass(frozen=True)
class RewardConfigC:
    """ref configs/model/traffic_bots.yaml:157-172."""

    w_collision: float = 0.0
    reduce_collision_with_max: bool = True
    use_il_loss: bool = True
    w_pos: float = 1e-1
    criterion_pos: str = "SmoothL1Loss"
    w_rot: float = 1e1
    criterion_rot: str = "SmoothL1Loss"
    angular_type_rot: str = "cosine"
    w_spd: float = 1e-1
    criterion_spd: str = "SmoothL1Loss"


@dataclass(frozen=True)
class TeacherForcingConfigC:
    step_spawn_agent: int = 10
    step_warm_start: int = 10
    step_horizon: int = 0
    step_horizon_decrease_per_epoch: int = 0
    prob_forcing_agent: float = 0.0
    prob_forcing_agent_decrease_per_epoch: float = 0.0
    # what-if motion prediction: force the SDC (agent 0) to GT at every step
    # (ref teacher_forcing.py:69-72, configs/resume sub_womd_sdc recipe)
    gt_sdc: bool = False


@dataclass(frozen=True)
class RuleCheckerConfig:
    """ref configs/model/traffic_bots.yaml:240-244."""

    enable_check_collided: bool = False
    enable_check_run_road_edge: bool = False
    enable_check_run_red_light: bool = False
    enable_check_passive: bool = False
    collision_size_scale: float = 1.1


@dataclass(frozen=True)
class TrainingMetricsConfig:
    """ref configs/model/traffic_bots.yaml:209-219."""

    w_vae_kl: float = 1e-1
    kl_balance_scale: float = -1.0
    kl_free_nats: float = 1e-2
    kl_for_unseen_agent: bool = True
    w_diffbar_reward: float = 1.0
    w_goal: float = 1.0
    w_relevant_agent: float = 0.0
    p_loss_for_irrelevant: float = -1.0
    loss_for_teacher_forcing: bool = True
    step_training_start: int = 10


@dataclass(frozen=True)
class OptimizerConfig:
    """ref configs/model/traffic_bots.yaml:221-229."""

    lr: float = 3e-4
    lr_goal: float = 3e-4
    scheduler_gamma: float = 0.5
    scheduler_step_size: int = 7  # epochs
    gradient_clip_val: float = 5.0  # ref configs/trainer/default.yaml:12


@dataclass(frozen=True)
class PostProcessingConfig:
    """ref configs/model/traffic_bots.yaml:179-186."""

    k_pred: int = 6
    use_ade: bool = True
    score_temperature: float = 1e2
    mpa_nms_thresh: Tuple[float, ...] = ()
    mtr_nms_thresh: Tuple[float, ...] = ()
    aggr_thresh: Tuple[float, ...] = ()
    n_iter_em: int = 3


@dataclass(frozen=True)
class ModelConfig:
    """The policy network tree. ref configs/model/traffic_bots.yaml:34-125."""

    hidden_dim: int = 128
    add_goal_latent_first: bool = False
    resample_latent: bool = False
    n_layer_tf_as2pl: int = 3
    n_layer_tf_as2tl: int = 3
    tf_cfg: TransformerConfig = field(default_factory=TransformerConfig)
    input_pe_encoder: InputPeEncoderConfig = field(default_factory=InputPeEncoderConfig)
    map_encoder: MapEncoderConfig = field(default_factory=MapEncoderConfig)
    goal_manager: GoalManagerConfig = field(default_factory=GoalManagerConfig)
    latent_encoder: LatentEncoderConfig = field(default_factory=LatentEncoderConfig)
    temporal_aggregate_mode: str = "max_valid"
    agent_temporal: AgentTemporalConfig = field(default_factory=AgentTemporalConfig)
    agent_interaction: AgentInteractionConfig = field(default_factory=AgentInteractionConfig)
    add_latent: AddLatentGoalConfig = field(default_factory=AddLatentGoalConfig)
    add_goal: AddLatentGoalConfig = field(
        default_factory=lambda: AddLatentGoalConfig(n_layer_mlp_in=3, mlp_in_use_layernorm=True)
    )
    interaction_first: bool = True
    n_layer_final_mlp: int = -1
    # use the fused Pallas attention also for the small-target in-scan blocks
    # (as2tl T=100, agent interaction T=64); the big-target as2pl (T=1024)
    # always uses it when eligible
    # measured round 2: the small-T kernels' launch overhead (90 steps x
    # batch-sized grids) exceeds their VMEM savings -> XLA by default
    fused_attention_small_t: bool = False
    # store the per-episode as2pl K/V cache in bf16 in EVAL rollouts: they
    # re-read it every step (batch x 1MB x 90 steps x n_layers of HBM
    # traffic), and the attention math accumulates in fp32 either way.
    # Training always keeps fp32 K/V (gradient precision parity).
    map_kv_bf16: bool = True
    # fused-attention query-row blocking: -1 = round-2 whole-S blocks with
    # the dead-row skip OFF (the default), 0 = auto ~8 skip-granular blocks
    # with the skip ON, >0 = explicit rows per grid step (skip ON).
    # Round-4 hardware A/B at WOMD-like fill (768/1024 polylines, 40/64
    # agents valid): skip OFF 383.9 ms vs ON 538.7 ms — the finer grid's
    # launch overhead swamps the skipped compute unless the batch is very
    # sparse (at 12.5%-polyline fill the skip wins 394 vs 387 ms; set 0 for
    # such data). See PERF.md round-4 fill-sensitivity table.
    # NOTE: the latent encoder's episode as2pl flattens (step*agent) tokens
    # whose live rows repeat with period n_agent, so it honors an explicit
    # value only when it divides step*agent and is <= n_agent (otherwise it
    # coerces to 16 so the dead-row skip can still fire; latent_encoder.py).
    # (port: K1's dead-row skip is not ported yet, ROADMAP Queue 2; a value
    # >= 0 raises NotImplementedError in models/traffic_bots.py)
    attn_row_block: int = -1
    # EVAL episode map encode: process the scene batch in chunks of this many
    # scenes (lax.map), recomputing the map PE per chunk from sc/map_pos so
    # the [B, n_pl, n_node, *] featurization temporaries only ever exist at
    # chunk size. Caps the episode-encode HBM peak (batch 256 OOM'd the 16G
    # chip at 24G before this, dominated by tile-padded PE/MLP temps) without
    # touching throughput: the per-scene math is identical, just partitioned.
    # 0 disables; chunking also auto-disables when the batch is not a
    # multiple of the chunk, in training (dropout rng plumbing + BPTT remat
    # stay on the unchunked path), when views see different maps, or when
    # the Validator shards the step over a mesh (the jitted batch axis is
    # then GLOBAL: lax.map over global sub-batches would serialize the
    # data-parallel map encode and reshard each chunk, while the HBM cap
    # this flag exists for is per-device anyway).
    map_encode_chunk: int = 32
    # pre-processing (ref configs/model/traffic_bots.yaml:14-32)
    pe_dim: int = 96
    pose_pe_map: str = "pe_xy_yaw"
    pose_pe_tl: str = "pe_xy_yaw"
    pose_pe_agent: str = "pe_xy_yaw"
    dropout_p_history: float = -1.0
    perturb_input_to_latent: bool = False
    perturb_max_meter: float = 50.0
    perturb_max_rad: float = 3.14

    def __post_init__(self):
        # The reference interpolates d_model from hidden_dim
        # (configs/model/traffic_bots.yaml:42 `d_model: ${..hidden_dim}`);
        # keep the same invariant so a CLI `model.hidden_dim=...` override
        # cannot silently desynchronize the transformer width.
        if self.tf_cfg.d_model != self.hidden_dim:
            object.__setattr__(
                self, "tf_cfg", dataclasses.replace(self.tf_cfg, d_model=self.hidden_dim)
            )


@dataclass(frozen=True)
class ExperimentConfig:
    """Composition root (ref configs/run.yaml + waymo_motion.py hparams)."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    dynamics: DynamicsConfig = field(default_factory=DynamicsConfig)
    action_head: ActionHeadConfig = field(default_factory=ActionHeadConfig)
    reward: RewardConfigC = field(default_factory=RewardConfigC)
    rule_checker: RuleCheckerConfig = field(default_factory=RuleCheckerConfig)
    training_metrics: TrainingMetricsConfig = field(default_factory=TrainingMetricsConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    post_processing: PostProcessingConfig = field(default_factory=PostProcessingConfig)
    tf_training: TeacherForcingConfigC = field(default_factory=TeacherForcingConfigC)
    tf_reactive_replay: TeacherForcingConfigC = field(
        default_factory=lambda: TeacherForcingConfigC(step_spawn_agent=90)
    )
    tf_joint_future_pred: TeacherForcingConfigC = field(default_factory=TeacherForcingConfigC)

    # Sub-epoch training cadence: each "epoch" consumes this fraction of the
    # training loader (float in (0,1]) or this many batches (int > 1) before
    # validation/checkpoint/LR-epoch accounting run — the reference validates
    # every 0.15 of the packed training file (configs/trainer/default.yaml:3
    # `limit_train_batches: 0.15`, PL semantics).
    limit_train_batches: float = 0.15

    time_step_current: int = 10
    time_step_gt: int = 90
    time_step_end: int = 90
    time_step_sim_start: int = 1
    n_joint_future: int = 6
    interactive_challenge: bool = False
    # render videos/dest-prob images for the first N val batches
    # (ref configs/model/traffic_bots.yaml:10; 0 disables)
    n_video_batch: int = 3

    step_detach_hidden: int = -1
    p_drop_hidden: float = -1.0
    p_training_rollout_prior: float = 0.1
    detach_state_policy: bool = True
    training_deterministic_action: bool = True

    seed: int = 2023
    precision: str = "fp32"  # fp32 | bf16 (encoder compute dtype; physics stays fp32)
    # rematerialize the rollout scan body in the training backward pass
    # (memory O(1 step) instead of O(90 steps); SURVEY.md hard part #2)
    remat_rollout_step: bool = True
    # what the remat saves: "none" recomputes the whole step forward in the
    # backward pass; "save_attn" additionally saves each attention core's
    # output ([B, A, d] per layer per step — ~1 MB/step at batch 32), so the
    # remat re-forward skips the attention kernels whose custom VJP already
    # recomputes logits in-VMEM during the backward (avoiding the double
    # recompute). Gradients are identical either way. Default save_attn:
    # 673 vs 692 ms at the WOMD-like-fill batch-32 train step (PERF.md
    # round-4 train table) for ~90 MB of residuals. "save_core" also saves
    # the per-step featurization, GRU output and action-head input.
    remat_policy: str = "save_attn"  # none | save_attn | save_core


# ---------------------------------------------------------------------------
# Ablation presets (ref docs/ablation_models.md)
# ---------------------------------------------------------------------------


def ablation(name: str, base: Optional[ExperimentConfig] = None) -> ExperimentConfig:
    """Reproduce the reference ablation recipes by name."""
    cfg = base or ExperimentConfig()
    m = cfg.model
    if name == "traffic_bots":
        return cfg
    if name == "simnet":
        # no latent, no goal (docs/ablation_models.md SimNet)
        return replace(
            cfg,
            model=replace(
                m,
                goal_manager=replace(m.goal_manager, goal_attr_mode="dummy"),
                latent_encoder=replace(
                    m.latent_encoder,
                    latent_prior=replace(m.latent_encoder.latent_prior, dist_type="dummy"),
                    latent_post=replace(m.latent_encoder.latent_post, dist_type="dummy"),
                ),
            ),
            training_metrics=replace(cfg.training_metrics, w_vae_kl=0.0, w_goal=0.0),
        )
    if name == "trafficsim":
        # StateIntegrator dynamics + resample latent + goal/latent first
        # (docs/ablation_models.md TrafficSim: per-type max_v 27/6/3)
        return replace(
            cfg,
            model=replace(
                m,
                resample_latent=True,
                add_goal_latent_first=True,
                interaction_first=False,
                agent_temporal=replace(m.agent_temporal, kind="gru_unmasked"),
                temporal_aggregate_mode="last",
                goal_manager=replace(m.goal_manager, goal_attr_mode="goal_xy"),
            ),
            dynamics=replace(
                cfg.dynamics,
                veh=DynamicsTypeConfig(kind="state_integrator", max_v=27.0),
                cyc=DynamicsTypeConfig(kind="state_integrator", max_v=6.0),
                ped=DynamicsTypeConfig(kind="state_integrator", max_v=3.0),
            ),
        )
    if name == "bc":
        # behavior cloning: full-horizon teacher forcing (step_horizon=90)
        return replace(cfg, tf_training=replace(cfg.tf_training, step_horizon=90))
    if name == "bc_simnet":
        return ablation("bc", ablation("simnet", cfg))
    if name == "no_free_nats":
        return replace(cfg, training_metrics=replace(cfg.training_metrics, kl_free_nats=-1.0))
    if name == "large_kl":
        return replace(cfg, training_metrics=replace(cfg.training_metrics, w_vae_kl=1e-2))
    if name == "action_gradients":
        return replace(cfg, detach_state_policy=False)
    if name == "goal_no_navigator":
        return replace(
            cfg,
            model=replace(
                m,
                goal_manager=replace(
                    m.goal_manager, goal_attr_mode="goal_xy", disable_if_reached=False
                ),
            ),
        )
    if name == "no_latent":
        le = m.latent_encoder
        return replace(
            cfg,
            model=replace(
                m,
                latent_encoder=replace(
                    le,
                    latent_prior=replace(le.latent_prior, dist_type="dummy"),
                    latent_post=replace(le.latent_post, dist_type="dummy"),
                ),
            ),
            training_metrics=replace(cfg.training_metrics, w_vae_kl=0.0),
        )
    if name == "no_goal":
        return replace(
            cfg,
            model=replace(m, goal_manager=replace(m.goal_manager, goal_attr_mode="dummy")),
            training_metrics=replace(cfg.training_metrics, w_goal=0.0),
        )
    if name == "scene_transformer_pe":
        # Eq. 1: PE position + unit dir, everything into the MLP
        return replace(
            cfg,
            model=replace(
                m,
                pose_pe_map="pe_xy_unit_dir", pose_pe_tl="pe_xy_unit_dir",
                pose_pe_agent="pe_xy_unit_dir",
                input_pe_encoder=replace(m.input_pe_encoder, pe_mode="input"),
            ),
        )
    if name == "pe_add":
        # Eq. 2: PE for position and direction, added after the MLP
        return replace(
            cfg,
            model=replace(
                m,
                pose_pe_map="pe_xy_dir", pose_pe_tl="pe_xy_dir", pose_pe_agent="pe_xy_dir",
                pe_dim=m.hidden_dim,
                input_pe_encoder=replace(m.input_pe_encoder, pe_mode="add"),
            ),
        )
    if name in ("pe_xy_dir", "pe_xy_unit_dir", "xy_dir", "mpa_pl"):
        return replace(
            cfg, model=replace(m, pose_pe_map=name, pose_pe_tl=name, pose_pe_agent=name)
        )
    if name == "no_interaction":
        return replace(cfg, model=replace(m, agent_interaction=replace(m.agent_interaction, n_layer=0)))
    if name == "goal_xy":
        return replace(cfg, model=replace(m, goal_manager=replace(m.goal_manager, goal_attr_mode="goal_xy")))
    if name == "latent_cat":
        le = m.latent_encoder
        return replace(
            cfg,
            model=replace(
                m,
                latent_encoder=replace(
                    le,
                    latent_prior=replace(le.latent_prior, dist_type="cat"),
                    latent_post=replace(le.latent_post, dist_type="cat"),
                ),
            ),
        )
    if name == "latent_std_gaus":
        le = m.latent_encoder
        return replace(
            cfg,
            model=replace(
                m,
                latent_encoder=replace(
                    le,
                    latent_prior=replace(le.latent_prior, dist_type="std_gaus"),
                ),
            ),
        )
    raise ValueError(f"unknown ablation {name}")


# ---------------------------------------------------------------------------
# Config persistence (ref save_hyperparameters, waymo_motion.py:63 + the
# resume/model_overrides flow, ref run.py:40-44, configs/resume/submission.yaml)
# ---------------------------------------------------------------------------


def config_to_dict(cfg) -> Dict:
    """Full config tree as plain (json-serializable) dicts/lists/scalars."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict, cls=None):
    """Rebuild a config dataclass tree from a json-loaded dict.

    - nested dataclasses recurse (type taken from a default instance, which
      also restores tuples that json round-tripped into lists);
    - keys missing from the dict keep their defaults (forward compatible);
    - unknown keys raise: a typo'd or stale snapshot must not silently run a
      different experiment than it claims.
    """
    if cls is None:
        cls = ExperimentConfig
    ref = cls()
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name in names:
        if name not in d:
            continue
        v = d[name]
        cur = getattr(ref, name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kwargs[name] = config_from_dict(v, type(cur))
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            kwargs[name] = tuple(v)
        else:
            kwargs[name] = v
    return cls(**kwargs)
