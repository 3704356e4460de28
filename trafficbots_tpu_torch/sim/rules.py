"""Traffic-rule checking over (constants, sticky state) dataclasses.

Counterpart of `trafficbots_tpu/sim/rules.py`. `RuleConstants` holds the
per-episode precomputation, `RuleState` the sticky violation flags carried
from step to step, and `check_rules` evaluates one step. The enable flags
are static config: only outside-map, goal-reached and dest-reached run in
the default configuration.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..geometry import cast_rad

Tensor = torch.Tensor

GOAL_THRESH_ROT = math.radians(15.0)
DEST_THRESH_ROT = math.radians(30.0)


@dataclasses.dataclass(frozen=True)
class RuleConfig:
    enable_check_collided: bool = False
    enable_check_run_road_edge: bool = False
    enable_check_run_red_light: bool = False
    enable_check_passive: bool = False
    collision_size_scale: float = 1.1


@dataclasses.dataclass(frozen=True)
class RuleConstants:
    agent_size: Tensor  # [B, A, 2] scaled (length, width)
    map_boundary: Tensor  # [B, 4]
    veh_mask: Tensor  # [B, A]
    collision_invalid_mask: Tensor  # [B, A, A]
    road_edge: Tensor  # [B, P*N, 2, 2]
    road_edge_valid: Tensor  # [B, P*N]
    lane_center: Tensor  # [B, P*N, 2]
    lane_center_valid: Tensor  # [B, P*N]
    rrl_agent_length: Tensor  # [B, A, 1]
    rrl_agent_width: Tensor  # [B, A, 1]
    agent_goal: Optional[Tensor] = None  # [B, A, 4]
    goal_thresh_pos: Optional[Tensor] = None  # [B, A]
    agent_dest: Optional[Tensor] = None  # [B, A] int
    dest_valid: Optional[Tensor] = None  # [B, A, N]
    dest_type: Optional[Tensor] = None  # [B, A, 11]
    dest_pos: Optional[Tensor] = None  # [B, A, N, 2]
    dest_dir: Optional[Tensor] = None  # [B, A, N, 2] unit
    dest_thresh_pos: Optional[Tensor] = None  # [B, A]


@dataclasses.dataclass(frozen=True)
class RuleState:
    outside_map: Tensor
    collided: Tensor
    run_road_edge: Tensor
    run_red_light: Tensor
    passive: Tensor
    passive_counter: Tensor  # float32
    goal_reached: Tensor
    dest_reached: Tensor


def init_rule_constants(
    map_boundary: Tensor, map_valid: Tensor, map_type: Tensor, map_pos: Tensor, map_dir: Tensor,
    agent_type: Tensor, agent_size: Tensor,
    agent_goal: Optional[Tensor] = None, agent_dest: Optional[Tensor] = None,
    cfg: RuleConfig = RuleConfig(),
) -> RuleConstants:
    n_batch, n_agent = agent_type.shape[:2]
    dev = agent_type.device
    ego = torch.eye(n_agent, dtype=torch.bool, device=dev)[None].expand(n_batch, n_agent, n_agent)
    ped_cyc = agent_type[:, :, 1]
    collision_invalid = ego | (ped_cyc[:, :, None] & ped_cyc[:, None, :])
    road_edge_valid = (map_valid & map_type[:, :, [4, 5, 7]].any(dim=-1, keepdim=True)).reshape(n_batch, -1)
    road_edge = torch.stack([map_pos, map_pos + map_dir], dim=-2).reshape(n_batch, -1, 2, 2)
    lane_center_valid = (map_valid & map_type[:, :, :3].any(dim=-1, keepdim=True)).reshape(n_batch, -1)
    lane_center = map_pos.reshape(n_batch, -1, 2)

    kw: Dict = {}
    if agent_goal is not None:
        kw["agent_goal"] = agent_goal
        kw["goal_thresh_pos"] = agent_size[:, :, 0] * 8.0
    if agent_dest is not None:
        bidx = torch.arange(n_batch, device=dev)[:, None]
        dest_type = map_type[bidx, agent_dest]
        dest_dir = map_dir[bidx, agent_dest]
        dest_dir = dest_dir / torch.linalg.norm(dest_dir, dim=-1, keepdim=True)
        dest_thresh_pos = torch.ones_like(agent_size[:, :, 0]) * 50.0
        dest_thresh_pos = dest_thresh_pos * (1.0 - dest_type[:, :, 4].float() * 0.8)
        kw.update(
            agent_dest=agent_dest, dest_valid=map_valid[bidx, agent_dest], dest_type=dest_type,
            dest_pos=map_pos[bidx, agent_dest], dest_dir=dest_dir, dest_thresh_pos=dest_thresh_pos,
        )
    return RuleConstants(
        agent_size=agent_size[..., :2] * cfg.collision_size_scale,
        map_boundary=map_boundary,
        veh_mask=agent_type[:, :, 0],
        collision_invalid_mask=collision_invalid,
        road_edge=road_edge,
        road_edge_valid=road_edge_valid,
        lane_center=lane_center,
        lane_center_valid=lane_center_valid,
        rrl_agent_length=agent_size[:, :, 0:1] * 0.5 * 0.6,
        rrl_agent_width=agent_size[:, :, 1:2] * 0.5 * 1.8,
        **kw,
    )


def init_rule_state(n_batch: int, n_agent: int, device=None) -> RuleState:
    b = torch.zeros((n_batch, n_agent), dtype=torch.bool, device=device)
    return RuleState(
        outside_map=b, collided=b, run_road_edge=b, run_red_light=b, passive=b,
        passive_counter=torch.zeros((n_batch, n_agent), device=device), goal_reached=b, dest_reached=b,
    )


def agent_bbox_corners(agent_states: Tensor, agent_size: Tensor) -> Tensor:
    """Oriented bbox corners [B, A, 4, 2]."""
    c = torch.cos(agent_states[..., 2])
    s = torch.sin(agent_states[..., 2])
    heading_f = torch.stack([c, s], dim=-1)
    heading_r = torch.stack([s, -c], dim=-1)
    off_f = 0.5 * agent_size[..., 0:1] * heading_f
    off_r = 0.5 * agent_size[..., 1:2] * heading_r
    corners = torch.stack([-off_f + off_r, off_f + off_r, off_f - off_r, -off_f - off_r], dim=2)
    return agent_states[:, :, None, :2] + corners


def _check_outside_map(valid, state, map_boundary):
    x, y = state[:, :, 0], state[:, :, 1]
    xmin, xmax, ymin, ymax = (map_boundary[:, i : i + 1] for i in range(4))
    return ((x > xmax) | (x < xmin) | (y > ymax) | (y < ymin)) & valid


def _check_collided(valid, bbox, collision_invalid_mask):
    """Separating-lines bbox overlap test."""
    bbox_next = torch.roll(bbox, -1, dims=2)
    line = torch.cat(
        [
            bbox_next[..., 1:2] - bbox[..., 1:2],
            bbox[..., 0:1] - bbox_next[..., 0:1],
            bbox_next[..., 0:1] * bbox[..., 1:2] - bbox_next[..., 1:2] * bbox[..., 0:1],
        ],
        dim=-1,
    )
    point = torch.cat([bbox, torch.ones_like(bbox[..., :1])], dim=-1)
    is_outside = torch.einsum("nilc,njpc->nijlp", line, point) > 0
    no_collision = is_outside.all(dim=-1).any(dim=-1)
    no_collision = no_collision | no_collision.transpose(1, 2)
    invalid = ~(valid[:, :, None] & valid[:, None, :])
    no_collision = no_collision | collision_invalid_mask | invalid
    return ~no_collision.all(dim=-1)


def _ccw(A, B, C):
    return (C[..., 1] - A[..., 1]) * (B[..., 0] - A[..., 0]) > (B[..., 1] - A[..., 1]) * (C[..., 0] - A[..., 0])


def _check_run_road_edge(valid, bbox, veh_mask, road_edge, road_edge_valid):
    bbox_next = torch.roll(bbox, -1, dims=2)
    A = bbox[:, :, None, :, :]
    B = bbox_next[:, :, None, :, :]
    C = road_edge[:, None, :, None, 0, :]
    D = road_edge[:, None, :, None, 1, :]
    crossed = (_ccw(A, C, D) != _ccw(B, C, D)) & (_ccw(A, B, C) != _ccw(A, B, D))
    crossed = crossed.any(dim=-1) & road_edge_valid[:, None, :]
    return crossed.any(dim=-1) & valid & veh_mask


def _check_run_red_light(valid, state, tl_valid, tl_pos, tl_state, rrl_len, rrl_wid, veh_mask):
    c, s = torch.cos(state[..., 2]), torch.sin(state[..., 2])
    heading_f = torch.stack([c, s], dim=-1)[:, :, None, :]
    heading_r = torch.stack([s, -c], dim=-1)[:, :, None, :]
    xy0 = state[..., :2][:, :, None, :]
    xy1 = xy0 + 0.1 * state[..., 3:4][:, :, None, :] * heading_f
    tlp = tl_pos[:, None, :, :]

    def inside(xy):
        return (torch.abs(((tlp - xy) * heading_f).sum(dim=-1)) < rrl_len) & (
            torch.abs(((tlp - xy) * heading_r).sum(dim=-1)) < rrl_wid
        )

    mask_agent = (valid & veh_mask)[:, :, None]
    mask_tl = (tl_valid & tl_state[:, :, 1])[:, None, :]
    return (inside(xy0) & ~inside(xy1) & mask_agent & mask_tl).any(dim=-1)


def _check_passive(valid, state, passive_counter, tl_valid, tl_pos, tl_state,
                   lane_center, lane_center_valid, veh_mask, n_agent_eye):
    close = torch.linalg.norm(state[:, :, None, :2] - lane_center[:, None, :, :], dim=-1) < 2.0
    close_to_lane = (close & lane_center_valid[:, None, :]).any(dim=-1)
    low_speed = state[:, :, 3] < 5.0
    heading_f = torch.stack([torch.cos(state[..., 2]), torch.sin(state[..., 2])], dim=-1)[:, :, None, :]
    mask_tl = (tl_valid & tl_state[:, :, [0, 1, 2, 4]].any(dim=-1))[:, None, :]
    tl_vec = tl_pos[:, None, :, :] - state[:, :, None, :2]
    tl_norm = torch.linalg.norm(tl_vec, dim=-1)
    tl_ahead = (heading_f * tl_vec).sum(dim=-1) / tl_norm > 0.95
    red_ahead = ((tl_norm < 10.0) & tl_ahead & mask_tl).any(dim=-1)
    agent_vec = state[:, None, :, :2] - state[:, :, None, :2]
    agent_norm = torch.linalg.norm(agent_vec, dim=-1)
    a_ahead = (heading_f * agent_vec).sum(dim=-1) / agent_norm > 0.95
    agent_ahead = (
        (agent_norm < 10.0) & a_ahead & valid[:, None, :] & valid[:, :, None] & ~n_agent_eye
    ).any(dim=-1)
    passive_now = valid & veh_mask & close_to_lane & low_speed & ~red_ahead & ~agent_ahead
    passive_counter = (passive_counter + passive_now) * passive_now
    return passive_counter > 20.0, passive_counter


def _check_goal_reached(valid, state, goal, goal_reached, thresh_pos):
    pos_ok = torch.linalg.norm(state[..., :2] - goal[..., :2], dim=-1) < thresh_pos
    rot_ok = torch.abs(cast_rad(state[..., 2] - goal[..., 2])) < GOAL_THRESH_ROT
    return pos_ok & rot_ok & valid & ~goal_reached


def _check_dest_reached(valid, state, c: RuleConstants, dest_reached):
    dist = torch.linalg.norm(state[..., :2][:, :, None, :] - c.dest_pos, dim=-1)
    dist = torch.where(c.dest_valid, dist, torch.full_like(dist, 1e4))
    pos_ok = (dist < c.dest_thresh_pos[..., None]).any(dim=-1)
    heading_f = torch.stack([torch.cos(state[..., 2]), torch.sin(state[..., 2])], dim=-1)
    rot_diff = (heading_f[:, :, None, :] * c.dest_dir).sum(dim=-1)
    rot_diff = torch.where(c.dest_valid, rot_diff, torch.zeros_like(rot_diff))
    rot_ok = (rot_diff > math.cos(DEST_THRESH_ROT)).any(dim=-1)
    mask_lane = c.dest_type[:, :, :4].any(dim=-1)
    mask_edge = c.dest_type[:, :, 4]
    return ~dest_reached & valid & ((mask_lane & pos_ok & rot_ok) | (mask_edge & pos_ok))


def check_rules(
    cfg: RuleConfig, consts: RuleConstants, rs: RuleState,
    valid: Tensor,  # [B, A] bool, post-update
    state: Tensor,  # [B, A, 4]
    tl_valid: Tensor, tl_pos: Tensor, tl_state: Tensor,  # this step's traffic-light slice
) -> Tuple[RuleState, Dict[str, Tensor]]:
    """One rule-check step -> (new sticky state, the 14-key violations dict)."""
    bbox = agent_bbox_corners(state, consts.agent_size)
    outside_now = _check_outside_map(valid, state, consts.map_boundary)
    outside = rs.outside_map | outside_now
    if cfg.enable_check_collided:
        collided_now = _check_collided(valid, bbox, consts.collision_invalid_mask)
        collided = rs.collided | collided_now
    else:
        collided_now = collided = rs.collided
    if cfg.enable_check_run_road_edge:
        rre_now = _check_run_road_edge(valid, bbox, consts.veh_mask, consts.road_edge, consts.road_edge_valid)
        rre = rs.run_road_edge | rre_now
    else:
        rre_now = rre = rs.run_road_edge
    if cfg.enable_check_run_red_light:
        rrl_now = _check_run_red_light(
            valid, state, tl_valid, tl_pos, tl_state,
            consts.rrl_agent_length, consts.rrl_agent_width, consts.veh_mask,
        )
        rrl = rs.run_red_light | rrl_now
    else:
        rrl_now = rrl = rs.run_red_light
    if cfg.enable_check_passive:
        eye = torch.eye(valid.shape[1], dtype=torch.bool, device=valid.device)[None]
        passive_now, passive_counter = _check_passive(
            valid, state, rs.passive_counter, tl_valid, tl_pos, tl_state,
            consts.lane_center, consts.lane_center_valid, consts.veh_mask, eye,
        )
        passive = rs.passive | passive_now
    else:
        passive_now = passive = rs.passive
        passive_counter = rs.passive_counter
    if consts.agent_goal is not None:
        goal_now = _check_goal_reached(valid, state, consts.agent_goal, rs.goal_reached, consts.goal_thresh_pos)
    else:
        goal_now = torch.zeros_like(rs.goal_reached)
    goal_reached = rs.goal_reached | goal_now
    if consts.agent_dest is not None:
        dest_now = _check_dest_reached(valid, state, consts, rs.dest_reached)
    else:
        dest_now = torch.zeros_like(rs.dest_reached)
    dest_reached = rs.dest_reached | dest_now

    new_rs = RuleState(
        outside_map=outside, collided=collided, run_road_edge=rre, run_red_light=rrl,
        passive=passive, passive_counter=passive_counter, goal_reached=goal_reached,
        dest_reached=dest_reached,
    )
    violations = {
        "outside_map": outside, "outside_map_this_step": outside_now,
        "collided": collided, "collided_this_step": collided_now,
        "run_road_edge": rre, "run_road_edge_this_step": rre_now,
        "run_red_light": rrl, "run_red_light_this_step": rrl_now,
        "passive": passive, "passive_this_step": passive_now,
        "goal_reached": goal_reached, "goal_reached_this_step": goal_now,
        "dest_reached": dest_reached, "dest_reached_this_step": dest_now,
    }
    return new_rs, violations
