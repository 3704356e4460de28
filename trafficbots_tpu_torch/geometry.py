"""SE(2) geometry, angle utilities and pose positional encodings in PyTorch.

Counterpart of `trafficbots_tpu/geometry.py`. Every function is a plain
tensor function over trailing dims that broadcasts over leading batch dims,
in fp32 unless stated. The frequency tables are built with numpy exactly as
in the JAX package and moved to the input's device, so both packages encode
a pose with the same constants.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

Tensor = torch.Tensor


def cast_rad(angle: Tensor) -> Tensor:
    """Wrap angles to [-pi, pi). `torch.remainder` takes the divisor's sign,
    like `jnp.mod` (`torch.fmod` would not)."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def rad2rot(rad: Tensor) -> Tensor:
    """[...] -> [..., 2, 2] rotation matrices [[c, -s], [s, c]]."""
    c = torch.cos(rad)
    s = torch.sin(rad)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def _rowvec_matmul(v: Tensor, rot: Tensor) -> Tensor:
    """v [..., M, 2] @ rot [..., 2, 2], written out elementwise in the same
    order as the JAX package so coordinates round identically."""
    r = rot[..., None, :, :]
    x = v[..., 0:1] * r[..., 0, 0:1] + v[..., 1:2] * r[..., 1, 0:1]
    y = v[..., 0:1] * r[..., 0, 1:2] + v[..., 1:2] * r[..., 1, 1:2]
    return torch.cat([x, y], dim=-1)


def pos2local(in_pos: Tensor, local_pos: Tensor, local_rot: Tensor) -> Tensor:
    """in_pos [..., M, 2], local_pos [..., 1, 2], local_rot [..., 2, 2]."""
    return _rowvec_matmul(in_pos - local_pos, local_rot)


def pos2global(in_pos: Tensor, local_pos: Tensor, local_rot: Tensor) -> Tensor:
    return _rowvec_matmul(in_pos, local_rot.transpose(-1, -2)) + local_pos


def dir2local(in_dir: Tensor, local_rot: Tensor) -> Tensor:
    return _rowvec_matmul(in_dir, local_rot)


def rad2local(in_rad: Tensor, local_rad: Tensor, cast: bool = True) -> Tensor:
    out = in_rad - local_rad[..., None]
    return cast_rad(out) if cast else out


# ---------------------------------------------------------------------------
# Sinusoidal positional embeddings
# ---------------------------------------------------------------------------


def _pe_freqs(dim: int, theta: float) -> np.ndarray:
    """freqs = 1/theta^(2i/dim) for i in [0, dim/2), each repeated twice."""
    assert dim % 2 == 0
    half = np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / dim
    freqs = 1.0 / (theta ** half)
    return np.repeat(freqs, 2).astype(np.float32)


def _pe_freqs_rad(dim: int) -> np.ndarray:
    """Integer frequency table [1, 1, 2, 2, 3, 3, ...]."""
    assert dim % 2 == 0
    freqs = np.arange(0, dim // 2, dtype=np.float32) + 1.0
    return np.repeat(freqs, 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _freq_table(dim: int, theta, dtype: torch.dtype, device: torch.device) -> Tensor:
    """The unrepeated frequency table on `device`, built once: a copy from
    the host on every rollout step would stall the stream each time.
    theta None = the integer table of positional_embedding_rad."""
    freqs = _pe_freqs_rad(dim) if theta is None else _pe_freqs(dim, theta)
    return torch.as_tensor(freqs[::2].copy(), dtype=dtype, device=device)


def _apply_pe(x: Tensor, dim: int, theta) -> Tensor:
    """x [...] -> [..., dim] = cat(cos(x f), sin(x f)) on the unrepeated table."""
    enc = x[..., None] * _freq_table(dim, theta, x.dtype, x.device)
    return torch.cat([torch.cos(enc), torch.sin(enc)], dim=-1)


def positional_embedding(x: Tensor, dim: int, theta: float = 10000.0) -> Tensor:
    return _apply_pe(x, dim, float(theta))


def positional_embedding_rad(x: Tensor, dim: int) -> Tensor:
    return _apply_pe(x, dim, None)


POSE_PE_MODES = ("xy_dir", "mpa_pl", "pe_xy_unit_dir", "pe_xy_dir", "pe_xy_yaw")


def pose_pe_out_dim(mode: str, pe_dim: int) -> int:
    if mode == "xy_dir":
        return 4
    if mode == "mpa_pl":
        return 7
    if mode == "pe_xy_unit_dir":
        return pe_dim + 2
    if mode in ("pe_xy_dir", "pe_xy_yaw"):
        return pe_dim
    raise NotImplementedError(mode)


def _dir_as_unit(direction: Tensor) -> Tensor:
    """Accept [..., 1] yaw or [..., 2] cos/sin; return [..., 2]."""
    if direction.shape[-1] == 1:
        return torch.cat([torch.cos(direction), torch.sin(direction)], dim=-1)
    return direction


def encode_polyline_mpa(pos: Tensor, direction: Tensor) -> Tensor:
    """MultiPath++-style 7-d polyline feature."""
    eps = torch.finfo(pos.dtype).eps
    seg_vec = direction
    seg_proj = torch.sum(-pos * seg_vec, dim=-1) / (torch.sum(seg_vec * seg_vec, dim=-1) + eps)
    closest = pos + torch.clamp(seg_proj, 0.0, 1.0)[..., None] * seg_vec
    r_norm = torch.linalg.norm(closest, dim=-1, keepdim=True)
    seg_norm = torch.linalg.norm(seg_vec, dim=-1, keepdim=True)
    return torch.cat(
        [
            r_norm,
            closest / (r_norm + eps),
            seg_vec / (seg_norm + eps),
            seg_norm,
            torch.linalg.norm(pos + seg_vec - closest, dim=-1, keepdim=True),
        ],
        dim=-1,
    )


def pose_pe(
    xy: Tensor,
    direction: Tensor,
    mode: str,
    pe_dim: int = 256,
    theta_xy: float = 1e3,
    theta_cs: float = 1e1,
) -> Tensor:
    """Pose positional encoding; xy [..., 2], direction [..., 1] yaw or [..., 2]."""
    if mode == "xy_dir":
        return torch.cat([xy, _dir_as_unit(direction)], dim=-1)
    if mode == "mpa_pl":
        return encode_polyline_mpa(xy, _dir_as_unit(direction))
    if mode == "pe_xy_unit_dir":
        d = _dir_as_unit(direction)
        return torch.cat(
            [
                positional_embedding(xy[..., 0], pe_dim // 2, theta_xy),
                positional_embedding(xy[..., 1], pe_dim // 2, theta_xy),
                d[..., 0:1],
                d[..., 1:2],
            ],
            dim=-1,
        )
    if mode == "pe_xy_dir":
        d = _dir_as_unit(direction)
        return torch.cat(
            [
                positional_embedding(xy[..., 0], pe_dim // 4, theta_xy),
                positional_embedding(xy[..., 1], pe_dim // 4, theta_xy),
                positional_embedding(d[..., 0], pe_dim // 4, theta_cs),
                positional_embedding(d[..., 1], pe_dim // 4, theta_cs),
            ],
            dim=-1,
        )
    if mode == "pe_xy_yaw":
        if direction.shape[-1] == 1:
            yaw = direction[..., 0]
        else:
            yaw = torch.atan2(direction[..., 1], direction[..., 0])
        if pe_dim % 8 == 0:
            return _pe_xy_yaw_packed(xy, yaw, pe_dim, theta_xy)
        return torch.cat(
            [
                positional_embedding(xy[..., 0], pe_dim // 4, theta_xy),
                positional_embedding(xy[..., 1], pe_dim // 4, theta_xy),
                positional_embedding_rad(yaw, pe_dim // 2),
            ],
            dim=-1,
        )
    raise NotImplementedError(mode)


@functools.lru_cache(maxsize=None)
def _pe_xy_yaw_tables(pe_dim: int, theta_xy: float, dtype: torch.dtype, device: torch.device):
    """(freq_x, freq_y, freq_r, is_cos) over the pe_dim channels, on `device`, built once."""
    fx = _pe_freqs(pe_dim // 4, theta_xy)[::2]
    fr = _pe_freqs_rad(pe_dim // 2)[::2]
    zx, zr = np.zeros_like(fx), np.zeros_like(fr)
    ox, or_ = np.ones_like(fx), np.ones_like(fr)
    tables = (
        np.concatenate([fx, fx, zx, zx, zr, zr]),
        np.concatenate([zx, zx, fx, fx, zr, zr]),
        np.concatenate([zx, zx, zx, zx, fr, fr]),
    )
    is_cos = np.concatenate([ox, zx, ox, zx, or_, zr]).astype(bool)
    return (*(torch.as_tensor(t, dtype=dtype, device=device) for t in tables),
            torch.as_tensor(is_cos, device=device))


def _pe_xy_yaw_packed(xy: Tensor, yaw: Tensor, pe_dim: int, theta_xy: float) -> Tensor:
    """pe_xy_yaw as one elementwise expression over [..., pe_dim].

    Channel c has arg = x*FX[c] + y*FY[c] + yaw*FR[c] with exactly one table
    nonzero per channel and out = cos or sin by IS_COS[c]: the same products
    as concat(PE(x), PE(y), PE_rad(yaw)), with the same per-channel tables
    as the JAX package so the arguments agree bit for bit.
    """
    freq_x, freq_y, freq_r, is_cos = _pe_xy_yaw_tables(pe_dim, float(theta_xy), xy.dtype, xy.device)
    arg = xy[..., 0:1] * freq_x + xy[..., 1:2] * freq_y + yaw[..., None].to(xy.dtype) * freq_r
    return torch.where(is_cos, torch.cos(arg), torch.sin(arg))
