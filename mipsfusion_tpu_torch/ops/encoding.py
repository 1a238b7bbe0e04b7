"""Frequency positional encoding, the Triplane+CP encoding and the
multiresolution hash grid (plain torch).

Port of ``mipsfusion_tpu/ops/encoding.py``. The reference builds
bilinear interpolation as 2-sparse one-hot matrices (a TPU matmul); here
a lookup is a 4-tap gather (2 taps on a CP line) with the same weights,
which is the same function. This is the composite CPU path and the oracle
the CUDA kernels are held against.

Coordinates are clamped to [0, R-1-1e-6] in float32 exactly as the
reference's ``_coords``: for R=64 and R=384 the bound rounds to R-1, so
the upper tap of a point at the bound would read row R. It carries weight
0 there, and ``taps`` clamps its index to R-1 so the read stays in range.

The hash grid (``hash_encode``, the reference paper's own field) has no
Pallas kernel in the JAX package and none here: it is plain torch on
every device. Its table gradient is summed in int64 fixed point, so a
call gives the same bits every time on the card (see ``HashEncode``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FrequencyConfig:
    n_frequencies: int = 8
    input_dim: int = 3

    @property
    def out_dim(self) -> int:
        return self.input_dim * self.n_frequencies * 2


@dataclasses.dataclass(frozen=True)
class TriplaneConfig:
    resolutions: Tuple[int, ...] = (32, 64, 128, 256)
    n_features: int = 4
    cp_resolution: int = 0       # 0 disables the CP term
    cp_components: int = 32

    @property
    def out_dim(self) -> int:
        base = len(self.resolutions) * self.n_features
        return base + (self.cp_components if self.cp_resolution else 0)


def frequency_encode(x: torch.Tensor, n_freq: int) -> torch.Tensor:
    """[..., D] -> [..., D * n_freq * 2] in the tcnn interleaved layout:
    index d*2J + 2j holds sin(2^j pi x_d), the next index the cosine."""
    freqs = (2.0 ** torch.arange(n_freq, dtype=x.dtype, device=x.device)
             ) * math.pi
    ang = x[..., :, None] * freqs                          # [..., D, J]
    enc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return enc.reshape(x.shape[:-1] + (x.shape[-1] * n_freq * 2,))


def init_triplane(cfg: TriplaneConfig, generator: torch.Generator,
                  device=None) -> Dict[str, torch.Tensor]:
    """Planes {"s<i>": [3, R, R, F]} at U(-1e-4, 1e-4) (+ "cp":
    [3, Rcp, C] at 0.05 N(0, 1)), the reference's init scales."""
    out = {}
    for i, R in enumerate(cfg.resolutions):
        u = torch.rand((3, R, R, cfg.n_features), generator=generator,
                       device=device)
        out[f"s{i}"] = (u * 2.0 - 1.0) * 1e-4
    if cfg.cp_resolution:
        out["cp"] = 0.05 * torch.randn(
            (3, cfg.cp_resolution, cfg.cp_components), generator=generator,
            device=device)
    return out


def grid_coord(u: torch.Tensor, R: int) -> torch.Tensor:
    """Continuous clamped grid coordinate (reference ``_coords``)."""
    return torch.clamp(u * (R - 1), 0.0, R - 1 - 1e-6)


def taps(u: torch.Tensor, R: int):
    """(i0, i1, w, has_next) of linear interpolation on an R-row axis:
    weight 1-w at row i0, w at row i1 = min(i0+1, R-1). ``has_next`` is
    False where row i0+1 does not exist (there w == 0)."""
    p = grid_coord(u, R)
    f = torch.floor(p)
    w = p - f
    i0 = f.long()
    has_next = i0 + 1 <= R - 1
    i1 = torch.clamp(i0 + 1, max=R - 1)
    return i0, i1, w, has_next


# plane p samples (u, v) = (x, y), (x, z), (y, z)
PLANE_AXES = ((0, 1), (0, 2), (1, 2))


def plane_lookup(plane: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup on one plane [R, R, F] at N (u, v) -> [N, F]."""
    R = plane.shape[0]
    u0, u1, wu, _ = taps(u, R)
    v0, v1, wv, _ = taps(v, R)
    wu, wv = wu[:, None], wv[:, None]
    return ((1 - wu) * ((1 - wv) * plane[u0, v0] + wv * plane[u0, v1])
            + wu * ((1 - wv) * plane[u1, v0] + wv * plane[u1, v1]))


def line_lookup(line: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Linear lookup on a factor line [R, C] at N coords -> [N, C]."""
    i0, i1, w, _ = taps(u, line.shape[0])
    w = w[:, None]
    return (1 - w) * line[i0] + w * line[i1]


def triplane_encode(planes: Dict[str, torch.Tensor], x: torch.Tensor,
                    n_scales: int) -> torch.Tensor:
    """Encode points x [N, 3] -> [N, S*F (+ C)]: per scale the sum of the
    three plane lookups, then the product of the three CP line lookups."""
    feats = []
    for s in range(n_scales):
        P = planes[f"s{s}"]
        feats.append(sum(plane_lookup(P[p], x[:, a], x[:, b])
                         for p, (a, b) in enumerate(PLANE_AXES)))
    cp = planes.get("cp")
    if cp is not None:
        feats.append(line_lookup(cp[0], x[:, 0]) * line_lookup(cp[1], x[:, 1])
                     * line_lookup(cp[2], x[:, 2]))
    return torch.cat(feats, dim=-1)


# ---------------------------------------------------------------------------
# Multiresolution hash grid (ops/encoding.py:34-133 of the JAX package)
# ---------------------------------------------------------------------------

# XOR-prime spatial hash constants (Teschner et al., as in instant-ngp)
_PRIMES = (1, 2654435761, 805459861)
# points per pass: bounds the [n, L, 8] corner tables (RO queries 768,000
# points at once)
HASH_CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    desired_resolution: int = 256

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def per_level_scale(self) -> float:
        return float(np.exp2(np.log2(self.desired_resolution
                                     / self.base_resolution)
                             / (self.n_levels - 1)))

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_scales(self) -> np.ndarray:
        lv = np.arange(self.n_levels)
        return (self.base_resolution
                * np.exp2(lv * np.log2(self.per_level_scale)) - 1.0)

    def level_resolutions(self) -> np.ndarray:
        return np.ceil(self.level_scales()).astype(np.int64) + 1

    @property
    def n_dense(self) -> int:
        """Levels whose dense grid fits the table (res^3 <= T): a prefix,
        since the resolutions grow."""
        return int((self.level_resolutions() ** 3 <= self.table_size).sum())


def init_hash_table(cfg: HashGridConfig, generator: torch.Generator,
                    device=None) -> torch.Tensor:
    """The table [L, T, F] at U(-1e-4, 1e-4), tcnn's hash-grid default."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features),
                   generator=generator, device=device)
    return (u * 2.0 - 1.0) * 1e-4


def _corners(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, op,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-axis terms [2, L, n] (lower and upper corner along x, y, z) ->
    [8, L, n] over the corners in the JAX package's order: corner
    4 i + 2 j + k is (x_i, y_j, z_k), written into ``out`` if given.
    Corner-major, so every broadcast runs along the long point axis."""
    shape = (8,) + a.shape[1:]
    ab = op(a[:, None, None], b[None, :, None])
    if out is None:
        return op(ab, c[None, None, :]).reshape(shape)
    op(ab, c[None, None, :], out=out.view((2, 2, 2) + a.shape[1:]))
    return out


_level_cache = {}


def _level_tables(cfg: HashGridConfig, dtype, device):
    """The level scales [L] and resolutions [L, 1] on ``device``, copied
    from the host once per config, type and device: a copy from the host
    inside a stage would stop a CUDA graph's capture."""
    key = (cfg, dtype, torch.device(device))
    if key not in _level_cache:
        _level_cache[key] = (
            torch.tensor(cfg.level_scales(), dtype=dtype, device=device),
            torch.tensor(cfg.level_resolutions(), dtype=torch.int64,
                         device=device)[:, None])
    return _level_cache[key]


def _hash_taps(x: torch.Tensor, cfg: HashGridConfig):
    """Corner rows and weights of points x [n, 3]: rows [8, L, n] into the
    table flattened to [L * T, F], per-axis weights [3, 2, L, n] (lower,
    upper corner) and the level scales [L]. Corner coordinates and
    indices are built per axis and combined over the 8 corners only at
    the end."""
    dev = x.device
    L, T = cfg.n_levels, cfg.table_size
    Ld = cfg.n_dense
    scales, res = _level_tables(cfg, x.dtype, dev)               # [L], [L, 1]
    offset = (torch.arange(L, device=dev) * T)[:, None]
    pos = x.T[:, None, :] * scales[None, :, None] + 0.5          # [3, L, n]
    grid0 = torch.floor(pos)
    frac = pos - grid0
    g0 = grid0.to(torch.int64)
    cidx = torch.stack([g0, g0 + 1], 1)                          # [3, 2, L, n]
    rows = torch.empty((8, L, x.shape[0]), dtype=torch.int64, device=dev)
    if Ld:
        # dense levels: x + y res + z res^2 of the clamped corner
        r = res[:Ld]
        cl = torch.minimum(torch.clamp(cidx[:, :, :Ld], min=0), r - 1)
        _corners(cl[0] + offset[:Ld], cl[1] * r, cl[2] * (r * r), torch.add,
                 out=rows[:, :Ld])
    if Ld < L:
        # hashed levels: the spatial hash in uint32 arithmetic, masked to
        # T - 1. The low bits of a product depend only on the operands'
        # low bits, so the product of the masked operands fits int64; a
        # negative corner (a point outside [0, 1]) keeps the two's-
        # complement low bits that astype(uint32) keeps. Each term is
        # below T, so the level's offset (a multiple of T) can ride on the
        # x term through the xor.
        m = T - 1
        low = cidx[:, :, Ld:] & m
        _corners(((low[0] * (_PRIMES[0] & m)) & m) + offset[Ld:],
                 (low[1] * (_PRIMES[1] & m)) & m,
                 (low[2] * (_PRIMES[2] & m)) & m, torch.bitwise_xor,
                 out=rows[:, Ld:])
    wa = torch.stack([1.0 - frac, frac], 1)                      # [3, 2, L, n]
    return rows, wa, scales


def _weights(wa: torch.Tensor) -> torch.Tensor:
    """Trilinear corner weights [8, L, n]: (w_x w_y) w_z."""
    return _corners(wa[0], wa[1], wa[2], torch.mul)


def _hash_forward(table: torch.Tensor, x: torch.Tensor,
                  cfg: HashGridConfig) -> torch.Tensor:
    L, T, F = table.shape
    flat = table.reshape(L * T, F)
    out = []
    for s in range(0, x.shape[0], HASH_CHUNK):
        rows, wa, _ = _hash_taps(x[s:s + HASH_CHUNK], cfg)
        feats = flat[rows]                                       # [8, L, n, F]
        enc = (feats * _weights(wa)[..., None]).sum(0)           # [L, n, F]
        out.append(enc.transpose(0, 1).reshape(-1, L * F))
    return torch.cat(out) if len(out) != 1 else out[0]


def _hash_backward(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                   cfg: HashGridConfig, need_x: bool, need_table: bool):
    """(d_x [N, 3] or None, d_table [L, T, F] or None) for the output
    cotangent g [N, L * F].

    The table gradient adds each corner's share g w (float32, as JAX forms
    it) in int64 fixed point at the scale 2^(61 - e), where 2^e bounds the
    largest column sum of |g| (a corner weight is at most 1 and a point's
    weights sum to 1, so no entry's total can exceed it): integer adds
    commute, so the sum is the same whatever order the device's atomics
    take, exact down to 2^(e - 61), and rounded to float32 once."""
    L, T, F = table.shape
    flat = table.reshape(L * T, F)
    g = g.reshape(-1, L, F)
    d_x, acc, scale = None, None, None
    if need_table:
        acc = torch.zeros((L * T, F), dtype=torch.int64, device=x.device)
        e = torch.frexp(g.abs().sum(0).amax())[1]
        scale = torch.ldexp(torch.ones((), device=x.device),
                            torch.clamp(61 - e, -120, 120).to(torch.float32))
    if need_x:
        d_x = torch.empty_like(x)
    for s in range(0, x.shape[0], HASH_CHUNK):
        xs = x[s:s + HASH_CHUNK]
        gs = g[s:s + HASH_CHUNK].transpose(0, 1)                 # [L, n, F]
        rows, wa, scales = _hash_taps(xs, cfg)
        if need_table:
            share = gs[None] * _weights(wa)[..., None]           # [8, L, n, F]
            fixed = torch.round_(share.mul_(scale)).to(torch.int64)
            acc.index_add_(0, rows.reshape(-1), fixed.reshape(-1, F))
        if need_x:
            # d out / d frac_d = sum over corners of d w_c times the other
            # two axes' weights, signed by the corner's side on axis d
            dw = (flat[rows] * gs[None]).sum(-1)                 # [8, L, n]
            dw = dw.reshape((2, 2, 2) + dw.shape[1:])
            wx, wy, wz = wa[0], wa[1], wa[2]                     # [2, L, n]
            tx = (dw * wy[None, :, None] * wz[None, None, :]).sum((1, 2))
            ty = (dw * wx[:, None, None] * wz[None, None, :]).sum((0, 2))
            tz = (dw * wx[:, None, None] * wy[None, :, None]).sum((0, 1))
            d_frac = torch.stack([t[1] - t[0] for t in (tx, ty, tz)])
            d_x[s:s + HASH_CHUNK] = (d_frac * scales[None, :, None]).sum(1).T
    d_table = None
    if need_table:
        d_table = (acc.to(torch.float64) / scale.to(torch.float64)).to(
            table.dtype).reshape(L, T, F)
    return d_x, d_table


class HashEncode(torch.autograd.Function):
    """out [N, L * F] = hash_encode(table, x). Saves only x and the table;
    the backward recomputes the corners chunk by chunk and gives each
    input its gradient only when it is asked for (GO: x alone)."""

    @staticmethod
    def forward(ctx, x, table, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(x, table)
        return _hash_forward(table, x, cfg)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        d_x, d_table = _hash_backward(table, x, g.contiguous(), ctx.cfg,
                                      ctx.needs_input_grad[0],
                                      ctx.needs_input_grad[1])
        return d_x, d_table, None


def hash_encode(table: torch.Tensor, x: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """Encode points x [N, 3] (nominally in [0, 1]) with the table
    [L, T, F] -> [N, L * F]: per level the trilinear blend of the 8
    corner features, densely indexed on levels whose grid fits the table
    (res^3 <= T), hashed above them. Differentiable in x and the table."""
    return HashEncode.apply(x, table, cfg)
