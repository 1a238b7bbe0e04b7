"""Frequency positional encoding and the Triplane+CP encoding (plain torch).

Port of ``mipsfusion_tpu/ops/encoding.py:136-285``. The reference builds
bilinear interpolation as 2-sparse one-hot matrices (a TPU matmul); here
a lookup is a 4-tap gather (2 taps on a CP line) with the same weights,
which is the same function. This is the composite CPU path and the oracle
the CUDA kernels are held against.

Coordinates are clamped to [0, R-1-1e-6] in float32 exactly as the
reference's ``_coords``: for R=64 and R=384 the bound rounds to R-1, so
the upper tap of a point at the bound would read row R. It carries weight
0 there, and ``taps`` clamps its index to R-1 so the read stays in range.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

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
    resolutions: Tuple[int, ...] = (32, 64)
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
