"""The multiresolution hash encoding of the plain reference, MIPS-Fusion's
own field (Müller et al., "Instant Neural Graphics Primitives with a
Multiresolution Hash Encoding", SIGGRAPH 2022, arXiv 2201.05989, §3),
written from that definition in float32 plain PyTorch.

Widths as the port reads them (its ``FieldConfig.from_dict``, after the
JAX package's): 16 levels of 2 features from resolution 16 to 256, a
table of T = 2^``grid.hash_size`` rows a level (``hash_size`` missing:
19). Per level l, with b = 2^(log2(256 / 16) / 15):

- scale_l = 16 b^l - 1 and res_l = ceil(scale_l) + 1 (tiny-cuda-nn's
  grid, which MIPS-Fusion runs);
- pos = x scale_l + 0.5; the 8 corners floor(pos) + {0, 1}^3, weighted
  trilinearly by pos - floor(pos);
- a corner's row: where res_l^3 <= T, the dense index x + y res_l +
  z res_l^2 of the corner clamped to the grid; above, the spatial hash
  (x 1 xor y 2654435761 xor z 805459861) in uint32 arithmetic, modulo T
  (a corner outside the grid keeps its two's-complement bits).

The output is level-major, ``[N, 16 x 2]``. Parameters: ``{"hash":
[16, T, 2]}``; the embed group is the table.

The gradients are autograd's. floor has no derivative, so the gradient
to x flows through the trilinear weights at scale_l; the table's is the
gathers' backward, float32 adds whose order on the card is free (the
port sums it in fixed point: the two agree to float32 rounding).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Tuple

import torch

LEVELS = 16
FEATURES = 2
BASE_RES = 16
FINEST_RES = 256
PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def spec(cfg: Dict) -> int:
    """log2 of the rows a level."""
    return int(cfg["grid"].get("hash_size", 19))


def embed_leaves(params: Dict) -> List[Tuple[str, torch.Tensor]]:
    return [("hash", params["hash"])]


def level_scale(level: int) -> float:
    b = 2.0 ** (math.log2(FINEST_RES / BASE_RES) / (LEVELS - 1))
    return BASE_RES * b ** level - 1.0


def _mul_u32(a, p: int):
    """(a p) mod 2^32 for a in [0, 2^32) (int64), in two 16-bit halves of
    p so that no product leaves int64."""
    lo = a * (p & 0xFFFF)
    hi = (a * (p >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _rows(corner, res: int, T: int):
    """Table rows of integer corners [N, 3] on a level of resolution
    res."""
    if res ** 3 <= T:
        c = torch.clamp(corner, 0, res - 1)
        return c[:, 0] + c[:, 1] * res + c[:, 2] * (res * res)
    u = corner & _U32
    h = (_mul_u32(u[:, 0], PRIMES[0]) ^ _mul_u32(u[:, 1], PRIMES[1])
         ^ _mul_u32(u[:, 2], PRIMES[2]))
    return torch.remainder(h, T)


def encode(params: Dict, x, log2_rows: int):
    """x [N, 3] -> [N, 16 x 2]."""
    table = params["hash"]
    T = 1 << log2_rows
    if tuple(table.shape) != (LEVELS, T, FEATURES):
        raise ValueError(f"hash table {tuple(table.shape)}: the encoding "
                         f"is ({LEVELS}, {T}, {FEATURES})")
    feats = []
    for level in range(LEVELS):
        scale = level_scale(level)
        res = math.ceil(scale) + 1
        pos = x * torch.tensor(scale, dtype=torch.float32,
                               device=x.device) + 0.5
        lower = torch.floor(pos)
        w_up = pos - lower
        lower = lower.detach().long()
        out = 0.0
        for bits in itertools.product((0, 1), repeat=3):
            w = None
            for axis, bit in enumerate(bits):
                wa = w_up[:, axis] if bit else 1.0 - w_up[:, axis]
                w = wa if w is None else w * wa
            corner = lower + torch.tensor(bits, device=x.device)
            out = out + w[:, None] * table[level][_rows(corner, res, T)]
        feats.append(out)
    return torch.cat(feats, dim=-1)
