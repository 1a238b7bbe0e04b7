"""The Triplane + CP encoding of the plain reference (the flagship field):
per scale the sum of bilinear taps on the three axis-pair planes, then
the product of three linear CP line taps. Its gradient to the points is
the field's as the JAX package states it: the tent derivative at the
clamped coordinate, also outside the unit cube (the JAX kernel's rule,
where plain autograd through the clamp would give 0).

Widths: ``grid.tri_resolutions`` (one plane stack a scale), with the
feature and CP widths read from the tables themselves. Parameters:
``{"planes": {"s0", "s1", ..., "cp"}}``; the embed group is the planes in
that order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def spec(cfg: Dict) -> int:
    """The number of plane scales."""
    return len(cfg["grid"]["tri_resolutions"])


def embed_leaves(params: Dict) -> List[Tuple[str, torch.Tensor]]:
    return list(params["planes"].items())


def encode(params: Dict, x, n_scales: int):
    return triplane_encode(params["planes"], x, n_scales)


def _taps(u, R: int):
    """(i0, i1, w, has_next) of linear interpolation on R rows at the
    clamped coordinate; ``has_next`` is False where row i0 + 1 does not
    exist (the upper clamp, where w is 0)."""
    p = torch.clamp(u * (R - 1), 0.0, R - 1 - 1e-6)
    f = torch.floor(p)
    i0 = f.long()
    return i0, torch.clamp(i0 + 1, max=R - 1), p - f, i0 + 1 <= R - 1


def _plane(plane, u, v):
    R = plane.shape[0]
    u0, u1, wu, _ = _taps(u, R)
    v0, v1, wv, _ = _taps(v, R)
    wu, wv = wu[:, None], wv[:, None]
    return ((1 - wu) * ((1 - wv) * plane[u0, v0] + wv * plane[u0, v1])
            + wu * ((1 - wv) * plane[u1, v0] + wv * plane[u1, v1]))


def _line(line, u):
    i0, i1, w, _ = _taps(u, line.shape[0])
    w = w[:, None]
    return (1 - w) * line[i0] + w * line[i1]


PLANE_AXES = ((0, 1), (0, 2), (1, 2))


def _encode(planes: Dict, x, n_scales: int):
    feats = []
    for s in range(n_scales):
        P = planes[f"s{s}"]
        feats.append(sum(_plane(P[p], x[:, a], x[:, b])
                         for p, (a, b) in enumerate(PLANE_AXES)))
    cp = planes.get("cp")
    if cp is not None:
        feats.append(_line(cp[0], x[:, 0]) * _line(cp[1], x[:, 1])
                     * _line(cp[2], x[:, 2]))
    return torch.cat(feats, dim=-1)


def _encode_dx(planes: Dict, x, n_scales: int):
    """d embed / d x [N, E, 3] as the field states it: the tent
    derivative (row i0 + 1 minus row i0, times R - 1) at the clamped
    coordinate, also outside [0, 1], a missing row i0 + 1 reading 0."""
    N = x.shape[0]
    blocks = []
    for s in range(n_scales):
        P = planes[f"s{s}"]
        R, F = P.shape[1], P.shape[-1]
        J = torch.zeros((N, F, 3), dtype=x.dtype, device=x.device)
        for p, (a, b) in enumerate(PLANE_AXES):
            u0, u1, wu, hu = _taps(x[:, a], R)
            v0, v1, wv, hv = _taps(x[:, b], R)
            Pp = P[p]
            hu, hv = hu[:, None].to(x.dtype), hv[:, None].to(x.dtype)
            wu, wv = wu[:, None], wv[:, None]
            p00, p01, p10, p11 = Pp[u0, v0], Pp[u0, v1], Pp[u1, v0], Pp[u1, v1]
            J[:, :, a] += ((1 - wv) * (p10 * hu - p00)
                           + wv * (p11 * hu - p01)) * (R - 1)
            J[:, :, b] += ((1 - wu) * (p01 * hv - p00)
                           + wu * (p11 * hv - p10)) * (R - 1)
        blocks.append(J)
    cp = planes.get("cp")
    if cp is not None:
        R = cp.shape[1]
        f, df = [], []
        for a in range(3):
            i0, i1, w, has = _taps(x[:, a], R)
            lo, hi = cp[a][i0], cp[a][i1]
            f.append((1 - w)[:, None] * lo + w[:, None] * hi)
            df.append((hi * has[:, None].to(x.dtype) - lo) * (R - 1))
        blocks.append(torch.stack([df[0] * f[1] * f[2], f[0] * df[1] * f[2],
                                   f[0] * f[1] * df[2]], dim=-1))
    return torch.cat(blocks, dim=1)


def triplane_encode(planes: Dict, x, n_scales: int):
    """x [N, 3] in [0, 1]^3 -> [N, S F + C]: per scale the sum of the three
    plane lookups, then the product of the three CP line lookups. The
    gradient to x is ``_encode_dx``'s (the gradient to the planes the
    interpolation weights')."""
    xd = x.detach()
    emb = _encode(planes, xd, n_scales)
    if x.requires_grad:
        with torch.no_grad():
            J = _encode_dx({k: v.detach() for k, v in planes.items()}, xd,
                           n_scales)
        emb = emb + ((x - xd)[:, None, :] * J).sum(-1)
    return emb
