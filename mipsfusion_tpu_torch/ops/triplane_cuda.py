"""K3 (plane/CP-line gradients) and K4 (coordinate gradients).

Port of ``mipsfusion_tpu/ops/triplane_pallas.py``: ``plane_backward``
replaces ``_fused_backward_plane`` and ``x_backward`` replaces
``_fused_backward_x``. Each wrapper serves a CPU tensor with its plain
PyTorch version and a CUDA tensor with the kernel in
``csrc/triplane.cu`` (or raises); ``<wrapper>.launches`` counts kernel
launches.

Point-indexed arrays are points-minor: x [3, N], d_embed [E, N].
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _build
from .encoding import PLANE_AXES, line_lookup, taps


def _plane_list(planes: Dict[str, torch.Tensor], n_scales: int):
    return [planes[f"s{s}"] for s in range(n_scales)]


# ----------------------------------------------------------------- K3 ----

def plane_backward_plain(xT: torch.Tensor, d_embed: torch.Tensor,
                         planes: Dict[str, torch.Tensor],
                         n_scales: int) -> Dict[str, torch.Tensor]:
    """Gradients of sum(d_embed * encode(x)) w.r.t. the planes and CP
    lines, as index_add_ scatters of the interpolation weights. The upper
    tap of a point at the clamp bound has weight 0 and a clamped index, so
    it adds nothing."""
    x = xT.T
    out = {}
    F = planes["s0"].shape[-1]
    for s, P in enumerate(_plane_list(planes, n_scales)):
        R = P.shape[1]
        g = d_embed[s * F:(s + 1) * F].T                        # [N, F]
        dP = torch.zeros_like(P)
        flat = dP.view(3 * R * R, F)
        for p, (a, b) in enumerate(PLANE_AXES):
            u0, u1, wu, _ = taps(x[:, a], R)
            v0, v1, wv, _ = taps(x[:, b], R)
            for iu, wgu in ((u0, 1 - wu), (u1, wu)):
                for iv, wgv in ((v0, 1 - wv), (v1, wv)):
                    flat.index_add_(0, (p * R + iu) * R + iv,
                                    (wgu * wgv)[:, None] * g)
        out[f"s{s}"] = dP
    cp = planes.get("cp")
    if cp is not None:
        R = cp.shape[1]
        gc = d_embed[n_scales * F:].T                           # [N, C]
        f = [line_lookup(cp[a], x[:, a]) for a in range(3)]
        others = (f[1] * f[2], f[0] * f[2], f[0] * f[1])
        dcp = torch.zeros_like(cp)
        for a in range(3):
            i0, i1, w, _ = taps(x[:, a], R)
            da = gc * others[a]
            dcp[a].index_add_(0, i0, (1 - w)[:, None] * da)
            dcp[a].index_add_(0, i1, w[:, None] * da)
        out["cp"] = dcp
    return out


def plane_backward(xT: torch.Tensor, d_embed: torch.Tensor,
                   planes: Dict[str, torch.Tensor],
                   n_scales: int) -> Dict[str, torch.Tensor]:
    if xT.device.type == "cpu":
        return plane_backward_plain(xT, d_embed, planes, n_scales)
    if n_scales != 2 or "cp" not in planes:
        raise ValueError("plane_backward kernel: flagship field only "
                         "(2 scales + CP)")
    N = xT.shape[1]
    cp = planes["cp"]
    args = [_build.ptr(xT, "x", (3, N)),
            _build.ptr(d_embed, "d_embed", (_build.EMBED_DIM, N)),
            _build.ptr(cp, "cp", _build.CP_SHAPE)]
    d_s0 = torch.zeros(_build.PLANE_SHAPES[0], device=xT.device)
    d_s1 = torch.zeros(_build.PLANE_SHAPES[1], device=xT.device)
    d_cp = torch.zeros(_build.CP_SHAPE, device=xT.device)
    err = _build.lib().mf_plane_backward(
        args[0], args[1], args[2], N, d_s0.data_ptr(), d_s1.data_ptr(),
        d_cp.data_ptr(), _build.stream())
    _build.check(err, "plane_backward")
    plane_backward.launches += 1
    return {"s0": d_s0, "s1": d_s1, "cp": d_cp}


plane_backward.launches = 0


# ----------------------------------------------------------------- K4 ----

def x_backward_plain(xT: torch.Tensor, d_embed: torch.Tensor,
                     planes: Dict[str, torch.Tensor],
                     n_scales: int) -> torch.Tensor:
    """d_x [3, N] through the plane and CP interpolation: the derivative
    taps (row i0+1 minus row i0) times (R-1), at the clamped coordinate.
    Where row i0+1 does not exist (upper clamp) it reads as 0, so the
    derivative is -P[R-1]; outside [0, 1] the tent derivative of the
    clamped coordinate stands (reference ``_make_bwd_x_kernel``)."""
    x = xT.T
    N = x.shape[0]
    dx = torch.zeros((N, 3), dtype=x.dtype, device=x.device)
    F = planes["s0"].shape[-1]
    for s, P in enumerate(_plane_list(planes, n_scales)):
        R = P.shape[1]
        g = d_embed[s * F:(s + 1) * F].T                        # [N, F]
        for p, (a, b) in enumerate(PLANE_AXES):
            u0, u1, wu, hu = taps(x[:, a], R)
            v0, v1, wv, hv = taps(x[:, b], R)
            Pp = P[p]
            hu_, hv_ = hu[:, None].to(x.dtype), hv[:, None].to(x.dtype)
            p00, p01 = Pp[u0, v0], Pp[u0, v1]
            p10, p11 = Pp[u1, v0], Pp[u1, v1]
            gu0 = p10 * hu_ - p00                    # d/du at column v0
            gu1 = p11 * hu_ - p01                    # d/du at column v1
            gv0 = p01 * hv_ - p00                    # d/dv at row u0
            gv1 = p11 * hv_ - p10                    # d/dv at row u1
            du = ((1 - wv) * (g * gu0).sum(-1) + wv * (g * gu1).sum(-1)) \
                * (R - 1)
            dv = ((1 - wu) * (g * gv0).sum(-1) + wu * (g * gv1).sum(-1)) \
                * (R - 1)
            dx[:, a] += du
            dx[:, b] += dv
    cp = planes.get("cp")
    if cp is not None:
        R = cp.shape[1]
        gc = d_embed[n_scales * F:].T
        t = [taps(x[:, a], R) for a in range(3)]
        f, df = [], []
        for a in range(3):
            i0, i1, w, has_next = t[a]
            lo, hi = cp[a][i0], cp[a][i1]
            f.append((1 - w)[:, None] * lo + w[:, None] * hi)
            df.append(hi * has_next[:, None].to(x.dtype) - lo)
        others = (f[1] * f[2], f[0] * f[2], f[0] * f[1])
        for a in range(3):
            dx[:, a] += (gc * df[a] * others[a]).sum(-1) * (R - 1)
    return dx.T.contiguous()


def x_backward(xT: torch.Tensor, d_embed: torch.Tensor,
               planes: Dict[str, torch.Tensor],
               n_scales: int) -> torch.Tensor:
    if xT.device.type == "cpu":
        return x_backward_plain(xT, d_embed, planes, n_scales)
    if n_scales != 2 or "cp" not in planes:
        raise ValueError("x_backward kernel: flagship field only "
                         "(2 scales + CP)")
    N = xT.shape[1]
    args = [_build.ptr(xT, "x", (3, N)),
            _build.ptr(d_embed, "d_embed", (_build.EMBED_DIM, N)),
            _build.ptr(planes["s0"], "s0", _build.PLANE_SHAPES[0]),
            _build.ptr(planes["s1"], "s1", _build.PLANE_SHAPES[1]),
            _build.ptr(planes["cp"], "cp", _build.CP_SHAPE)]
    d_x = torch.empty((3, N), device=xT.device)
    err = _build.lib().mf_x_backward(*args, N, d_x.data_ptr(),
                                     _build.stream())
    _build.check(err, "x_backward")
    x_backward.launches += 1
    return d_x


x_backward.launches = 0

