"""K0 (the encoding alone), K3 (plane/CP-line gradients) and K4
(coordinate gradients), and the encode op ``TriplaneEncode``.

Port of ``mipsfusion_tpu/ops/triplane_pallas.py``: ``encode_forward``
replaces ``_fused_forward``, ``plane_backward`` replaces
``_fused_backward_plane``, ``x_backward`` replaces ``_fused_backward_x``
and ``TriplaneEncode`` / ``triplane_encode`` the custom VJP of
``triplane_encode_pallas``. Each wrapper serves a CPU tensor with its
plain PyTorch version and a CUDA tensor with the kernel in
``csrc/triplane.cu`` (or raises); ``<wrapper>.launches`` counts kernel
launches.

The encode op takes and returns the reference's row layout (x [N, 3] ->
[N, E]); K3 and K4 take points-minor arrays: x [3, N], d_embed [E, N].
Like its JAX counterpart, the encode op has no caller on the SLAM path,
where K1's ``return_embed`` output carries the encoding.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _build
from .encoding import PLANE_AXES, line_lookup, taps
from .encoding import triplane_encode as encode_forward_plain


def _plane_list(planes: Dict[str, torch.Tensor], n_scales: int):
    return [planes[f"s{s}"] for s in range(n_scales)]


# ----------------------------------------------------------------- K0 ----

def encode_forward(x: torch.Tensor, planes: Dict[str, torch.Tensor],
                   n_scales: int) -> torch.Tensor:
    """Encode points x [N, 3] -> [N, E]: the plain composite
    (``encoding.triplane_encode``) for a CPU tensor, K0 for a CUDA one."""
    if x.device.type == "cpu":
        return encode_forward_plain(planes, x, n_scales)
    if n_scales != 2 or "cp" not in planes:
        raise ValueError("encode_forward kernel: flagship field only "
                         "(2 scales + CP)")
    N = x.shape[0]
    args = [_build.ptr(x, "x", (N, 3)),
            _build.ptr(planes["s0"], "s0", _build.PLANE_SHAPES[0]),
            _build.ptr(planes["s1"], "s1", _build.PLANE_SHAPES[1]),
            _build.ptr(planes["cp"], "cp", _build.CP_SHAPE)]
    out = torch.empty((N, _build.EMBED_DIM), device=x.device)
    err = _build.lib().mf_encode_forward(*args, N, out.data_ptr(),
                                         _build.stream())
    _build.check(err, "encode_forward")
    encode_forward.launches += 1
    return out


encode_forward.launches = 0


class TriplaneEncode(torch.autograd.Function):
    """[N, E] = encode(planes, x [N, 3]): K0 forward; the backward is K3
    for the plane and CP gradients, then K4 for d_x, each only when
    ``ctx.needs_input_grad`` asks for it. Inputs after ``n_scales`` are
    the plane tensors (s0.., cp)."""

    @staticmethod
    def forward(ctx, x, n_scales, *tensors):
        planes = planes_from_tensors(tensors, n_scales)
        ctx.n_scales = n_scales
        ctx.save_for_backward(x, *tensors)
        return encode_forward(x, planes, n_scales)

    @staticmethod
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        planes = planes_from_tensors(tensors, ctx.n_scales)
        need = ctx.needs_input_grad
        xT = x.T.contiguous()
        gT = g.T.contiguous()
        plane_grads = [None] * len(tensors)
        if any(need[2:]):
            dp = plane_backward(xT, gT, planes, ctx.n_scales)
            plane_grads = [dp[k] for k in plane_keys(planes)]
        d_x = (x_backward(xT, gT, planes, ctx.n_scales).T
               if need[0] else None)
        return (d_x, None, *plane_grads)


def plane_keys(planes):
    """The plane keys in the order an autograd Function takes them:
    s0.., then cp."""
    n = sum(1 for k in planes if k.startswith("s"))
    return [f"s{s}" for s in range(n)] + (["cp"] if "cp" in planes else [])


def planes_from_tensors(tensors, n_scales: int) -> Dict[str, torch.Tensor]:
    """The inverse of ``plane_keys``: tensors in that order -> planes."""
    planes = {f"s{s}": tensors[s] for s in range(n_scales)}
    if len(tensors) > n_scales:
        planes["cp"] = tensors[n_scales]
    return planes


def triplane_encode(planes: Dict[str, torch.Tensor], x: torch.Tensor,
                    n_scales: int) -> torch.Tensor:
    """Differentiable encode of x [N, 3] -> [N, E] through K0, K3 and K4
    (the counterpart of ``triplane_encode_pallas``)."""
    return TriplaneEncode.apply(x.contiguous(), n_scales,
                                *[planes[k] for k in plane_keys(planes)])


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
    lib = _build.lib()
    dev = xT.device
    d_s0 = torch.empty(_build.PLANE_SHAPES[0], device=dev)
    d_s1 = torch.empty(_build.PLANE_SHAPES[1], device=dev)
    d_cp = torch.empty(_build.CP_SHAPE, device=dev)
    # the fixed-point accumulators and the magnitude maxima (csrc: K3)
    acc = torch.zeros((lib.mf_plane_backward_acc_size(),), dtype=torch.int64,
                      device=dev)
    mx = torch.zeros((3,), dtype=torch.int32, device=dev)
    err = lib.mf_plane_backward(
        args[0], args[1], args[2], N, d_s0.data_ptr(), d_s1.data_ptr(),
        d_cp.data_ptr(), acc.data_ptr(), mx.data_ptr(), _build.stream())
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

