"""K0 (the encoding alone), K3 (plane/CP-line gradients) and K4
(coordinate gradients), and the encode op ``TriplaneEncode``.

Port of ``mipsfusion_tpu/ops/triplane_pallas.py``: ``encode_forward``
replaces ``_fused_forward``, ``plane_backward`` replaces
``_fused_backward_plane``, ``x_backward`` replaces ``_fused_backward_x``
and ``TriplaneEncode`` / ``triplane_encode`` the custom VJP of
``triplane_encode_pallas``. Each wrapper serves a CPU tensor with its
plain PyTorch version and a CUDA tensor with the kernel in
``csrc/triplane.cuh`` at the field's shape (one of ``_build.SHAPES``;
any other shape raises); ``<wrapper>.launches`` counts kernel launches
(``launches_by_device`` per device; a CUDA graph's replays included,
through ``field_cuda.add_launch_counts``, which covers these wrappers
too). A launch goes to the tensors' device, on that device's current
stream.

The encode op takes and returns the reference's row layout (x [N, 3] ->
[N, E]); K3 and K4 take points-minor arrays: x [3, N], d_embed [E, N].
Like its JAX counterpart, the encode op has no caller on the SLAM path,
where K1's ``return_embed`` output carries the encoding.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from .encoding import PLANE_AXES, line_lookup, taps
from .encoding import triplane_encode as encode_forward_plain


def _plane_list(planes: Dict[str, torch.Tensor], n_scales: int):
    return [planes[f"s{s}"] for s in range(n_scales)]


def plane_ptrs(planes: Dict[str, torch.Tensor], shape) -> list:
    """The kernels' plane arguments at a table shape: s0, s1, s2 (None with
    2 scales), cp, each checked against the shape."""
    ptrs = [_build.ptr(planes[f"s{s}"], f"s{s}", shp)
            for s, shp in enumerate(shape.plane_shapes)]
    return (ptrs + [None] * (3 - len(ptrs))
            + [_build.ptr(planes["cp"], "cp", shape.cp_shape)])


# ----------------------------------------------------------------- K0 ----

def encode_forward(x: torch.Tensor, planes: Dict[str, torch.Tensor],
                   n_scales: int) -> torch.Tensor:
    """Encode points x [N, 3] -> [N, E]: the plain composite
    (``encoding.triplane_encode``) for a CPU tensor, K0 for a CUDA one."""
    if x.device.type == "cpu":
        return encode_forward_plain(planes, x, n_scales)
    shape = _build.kernel_shape(planes, n_scales)
    N = x.shape[0]
    args = [_build.ptr(x, "x", (N, 3))] + plane_ptrs(planes, shape)
    out = torch.empty((N, shape.embed_dim), device=x.device)
    plan = _build.encode_args(shape, x.device)
    with torch.cuda.device(x.device):
        err = shape.fn("encode_forward")(*args, N, out.data_ptr(), *plan,
                                         _build.stream(x.device))
    _build.check(err, "encode_forward")
    _build.count_launch(encode_forward, x.device)
    return out


encode_forward.launches = 0
encode_forward.launches_by_device = {}


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
    shape = _build.kernel_shape(planes, n_scales)
    N = xT.shape[1]
    args = [_build.ptr(xT, "x", (3, N)),
            _build.ptr(d_embed, "d_embed", (shape.embed_dim, N)),
            plane_ptrs(planes, shape)[3]]    # cp; every table is checked
    dev = xT.device
    out = {f"s{s}": torch.empty(shp, device=dev)
           for s, shp in enumerate(shape.plane_shapes)}
    out["cp"] = torch.empty(shape.cp_shape, device=dev)
    d_planes = [out[f"s{s}"].data_ptr() for s in range(shape.n_scales)]
    d_planes += [None] * (3 - len(d_planes))
    # the fixed-point accumulators and the magnitude maxima (csrc: K3)
    acc = torch.zeros((shape.size("plane_backward_acc_size"),),
                      dtype=torch.int64, device=dev)
    mx = torch.zeros((3,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = shape.fn("plane_backward")(
            *args, N, *d_planes, out["cp"].data_ptr(), acc.data_ptr(),
            mx.data_ptr(), _build.stream(dev))
    _build.check(err, "plane_backward")
    _build.count_launch(plane_backward, dev)
    return out


plane_backward.launches = 0
plane_backward.launches_by_device = {}


# ----------------------------------------------------------------- K4 ----

def x_backward_plain(xT: torch.Tensor, d_embed: torch.Tensor,
                     planes: Dict[str, torch.Tensor], n_scales: int,
                     d_x_pe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d_x [3, N] through the plane and CP interpolation: the derivative
    taps (row i0+1 minus row i0) times (R-1), at the clamped coordinate.
    Where row i0+1 does not exist (upper clamp) it reads as 0, so the
    derivative is -P[R-1]; outside [0, 1] the tent derivative of the
    clamped coordinate stands (reference ``_make_bwd_x_kernel``).
    ``d_x_pe`` [3, N], if given, is added (the PE's share of d_x)."""
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
    dxT = dx.T.contiguous()
    return dxT if d_x_pe is None else d_x_pe + dxT


def x_backward(xT: torch.Tensor, d_embed: torch.Tensor,
               planes: Dict[str, torch.Tensor], n_scales: int,
               d_x_pe: Optional[torch.Tensor] = None) -> torch.Tensor:
    if xT.device.type == "cpu":
        return x_backward_plain(xT, d_embed, planes, n_scales, d_x_pe)
    shape = _build.kernel_shape(planes, n_scales)
    N = xT.shape[1]
    args = ([_build.ptr(xT, "x", (3, N)),
             _build.ptr(d_embed, "d_embed", (shape.embed_dim, N))]
            + plane_ptrs(planes, shape))
    add = None if d_x_pe is None else _build.ptr(d_x_pe, "d_x_pe", (3, N))
    d_x = torch.empty((3, N), device=xT.device)
    with torch.cuda.device(xT.device):
        err = shape.fn("x_backward")(*args, N, add, d_x.data_ptr(),
                                     _build.stream(xT.device))
    _build.check(err, "x_backward")
    _build.count_launch(x_backward, xT.device)
    return d_x


x_backward.launches = 0
x_backward.launches_by_device = {}

