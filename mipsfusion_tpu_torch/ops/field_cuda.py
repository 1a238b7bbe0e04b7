"""K1 (fused field forward), K2 (decoder backward) and the differentiable
field query ``FieldQueryT``.

Port of ``mipsfusion_tpu/ops/field_pallas.py``: ``field_forward``
replaces ``field_query_pallas``, ``decoder_backward`` replaces
``_decoder_bwd_call`` and ``FieldQueryT`` replaces the custom VJP of
``field_query_diff_T``. Each wrapper serves a CPU tensor with its plain
PyTorch version and a CUDA tensor with the kernel in ``csrc/field.cu``
(or raises); ``<wrapper>.launches`` counts kernel launches.

Field parameters are the JAX tree's layout:
``{"planes": {"s0", "s1", "cp"}, "decoder": {layer: {"w", "b"}}}``.
Point-indexed arrays are points-minor: x [3, N], out [5 + C, N],
embed [E, N].
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.decoder import LAYERS, decoder_apply
from . import _build
from .encoding import frequency_encode, triplane_encode
from .triplane_cuda import (encode_forward, plane_backward, plane_keys,
                            planes_from_tensors, x_backward)

Tree = Dict[str, Dict]


def _dec_flat(dec: Tree):
    return [dec[name][k] for name in LAYERS for k in ("w", "b")]


def _dec_tree(flat) -> Tree:
    return {name: {"w": flat[2 * i], "b": flat[2 * i + 1]}
            for i, name in enumerate(LAYERS)}


def _check_flagship(n_scales: int, n_freq: int, n_class: int):
    if (n_scales, n_freq, n_class) != (2, _build.N_FREQ, _build.N_CLASS):
        raise ValueError(
            f"field kernels take 2 scales, {_build.N_FREQ} PE bands and "
            f"{_build.N_CLASS} classes; got {(n_scales, n_freq, n_class)}")


def _dec_ptrs(dec: Tree):
    return [_build.ptr(t, f"decoder.{LAYERS[i // 2]}.{'wb'[i % 2]}", shp)
            for i, (t, shp) in enumerate(zip(
                _dec_flat(dec),
                [s for pair in _build.DECODER_SHAPES for s in pair]))]


# ----------------------------------------------------------------- K1 ----

def field_forward_plain(xT: torch.Tensor, planes: Dict[str, torch.Tensor],
                        dec: Tree, n_scales: int, n_freq: int, n_class: int,
                        sdf_only: bool = False, return_embed: bool = False):
    """Composite encode -> PE -> decoder on x [3, N] -> [5 + C, N]
    (or [1, N] with ``sdf_only``), plus the embed [E, N] if asked."""
    x = xT.T
    embed = triplane_encode(planes, x, n_scales)
    pe = torch.cat([x, frequency_encode(x, n_freq)], dim=-1)
    out = decoder_apply(dec, embed, pe, n_class, sdf_only=sdf_only).T
    return (out, embed.T) if return_embed else out


def field_forward(xT: torch.Tensor, planes: Dict[str, torch.Tensor],
                  dec: Tree, n_scales: int, n_freq: int, n_class: int,
                  sdf_only: bool = False, return_embed: bool = False):
    if xT.device.type == "cpu":
        return field_forward_plain(xT, planes, dec, n_scales, n_freq,
                                   n_class, sdf_only, return_embed)
    _check_flagship(n_scales, n_freq, n_class)
    N = xT.shape[1]
    args = ([_build.ptr(xT, "x", (3, N)),
             N,
             _build.ptr(planes["s0"], "s0", _build.PLANE_SHAPES[0]),
             _build.ptr(planes["s1"], "s1", _build.PLANE_SHAPES[1]),
             _build.ptr(planes["cp"], "cp", _build.CP_SHAPE)]
            + _dec_ptrs(dec))
    out = torch.empty((1 if sdf_only else 5 + n_class, N), device=xT.device)
    embed = (torch.empty((_build.EMBED_DIM, N), device=xT.device)
             if return_embed else None)
    err = _build.lib().mf_field_forward(
        *args, out.data_ptr(), embed.data_ptr() if return_embed else None,
        int(sdf_only), _build.stream())
    _build.check(err, "field_forward")
    field_forward.launches += 1
    return (out, embed) if return_embed else out


field_forward.launches = 0


# ----------------------------------------------------------------- K2 ----

def decoder_backward_plain(xT: torch.Tensor, g: torch.Tensor,
                           embed: torch.Tensor, dec: Tree, n_freq: int,
                           n_class: int, weight_grads: bool = True):
    """Vector-Jacobian product of PE + decoder at (x, embed) with the
    output cotangent g [5 + C, N]: (d_x through the PE [3, N],
    d_embed [E, N], decoder grads tree or None)."""
    with torch.enable_grad():
        x = xT.T.detach().requires_grad_(True)
        emb = embed.T.detach().requires_grad_(True)
        flat = [t.detach().requires_grad_(weight_grads)
                for t in _dec_flat(dec)]
        pe = torch.cat([x, frequency_encode(x, n_freq)], dim=-1)
        out = decoder_apply(_dec_tree(flat), emb, pe, n_class)
        inputs = [x, emb] + (flat if weight_grads else [])
        grads = torch.autograd.grad(out, inputs, grad_outputs=g.T)
    dgrads = _dec_tree(list(grads[2:])) if weight_grads else None
    return grads[0].T, grads[1].T, dgrads


def decoder_backward(xT: torch.Tensor, g: torch.Tensor, embed: torch.Tensor,
                     dec: Tree, n_freq: int, n_class: int,
                     weight_grads: bool = True):
    if xT.device.type == "cpu":
        return decoder_backward_plain(xT, g, embed, dec, n_freq, n_class,
                                      weight_grads)
    _check_flagship(2, n_freq, n_class)
    N = xT.shape[1]
    lib = _build.lib()
    args = ([_build.ptr(xT, "x", (3, N)),
             _build.ptr(g, "g", (5 + n_class, N)),
             _build.ptr(embed, "embed", (_build.EMBED_DIM, N)),
             N] + _dec_ptrs(dec))
    dev = xT.device
    wt = torch.empty((lib.mf_decoder_wt_size(),), device=dev)
    sizes = [(w[0] + 1) * w[1] for w, _ in _build.DECODER_SHAPES]
    total = sum(sizes)
    # one partial sum per block of the persistent grid (a block per SM)
    splits = torch.cuda.get_device_properties(dev).multi_processor_count
    partials = (torch.zeros((splits, total), device=dev) if weight_grads
                else wt)
    grads = torch.empty((total,), device=dev) if weight_grads else wt
    d_x = torch.empty((3, N), device=dev)
    d_embed = torch.empty((_build.EMBED_DIM, N), device=dev)
    err = lib.mf_decoder_backward(
        *args, wt.data_ptr(), partials.data_ptr(), splits, d_x.data_ptr(),
        d_embed.data_ptr(), grads.data_ptr(), int(weight_grads),
        _build.stream())
    _build.check(err, "decoder_backward")
    decoder_backward.launches += 1
    if not weight_grads:
        return d_x, d_embed, None
    tree, off = {}, 0
    for name, ((fi, fo), _), n in zip(LAYERS, _build.DECODER_SHAPES, sizes):
        block = grads[off:off + n].view(fi + 1, fo)
        tree[name] = {"w": block[:fi], "b": block[fi]}
        off += n
    return d_x, d_embed, tree


decoder_backward.launches = 0


# ------------------------------------------------ differentiable query ----

class FieldQueryT(torch.autograd.Function):
    """out [5 + C, N] = field(x [3, N]) with the kernels' backward.

    Forward is K1 with the embed saved as the only residual. Backward is
    K2 (decoder and PE), then K3 only if a plane or CP tensor needs a
    gradient (GO differentiates only the pose), then K4 only if x does.
    Inputs after ``meta`` = (n_scales, n_freq, n_class) are the plane
    tensors (s0.., cp) followed by the decoder's w, b per layer.
    """

    @staticmethod
    def forward(ctx, xT, meta, *tensors):
        n_scales, n_freq, n_class = meta
        n_planes = len(tensors) - 2 * len(LAYERS)
        planes = planes_from_tensors(tensors[:n_planes], n_scales)
        dec = _dec_tree(tensors[n_planes:])
        out, embed = field_forward(xT, planes, dec, n_scales, n_freq,
                                   n_class, return_embed=True)
        ctx.meta = meta
        ctx.n_planes = n_planes
        ctx.save_for_backward(xT, embed, *tensors)
        return out

    @staticmethod
    def backward(ctx, g):
        n_scales, n_freq, n_class = ctx.meta
        xT, embed, *tensors = ctx.saved_tensors
        n_planes = ctx.n_planes
        planes = planes_from_tensors(tensors[:n_planes], n_scales)
        dec = _dec_tree(tensors[n_planes:])
        need = ctx.needs_input_grad
        need_planes = any(need[2:2 + n_planes])
        need_dec = any(need[2 + n_planes:])
        d_x_pe, d_embed, d_dec = decoder_backward(
            xT, g.contiguous(), embed, dec, n_freq, n_class,
            weight_grads=need_dec)
        plane_grads = [None] * n_planes
        if need_planes:
            dp = plane_backward(xT, d_embed, planes, n_scales)
            plane_grads = [dp[k] for k in plane_keys(planes)]
        dec_grads = _dec_flat(d_dec) if need_dec else [None] * 2 * len(LAYERS)
        d_x = None
        if need[0]:
            d_x = d_x_pe + x_backward(xT, d_embed, planes, n_scales)
        return (d_x, None, *plane_grads, *dec_grads)


def field_query_T(params: Tree, xT: torch.Tensor, n_scales: int,
                  n_freq: int, n_class: int) -> torch.Tensor:
    """Differentiable query of params {"planes", "decoder"} at x [3, N]."""
    planes = params["planes"]
    tensors = ([planes[k] for k in plane_keys(planes)]
               + _dec_flat(params["decoder"]))
    return FieldQueryT.apply(xT.contiguous(), (n_scales, n_freq, n_class),
                             *tensors)


KERNEL_WRAPPERS = {
    "encode_forward": encode_forward,
    "field_forward": field_forward,
    "decoder_backward": decoder_backward,
    "plane_backward": plane_backward,
    "x_backward": x_backward,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
