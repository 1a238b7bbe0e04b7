"""K1 (fused field forward), K2 (decoder backward) and the differentiable
field query ``FieldQueryT``.

Port of ``mipsfusion_tpu/ops/field_pallas.py``: ``field_forward``
replaces ``field_query_pallas``, ``decoder_backward`` replaces
``_decoder_bwd_call`` and ``FieldQueryT`` replaces the custom VJP of
``field_query_diff_T``. Each wrapper serves a CPU tensor with its plain
PyTorch version and a CUDA tensor with its kernel (K1
``csrc/field_forward.cuh``, K2 ``csrc/field.cuh``) at the field's shape
(one of ``_build.SHAPES``; any other shape raises);
``<wrapper>.launches`` counts kernel launches
(``launches_by_device`` per device). A launch goes to the tensors'
device, on that device's current stream. A CUDA graph's replay runs no
Python, so a stage program (``slam/programs.py``) records what its
capture counted (``launch_counters`` before and after) and adds it once a
replay (``add_launch_counts``): the counts stay those of the kernels the
device ran.

Field parameters are the JAX tree's layout:
``{"planes": {"s0", "s1"(, "s2"), "cp"}, "decoder": {layer: {"w", "b"}}}``.
Point-indexed arrays are points-minor: x [3, N], out [5 + C, N],
embed [E, N].
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.decoder import LAYERS, decoder_apply
from . import _build
from .encoding import frequency_encode, triplane_encode
from .triplane_cuda import (encode_forward, plane_backward, plane_keys,
                            plane_ptrs, planes_from_tensors, x_backward)

Tree = Dict[str, Dict]


def _dec_flat(dec: Tree):
    return [dec[name][k] for name in LAYERS for k in ("w", "b")]


def _dec_tree(flat) -> Tree:
    return {name: {"w": flat[2 * i], "b": flat[2 * i + 1]}
            for i, name in enumerate(LAYERS)}


def _dec_ptrs(dec: Tree, shape):
    return [_build.ptr(t, f"decoder.{LAYERS[i // 2]}.{'wb'[i % 2]}", shp)
            for i, (t, shp) in enumerate(zip(_dec_flat(dec),
                                             shape.decoder_flat_shapes))]


# ----------------------------------------------------------------- K1 ----

# K1 keeps a warp's activations in the registers of mma.sync.m16n8k8
# fragments, so it reads the decoder's weights in B-fragment order with
# each layer's input rows permuted to where the previous layer's
# accumulators (or the PE / embed values a thread computed) sit. Lane
# (g, t) = (lane // 4, lane % 4); slot s of a k-block is A column s, held
# by thread s % 4.

def _perm_chain(kb, s):
    """Input row in slot s of k-block kb when the input is the previous
    layer's output: thread t holds columns 8 kb + 2t, 8 kb + 2t + 1."""
    return 8 * kb + 2 * (s & 3) + (s >> 2)


def _perm_pe(kb, s):
    """PE rows [x 3 | (axis, band) sin, cos]: k-block kb < 6 holds pair
    4 kb + t as sin (slot t) and cos (slot t + 4); k-block 6 holds raw x
    in slots 0..2 and zero padding (-1)."""
    return np.where(kb < 6, 3 + 2 * (4 * kb + (s & 3)) + (s >> 2),
                    np.where(s < 3, s, -1))


def _perm_emb(kb, s, embed_dim):
    """Embed rows: thread t holds parts t, t + 4, t + 8, .. (4 rows each);
    part t + 4 i fills k-blocks 2 i and 2 i + 1. Rows at or past the embed
    width are zero padding (-1)."""
    r = 4 * ((s & 3) + 4 * (kb >> 1)) + 2 * (kb & 1) + (s >> 2)
    return np.where(r < embed_dim, r, -1)


def _wide_index(rows, base: int) -> np.ndarray:
    """A 128-column layer [k-block][tile pair][lane][4]: rows(kb, slot) is
    the input row (-1: padding), base the layer's offset in the flat
    parameters."""
    n_kb = rows.shape[0]
    lane = np.arange(32)[None, None, :, None]
    e = np.arange(4)[None, None, None, :]
    pair = np.arange(8)[None, :, None, None]
    kb = np.arange(n_kb)[:, None, None, None]
    k = rows[kb, (lane & 3) + 4 * (e & 1)]
    n = 8 * (2 * pair + (e >> 1)) + (lane >> 2)
    return np.where(k >= 0, base + k * 128 + n, -1).reshape(-1)


def _narrow_index(rows, base: int, n_valid: int) -> np.ndarray:
    """A layer of n_valid <= 8 columns [k-block][lane][2], zero columns
    up to 8."""
    n_kb = rows.shape[0]
    lane = np.arange(32)[None, :, None]
    e = np.arange(2)[None, None, :]
    kb = np.arange(n_kb)[:, None, None]
    k = rows[kb, (lane & 3) + 4 * e]
    n = np.broadcast_to(lane >> 2, k.shape)
    return np.where((k >= 0) & (n < n_valid), base + k * n_valid + n,
                    -1).reshape(-1)


def _pad_index(base: int, n_valid: int, n: int) -> np.ndarray:
    i = np.arange(n)
    return np.where(i < n_valid, base + i, -1)


_packed_index = {}


def packed_index(shape) -> np.ndarray:
    """For every float of K1's packed weight set at a table shape, its
    index into the concatenation of the decoder's flat parameters (w, b
    per layer in ``LAYERS`` order), or -1 for zero padding."""
    if shape.name not in _packed_index:
        sizes = [int(np.prod(s)) for s in shape.decoder_flat_shapes]
        off = np.concatenate([[0], np.cumsum(sizes)])
        w0, b0, w1, b1, wr, br, ws0, bs0, ws1, bs1 = off[:10]
        s = np.arange(8)[None, :]
        kb = np.arange(shape.k1_embed_kblocks)[:, None]

        def rows(fn, n_kb):
            return fn(np.arange(n_kb)[:, None], s)

        pe, chain16, chain8 = (rows(_perm_pe, 7), rows(_perm_chain, 16),
                               rows(_perm_chain, 8))
        emb = _perm_emb(kb, s, shape.embed_dim)
        emb = np.where(emb >= 0, 64 + emb, -1)
        pe_rgb = np.where(pe >= 0, 64 + pe, -1)
        _packed_index[shape.name] = np.concatenate([
            _wide_index(pe, w0),
            _wide_index(chain16, w1),
            _wide_index(np.concatenate([chain8, emb]), ws0),
            _narrow_index(chain16, ws1, _build.N_CLASS),
            _narrow_index(np.concatenate([chain8, pe_rgb]), wr, 3),
            _pad_index(b0, 128, 128), _pad_index(b1, 128, 128),
            _pad_index(bs0, 128, 128), _pad_index(bs1, _build.N_CLASS, 8),
            _pad_index(br, 3, 8)])
    return _packed_index[shape.name]


def pack_decoder_weights_plain(dec: Tree, shape) -> torch.Tensor:
    """The decoder's weights in K1's packed order at a table shape, as
    csrc/field_forward.cuh pack_weights_kernel writes them."""
    flat = torch.cat([t.reshape(-1) for t in _dec_flat(dec)])
    idx = torch.as_tensor(packed_index(shape), device=flat.device)
    return torch.where(idx >= 0, flat[idx.clamp(min=0)],
                       torch.zeros((), dtype=flat.dtype, device=flat.device))


def pack_decoder_weights(dec: Tree, shape) -> torch.Tensor:
    """K1's packed weight set: the plain packer for CPU tensors, the
    kernel's own first step for CUDA tensors."""
    w = dec[LAYERS[0]]["w"]
    if w.device.type == "cpu":
        return pack_decoder_weights_plain(dec, shape)
    packed = torch.empty((shape.size("field_packed_size"),), device=w.device)
    with torch.cuda.device(w.device):
        err = shape.fn("field_pack_weights")(*_dec_ptrs(dec, shape),
                                             packed.data_ptr(),
                                             _build.stream(w.device))
    _build.check(err, "pack_decoder_weights")
    return packed


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
    if sdf_only and return_embed:
        raise ValueError("field_forward: the embed comes with the full "
                         "output only (K1 has no sdf_only instance that "
                         "stores it)")
    if xT.device.type == "cpu":
        return field_forward_plain(xT, planes, dec, n_scales, n_freq,
                                   n_class, sdf_only, return_embed)
    shape = _build.kernel_shape(planes, n_scales, n_freq, n_class)
    N = xT.shape[1]
    args = ([_build.ptr(xT, "x", (3, N)), N] + plane_ptrs(planes, shape)
            + _dec_ptrs(dec, shape))
    out = torch.empty((1 if sdf_only else 5 + n_class, N), device=xT.device)
    embed = (torch.empty((shape.embed_dim, N), device=xT.device)
             if return_embed else None)
    # scratch for the weights in the kernel's fragment order
    packed = torch.empty((shape.size("field_packed_size"),),
                         device=xT.device)
    with torch.cuda.device(xT.device):
        err = shape.fn("field_forward")(
            *args, packed.data_ptr(), _build.sm_count(xT.device),
            out.data_ptr(), embed.data_ptr() if return_embed else None,
            int(sdf_only), _build.stream(xT.device))
    _build.check(err, "field_forward")
    _build.count_launch(field_forward, xT.device)
    if sdf_only:
        field_forward.sdf_launches_by_n[N] = \
            field_forward.sdf_launches_by_n.get(N, 0) + 1
    return (out, embed) if return_embed else out


field_forward.launches = 0
field_forward.launches_by_device = {}
# K1's sdf-only launches by point count (RO's queries; the screen's two
# stages differ in size)
field_forward.sdf_launches_by_n = {}


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
    # K2 depends on the field through the embed width alone
    shape = _build.kernel_shape(n_freq=n_freq, n_class=n_class,
                                embed_dim=embed.shape[0])
    N = xT.shape[1]
    args = ([_build.ptr(xT, "x", (3, N)),
             _build.ptr(g, "g", (5 + n_class, N)),
             _build.ptr(embed, "embed", (shape.embed_dim, N)),
             N] + _dec_ptrs(dec, shape))
    dev = xT.device
    wt = torch.empty((shape.size("decoder_wt_size"),), device=dev)
    total = shape.grad_offsets[-1]        # the library's, checked on load
    # one partial sum per block of the persistent grid (a block per SM)
    splits = _build.sm_count(dev)
    partials = (torch.zeros((splits, total), device=dev) if weight_grads
                else wt)
    grads = torch.empty((total,), device=dev) if weight_grads else wt
    d_x = torch.empty((3, N), device=dev)
    d_embed = torch.empty((shape.embed_dim, N), device=dev)
    with torch.cuda.device(dev):
        err = shape.fn("decoder_backward")(
            *args, wt.data_ptr(), partials.data_ptr(), splits,
            d_x.data_ptr(), d_embed.data_ptr(), grads.data_ptr(),
            int(weight_grads), _build.stream(dev))
    _build.check(err, "decoder_backward")
    _build.count_launch(decoder_backward, dev)
    decoder_backward.dw_launches += int(weight_grads)
    if not weight_grads:
        return d_x, d_embed, None
    return d_x, d_embed, decoder_grads_from_flat(grads, shape)


decoder_backward.launches = 0
decoder_backward.launches_by_device = {}
# the launches among them that also summed the weight gradients
decoder_backward.dw_launches = 0


def decoder_grads_from_flat(flat: torch.Tensor, shape) -> Tree:
    """K2's flat weight gradient -> {layer: {"w", "b"}}: per layer (in
    ``LAYERS`` order) the [in + 1, out] block of w rows, then the bias row
    (the JAX kernel's layout), at the real embed width."""
    off = shape.grad_offsets
    tree = {}
    for i, (name, ((fi, fo), _)) in enumerate(zip(LAYERS,
                                                   shape.decoder_shapes)):
        block = flat[off[i]:off[i + 1]].view(fi + 1, fo)
        tree[name] = {"w": block[:fi], "b": block[fi]}
    return tree


# ------------------------------------------------ differentiable query ----

class FieldQueryT(torch.autograd.Function):
    """out [5 + C, N] = field(x [3, N]) with the kernels' backward.

    Forward is K1 with the embed saved as the only residual. Backward is
    K2 (decoder and PE), then K3 only if a plane or CP tensor needs a
    gradient (GO differentiates only the pose), then K4 only if x does;
    K4 takes K2's d_x through the PE and returns the sum (the fused add:
    no separate addition follows).
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
            d_x = x_backward(xT, d_embed, planes, n_scales, d_x_pe=d_x_pe)
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
        fn.launches_by_device = {}
    field_forward.sdf_launches_by_n = {}
    decoder_backward.dw_launches = 0


def launch_counters() -> Dict:
    """Every launch counter of the five wrappers, as {(wrapper, counter):
    count} for the totals and K2's launches with weight gradients and
    {(wrapper, counter, key): count} for the per-device counts and K1's
    sdf-only launches by point count."""
    out = {}
    for name, fn in KERNEL_WRAPPERS.items():
        out[(name, "launches")] = fn.launches
        for d, c in fn.launches_by_device.items():
            out[(name, "launches_by_device", d)] = c
    out[("decoder_backward", "dw_launches")] = decoder_backward.dw_launches
    for n, c in field_forward.sdf_launches_by_n.items():
        out[("field_forward", "sdf_launches_by_n", n)] = c
    return out


def launch_count_delta(before: Dict, after: Dict) -> Dict:
    """The counters that moved from ``before`` to ``after``
    (``launch_counters``), by how much."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def add_launch_counts(delta: Dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (``launch_count_delta``) to the wrappers'
    counters: a replay's launches, or with times -1 a capture's, which
    launched nothing."""
    with _build.count_lock:
        for k, c in delta.items():
            fn = KERNEL_WRAPPERS[k[0]]
            if len(k) == 2:
                setattr(fn, k[1], getattr(fn, k[1]) + times * c)
            else:
                d = getattr(fn, k[1])
                d[k[2]] = d.get(k[2], 0) + times * c


def launch_counts(by_device: bool = False) -> Dict:
    """Each wrapper's kernel launches since the last reset: a count, or
    with ``by_device`` a count per CUDA device ordinal."""
    if by_device:
        return {name: dict(fn.launches_by_device)
                for name, fn in KERNEL_WRAPPERS.items()}
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
