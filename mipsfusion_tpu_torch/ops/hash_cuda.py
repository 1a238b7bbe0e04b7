"""H1 (the hash-grid encode), H2 (its table gradient) and H3 (its point
gradient): the multiresolution hash grid on the card.

No TPU kernel is replaced: the JAX package builds the hash grid from XLA
operations, as the plain versions here do (``encoding._hash_forward``,
``encoding._hash_backward``), and the kernels (``csrc/hashgrid.cuh``)
follow that definition exactly. Each wrapper serves a CPU tensor with its
plain version and a CUDA tensor with its kernel at the grid's table shape
(``_build.hash_shape``: 16 levels of 2 features; any other grid raises).
``<wrapper>.launches`` counts kernel launches (``launches_by_device`` per
device); a CUDA graph's replays are added through
``field_cuda.add_launch_counts``.

Arrays are points-minor: x [3, N], embed and its cotangent [2 L, N] (level
l in rows 2 l, 2 l + 1), d_x [3, N]; the table is [L, T, 2].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from .encoding import (HashGridConfig, _hash_backward, _hash_forward,
                       fixed_point_scale)

_levels = {}


def _level_args(cfg: HashGridConfig) -> tuple:
    """The grid's levels as the kernels take them: log2 T, the dense
    levels, and host pointers to the float32 scales and int32
    resolutions (the plain version's tables), kept alive here."""
    if cfg not in _levels:
        scales = np.ascontiguousarray(cfg.level_scales(), np.float32)
        res = np.ascontiguousarray(cfg.level_resolutions(), np.int32)
        _levels[cfg] = (scales, res, (cfg.log2_hashmap_size, cfg.n_dense,
                                      scales.ctypes.data, res.ctypes.data))
    return _levels[cfg][2]


def _shape(table: torch.Tensor, cfg: HashGridConfig):
    shape = _build.hash_shape(cfg.n_levels, cfg.n_features)
    _build.ptr(table, "table",
               (cfg.n_levels, cfg.table_size, cfg.n_features))
    return shape


# ----------------------------------------------------------------- H1 ----

def hash_forward(xT: torch.Tensor, table: torch.Tensor,
                 cfg: HashGridConfig) -> torch.Tensor:
    """embed [2 L, N] of points x [3, N]: the plain encode for a CPU
    tensor, H1 for a CUDA one."""
    if xT.device.type == "cpu":
        return _hash_forward(table, xT.T, cfg).T
    shape = _shape(table, cfg)
    N = xT.shape[1]
    embed = torch.empty((shape.embed_dim, N), device=xT.device)
    with torch.cuda.device(xT.device):
        err = shape.fn("hash_forward")(
            _build.ptr(xT, "x", (3, N)), N, table.data_ptr(),
            *_level_args(cfg), embed.data_ptr(), _build.stream(xT.device))
    _build.check(err, "hash_forward")
    _build.count_launch(hash_forward, xT.device)
    return embed


hash_forward.launches = 0
hash_forward.launches_by_device = {}


# ----------------------------------------------------------------- H2 ----

def hash_table_backward(xT: torch.Tensor, d_embed: torch.Tensor,
                        table: torch.Tensor,
                        cfg: HashGridConfig) -> torch.Tensor:
    """d_table [L, T, 2] for the embed's cotangent d_embed [2 L, N]: the
    plain scatter for a CPU tensor, H2 for a CUDA one; both sum in int64
    fixed point at ``fixed_point_scale``, so they give the same bits."""
    if xT.device.type == "cpu":
        return _hash_backward(table, xT.T, d_embed.T, cfg, False, True)[1]
    shape = _shape(table, cfg)
    N = xT.shape[1]
    dev = xT.device
    g = _build.ptr(d_embed, "d_embed", (shape.embed_dim, N))
    # the plain version's scale, from the same layout of the same values
    scale = fixed_point_scale(d_embed.T.reshape(N, cfg.n_levels,
                                                cfg.n_features))
    acc = torch.empty((table.numel(),), dtype=torch.int64, device=dev)
    d_table = torch.empty_like(table)
    with torch.cuda.device(dev):
        err = shape.fn("hash_table_backward")(
            _build.ptr(xT, "x", (3, N)), g, N, *_level_args(cfg),
            scale.data_ptr(), acc.data_ptr(), d_table.data_ptr(),
            _build.stream(dev))
    _build.check(err, "hash_table_backward")
    _build.count_launch(hash_table_backward, dev)
    return d_table


hash_table_backward.launches = 0
hash_table_backward.launches_by_device = {}


# ----------------------------------------------------------------- H3 ----

def hash_x_backward(xT: torch.Tensor, d_embed: torch.Tensor,
                    table: torch.Tensor, cfg: HashGridConfig,
                    d_x_pe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d_x [3, N] through the grid's trilinear weights, plus ``d_x_pe``
    [3, N] where given (the PE's share, added in the kernel)."""
    if xT.device.type == "cpu":
        d_x = _hash_backward(table, xT.T, d_embed.T, cfg, True, False)[0].T
        return d_x if d_x_pe is None else d_x_pe + d_x
    shape = _shape(table, cfg)
    N = xT.shape[1]
    add = None if d_x_pe is None else _build.ptr(d_x_pe, "d_x_pe", (3, N))
    d_x = torch.empty((3, N), device=xT.device)
    with torch.cuda.device(xT.device):
        err = shape.fn("hash_x_backward")(
            _build.ptr(xT, "x", (3, N)),
            _build.ptr(d_embed, "d_embed", (shape.embed_dim, N)), N,
            table.data_ptr(), *_level_args(cfg), add, d_x.data_ptr(),
            _build.stream(xT.device))
    _build.check(err, "hash_x_backward")
    _build.count_launch(hash_x_backward, xT.device)
    return d_x


hash_x_backward.launches = 0
hash_x_backward.launches_by_device = {}
