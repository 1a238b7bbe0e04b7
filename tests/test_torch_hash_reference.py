"""The port's HashGrid field against the benchmark's plain reference, on the
CPU: the multiresolution hash grid of ``perfbench/reference/encodings/
HashGrid.py`` (written from Instant-NGP's definition, nothing of the port)
with the reference's plain decoder (``perfbench/reference/plain.py``), on
seeded random weights at 2^12 rows a level (1 dense level, 15 hashed),
a table drawn U(-1, 1) and points in [-0.25, 1.25]^3.

Two routes of the port are held to it: the CPU's own (``scene_rep.
query_color_sdf_T``: ``hash_field``, plain torch) and the card's dataflow
(``field_cuda.hash_query_T``: H1 -> K1 forward, K2 -> H2 -> H3 backward),
which on CPU tensors runs each wrapper's plain version. Also the hash
shape of the kernels' table (``_build.SHAPES``) and K1's packed weights at
that shape."""

import os
import sys

import numpy as np
import pytest
import torch

from mipsfusion_tpu_torch.config import FLAGSHIP_ORBIT
from mipsfusion_tpu_torch.models import scene_rep as sr
from mipsfusion_tpu_torch.ops import _build
from mipsfusion_tpu_torch.ops import encoding as enc
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.ops import hash_cuda as hc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "perfbench"))
from reference import plain  # noqa: E402

torch.set_num_threads(1)
HASH_SIZE = 12
N = 3000


def _config():
    return {**FLAGSHIP_ORBIT, "grid": {**FLAGSHIP_ORBIT["grid"],
                                       "enc": "HashGrid",
                                       "hash_size": HASH_SIZE}}


@pytest.fixture(scope="module")
def case():
    """(port config, reference config, params, x [3, N], cotangent)."""
    cfg = _config()
    fcfg = sr.FieldConfig.from_dict(cfg)
    assert 0 < fcfg.grid.n_dense < fcfg.grid.n_levels
    gen = torch.Generator().manual_seed(19)
    params = sr.init_field(fcfg, gen)
    params["hash"] = torch.rand(params["hash"].shape, generator=gen) * 2 - 1
    xT = torch.rand((3, N), generator=gen) * 1.5 - 0.25
    cot = torch.rand((10, N), generator=gen) * 2 - 1
    return fcfg, plain.FieldCfg.from_config(cfg), params, xT, cot


def _run(fn, params, xT, cot):
    """(out, d table, {layer.w/b: d}, d x) of sum(fn(params, x) * cot)."""
    leaves = {"hash": params["hash"].clone().requires_grad_(True),
              "decoder": {n: {k: t.clone().requires_grad_(True)
                              for k, t in d.items()}
                          for n, d in params["decoder"].items()}}
    x = xT.clone().requires_grad_(True)
    y = fn(leaves, x)
    (y * cot).sum().backward()
    return (y.detach(), leaves["hash"].grad,
            {f"{n}.{k}": t.grad for n, d in leaves["decoder"].items()
             for k, t in d.items()}, x.grad)


@pytest.mark.parametrize("route", ["cpu_query", "kernel_dataflow"])
def test_hash_field_matches_the_reference(case, route):
    """Outputs and gradients to the table, the decoder and the points.

    - output: the encode's 8 products a level summed in float32, each of
      size <= 1, then the same decoder: a few ulps of the largest output,
      atol 1e-6 of it;
    - table gradient: a row sums the shares of the points that reach it
      (float32 adds in the reference, the port's exact int64 fixed-point
      sum rounded once): a few ulps of the largest row, 2e-6 of it;
    - decoder gradients: the same float32 graph below the embed, which
      itself agrees to a few ulps: 2e-6 of each one's largest;
    - point gradient: 16 levels x 8 corners x 2 features of terms up to
      scale_l (255) in size, associated in another order: a few ulps of
      the largest partial sum, about the largest |gradient|: 2e-6 of it.
    """
    fcfg, rcfg, params, xT, cot = case
    ref = _run(lambda p, x: plain.field(p, x, rcfg), params, xT, cot)
    if route == "cpu_query":
        got = _run(lambda p, x: sr.query_color_sdf_T(p, x, fcfg),
                   params, xT, cot)
    else:
        got = _run(lambda p, x: fc.hash_query_T(p, x, fcfg), params, xT,
                   cot)

    def close(a, b, rel):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=rel * float(b.abs().max()))

    close(got[0], ref[0], 1e-6)
    close(got[1], ref[1], 2e-6)
    for k in ref[2]:
        close(got[2][k], ref[2][k], 2e-6)
    close(got[3], ref[3], 2e-6)


def test_gradient_free_query_matches_the_reference(case):
    """The mesher's and RO's query (sdf only) and the full outputs, on the
    CPU route and through ``hash_field_forward``'s dataflow (H1 -> K1),
    against the reference: atol 1e-6 of the largest, as the output above."""
    fcfg, rcfg, params, xT, _ = case
    for sdf_only in (False, True):
        ref = plain.field(params, xT, rcfg, sdf_only=sdf_only)
        for got in (sr.field_outputs_T(params, xT, fcfg, sdf_only=sdf_only),
                    fc.hash_field_forward(xT, params["hash"],
                                          params["decoder"], fcfg,
                                          sdf_only=sdf_only)):
            assert got.shape == ref.shape
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-6 * float(ref.abs().max()))


def test_wrappers_plain_routes_are_the_plain_hash_grid(case):
    """On CPU tensors H1-H3's wrappers are the plain version's functions
    (points-minor): the embed, the table gradient and the point gradient
    (plus d_x_pe) bit for bit, and no launch is counted."""
    fcfg, _, params, xT, _ = case
    grid, table = fcfg.grid, params["hash"]
    g = torch.rand((32, N), generator=torch.Generator().manual_seed(2))
    d_x_pe = torch.rand((3, N), generator=torch.Generator().manual_seed(3))
    fc.reset_launch_counts()
    assert torch.equal(hc.hash_forward(xT, table, grid),
                       enc._hash_forward(table, xT.T, grid).T)
    d_x, d_t = enc._hash_backward(table, xT.T, g.T, grid, True, True)
    assert torch.equal(hc.hash_table_backward(xT, g, table, grid), d_t)
    assert torch.equal(hc.hash_x_backward(xT, g, table, grid, d_x_pe),
                       d_x_pe + d_x.T)
    assert all(v == 0 for v in fc.launch_counters().values())


def test_hash_shape_of_the_table():
    """The table's hash entry: no planes, E = 32 in 8 parts of two levels,
    K1's embed in 4 k-blocks (no padding), K2 at E = 32; found by the
    grid's levels and features (16 x 2) and by the embed width, and a grid
    of other widths is refused naming the table."""
    shape = _build.hash_shape(16, 2)
    assert shape.name == "hash" and shape.hash_levels == 16
    assert shape.resolutions == () and shape.n_scales == 0
    assert (shape.embed_dim, shape.n_parts, shape.k1_embed_kblocks) == (
        32, 8, 4)
    assert _build.kernel_shape(embed_dim=32) is shape
    assert shape.defines == ["-DMF_SHAPE=hash", "-DMF_HASH_L=16"]
    assert "mf_hash_table_backward" in shape.signatures
    assert "mf_plane_backward" not in shape.signatures
    assert shape.grad_offsets[-1] == 38625 + 128 * (32 - 48)
    with pytest.raises(ValueError, match="HashGrid 16 x 2"):
        _build.hash_shape(8, 2)


def test_k1_packed_weights_at_the_hash_shape():
    """K1's packed set at the hash shape holds every decoder weight and
    bias once and zeros elsewhere (the 32 embed rows fill its 4 embed
    k-blocks with no padding row)."""
    shape = _build.hash_shape(16, 2)
    idx = fc.packed_index(shape)
    real = idx[idx >= 0]
    n_params = sum(int(np.prod(s)) for s in shape.decoder_flat_shapes)
    assert len(np.unique(real)) == len(real) == n_params
    emb_rows = set()
    for kb in range(shape.k1_embed_kblocks):
        for s in range(8):
            emb_rows.add(int(fc._perm_emb(kb, s, shape.embed_dim)))
    assert emb_rows == set(range(32))
