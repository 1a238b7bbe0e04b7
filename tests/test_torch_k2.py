"""K2 (decoder backward) of the port, on the CPU: what the CUDA kernel
rests on, held before any run on a card.

K2 (csrc/field.cuh) keeps a 64-point tile's activations and gradients as
rows of shared memory, reads the decoder's weights packed in B-fragment
order and split into TF32 hi and lo parts
(``field_cuda.pack_k2_weights_plain`` mirrors the kernel's packer), and
takes each bias gradient from a row of ones or a sum on the CUDA cores.
Here, at every shape of ``_build.SHAPES``: the packed set holds every
weight once per direction in each part and zeros elsewhere, the tile's
swizzle keeps the kernel's fragment accesses free of bank conflicts, and a
numpy rendition of the kernel's tile dataflow (the same row layout, the
packed weights read back through the fragment index, the ones rows, the
weight gradients scattered into the flat layout as the kernel writes its
partial) reproduces ``decoder_backward_plain``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mipsfusion_tpu_torch.ops import _build
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.ops.hash_cuda import hash_forward

torch.set_num_threads(1)

SHAPES = {s.name: s for s in _build.SHAPES.values()}
FORWARD = ("w0", "w1", "ws0", "ws1")
BACKWARD = ("ws1_t", "ws0_t", "wr_t", "w1_t", "w0_wr_t")


def _layer_slices(shape):
    out, o = {}, 0
    for name, kb, pairs in shape.k2_layers:
        out[name] = (slice(o, o + kb * pairs * 256), kb, pairs)
        o += kb * pairs * 256
    return out


def _flat_params(shape):
    """{name: (offset, size)} of the decoder's flat parameters."""
    names = ("w0", "b0", "w1", "b1", "wr", "br", "ws0", "bs0", "ws1", "bs1")
    sizes = [int(np.prod(s)) for s in shape.decoder_flat_shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return {n: (int(o), s) for n, o, s in zip(names, offs, sizes)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k2_packed_weights_land_once_per_direction(name):
    """Each weight of the forward's layers lands once in the forward part's
    hi slots and once in its lo slots, each of the backward's likewise in
    the backward part, no bias anywhere; the size is the one the library
    is held to on load."""
    shape = SHAPES[name]
    idx = fc.k2_packed_index(shape)
    lo = fc.k2_lo_slots(shape)
    assert idx.shape == lo.shape == (shape.k2_packed_size,)
    sl = _layer_slices(shape)
    flat = _flat_params(shape)
    for layers, params in ((FORWARD, ("w0", "w1", "ws0", "ws1")),
                           (BACKWARD, ("ws1", "ws0", "wr", "w1", "w0"))):
        want = np.concatenate([np.arange(flat[n][0], flat[n][0] + flat[n][1])
                               for n in params])
        for half in (False, True):
            part = np.concatenate([idx[sl[n][0]][lo[sl[n][0]] == half]
                                   for n in layers])
            real = part[part >= 0]
            assert len(np.unique(real)) == len(real)
            assert np.array_equal(np.sort(real), np.sort(want))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k2_plain_packer_pads_with_zeros(name):
    shape = SHAPES[name]
    dec = chip_smoke.field_params(name, 1, torch.device("cpu"),
                                  log2_rows=12)["decoder"]
    dec = {n: {k: t + 1.0 for k, t in d.items()} for n, d in dec.items()}
    packed = fc.pack_k2_weights(dec, shape)
    idx = torch.as_tensor(fc.k2_packed_index(shape))
    lo = torch.as_tensor(fc.k2_lo_slots(shape))
    assert packed.shape == (shape.k2_packed_size,)
    assert torch.all(packed[idx < 0] == 0)
    assert torch.all(packed[(idx >= 0) & ~lo] != 0)
    # hi + lo is the weight itself, hi a TF32 value (13 low bits zero)
    hi, low = packed.view(-1, 8)[:, :4], packed.view(-1, 8)[:, 4:]
    w = idx.view(-1, 8)[:, :4]
    flat = torch.cat([dec[n][k].reshape(-1) for n in fc.LAYERS
                      for k in ("w", "b")])
    want = torch.where(w >= 0, flat[w.clamp(min=0)], torch.zeros(()))
    assert torch.equal(hi + low, want)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)


def _at(r, c):
    """csrc/field.cuh k2_at: the swizzled offset of tile row r, column c."""
    return r * 64 + (c ^ (((r ^ (r >> 1)) & 3) << 3))


@pytest.mark.parametrize("pattern", ["points_a", "points_out", "wgrad"])
def test_k2_tile_accesses_are_free_of_bank_conflicts(pattern):
    """Every 8-byte access K2 makes to its tile, per half warp (16 lanes,
    lane = 4g + t): 16 distinct pairs of banks. Rows start at multiples of
    8; each row's swizzle is a permutation of its 64 columns."""
    for r in range(16):
        assert sorted(_at(r, c) - 64 * r for c in range(64)) == list(
            range(64))
    for half in range(2):
        lanes = [(g, t) for g in range(4 * half, 4 * half + 4)
                 for t in range(4)]
        for base in range(0, 64, 8):
            for blk in range(8):
                for extra in (0, 1, 4, 8):
                    if pattern == "points_a":    # rows 8kb + t (+4)
                        if extra not in (0, 4):
                            continue
                        addr = [_at(base + t + extra, 16 * (blk % 4) + 2 * g)
                                for g, t in lanes]
                    elif pattern == "points_out":  # rows 8j + 2t (+1)
                        if extra not in (0, 1):
                            continue
                        addr = [_at(base + 2 * t + extra,
                                    16 * (blk % 4) + 2 * g) for g, t in lanes]
                    else:                          # rows base + g (+8)
                        if extra not in (0, 8):
                            continue
                        addr = [_at(base + g + extra, 8 * blk + 2 * t)
                                for g, t in lanes]
                    assert all(a % 2 == 0 for a in addr)
                    assert len({(a % 32) // 2 for a in addr}) == 16


def _unpack(packed, sl):
    """The B matrix [8 kb, 16 pairs] of a packed layer, read back through
    the fragment index (hi + lo)."""
    s, kb, pairs = sl
    q = np.arange(kb * pairs * 256)
    e, lane, blk = q & 3, (q >> 3) & 31, q >> 8
    k = 8 * (blk // pairs) + (lane & 3) + 4 * (e & 1)
    n = 8 * (2 * (blk % pairs) + (e >> 1)) + (lane >> 2)
    B = np.zeros((8 * kb, 16 * pairs))
    np.add.at(B, (k, n), packed[s])
    return B


def k2_tile_dataflow(shape, x, g, embed, dec, weight_grads=True):
    """A numpy rendition of csrc/field.cuh decoder_bwd_kernel, in float64:
    the tile rows of K2Layout (one PE block), the packed weights through
    the fragment index, the ones rows and the bias sums, each phase's
    reads and writes in the kernel's order, and the partial written as
    the kernel writes it."""
    E = shape.embed_dim
    EF, nin = -(-E // 8) * 8, 64 + E
    R = {"h1s": 0, "emb": 64}
    R["h1r"] = R["emb"] + EF
    R["pe"] = R["h1r"] + 64
    R["h0"] = R["pe"] + 56
    R["h2"] = R["h0"] + 128
    R["log"] = R["h2"] + 136
    R["g"] = R["log"] + 8
    R["dh2"] = R["g"] + 8
    rows = R["dh2"] + 128
    packed = fc.pack_k2_weights_plain(dec, shape).double().numpy()
    B = {n: _unpack(packed, s) for n, s in _layer_slices(shape).items()}
    b = {k: dec[n]["b"].double().numpy() for k, n in
         (("b0", "trunk0"), ("b1", "trunk1"), ("bs0", "sdf0"),
          ("bs1", "sdf1"))}
    x, g, embed = (t.double().numpy() for t in (x, g, embed))
    N = x.shape[1]
    d_x, d_embed = np.zeros((3, N)), np.zeros((E, N))
    # dW^T[out][in]; trunk0's, rgb's and sdf1's last column from a ones row,
    # sdf0's and trunk1's bias (the CUDA cores' sums) in their last column
    dwt = {"w0": np.zeros((128, 56)), "w1": np.zeros((128, 129)),
           "ws0": np.zeros((128, nin + 1)),
           "ws1": np.zeros((8, 136)), "wr": np.zeros((8, 120))}
    relu = lambda v: np.maximum(v, 0.0)
    T = np.zeros((rows, 64))
    for r, n in (("pe", 51), ("h2", 128)):
        T[R[r] + n] = 1.0
    freq = np.float32(2.0) ** np.arange(8) * np.float32(np.pi)
    for n0 in range(0, N, 64):
        nv = min(64, N - n0)
        xt = np.full((3, 64), 0.5)
        xt[:, :nv] = x[:, n0:n0 + nv]
        T[R["emb"]:R["emb"] + E] = 0.0
        T[R["emb"]:R["emb"] + E, :nv] = embed[:, n0:n0 + nv]
        T[R["pe"]:R["pe"] + 3] = xt
        for d in range(3):
            for j in range(8):
                T[R["pe"] + 3 + 16 * d + 2 * j] = np.sin(xt[d] * freq[j])
                T[R["pe"] + 4 + 16 * d + 2 * j] = np.cos(xt[d] * freq[j])
        gt = np.zeros((10, 64))
        gt[:, :nv] = g[:, n0:n0 + nv]
        T[R["g"]:R["g"] + 3] = gt[:3]
        # forward recompute
        T[R["h0"]:R["h0"] + 128] = relu(B["w0"].T @ T[R["pe"]:R["pe"] + 56]
                                        + b["b0"][:, None])
        h1 = B["w1"].T @ T[R["h0"]:R["h0"] + 128] + b["b1"][:, None]
        T[R["h1s"]:R["h1s"] + 64], T[R["h1r"]:R["h1r"] + 64] = h1[:64], h1[64:]
        T[R["h2"]:R["h2"] + 128] = relu(
            B["ws0"].T @ T[R["h1s"]:R["h1s"] + 64 + EF] + b["bs0"][:, None])
        logits = (B["ws1"].T @ T[R["h2"]:R["h2"] + 128])[:5] + b["bs1"][:, None]
        p = np.exp(logits - logits.max(0))
        p /= p.sum(0)
        dent = -(np.log2(p + 1e-5) + p / ((p + 1e-5) * np.log(2.0)))
        gp = gt[5:] + gt[3] * 0.5 * np.arange(5)[:, None] + gt[4] * dent
        T[R["log"]:R["log"] + 5] = p * (gp - (gp * p).sum(0))
        if weight_grads:                     # rgb, sdf1
            dwt["wr"] += T[R["g"]:R["g"] + 8] @ T[R["h1r"]:R["h1r"] + 120].T
            dwt["ws1"] += T[R["log"]:R["log"] + 8] @ T[R["h2"]:R["h2"] + 136].T
        T[R["dh2"]:R["dh2"] + 128] = (
            (B["ws1_t"].T @ T[R["log"]:R["log"] + 8])
            * (T[R["h2"]:R["h2"] + 128] > 0))
        T[R["h1r"]:R["h1r"] + 64] = B["wr_t"].T @ T[R["g"]:R["g"] + 8]
        if weight_grads:                     # sdf0
            dwt["ws0"][:, :nin] += (T[R["dh2"]:R["dh2"] + 128]
                                    @ T[R["h1s"]:R["h1s"] + nin].T)
            dwt["ws0"][:, nin] += T[R["dh2"]:R["dh2"] + 128].sum(1)
        T[R["h2"]:R["h2"] + nin] = (B["ws0_t"].T
                                    @ T[R["dh2"]:R["dh2"] + 128])[:nin]
        d_embed[:, n0:n0 + nv] = T[R["h2"] + 64:R["h2"] + 64 + E, :nv]
        dh1 = np.concatenate([T[R["h2"]:R["h2"] + 64],
                              T[R["h1r"]:R["h1r"] + 64]])
        if weight_grads:                     # trunk1
            dwt["w1"][:, :128] += dh1 @ T[R["h0"]:R["h0"] + 128].T
            dwt["w1"][:, 128] += dh1.sum(1)
        T[R["dh2"]:R["dh2"] + 128] = ((B["w1_t"].T @ dh1)
                                      * (T[R["h0"]:R["h0"] + 128] > 0))
        if weight_grads:                     # trunk0
            dwt["w0"] += T[R["dh2"]:R["dh2"] + 128] @ T[R["pe"]:R["pe"] + 56].T
        T[R["h0"]:R["h0"] + 56] = (B["w0_wr_t"].T @ np.concatenate(
            [T[R["dh2"]:R["dh2"] + 128], T[R["g"]:R["g"] + 8]]))[:56]
        dpe = T[R["h0"]:R["h0"] + 51]
        for d in range(3):
            acc = dpe[d].copy()
            for j in range(8):
                sn, cs = np.sin(xt[d] * freq[j]), np.cos(xt[d] * freq[j])
                acc += (dpe[3 + 16 * d + 2 * j] * cs
                        - dpe[4 + 16 * d + 2 * j] * sn) * freq[j]
            d_x[d, n0:n0 + nv] = acc[:nv]
    if not weight_grads:
        return d_x, d_embed, None
    # the partial as the kernel writes it: dW^T[out][in], in up to the
    # bias row
    off = shape.grad_offsets
    flat = np.zeros(off[-1])
    for i, (name, n_in, n_out) in enumerate((("w0", 51, 128), ("w1", 128, 128),
                                             ("wr", 115, 3), ("ws0", nin, 128),
                                             ("ws1", 128, 5))):
        flat[off[i]:off[i + 1]] = dwt[name][:n_out, :n_in + 1].T.reshape(-1)
    grads = fc.decoder_grads_from_flat(torch.tensor(flat), shape)
    return d_x, d_embed, grads


@pytest.mark.parametrize("weight_grads", [True, False])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k2_tile_dataflow_matches_plain(name, weight_grads):
    """The kernel's tile dataflow at every shape, two tiles with a ragged
    second (100 points), with and without weight gradients, against the
    plain backward (relative 1e-5; the cotangent is zero near ReLU kinks,
    where float32 and float64 may take different sides)."""
    shape = SHAPES[name]
    dev = torch.device("cpu")
    p = chip_smoke.field_params(name, 2, dev, log2_rows=12)
    dec = p["decoder"]
    x = chip_smoke.test_points(100, 3, dev)
    if shape.hash_levels:
        emb = hash_forward(x, p["hash"], chip_smoke.field_config(
            name, 12).grid)
    else:
        ns = len(shape.resolutions)
        _, emb = fc.field_forward_plain(x, p["planes"], dec, ns, 8, 5,
                                        return_embed=True)
    gen = torch.Generator().manual_seed(4)
    g = torch.randn((10, 100), generator=gen) * 0.1
    g, _ = chip_smoke.kink_free(g, x, emb, dec)
    got = k2_tile_dataflow(shape, x, g, emb, dec, weight_grads)
    want = fc.decoder_backward_plain(x, g, emb, dec, 8, 5, weight_grads)
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        assert chip_smoke._err(torch.tensor(a), b)[1] < 1e-5
    if weight_grads:
        for layer in want[2]:
            for k in ("w", "b"):
                assert chip_smoke._err(got[2][layer][k],
                                       want[2][layer][k])[1] < 1e-5
    else:
        assert got[2] is None and want[2] is None
