"""K1 (fused field forward) and K4 (coordinate backward) of the port, on
the CPU: what the CUDA kernels rest on, held before any run on a card.

K1 keeps a warp's activations in the registers of mma.sync.m16n8k8
fragments and reads the decoder's weights packed in B-fragment order
(``field_cuda.pack_decoder_weights_plain`` mirrors the kernel's packer).
Here the packed set is shown to be a permutation of the weights, a numpy
rendition of the kernel's fragment dataflow (one warp, 16 points, the
thread-to-value layout of csrc/field_forward.cuh) reproduces the JAX
field and the port's plain forward at the flagship widths, and the 3xTF32
products composed through the whole decoder stay within K1's tolerance.
K4's plain version takes the PE's share of d_x and returns the sum, and
``FieldQueryT`` uses that instead of a separate addition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu_torch.config import FLAGSHIP_ORBIT
from mipsfusion_tpu_torch.models.decoder import LAYERS
from mipsfusion_tpu_torch.ops import _build
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.ops import triplane_cuda as tc
from test_torch_field import (_jax_grads, np_bwd_x, points, small_fcfg,
                              small_params, torch_tree)
from test_torch_tf32_split import split, tf32_rna

torch.set_num_threads(1)

META = (2, 8, 5)
FLAG = _build.SHAPES[((32, 64), 4, 384, 40)]


@pytest.fixture(scope="module")
def flagship():
    """Flagship-width params from a seed (features O(1)), as torch and
    numpy trees."""
    p = chip_smoke.flagship_params(3, torch.device("cpu"))
    as_np = {"planes": {k: v.numpy() for k, v in p["planes"].items()},
             "decoder": {n: {k: t.numpy() for k, t in d.items()}
                         for n, d in p["decoder"].items()}}
    return p, as_np


def flat_decoder(dec):
    return torch.cat([dec[n][k].reshape(-1) for n in LAYERS
                      for k in ("w", "b")])


# ------------------------------------------------ (a) the packed weights --

def test_packed_weights_are_a_permutation_of_the_decoder(flagship):
    p, _ = flagship
    idx = fc.packed_index(FLAG)
    flat = flat_decoder(p["decoder"])
    assert idx.shape == (40272,)
    used = idx[idx >= 0]
    assert np.array_equal(np.sort(used), np.arange(flat.numel()))
    packed = fc.pack_decoder_weights(p["decoder"], FLAG)  # CPU: the plain one
    assert torch.equal(packed[torch.as_tensor(idx >= 0)],
                       flat[torch.as_tensor(used)])
    assert torch.all(packed[torch.as_tensor(idx < 0)] == 0)
    # every float of a 16-byte load belongs to one lane: [.., lane, 4]
    assert 40272 % 4 == 0 and (40272 * 4) <= 227 * 1024


def test_split_is_exact_on_the_packed_weights(flagship):
    """hi + lo == w bit for bit (lo = w - hi is exact in float32), and hi
    has only TF32's 10 mantissa bits."""
    p, _ = flagship
    w = fc.pack_decoder_weights_plain(p["decoder"], FLAG)
    hi = tf32_rna(w)
    lo = w - hi
    assert torch.equal(hi + lo, w)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert float((lo.abs() - w.abs() * 2.0 ** -11).max()) <= 0.0


# ----------------------------------- the kernel's dataflow, one warp ------

def _mma(a, b):
    """mma.sync.m16n8k8: a [32 lanes, 4], b [32, 2] -> c [32, 4] with the
    PTX fragment layouts (g = lane // 4, t = lane % 4)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a.T
    B[t, g], B[t + 4, g] = b.T
    C = A @ B
    return np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                     C[g + 8, 2 * t + 1]], axis=1)


def _wide(a, packed, off, n_tiles, pair0=0):
    """layer_wide: a [KB, 32, 4] -> c [n_tiles, 32, 4] (no bias)."""
    c = np.zeros((n_tiles, 32, 4))
    for kb in range(a.shape[0]):
        for j in range(n_tiles):
            pair = pair0 + j // 2
            w = packed[off + ((kb * 8 + pair) * 32) * 4:][:128].reshape(32, 4)
            c[j] += _mma(a[kb], w[:, 2 * (j & 1):2 * (j & 1) + 2])
    return c


def _narrow(a, packed, off):
    c = np.zeros((32, 4))
    for kb in range(a.shape[0]):
        c += _mma(a[kb], packed[off + kb * 64:][:64].reshape(32, 2))
    return c


def _bias(packed, off, n_tiles):
    t = np.arange(32) & 3
    c = np.zeros((n_tiles, 32, 4))
    for j in range(n_tiles):
        c[j, :, 0] = c[j, :, 2] = packed[off + 8 * j + 2 * t]
        c[j, :, 1] = c[j, :, 3] = packed[off + 8 * j + 2 * t + 1]
    return c


def _c_to_a(c, relu):
    a = c[:, :, [0, 2, 1, 3]]
    return np.maximum(a, 0.0) if relu else a


def warp_forward(x16, pe16, emb16, packed, shape=FLAG):
    """csrc/field_forward.cuh for one warp at a table shape: x16 [16, 3],
    the plain PE [16, 51] and embed [16, E] of those points (the kernel
    computes in each thread exactly the entries read here, zeros past the
    embed's last part) -> out [16, 10]."""
    kbe = shape.k1_embed_kblocks
    W0, W1 = 0, 7 * 1024
    WS0 = W1 + 16 * 1024
    WS1 = WS0 + (8 + kbe) * 1024
    WR = WS1 + 16 * 64
    B0 = WR + 15 * 64
    B1, BS0, BS1, BR = B0 + 128, B0 + 256, B0 + 384, B0 + 392
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    pts = (g, g + 8)
    pe = np.zeros((7, 32, 4))
    for kb in range(6):
        pair = 4 * kb + t                          # (axis, band)
        for q in range(2):
            pe[kb, :, q] = pe16[pts[q], 3 + 2 * pair]          # sin
            pe[kb, :, 2 + q] = pe16[pts[q], 3 + 2 * pair + 1]  # cos
    for q in range(2):
        pe[6, :, q] = np.where(t < 3, x16[pts[q], np.minimum(t, 2)], 0.0)
    em = np.zeros((kbe, 32, 4))
    emb_pad = np.zeros((16, 8 * kbe))
    emb_pad[:, :emb16.shape[1]] = emb16
    for i in range(kbe // 2):
        part = t + 4 * i
        for q in range(2):
            v = emb_pad[pts[q][:, None], 4 * part[:, None] + np.arange(4)]
            em[2 * i, :, q], em[2 * i, :, 2 + q] = v[:, 0], v[:, 1]
            em[2 * i + 1, :, q], em[2 * i + 1, :, 2 + q] = v[:, 2], v[:, 3]
    crgb = _narrow(pe, packed, WR + 8 * 64)
    a0 = _c_to_a(_bias(packed, B0, 16) + _wide(pe, packed, W0, 16), True)
    h1r = _bias(packed, B1 + 64, 8) + _wide(a0, packed, W1, 8, pair0=4)
    crgb = crgb + _narrow(_c_to_a(h1r, False), packed, WR)
    h1s = _bias(packed, B1, 8) + _wide(a0, packed, W1, 8)
    h2 = (_bias(packed, BS0, 16) + _wide(_c_to_a(h1s, False), packed, WS0, 16)
          + _wide(em, packed, WS0 + 8 * 1024, 16))
    cl = _narrow(_c_to_a(h2, True), packed, WS1)
    out = np.zeros((16, 10))
    logits = np.zeros((16, 8))
    for q in range(2):
        for h in range(2):
            col = 2 * t + h
            logits[pts[q], col] = cl[:, 2 * q + h] + packed[BS1 + col]
            rgb = crgb[:, 2 * q + h] + packed[BR + col]
            keep = col < 3
            out[pts[q][keep], col[keep]] = rgb[keep]
    assert np.all(logits[:, 5:] == 0.0)            # zero padding columns
    lg = logits[:, :5]
    prob = np.exp(lg - lg.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    out[:, 3] = ((prob * np.arange(5)).sum(-1) / 4 - 0.5) * 2
    out[:, 4] = -(prob * np.log2(prob + 1e-5)).sum(-1)
    out[:, 5:] = prob
    return out


def test_fragment_dataflow_matches_jax_field_and_plain(flagship):
    """Two warps' worth of points (inside, outside and on the edges of the
    unit cube) through the rendition of the kernel's dataflow, against the
    JAX field and the port's plain forward."""
    p, p_np = flagship
    fcfg = jsr.FieldConfig.from_dict(FLAGSHIP_ORBIT)
    x = chip_smoke.test_points(32, 11, torch.device("cpu"))
    ref = np.asarray(jsr.query_color_sdf(p_np, jnp.asarray(x.T.numpy()),
                                         fcfg))
    plain, emb = fc.field_forward_plain(x, p["planes"], p["decoder"], *META,
                                        return_embed=True)
    np.testing.assert_allclose(plain.T.numpy(), ref, rtol=2e-5, atol=2e-5)
    packed = fc.pack_decoder_weights_plain(p["decoder"],
                                           FLAG).double().numpy()
    xr = x.T.double()
    from mipsfusion_tpu_torch.ops.encoding import frequency_encode
    pe = torch.cat([xr, frequency_encode(xr, 8)], dim=-1).numpy()
    for w in range(2):
        sl = slice(16 * w, 16 * w + 16)
        out = warp_forward(xr.numpy()[sl], pe[sl], emb.T.double().numpy()[sl],
                           packed)
        scale = np.abs(ref).max()
        assert np.abs(out - ref[sl]).max() <= 2e-5 * scale
        assert np.abs(out - plain.T.numpy()[sl]).max() <= 2e-5 * scale


def test_field_forward_modes_are_the_kernels_three(flagship):
    """The wrapper serves K1's three instances (full, full with the embed,
    sdf only) and refuses the fourth combination on every device."""
    p, _ = flagship
    x = chip_smoke.test_points(8, 14, torch.device("cpu"))
    full, emb = fc.field_forward(x, p["planes"], p["decoder"], *META,
                                 return_embed=True)
    assert full.shape == (10, 8) and emb.shape == (48, 8)
    assert torch.equal(full, fc.field_forward(x, p["planes"], p["decoder"],
                                              *META))
    sdf = fc.field_forward(x, p["planes"], p["decoder"], *META, sdf_only=True)
    torch.testing.assert_close(sdf, full[3:4], rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="embed"):
        fc.field_forward(x, p["planes"], p["decoder"], *META, sdf_only=True,
                         return_embed=True)


# -------------------------- (b) 3xTF32 through the whole decoder ----------

def _mma3(a, w, single=False):
    """a [P, K] w [K, N] as K1 takes it: k in steps of 8, per step the
    terms lo-hi, hi-lo, hi-hi into a float32 accumulator."""
    ah, al = split(a)
    wh, wl = split(w)
    c = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        if not single:
            c = c + al[:, s] @ wh[s]
            c = c + ah[:, s] @ wl[s]
        c = c + ah[:, s] @ wh[s]
    return c


def _pad(t, rows=None, cols=None):
    out = torch.zeros((rows or t.shape[0], cols or t.shape[1]),
                      dtype=t.dtype)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _decoder(dec, embed, pe, product):
    """The decoder with each product through ``product`` at K1's padded
    shapes: 56x128, 128x128, 112x128, 128x8, 120x8."""
    d = {n: dec[n] for n in LAYERS}
    h0 = torch.relu(product(_pad(pe, cols=56), _pad(d["trunk0"]["w"], rows=56))
                    + d["trunk0"]["b"])
    h1 = product(h0, d["trunk1"]["w"]) + d["trunk1"]["b"]
    h2 = torch.relu(product(torch.cat([h1[:, :64], embed], -1),
                            d["sdf0"]["w"]) + d["sdf0"]["b"])
    logits = product(h2, _pad(d["sdf1"]["w"], cols=8))[:, :5] + d["sdf1"]["b"]
    rgb_in = _pad(torch.cat([h1[:, 64:], pe], -1), cols=120)
    rgb = product(rgb_in, _pad(d["rgb"]["w"], rows=120, cols=8))[:, :3] \
        + d["rgb"]["b"]
    prob = torch.softmax(logits, -1)
    sdf = ((prob * torch.arange(5.0)).sum(-1, keepdim=True) / 4 - 0.5) * 2
    ent = -(prob * torch.log2(prob + 1e-5)).sum(-1, keepdim=True)
    return torch.cat([rgb, sdf, ent, prob], -1)


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_through_the_decoder_holds_k1_tolerance(flagship, seed):
    """The 3xTF32 products composed through all five layers stay within
    2e-5 of float32 at the output (max abs error / max |reference|, as
    chip_smoke holds K1); single TF32 does not."""
    p, _ = flagship
    x = chip_smoke.test_points(256, 20 + seed, torch.device("cpu"))
    _, emb = fc.field_forward_plain(x, p["planes"], p["decoder"], *META,
                                    return_embed=True)
    from mipsfusion_tpu_torch.ops.encoding import frequency_encode
    pe = torch.cat([x.T, frequency_encode(x.T, 8)], dim=-1)
    ref = _decoder(p["decoder"], emb.T, pe, lambda a, w: a @ w)
    ref64 = _decoder({n: {k: t.double() for k, t in d.items()}
                      for n, d in p["decoder"].items()},
                     emb.T.double(), pe.double(), lambda a, w: a @ w)
    three = _decoder(p["decoder"], emb.T, pe, _mma3)
    single = _decoder(p["decoder"], emb.T, pe,
                      lambda a, w: _mma3(a, w, single=True))
    assert chip_smoke._err(three, ref)[1] < 2e-5
    assert chip_smoke._err(three, ref64)[1] < 2e-5
    assert chip_smoke._err(single, ref64)[1] > 2e-5


# ------------------------------------------- (c) K4 with the added term --

@pytest.mark.parametrize("kind", ["inside", "upper_edge", "outside"])
def test_x_backward_adds_the_pe_share(kind):
    """x_backward_plain(..., d_x_pe) = d_x_pe + the Pallas kernel's formula
    (tests/test_torch_field.np_bwd_x), on and beyond the [0, 1] edges."""
    p = small_params(small_fcfg())
    rng = np.random.default_rng(14)
    x = rng.uniform(0.05, 0.95, (200, 3))
    if kind == "upper_edge":
        x[np.arange(200), rng.integers(0, 3, 200)] = 1.0
        x[:20, 0] = 0.0
    elif kind == "outside":
        x = rng.uniform(-0.3, 1.3, (200, 3))
    x = x.astype(np.float32)
    g = (rng.normal(size=(200, 16)) * 0.1).astype(np.float32)
    add = rng.normal(size=(200, 3)).astype(np.float32)
    ref = np_bwd_x(x, g, p["planes"]) + add
    planes = torch_tree(p)["planes"]
    xT, gT = torch.tensor(x.T.copy()), torch.tensor(g.T.copy())
    out = tc.x_backward(xT, gT, planes, 2, d_x_pe=torch.tensor(add.T.copy()))
    np.testing.assert_allclose(out.T.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    alone = tc.x_backward(xT, gT, planes, 2)
    assert torch.equal(out, torch.tensor(add.T.copy()) + alone)


# ------------------------- (d) FieldQueryT through the fused add ----------

@pytest.mark.parametrize("group", ["planes", "decoder", "x"])
def test_field_query_grads_match_jax_grad_through_fused_add(group,
                                                            monkeypatch):
    """FieldQueryT's gradients against jax.grad of the JAX field, with the
    backward's d_x taken from x_backward's ``d_x_pe`` argument (the test
    spies that the sum is formed there and nowhere else)."""
    fcfg = small_fcfg()
    p = small_params(fcfg, seed=5)
    x = points("inside", n=200, seed=6)
    G = (np.random.default_rng(7).normal(size=(x.shape[0], 10)) * 0.1
         ).astype(np.float32)
    gj, gx = _jax_grads(fcfg, p, x, G)
    seen = []
    inner = fc.x_backward

    def spy(xT, d_embed, planes, n_scales, d_x_pe=None):
        seen.append(d_x_pe)
        return inner(xT, d_embed, planes, n_scales, d_x_pe=d_x_pe)

    monkeypatch.setattr(fc, "x_backward", spy)
    tp = torch_tree(p, requires_grad=True)
    xT = torch.tensor(x.T.copy(), requires_grad=True)
    out = fc.field_query_T(tp, xT, *META)
    (out * torch.tensor(G.T.copy())).sum().backward()
    assert len(seen) == 1 and seen[0] is not None
    assert seen[0].shape == (3, x.shape[0])
    if group == "x":
        pairs = [(xT.grad.T.numpy(), np.asarray(gx))]
    elif group == "planes":
        pairs = [(tp["planes"][k].grad.numpy(), np.asarray(gj["planes"][k]))
                 for k in p["planes"]]
    else:
        pairs = [(tp["decoder"][n][k].grad.numpy(),
                  np.asarray(gj["decoder"][n][k]))
                 for n in p["decoder"] for k in ("w", "b")]
    for a, b in pairs:
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-5 * scale + 1e-9, (
            np.abs(a - b).max(), scale)
