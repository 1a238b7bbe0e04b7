"""Parity of the port's field (plain K1-K4 and FieldQueryT) with the JAX
package on the CPU, at a small field: Triplane (8, 16) x F4, CP 32 x 8,
8 PE bands, a narrow decoder.

The JAX side is the composite path (use_pallas=False), which is what the
reference's Pallas kernels are tested against in
tests/test_pallas_equivalence.py. Inputs come from a numpy seed and go
through both packages. Both sides compute in float32; tolerances are a
few float32 ulps of the compared magnitudes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.ops.encoding import triplane_encode as j_triplane_encode
from mipsfusion_tpu_torch.convert import params_from_jax, params_to_numpy
from mipsfusion_tpu_torch.ops import _build
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.ops import triplane_cuda as tc

torch.set_num_threads(1)

META = (2, 8, 5)          # n_scales, PE bands, classes


def small_fcfg(**decoder):
    fcfg = jsr.FieldConfig(
        enc="Triplane",
        tri=dataclasses.replace(jsr.FieldConfig().tri, resolutions=(8, 16),
                                n_features=4, cp_resolution=32,
                                cp_components=8),
        freq=dataclasses.replace(jsr.FieldConfig().freq, n_frequencies=8),
        perturb=False)
    dec = dict(n_hidden=32, n_hidden_branch=32, n_hidden_sdf=16,
               n_hidden_rgb=16)
    dec.update(decoder)
    return dataclasses.replace(fcfg, decoder=dataclasses.replace(
        fcfg.decoder, input_ch=fcfg.tri.out_dim,
        input_ch_pos=fcfg.freq.out_dim + 3, **dec))


def small_params(fcfg, seed=0, scale=True):
    """JAX-initialized params as numpy; planes brought to O(1) so the
    comparisons are not trivially small."""
    p = jsr.init_field_params(jax.random.PRNGKey(seed), fcfg)
    p = jax.tree.map(np.asarray, p)
    if scale:
        p["planes"] = {k: v * (1e4 if k.startswith("s") else 4.0)
                       for k, v in p["planes"].items()}
    return p


def torch_tree(params, requires_grad=False):
    def t(a):
        return torch.tensor(np.asarray(a)).requires_grad_(requires_grad)
    return {"planes": {k: t(v) for k, v in params["planes"].items()},
            "decoder": {n: {k: t(a) for k, a in d.items()}
                        for n, d in params["decoder"].items()}}


def points(kind, n=300, seed=1):
    """x [n, 3]: inside (0.05, 0.95)^3, or with coordinates outside
    [0, 1] and exactly on the clamp edges 0.0 / 1.0."""
    rng = np.random.default_rng(seed)
    if kind == "inside":
        return rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    x[: n // 6] = 1.0
    x[n // 6: n // 3, 0] = 1.0
    x[n // 3: n // 2, 1] = 0.0
    return x


@pytest.fixture(scope="module")
def field():
    fcfg = small_fcfg()
    return fcfg, small_params(fcfg)


@pytest.mark.parametrize("kind", ["inside", "edges"])
def test_forward_matches_composite(field, kind):
    fcfg, p = field
    x = points(kind)
    ref = np.asarray(jsr.query_color_sdf(p, jnp.asarray(x), fcfg))
    tp = torch_tree(p)
    out = fc.field_forward(torch.tensor(x.T.copy()), tp["planes"],
                           tp["decoder"], *META)
    assert out.shape == (10, x.shape[0])
    np.testing.assert_allclose(out.T.numpy(), ref, rtol=1e-5, atol=2e-6)


def test_embed_and_sdf_only(field):
    fcfg, p = field
    x = points("edges")
    tp = torch_tree(p)
    xT = torch.tensor(x.T.copy())
    out, emb = fc.field_forward(xT, tp["planes"], tp["decoder"], *META,
                                return_embed=True)
    ref = np.asarray(j_triplane_encode(p["planes"], jnp.asarray(x),
                                       fcfg.tri))
    np.testing.assert_allclose(emb.T.numpy(), ref, rtol=1e-5, atol=1e-6)
    sdf = fc.field_forward(xT, tp["planes"], tp["decoder"], *META,
                           sdf_only=True)
    assert sdf.shape == (1, x.shape[0])
    np.testing.assert_allclose(sdf[0].numpy(), out[3].numpy(), atol=1e-6)


def _jax_grads(fcfg, p, x, G):
    return jax.grad(lambda pp, xx: jnp.sum(
        jsr.query_color_sdf(pp, xx, fcfg) * G), argnums=(0, 1))(
        p, jnp.asarray(x))


def _port_grads(p, x, G):
    tp = torch_tree(p, requires_grad=True)
    xT = torch.tensor(x.T.copy(), requires_grad=True)
    out = fc.field_query_T(tp, xT, *META)
    (out * torch.tensor(G.T.copy())).sum().backward()
    return tp, xT.grad.T.numpy()


@pytest.mark.parametrize("group", ["planes", "decoder", "x"])
def test_field_query_grads_match_jax_grad(field, group):
    """FieldQueryT (plain K2, K3, K4) against jax.grad of the composite on
    interior points (inside [0, 1] the kernels' coordinate gradient and
    the composite's agree). Tolerance: 1e-5 of each gradient's scale."""
    fcfg, p = field
    x = points("inside")
    G = (np.random.default_rng(2).normal(size=(x.shape[0], 10)) * 0.1
         ).astype(np.float32)
    gj, gx = _jax_grads(fcfg, p, x, G)
    tp, dx = _port_grads(p, x, G)
    if group == "x":
        pairs = [(dx, np.asarray(gx))]
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


def test_plane_backward_edges_match_jax_grad(field):
    """K3 plain at edge and outside points: the plane and CP gradients of
    the composite are the same scatter everywhere (the clamp only moves
    the taps), so jax.grad is the reference there too."""
    fcfg, p = field
    x = points("edges")
    g = (np.random.default_rng(3).normal(size=(x.shape[0], 16)) * 0.1
         ).astype(np.float32)
    ref = jax.grad(lambda pl: jnp.sum(
        j_triplane_encode(pl, jnp.asarray(x), fcfg.tri) * g))(p["planes"])
    tp = torch_tree(p)
    out = tc.plane_backward(torch.tensor(x.T.copy()), torch.tensor(g.T.copy()),
                            tp["planes"], 2)
    for k in p["planes"]:
        b = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


def _np_coords(u, R):
    return np.clip(u.astype(np.float32) * np.float32(R - 1), np.float32(0.0),
                   np.float32(R - 1 - 1e-6))


def _np_tents(pu, R):
    """Reference _onehotT and _onehotT_diff as [R, N] matrices."""
    iota = np.arange(R, dtype=np.float32)[:, None]
    W = np.maximum(np.float32(1.0) - np.abs(iota - pu[None]), 0.0)
    i0 = np.floor(pu)[None]
    D = (iota == i0 + 1.0).astype(np.float32) - (iota == i0).astype(np.float32)
    return W, D


def np_bwd_x(x, g, planes):
    """numpy rendition of triplane_pallas._make_bwd_x_kernel: derivative
    one-hots (row i0+1 minus row i0, the +1 row absent at the upper clamp)
    against tents, times (R-1), in float64 accumulation."""
    dx = np.zeros((x.shape[0], 3))
    F = planes["s0"].shape[-1]
    n_scales = sum(k.startswith("s") for k in planes)
    for s in range(n_scales):
        P = planes[f"s{s}"].astype(np.float64)
        R = P.shape[1]
        gs = g[:, s * F:(s + 1) * F].astype(np.float64)
        tents = [_np_tents(_np_coords(x[:, a], R), R) for a in range(3)]
        for p_, (a, b) in enumerate(((0, 1), (0, 2), (1, 2))):
            Wu, Du = tents[a]
            Wv, Dv = tents[b]
            du = np.einsum("rn,rvf,vn,nf->n", Du, P[p_], Wv, gs) * (R - 1)
            dv = np.einsum("rn,rvf,vn,nf->n", Wu, P[p_], Dv, gs) * (R - 1)
            dx[:, a] += du
            dx[:, b] += dv
    cp = planes["cp"].astype(np.float64)
    Rc = cp.shape[1]
    gc = g[:, n_scales * F:].astype(np.float64)
    tents = [_np_tents(_np_coords(x[:, a], Rc), Rc) for a in range(3)]
    fs = [np.einsum("rn,rc->nc", tents[a][0], cp[a]) for a in range(3)]
    ds = [np.einsum("rn,rc->nc", tents[a][1], cp[a]) for a in range(3)]
    others = (fs[1] * fs[2], fs[0] * fs[2], fs[0] * fs[1])
    for a in range(3):
        dx[:, a] += (gc * ds[a] * others[a]).sum(-1) * (Rc - 1)
    return dx


@pytest.mark.parametrize("kind", ["inside", "upper_edge", "outside"])
def test_x_backward_matches_reference_formula(field, kind):
    """K4 plain against the Pallas kernel's formula, including the two
    edge behaviours the port keeps: d_x = -P[R-1] (times R-1) at the
    upper clamp, and the tent derivative (not 0) outside [0, 1]."""
    _, p = field
    rng = np.random.default_rng(4)
    if kind == "inside":
        x = rng.uniform(0.05, 0.95, (200, 3))
    elif kind == "upper_edge":
        x = rng.uniform(0.05, 0.95, (200, 3))
        x[np.arange(200), rng.integers(0, 3, 200)] = 1.0
    else:
        x = rng.uniform(-0.3, 1.3, (200, 3))
    x = x.astype(np.float32)
    g = (rng.normal(size=(200, 16)) * 0.1).astype(np.float32)
    ref = np_bwd_x(x, g, p["planes"])
    out = tc.x_backward(torch.tensor(x.T.copy()), torch.tensor(g.T.copy()),
                        torch_tree(p)["planes"], 2)
    np.testing.assert_allclose(out.T.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_convert_roundtrip(field):
    _, p = field
    back = params_to_numpy(params_from_jax(p))
    for k in p["planes"]:
        np.testing.assert_array_equal(back["planes"][k], p["planes"][k])
    for n in p["decoder"]:
        for k in ("w", "b"):
            np.testing.assert_array_equal(back["decoder"][n][k],
                                          p["decoder"][n][k])


def test_non_cpu_tensor_launches_or_raises(field):
    """A tensor that is not on the CPU never takes the plain path: the
    wrapper goes to the kernel and its checks raise for anything the
    kernel cannot take (here a 'meta' tensor, which is not CUDA)."""
    _, p = field
    tp = torch_tree(p)
    x = torch.empty((3, 16), device="meta")
    with pytest.raises(ValueError):
        fc.field_forward(x, tp["planes"], tp["decoder"], *META)
    with pytest.raises(ValueError):
        tc.x_backward(x, torch.empty((16, 16), device="meta"),
                      tp["planes"], 2)
    with pytest.raises(ValueError):
        tc.encode_forward(torch.empty((16, 3), device="meta"),
                          tp["planes"], 2)
    with pytest.raises(ValueError, match="CUDA"):
        _build.ptr(torch.zeros(4), "x")


# --------------------------------------------------- TriplaneEncode (K0)

def _encode_jax(p, x, fcfg, G):
    def f(planes, xx):
        return jnp.sum(j_triplane_encode(planes, xx, fcfg.tri) * G)
    return jax.grad(f, argnums=(0, 1))(p["planes"], jnp.asarray(x))


@pytest.mark.parametrize("part", ["value", "planes", "x"])
def test_triplane_encode_matches_jax(field, part):
    """TriplaneEncode on the CPU (plain K0 forward, plain K3 and K4
    backward) against the JAX composite encode and jax.grad, on interior
    points: values to 1e-5 relative, gradients to 1e-5 of each one's
    scale."""
    fcfg, p = field
    x = points("inside")
    G = (np.random.default_rng(4).normal(size=(x.shape[0], 16)) * 0.1
         ).astype(np.float32)
    tp = torch_tree(p, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tc.triplane_encode(tp["planes"], xt, 2)
    if part == "value":
        ref = np.asarray(j_triplane_encode(p["planes"], jnp.asarray(x),
                                           fcfg.tri))
        assert out.shape == (x.shape[0], 16)
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-6)
        return
    (out * torch.tensor(G)).sum().backward()
    gp, gx = _encode_jax(p, x, fcfg, G)
    pairs = ([(xt.grad.numpy(), np.asarray(gx))] if part == "x" else
             [(tp["planes"][k].grad.numpy(), np.asarray(gp[k]))
              for k in p["planes"]])
    for a, b in pairs:
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max() + 1e-9


def test_triplane_encode_backward_only_what_is_asked(field):
    """With only x requiring a gradient, the backward runs K4 alone (the
    wrappers' counters move only for a CUDA tensor, so this checks the
    gradients' presence)."""
    _, p = field
    tp = torch_tree(p)
    xt = torch.tensor(points("inside"), requires_grad=True)
    tc.triplane_encode(tp["planes"], xt, 2).sum().backward()
    assert xt.grad is not None and xt.grad.shape == xt.shape
    assert all(v.grad is None for v in tp["planes"].values())


@pytest.mark.slow
def test_triplane_encode_matches_pallas_interpret(field, monkeypatch):
    """Against triplane_encode_pallas run in Pallas interpret mode (as
    tests/test_pallas_equivalence.py runs it): the TPU kernel casts the
    planes and CP lines to bf16, so values and gradients agree to 2e-2
    of their scale."""
    from mipsfusion_tpu.ops import triplane_pallas as tpl
    monkeypatch.setenv("MIPS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(tpl, "_INTERPRET", True)
    fcfg, p = field
    x = points("inside")
    G = (np.random.default_rng(5).normal(size=(x.shape[0], 16)) * 0.1
         ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p["planes"])
    ref, vjp = jax.vjp(lambda pl, xx: tpl.triplane_encode_pallas(
        pl, xx, fcfg.tri.resolutions), jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(G))
    tp = torch_tree(p, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tc.triplane_encode(tp["planes"], xt, 2)
    (out * torch.tensor(G)).sum().backward()
    pairs = [(out.detach().numpy(), np.asarray(ref)),
             (xt.grad.numpy(), np.asarray(gx))]
    pairs += [(tp["planes"][k].grad.numpy(), np.asarray(gp[k]))
              for k in p["planes"]]
    for a, b in pairs:
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max()
