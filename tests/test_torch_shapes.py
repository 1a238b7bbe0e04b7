"""The port's kernels at the field shapes beside the flagship's, on the CPU.

The CUDA kernels are compiled for every shape of ``_build.SHAPES``; besides
the flagship's [32, 64] x F4 + CP 384 x 40 (tests/test_torch_field.py,
tests/test_torch_k1_k4.py) these are

  * cp:  [32, 64, 128] x F4 + CP 512 x 32, embed 44
         (configs/synthetic/orbit_fast_cp.yaml), and
  * fcl: [32, 64, 128] x F4 + CP 384 x 40, embed 52
         (configs/FastCaMo-large/*.yaml).

Each test runs at both, at the full decoder widths the kernels take, with
inputs from numpy seeds through the JAX package (the composite path,
use_pallas=False) and the port's plain versions: the encode and the field
forward in its three modes, FieldQueryT's gradients, a numpy rendition of
K1's fragment dataflow with the embed padded to whole part groups (44 ->
48, 52 -> 64, zero Ws0 rows), K2's flat gradient layout, the taps at the
clamp edge of every resolution (128, 384, 512), and one track_frame of the
CP profile against the JAX tracker. Tolerances are those of
tests/test_torch_field.py (a few float32 ulps of the compared magnitudes)
and tests/test_torch_k1_k4.py (2e-5 of the output's scale for the
dataflow).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.config import load_config as j_load_config
from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.ops.encoding import triplane_encode as j_triplane_encode
from mipsfusion_tpu_torch.config import load_config
from mipsfusion_tpu_torch.models.decoder import LAYERS
from mipsfusion_tpu_torch.ops import _build
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.ops import triplane_cuda as tc
from mipsfusion_tpu_torch.ops.encoding import frequency_encode, taps
from test_torch_field import _jax_grads, np_bwd_x, points, torch_tree
from test_torch_k1_k4 import flat_decoder, warp_forward
from test_torch_slice import _track_jax, _track_port

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# shape name -> (config file, the loader that reads it, E, K1's packed size)
CASES = {
    "cp": ("configs/synthetic/orbit_fast_cp.yaml", load_config, 44, 40272),
    "fcl": ("configs/FastCaMo-large/fastcamo_large.yaml", j_load_config, 52,
            42320),
}
SHAPE_NAMES = sorted(CASES)


def _config(name):
    """The shape's config file, merged (inherit_from resolves against the
    repository root). The FastCaMo files hold block sequences, which the
    port's loader refuses (the file readers are not ported), so the JAX
    package's PyYAML loader reads that one."""
    path, loader, _, _ = CASES[name]
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        return loader(path)
    finally:
        os.chdir(cwd)


def _fcfg(name):
    """The JAX field config of the shape's config file (composite path,
    no perturbation), at the kernels' decoder widths."""
    cfg = _config(name)
    jf = jsr.FieldConfig.from_dict(cfg)
    return dataclasses.replace(jf, enc="Triplane", use_pallas=False,
                               perturb=False)


@pytest.fixture(scope="module", params=SHAPE_NAMES)
def field(request):
    """(name, table entry, JAX field config, numpy params with planes and
    CP brought to O(1))."""
    name = request.param
    jf = _fcfg(name)
    p = jax.tree.map(np.asarray, jsr.init_field_params(
        jax.random.PRNGKey(11), jf))
    p["planes"] = {k: v * (1e4 if k.startswith("s") else 4.0)
                   for k, v in p["planes"].items()}
    shape = _build.kernel_shape(p["planes"], len(jf.tri.resolutions))
    return name, shape, jf, p


def _meta(jf):
    return (len(jf.tri.resolutions), jf.freq.n_frequencies,
            jf.decoder.n_class)


# ------------------------------------------------------------ the table --

def test_table_entry_matches_its_config(field):
    """The config file's field is the table entry the kernels take, with
    the widths the loader checks the library's sizes against."""
    name, shape, jf, p = field
    _, _, E, k1_size = CASES[name]
    assert shape.name == name
    assert shape.key == (jf.tri.resolutions, jf.tri.n_features,
                         jf.tri.cp_resolution, jf.tri.cp_components)
    assert shape.embed_dim == E == jf.tri.out_dim == jf.decoder.input_ch
    assert shape.embed_pad == (E + 7) // 8 * 8
    assert shape.grad_offsets[-1] == 38625 + 128 * (E - 48)
    assert fc.packed_index(shape).shape == (k1_size,)
    assert shape.table_size == sum(
        int(np.prod(v.shape)) for v in p["planes"].values())
    assert {k: tuple(v.shape) for k, v in p["planes"].items()} == {
        **{f"s{i}": s for i, s in enumerate(shape.plane_shapes)},
        "cp": shape.cp_shape}
    for (w, b), name_ in zip(shape.decoder_shapes, LAYERS):
        assert p["decoder"][name_]["w"].shape == w
        assert p["decoder"][name_]["b"].shape == b


def test_every_shape_has_its_unit_and_every_source_exists(tmp_path):
    """csrc/shape.cu is the one unit, compiled once per table entry with
    the entry's -D flags: preprocessed with those flags (the host c++,
    an empty stand-in for cuda_runtime.h) it defines every entry point
    the loader binds under the shape's name, and without them it stops.
    The library's name hashes the table, so a changed shape rebuilds it.
    The kernel sources chip_smoke.py reports are files of the
    repository."""
    import subprocess
    import chip_smoke
    csrc = os.path.join(ROOT, "mipsfusion_tpu_torch", "csrc")
    assert sorted(f for f in os.listdir(csrc) if f.endswith(".cu")) == [
        "shape.cu"]
    (tmp_path / "cuda_runtime.h").write_text("")
    cxx = ["c++", "-E", "-P", "-I", str(tmp_path), "-x", "c++", _build.UNIT]
    for s in _build.SHAPES.values():
        out = subprocess.run(cxx[:1] + s.defines + cxx[1:],
                             capture_output=True, text=True, check=True)
        for name in _build._SIGNATURES:
            assert f"int {name}_{s.name}(" in out.stdout, (s.name, name)
    res = subprocess.run(cxx, capture_output=True, text=True)
    assert res.returncode != 0 and "once per entry" in res.stderr
    path = _build.library_path()
    flag = _build.SHAPES[((32, 64), 4, 384, 40)]
    moved = dataclasses.replace(flag, cp_components=32)
    old = dict(_build.SHAPES)
    try:
        _build.SHAPES[flag.key] = moved
        assert _build.library_path() != path
    finally:
        _build.SHAPES.clear()
        _build.SHAPES.update(old)
    for path in chip_smoke.SOURCE.values():
        assert os.path.exists(os.path.join(ROOT, path)), path


def test_shape_outside_the_table_raises():
    """The JAX Pallas tests' small field, (16, 32) + CP 64 x 24, is not in
    the table: the lookup names the shapes it holds."""
    planes = {"s0": torch.zeros(3, 16, 16, 4), "s1": torch.zeros(3, 32, 32, 4),
              "cp": torch.zeros(3, 64, 24)}
    with pytest.raises(ValueError, match="orbit_fast_cp"):
        _build.kernel_shape(planes, 2)
    with pytest.raises(ValueError, match="PE bands"):
        _build.kernel_shape(planes, 2, n_freq=4)
    with pytest.raises(ValueError, match="embed width 40"):
        _build.kernel_shape(embed_dim=40)


# ----------------------------------------- plain forward against JAX ----

@pytest.mark.parametrize("mode", ["full", "sdf_only", "embed"])
def test_forward_matches_composite(field, mode):
    """The port's plain encode and field forward (K0's and K1's oracles)
    against the JAX composite, on points inside, outside and on the edges
    of the unit cube."""
    _, _, jf, p = field
    x = points("edges", n=300, seed=3)
    tp = torch_tree(p)
    xT = torch.tensor(x.T.copy())
    ref = np.asarray(jsr.query_color_sdf(p, jnp.asarray(x), jf))
    meta = _meta(jf)
    if mode == "full":
        out = fc.field_forward(xT, tp["planes"], tp["decoder"], *meta)
        assert out.shape == (10, x.shape[0])
        np.testing.assert_allclose(out.T.numpy(), ref, rtol=1e-5, atol=2e-6)
    elif mode == "sdf_only":
        sdf = fc.field_forward(xT, tp["planes"], tp["decoder"], *meta,
                               sdf_only=True)
        assert sdf.shape == (1, x.shape[0])
        np.testing.assert_allclose(sdf[0].numpy(), ref[:, 3], atol=2e-6)
    else:
        _, emb = fc.field_forward(xT, tp["planes"], tp["decoder"], *meta,
                                  return_embed=True)
        enc = tc.encode_forward(torch.tensor(x), tp["planes"], meta[0])
        want = np.asarray(j_triplane_encode(p["planes"], jnp.asarray(x),
                                            jf.tri))
        assert emb.shape == (jf.tri.out_dim, x.shape[0])
        np.testing.assert_allclose(emb.T.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(enc.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("group", ["planes", "decoder", "x"])
def test_field_query_grads_match_jax_grad(field, group):
    """FieldQueryT (plain K2, K3, K4) against jax.grad of the composite on
    interior points, 1e-5 of each gradient's scale."""
    _, _, jf, p = field
    x = points("inside", n=300, seed=4)
    G = (np.random.default_rng(5).normal(size=(x.shape[0], 10)) * 0.1
         ).astype(np.float32)
    gj, gx = _jax_grads(jf, p, x, G)
    tp = torch_tree(p, requires_grad=True)
    xT = torch.tensor(x.T.copy(), requires_grad=True)
    out = fc.field_query_T(tp, xT, *_meta(jf))
    (out * torch.tensor(G.T.copy())).sum().backward()
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


# ------------------------------------------- K1's packed, padded embed ----

def test_packed_weights_pad_the_embed_with_zero_rows(field):
    """K1's packed set at the shape is a permutation of the decoder's
    parameters plus zeros: every parameter once, and each k-block slot of
    an embed row past E (44 -> 48, 52 -> 64) reads zero."""
    _, shape, _, p = field
    dec = torch_tree(p)["decoder"]
    idx = fc.packed_index(shape)
    flat = flat_decoder(dec)
    used = idx[idx >= 0]
    assert np.array_equal(np.sort(used), np.arange(flat.numel()))
    packed = fc.pack_decoder_weights(dec, shape)         # CPU: the plain one
    assert torch.equal(packed[torch.as_tensor(idx >= 0)],
                       flat[torch.as_tensor(used)])
    assert torch.all(packed[torch.as_tensor(idx < 0)] == 0)
    # the Ws0 embed k-blocks: slots past E are padding
    kb = np.arange(shape.k1_embed_kblocks)[:, None]
    rows = fc._perm_emb(kb, np.arange(8)[None, :], shape.embed_dim)
    assert (rows < 0).sum() == 8 * shape.k1_embed_kblocks - shape.embed_dim
    assert np.array_equal(np.sort(rows[rows >= 0]),
                          np.arange(shape.embed_dim))


def test_fragment_dataflow_matches_jax_field_and_plain(field):
    """Two warps' worth of points through the numpy rendition of K1's
    dataflow (tests/test_torch_k1_k4.warp_forward) at the shape's packed
    layout, against the JAX field and the port's plain forward."""
    _, shape, jf, p = field
    x = points("edges", n=32, seed=6)
    ref = np.asarray(jsr.query_color_sdf(p, jnp.asarray(x), jf))
    tp = torch_tree(p)
    xT = torch.tensor(x.T.copy())
    plain, emb = fc.field_forward_plain(xT, tp["planes"], tp["decoder"],
                                        *_meta(jf), return_embed=True)
    np.testing.assert_allclose(plain.T.numpy(), ref, rtol=2e-5, atol=2e-5)
    packed = fc.pack_decoder_weights_plain(tp["decoder"],
                                           shape).double().numpy()
    xr = xT.T.double()
    pe = torch.cat([xr, frequency_encode(xr, 8)], dim=-1).numpy()
    scale = np.abs(ref).max()
    for w in range(2):
        sl = slice(16 * w, 16 * w + 16)
        out = warp_forward(xr.numpy()[sl], pe[sl], emb.T.double().numpy()[sl],
                           packed, shape)
        assert np.abs(out - ref[sl]).max() <= 2e-5 * scale
        assert np.abs(out - plain.T.numpy()[sl]).max() <= 2e-5 * scale


# --------------------------------------------- K2's flat gradient ---------

def test_k2_flat_gradient_maps_to_jax_blocks(field):
    """K2 returns its weight gradients as one flat vector: per layer the
    [in + 1, out] block of w rows then the bias row (the JAX kernel's
    layout), with the real E (64 + 44 or 64 + 52 sdf0 rows), never the
    padded one. The offsets and decoder_grads_from_flat map such a vector
    back onto jax.grad's tree exactly."""
    _, shape, jf, p = field
    x = points("inside", n=64, seed=7)
    G = (np.random.default_rng(8).normal(size=(64, 10)) * 0.1
         ).astype(np.float32)
    gj, _ = _jax_grads(jf, p, x, G)
    blocks = []
    for name, ((fi, fo), _) in zip(LAYERS, shape.decoder_shapes):
        w, b = np.asarray(gj["decoder"][name]["w"]), np.asarray(
            gj["decoder"][name]["b"])
        assert w.shape == (fi, fo) and b.shape == (fo,)
        blocks.append(np.concatenate([w, b[None]]).reshape(-1))
    off = np.cumsum([0] + [b.size for b in blocks])
    assert tuple(off) == shape.grad_offsets
    sdf0 = LAYERS.index("sdf0")
    assert shape.grad_offsets[sdf0 + 1] - shape.grad_offsets[sdf0] == (
        64 + shape.embed_dim + 1) * 128
    tree = fc.decoder_grads_from_flat(torch.tensor(np.concatenate(blocks)),
                                      shape)
    for name in LAYERS:
        for k in ("w", "b"):
            assert np.array_equal(tree[name][k].numpy(),
                                  np.asarray(gj["decoder"][name][k]))


# ---------------------------------------------------- the clamp edge ------

def test_taps_at_the_clamp_edge(field):
    """For every resolution of the shape from 64 up (128 and 512 besides
    the flagship's 64 and 384; not 32) the float32 clamp bound R-1-1e-6
    rounds to exactly R-1, so a point at 1.0 sits on row R-1 with weight 0
    on a row R that does not exist: the taps clamp that index (ROADMAP C,
    upper clamp index). At such points the encode, K3's scatter and K4's
    coordinate gradient (-P[R-1] there) match the JAX composite and the
    Pallas kernel's formula."""
    _, shape, jf, p = field
    for R in shape.resolutions + (shape.cp_resolution,):
        assert (np.float32(R - 1 - 1e-6) == np.float32(R - 1)) == (R >= 64)
        if R >= 64:
            i0, i1, w, has_next = taps(torch.ones(1), R)
            assert (int(i0), int(i1), float(w), bool(has_next)) == (
                R - 1, R - 1, 0.0, False)
    rng = np.random.default_rng(9)
    x = rng.uniform(0.05, 0.95, (200, 3)).astype(np.float32)
    x[np.arange(200), rng.integers(0, 3, 200)] = 1.0
    x[:20, 0] = 0.0
    E = shape.embed_dim
    g = (rng.normal(size=(200, E)) * 0.1).astype(np.float32)
    tp = torch_tree(p)
    n = shape.n_scales
    enc = tc.encode_forward(torch.tensor(x), tp["planes"], n)
    want = np.asarray(j_triplane_encode(p["planes"], jnp.asarray(x), jf.tri))
    np.testing.assert_allclose(enc.numpy(), want, rtol=1e-5, atol=1e-6)
    ref = jax.grad(lambda pl: jnp.sum(
        j_triplane_encode(pl, jnp.asarray(x), jf.tri) * g))(p["planes"])
    xT, gT = torch.tensor(x.T.copy()), torch.tensor(g.T.copy())
    dp = tc.plane_backward(xT, gT, tp["planes"], n)
    assert set(dp) == set(p["planes"])
    for k in p["planes"]:
        b = np.asarray(ref[k])
        np.testing.assert_allclose(dp[k].numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
    dx = tc.x_backward(xT, gT, tp["planes"], n)
    ref_x = np_bwd_x(x, g, p["planes"])
    np.testing.assert_allclose(dx.T.numpy(), ref_x, rtol=1e-4,
                               atol=1e-5 * np.abs(ref_x).max())


# --------------------------------------- the CP profile's track_frame ----

@pytest.mark.parametrize("n_go", [0, 3])
def test_track_frame_matches_jax_cp_profile(n_go):
    """tests/test_torch_slice.py's track_frame recipe with the field of
    configs/synthetic/orbit_fast_cp.yaml (embed 44, full decoder widths) at
    a tiny camera: the same params, frame and PST, no draws on either side.
    RO alone agrees to float32 rounding; with GO the bound is Adam's lr
    per step."""
    from mipsfusion_tpu.datasets.synthetic import SyntheticDataset
    from mipsfusion_tpu.slam import tracker as jtracker
    from test_smoke_e2e import smoke_config
    jf = dataclasses.replace(_fcfg("cp"), n_range_d=7, n_samples_d=9,
                             near=0.0, far=8.0)
    p = jax.tree.map(np.asarray, jsr.init_field_params(
        jax.random.PRNGKey(0), jf))
    p["planes"] = {k: v * (1e4 if k.startswith("s") else 4.0)
                   for k, v in p["planes"].items()}
    cfg = smoke_config(4)
    ds = SyntheticDataset(cfg, n_frames=4, trajectory="orbit", span=4 / 400)
    frame = np.asarray(ds.packed(1))
    pst = np.asarray(jtracker.make_pst(jax.random.PRNGKey(3),
                                       jtracker.ROConfig(particle_size=64)))
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    setup = (jf, p, frame, pst, bound)
    ref = _track_jax(setup, n_go)
    out = _track_port(setup, n_go)
    assert not np.allclose(ref, np.eye(4), atol=1e-6)   # the pose moved
    np.testing.assert_allclose(out, ref, atol=1e-5 if n_go == 0
                               else n_go * 1e-3)
