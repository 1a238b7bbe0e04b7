"""The CUDA kernels on the card, against their plain PyTorch versions, at
every field shape the kernels are compiled for (``_build.SHAPES``: the
flagship's, the CP profile's and the FastCaMo-large family's).

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. This file imports neither jax nor the JAX package, so it also
runs on a GPU machine without jax, where tests/conftest.py (which imports
jax) must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

import chip_smoke
from mipsfusion_tpu_torch.ops import _build
from mipsfusion_tpu_torch.ops import field_cuda as fc
from mipsfusion_tpu_torch.ops import triplane_cuda as tc

pytestmark = pytest.mark.cuda
SHAPES = ("flag", "cp", "fcl")


@pytest.fixture(scope="module", params=SHAPES)
def card(request):
    """(device, params at the shape, (n_scales, PE bands, classes), E)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    prm = chip_smoke.field_params(request.param, 0, dev)
    ns = sum(k.startswith("s") for k in prm["planes"])
    E = 4 * ns + prm["planes"]["cp"].shape[-1]
    return dev, prm, (ns, 8, 5), E


def test_forward_kernels_match_plain(card):
    dev, prm, META, E = card
    x = chip_smoke.test_points(20_000, 1, dev)
    planes, dec = prm["planes"], prm["decoder"]
    out, emb = fc.field_forward(x, planes, dec, *META, return_embed=True)
    ref, ref_emb = fc.field_forward_plain(x, planes, dec, *META,
                                          return_embed=True)
    assert chip_smoke._err(out, ref)[1] < 2e-5
    assert chip_smoke._err(emb, ref_emb)[1] < 2e-5
    sdf = fc.field_forward(x, planes, dec, *META, sdf_only=True)
    assert chip_smoke._err(sdf[0], ref[3])[1] < 2e-5


def test_backward_kernels_match_plain(card):
    """K2 with a cotangent that is zero near ReLU kinks (see
    chip_smoke.kink_free), K3 (fixed-point atomics) and K4, relative
    1e-4."""
    dev, prm, META, E = card
    ns = META[0]
    x = chip_smoke.test_points(20_000, 2, dev)
    planes, dec = prm["planes"], prm["decoder"]
    _, emb = fc.field_forward(x, planes, dec, *META, return_embed=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = torch.randn((10, x.shape[1]), generator=gen, device=dev) * 0.1
    g, _ = chip_smoke.kink_free(g, x, emb, dec)
    k2 = fc.decoder_backward(x, g, emb, dec, 8, 5)
    r2 = fc.decoder_backward_plain(x, g, emb, dec, 8, 5)
    assert chip_smoke._err(k2[0], r2[0])[1] < 1e-4
    assert chip_smoke._err(k2[1], r2[1])[1] < 1e-4
    for n in k2[2]:
        for k in ("w", "b"):
            assert chip_smoke._err(k2[2][n][k], r2[2][n][k])[1] < 1e-4
    d = torch.randn((E, x.shape[1]), generator=gen, device=dev) * 0.1
    k3 = tc.plane_backward(x, d, planes, ns)
    r3 = tc.plane_backward_plain(x, d, planes, ns)
    for k in k3:
        assert chip_smoke._err(k3[k], r3[k])[1] < 1e-4
    assert chip_smoke._err(tc.x_backward(x, d, planes, ns),
                           tc.x_backward_plain(x, d, planes, ns))[1] < 1e-4


def test_backward_kernels_match_plain_on_ray_points(card):
    """K2 (with weight gradients and in the GO form without them), K3 and
    K4 on ray-ordered points, where a warp's lanes share cells
    (chip_smoke.ray_points), relative 1e-4."""
    dev, prm, META, E = card
    ns = META[0]
    x = chip_smoke.ray_points(300, 75, 3, dev)
    planes, dec = prm["planes"], prm["decoder"]
    _, emb = fc.field_forward(x, planes, dec, *META, return_embed=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    g = torch.randn((10, x.shape[1]), generator=gen, device=dev) * 0.1
    g, _ = chip_smoke.kink_free(g, x, emb, dec)
    r2 = fc.decoder_backward_plain(x, g, emb, dec, 8, 5)
    k2 = fc.decoder_backward(x, g, emb, dec, 8, 5)
    assert chip_smoke._err(k2[0], r2[0])[1] < 1e-4
    assert chip_smoke._err(k2[1], r2[1])[1] < 1e-4
    for n in k2[2]:
        for k in ("w", "b"):
            assert chip_smoke._err(k2[2][n][k], r2[2][n][k])[1] < 1e-4
    k2 = fc.decoder_backward(x, g, emb, dec, 8, 5, weight_grads=False)
    assert k2[2] is None
    assert chip_smoke._err(k2[0], r2[0])[1] < 1e-4
    assert chip_smoke._err(k2[1], r2[1])[1] < 1e-4
    d = torch.randn((E, x.shape[1]), generator=gen, device=dev) * 0.1
    k3 = tc.plane_backward(x, d, planes, ns)
    r3 = tc.plane_backward_plain(x, d, planes, ns)
    for k in k3:
        assert chip_smoke._err(k3[k], r3[k])[1] < 1e-4
    assert chip_smoke._err(tc.x_backward(x, d, planes, ns),
                           tc.x_backward_plain(x, d, planes, ns))[1] < 1e-4


def test_k2_k3_give_the_same_bits_every_call(card):
    """K2 (fixed-order partial sums) and K3 (fixed-point integer atomics)
    return bitwise equal results when called twice on ray-ordered points,
    where K3's atomics contend most."""
    dev, prm, META, E = card
    ns = META[0]
    x = chip_smoke.ray_points(300, 75, 4, dev)
    planes, dec = prm["planes"], prm["decoder"]
    _, emb = fc.field_forward(x, planes, dec, *META, return_embed=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    g = torch.randn((10, x.shape[1]), generator=gen, device=dev) * 0.1
    d = torch.randn((E, x.shape[1]), generator=gen, device=dev) * 0.1
    a, b = (fc.decoder_backward(x, g, emb, dec, 8, 5) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for n in a[2]:
        for k in ("w", "b"):
            assert torch.equal(a[2][n][k], b[2][n][k])
    a, b = (tc.plane_backward(x, d, planes, ns) for _ in range(2))
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("points", ["snake", "go_rays"])
def test_k2_gives_the_same_bits_every_call_in_both_instances(card, points):
    """K2 with weight gradients at the scale profile's BA size (55,536
    points: blocks walk 6 or 7 tiles) and without them on the GO's
    ray-ordered points: bitwise equal results on two calls."""
    dev, prm, META, E = card
    x = (chip_smoke.test_points(55_536, 8, dev) if points == "snake"
         else chip_smoke.ray_points(1000, 75, 9, dev))
    planes, dec = prm["planes"], prm["decoder"]
    _, emb = fc.field_forward(x, planes, dec, *META, return_embed=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    g = torch.randn((10, x.shape[1]), generator=gen, device=dev) * 0.1
    for wg in (True, False):
        a, b = ([t for t in chip_smoke._flat(fc.decoder_backward(
            x, g, emb, dec, 8, 5, weight_grads=wg)) if t is not None]
                for _ in range(2))
        assert len(a) == (12 if wg else 2)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("n", [195_001, 63, 16, 1])
def test_k2_matches_plain_at_ragged_sizes(card, n):
    """K2 (64-point tiles, a persistent grid of at most one block an SM)
    at point counts that are no multiple of a tile, with and without
    weight gradients, against the plain backward: relative 1e-4, on a
    cotangent that is zero near ReLU kinks (chip_smoke.kink_free)."""
    dev, prm, META, E = card
    x = chip_smoke.test_points(n, 9, dev)
    planes, dec = prm["planes"], prm["decoder"]
    _, emb = fc.field_forward(x, planes, dec, *META, return_embed=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    g = torch.randn((10, n), generator=gen, device=dev) * 0.1
    g, _ = chip_smoke.kink_free(g, x, emb, dec)
    for wg in (True, False):
        got = fc.decoder_backward(x, g, emb, dec, 8, 5, weight_grads=wg)
        want = fc.decoder_backward_plain(x, g, emb, dec, 8, 5,
                                         weight_grads=wg)
        assert (got[2] is None) == (not wg)
        got, want = ([t for t in chip_smoke._flat(r) if t is not None]
                     for r in (got, want))
        assert len(got) == len(want) == (12 if wg else 2)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert chip_smoke._err(a, b)[1] < 1e-4


def test_k2_packed_weights_match_plain_packer(card):
    """K2's packer writes exactly what the plain packer (the one the CPU
    tests hold to place every weight once a direction) writes."""
    dev, prm, META, E = card
    shape = _build.kernel_shape(prm["planes"], META[0])
    assert shape.size("decoder_wt_size") == shape.k2_packed_size
    assert torch.equal(fc.pack_k2_weights(prm["decoder"], shape),
                       fc.pack_k2_weights_plain(prm["decoder"], shape))


@pytest.mark.parametrize("n", [195_001, 63, 16, 1])
def test_k1_k4_match_plain_at_ragged_sizes(card, n):
    """K1's three modes (persistent grid, 16-point tiles a warp) and K4
    (32-point blocks, with and without the added d_x_pe) at point counts
    that are no multiple of a tile: relative 2e-5 and 1e-4."""
    dev, prm, META, E = card
    ns = META[0]
    x = chip_smoke.test_points(n, 7, dev)
    planes, dec = prm["planes"], prm["decoder"]
    for mode in ({"return_embed": True}, {}, {"sdf_only": True}):
        got = fc.field_forward(x, planes, dec, *META, **mode)
        want = fc.field_forward_plain(x, planes, dec, *META, **mode)
        for a, b in zip(chip_smoke._flat(got), chip_smoke._flat(want)):
            assert a.shape == b.shape
            assert chip_smoke._err(a, b)[1] < 2e-5
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    d = torch.randn((E, n), generator=gen, device=dev) * 0.1
    add = torch.randn((3, n), generator=gen, device=dev)
    assert chip_smoke._err(tc.x_backward(x, d, planes, ns),
                           tc.x_backward_plain(x, d, planes, ns))[1] < 1e-4
    assert chip_smoke._err(
        tc.x_backward(x, d, planes, ns, d_x_pe=add),
        tc.x_backward_plain(x, d, planes, ns, d_x_pe=add))[1] < 1e-4


def test_k1_k4_give_the_same_bits_every_call(card):
    """K1 (fixed summation order in registers) and K4 (quad shuffles in a
    fixed order) return bitwise equal results when called twice."""
    dev, prm, META, E = card
    ns = META[0]
    x = chip_smoke.ray_points(300, 75, 5, dev)
    planes, dec = prm["planes"], prm["decoder"]
    for mode in ({"return_embed": True}, {}, {"sdf_only": True}):
        a, b = (chip_smoke._flat(fc.field_forward(x, planes, dec, *META,
                                                  **mode)) for _ in range(2))
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    d = torch.randn((E, x.shape[1]), generator=gen, device=dev) * 0.1
    add = torch.randn((3, x.shape[1]), generator=gen, device=dev)
    for kw in ({}, {"d_x_pe": add}):
        a, b = (tc.x_backward(x, d, planes, ns, **kw) for _ in range(2))
        assert torch.equal(a, b)


def test_k1_packed_weights_match_plain_packer(card):
    """The kernel's packer writes exactly what the plain packer (the one
    the CPU tests hold to be a permutation) writes."""
    dev, prm, META, E = card
    shape = _build.kernel_shape(prm["planes"], META[0])
    assert torch.equal(fc.pack_decoder_weights(prm["decoder"], shape),
                       fc.pack_decoder_weights_plain(prm["decoder"], shape))


def test_k1_empty_input(card):
    dev, prm, META, E = card
    x = torch.empty((3, 0), device=dev)
    out, emb = fc.field_forward(x, prm["planes"], prm["decoder"], *META,
                                return_embed=True)
    assert out.shape == (10, 0) and emb.shape == (E, 0)
    d = torch.empty((E, 0), device=dev)
    assert tc.x_backward(x, d, prm["planes"], META[0]).shape == (3, 0)


def test_encode_kernel_and_op_match_plain(card):
    """K0 against the plain encode (relative 2e-5), and TriplaneEncode's
    plane, CP and x gradients (K3, K4) against autograd of the plain
    encode on interior points (relative 1e-4)."""
    dev, prm, META, E = card
    ns = META[0]
    x = chip_smoke.test_points(20_000, 4, dev).T.contiguous()
    planes = prm["planes"]
    assert chip_smoke._err(tc.encode_forward(x, planes, ns),
                           tc.encode_forward_plain(planes, x, ns))[1] < 2e-5
    xi = chip_smoke.test_points(20_000, 5, dev, inside_only=True).T
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    G = torch.randn((xi.shape[0], E), generator=gen, device=dev)

    def grads(fn):
        pl = {k: v.detach().clone().requires_grad_(True)
              for k, v in planes.items()}
        xx = xi.detach().clone().requires_grad_(True)
        (fn(pl, xx, ns) * G).sum().backward()
        return [pl[k].grad for k in sorted(pl)] + [xx.grad]

    for a, b in zip(grads(tc.triplane_encode),
                    grads(tc.encode_forward_plain)):
        assert chip_smoke._err(a, b)[1] < 1e-4


@pytest.mark.parametrize("points", ["195001", "63", "rays"])
def test_encode_kernel_matches_plain_at_ragged_sizes_and_on_rays(card,
                                                                 points):
    """K0 at point counts that are no multiple of its 512-lane tiles and on
    ray-ordered points (each ray's samples contiguous): relative 2e-5, and
    the same bits on a second call."""
    dev, prm, META, E = card
    x = (chip_smoke.ray_points(300, 75, 7, dev) if points == "rays"
         else chip_smoke.test_points(int(points), 8, dev)).T.contiguous()
    planes = prm["planes"]
    out = tc.encode_forward(x, planes, META[0])
    assert out.shape == (x.shape[0], E)
    assert chip_smoke._err(out, tc.encode_forward_plain(planes, x,
                                                        META[0]))[1] < 2e-5
    assert torch.equal(out, tc.encode_forward(x, planes, META[0]))


def test_encode_kernel_gives_k1s_embed_bits(card):
    """K0 and K1's embed output are built from the same lookups (common.cuh
    scale_lookup, cp_lookup4; K0 reads staged tables, K1 reads device
    memory): on the same points and planes they agree bit for bit, so K0
    is the oracle of K1's encode stage."""
    dev, prm, META, E = card
    for x in (chip_smoke.test_points(30_001, 9, dev),
              chip_smoke.ray_points(400, 75, 10, dev)):
        enc = tc.encode_forward(x.T.contiguous(), prm["planes"], META[0])
        _, emb = fc.field_forward(x, prm["planes"], prm["decoder"], *META,
                                  return_embed=True)
        assert torch.equal(enc, emb.T)


def test_encode_launch_plan_fits_the_card(card):
    """K0's plan on this card: one block an SM split across the roles, the
    dynamic shared memory within a block's 232,448 bytes, and the library's
    own figure for it equal to the plan's."""
    dev, prm, META, E = card
    shape = _build.kernel_shape(prm["planes"], META[0])
    n_sm = _build.sm_count(dev)
    plan = shape.encode_plan(n_sm)
    assert sum(plan.blocks) == n_sm
    assert plan.smem <= 232_448
    assert shape.size("encode_smem_size") == plan.smem
    assert _build.encode_args(shape, dev) == plan.blocks


def test_encode_backward_launches_only_what_is_asked(card):
    """TriplaneEncode's backward launches K3 only when a plane or the CP
    lines need a gradient and K4 only when x does."""
    dev, prm, META, E = card
    xi = chip_smoke.test_points(4_096, 6, dev, inside_only=True).T
    planes = {k: v.detach().clone() for k, v in prm["planes"].items()}
    for x_grad, planes_grad, want in ((True, False, (0, 1)),
                                      (False, True, (1, 0)),
                                      (True, True, (1, 1))):
        pl = {k: v.clone().requires_grad_(planes_grad)
              for k, v in planes.items()}
        xx = xi.detach().clone().requires_grad_(x_grad)
        out = tc.triplane_encode(pl, xx, META[0])
        fc.reset_launch_counts()
        out.sum().backward()
        torch.cuda.synchronize()
        assert (tc.plane_backward.launches, tc.x_backward.launches) == want


def test_kernels_raise_on_other_widths(card):
    """A CUDA tensor launches the kernel or raises: a field shape outside
    the kernels' table (here the JAX Pallas tests' (16, 32) + CP 64 x 24)
    raises, naming the shapes the table holds, instead of falling back to
    the plain version; so do other PE bands and a table shape's planes
    with another CP width."""
    dev, prm, META, E = card
    x = chip_smoke.test_points(256, 3, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    small = {"s0": torch.rand((3, 16, 16, 4), generator=gen, device=dev),
             "s1": torch.rand((3, 32, 32, 4), generator=gen, device=dev),
             "cp": torch.rand((3, 64, 24), generator=gen, device=dev)}
    d = torch.zeros((32, x.shape[1]), device=dev)
    for call in (lambda: fc.field_forward(x, small, prm["decoder"], 2, 8, 5),
                 lambda: tc.encode_forward(x.T.contiguous(), small, 2),
                 lambda: tc.plane_backward(x, d, small, 2),
                 lambda: tc.x_backward(x, d, small, 2)):
        with pytest.raises(ValueError, match="shapes only"):
            call()
    planes = dict(prm["planes"])
    planes["cp"] = planes["cp"][:, :, :24].contiguous()
    with pytest.raises(ValueError, match="shapes only"):
        fc.field_forward(x, planes, prm["decoder"], *META)
    with pytest.raises(ValueError):
        fc.field_forward(x, prm["planes"], prm["decoder"], META[0], 4, 5)


# ------------------------------------------------- several devices ----

def test_virtual_mesh_sharded_loss_matches_unsharded(card):
    """A virtual 2-shard mesh on one card (["cuda:0", "cuda:0"]): the
    loss of 2,600 ray-ordered rays split in two shards against the
    unsharded loss with the same z perturbation, through K1-K4 (rtol
    1e-5 on the loss; the gradients of every field parameter within 1e-4
    of their scale: K3's fixed-point scale comes from each call's own
    gradient maximum, so shards round apart from one call)."""
    from mipsfusion_tpu_torch.models import scene_rep as sr
    from mipsfusion_tpu_torch.parallel import sharding as sh
    dev, prm, META, E = card
    ns = META[0]
    cfg = sr.FieldConfig(tri=sr.TriplaneConfig(
        tuple(prm["planes"][f"s{s}"].shape[1] for s in range(ns)), 4,
        prm["planes"]["cp"].shape[1], prm["planes"]["cp"].shape[2]),
        decoder=sr.DecoderConfig(input_ch=E, input_ch_pos=51))
    mesh = sh.make_mesh(devices=["cuda:0", "cuda:0"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    n = 2600
    d = torch.nn.functional.normalize(
        torch.randn((3, n), generator=gen, device=dev), dim=0)
    o = torch.zeros((3, n), device=dev)
    rgb = torch.rand((3, n), generator=gen, device=dev)
    depth = torch.rand((n, 1), generator=gen, device=dev) * 3.0 + 0.5
    u = torch.rand((n, cfg.n_range_d + cfg.n_samples_d), generator=gen,
                   device=dev)
    consts = sr.FieldConsts(torch.full((3,), -4.0, device=dev),
                            torch.full((3,), 0.125, device=dev))

    def run(shards):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in prm["planes"].items()}
        params = {"planes": leaves, "decoder": prm["decoder"]}
        fc.reset_launch_counts()
        if shards is None:
            ret = sr.forward_losses_T(params, o, d, rgb, depth, cfg, consts,
                                      u=u)
        else:
            devs = sh.ray_sharded(mesh).devices()
            ret = sr.forward_losses_T_sharded(
                sh.replicate_params(params, devs), sh.split(o, devs, 1),
                sh.split(d, devs, 1), sh.split(rgb, devs, 1),
                sh.split(depth, devs), cfg,
                sh.replicate_params(consts, devs), u=u)
        loss = sr.total_loss(ret, sr.LossWeights())
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), leaves, fc.launch_counts(by_device=True)

    ref_loss, ref_g, _ = run(None)
    loss, g, counts = run(2)
    assert torch.isclose(loss, ref_loss, rtol=1e-5)
    for k in g:
        scale = ref_g[k].grad.abs().max()
        assert (g[k].grad - ref_g[k].grad).abs().max() <= 1e-4 * scale
    assert counts["field_forward"] == {0: 2}
    assert counts["plane_backward"] == {0: 2}


def test_kernels_on_a_second_card_give_the_first_cards_bits(card):
    """K1-K4 launched on cuda:1 (their shared-memory limit raised there,
    on that device's stream) give cuda:0's bits at the BA label (195,000
    uniform points), and count their launches on device 1. Needs two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev, prm, META, E = card
    ns = META[0]

    def run(device):
        p = {"planes": {k: v.to(device) for k, v in prm["planes"].items()},
             "decoder": {n: {k: v.to(device) for k, v in d.items()}
                         for n, d in prm["decoder"].items()}}
        x = chip_smoke.test_points(195_000, 1, dev).to(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        g = (torch.randn((10, x.shape[1]), generator=gen, device=dev)
             * 0.1).to(device)
        de = (torch.randn((E, x.shape[1]), generator=gen, device=dev)
              * 0.1).to(device)
        out, emb = fc.field_forward(x, p["planes"], p["decoder"], *META,
                                    return_embed=True)
        k2 = fc.decoder_backward(x, g, emb, p["decoder"], 8, 5)
        k3 = tc.plane_backward(x, de, p["planes"], ns)
        k4 = tc.x_backward(x, de, p["planes"], ns)
        torch.cuda.synchronize(device)
        return [t.cpu() for t in chip_smoke._flat((out, emb, k2, k3, k4))]

    fc.reset_launch_counts()
    first = run(torch.device("cuda", 0))
    second = run(torch.device("cuda", 1))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    counts = fc.launch_counts(by_device=True)
    for name in ("field_forward", "decoder_backward", "plane_backward",
                 "x_backward"):
        assert counts[name] == {0: 1, 1: 1}, (name, counts[name])


# ------------------------------------------------- the hash-grid shape ----

@pytest.fixture(scope="module")
def hash_card():
    """(device, params at the hash shape: 16 x 2 levels, 2^19 rows, a table
    drawn U(-1, 1); the grid's config)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    return (dev, chip_smoke.field_params("hash", 0, dev),
            chip_smoke.field_config("hash").grid)


def _hash_points(label, dev):
    """x [3, N] at BA's 195,000 points, RO's 768,000 sdf points, a count
    that is no multiple of a block, and BA's ray-ordered points."""
    if label == "rays":
        return chip_smoke.ray_points(2600, 75, 8, dev)
    return chip_smoke.test_points(int(label), 1, dev)


@pytest.mark.parametrize("points", ["195000", "768000", "195001", "rays"])
def test_hash_kernels_match_plain(hash_card, points):
    """H1 against ``_hash_forward`` (8 corners blended in the plain order:
    relative 2e-5), H3 against ``_hash_backward``'s d_x plus d_x_pe (16
    levels x 8 corners in another order: relative 1e-4), and H2's table
    gradient equal to the plain one bit for bit (the same int64 sums)."""
    from mipsfusion_tpu_torch.ops import encoding as enc
    from mipsfusion_tpu_torch.ops import hash_cuda as hc
    dev, prm, grid = hash_card
    table = prm["hash"]
    x = _hash_points(points, dev)
    n = x.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    g = torch.randn((32, n), generator=gen, device=dev) * 0.1
    d_x_pe = torch.randn((3, n), generator=gen, device=dev)
    assert chip_smoke._err(hc.hash_forward(x, table, grid),
                           enc._hash_forward(table, x.T, grid).T)[1] < 2e-5
    want = d_x_pe + enc._hash_backward(table, x.T, g.T, grid, True,
                                       False)[0].T
    assert chip_smoke._err(hc.hash_x_backward(x, g, table, grid, d_x_pe),
                           want)[1] < 1e-4
    assert torch.equal(hc.hash_table_backward(x, g, table, grid),
                       enc._hash_backward(table, x.T, g.T, grid, False,
                                          True)[1])


def test_hash_kernels_give_the_same_bits_every_call(hash_card):
    """H1-H3 on ray-ordered points, where H2's atomics contend most: the
    same bits on two calls."""
    from mipsfusion_tpu_torch.ops import hash_cuda as hc
    dev, prm, grid = hash_card
    table = prm["hash"]
    x = chip_smoke.ray_points(300, 75, 4, dev)
    g = torch.randn((32, x.shape[1]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    for fn in (lambda: hc.hash_forward(x, table, grid),
               lambda: hc.hash_table_backward(x, g, table, grid),
               lambda: hc.hash_x_backward(x, g, table, grid)):
        assert torch.equal(fn(), fn())


@pytest.mark.parametrize("points", ["195000", "rays"])
def test_k1_k2_at_the_hash_shape_match_plain(hash_card, points):
    """K1 on H1's embed (E = 32) against the plain decoder (relative 2e-5,
    sdf only too) and K2 at E = 32 against ``decoder_backward_plain``
    with and without weight gradients (a cotangent zero near ReLU kinks:
    relative 1e-4)."""
    from mipsfusion_tpu_torch.models.decoder import decoder_apply
    from mipsfusion_tpu_torch.ops.encoding import frequency_encode
    dev, prm, grid = hash_card
    dec = prm["decoder"]
    x = _hash_points(points, dev)
    emb = fc.hash_forward(x, prm["hash"], grid)
    pe = torch.cat([x.T, frequency_encode(x.T, 8)], dim=-1)
    ref = decoder_apply(dec, emb.T, pe, 5).T
    assert chip_smoke._err(fc.field_forward_embed(x, emb, dec, 8, 5),
                           ref)[1] < 2e-5
    sdf = fc.field_forward_embed(x, emb, dec, 8, 5, sdf_only=True)
    assert chip_smoke._err(sdf[0], ref[3])[1] < 2e-5
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    g = torch.randn((10, x.shape[1]), generator=gen, device=dev) * 0.1
    g, _ = chip_smoke.kink_free(g, x, emb, dec)
    r2 = fc.decoder_backward_plain(x, g, emb, dec, 8, 5)
    for wg in (True, False):
        k2 = fc.decoder_backward(x, g, emb, dec, 8, 5, weight_grads=wg)
        assert chip_smoke._err(k2[0], r2[0])[1] < 1e-4
        assert chip_smoke._err(k2[1], r2[1])[1] < 1e-4
        if wg:
            for n in k2[2]:
                for k in ("w", "b"):
                    assert chip_smoke._err(k2[2][n][k],
                                           r2[2][n][k])[1] < 1e-4


# K1's and K2's outputs at every Triplane shape (chip_smoke.triplane_digests:
# the BA, RO and GO sizes of each shape's labels) as the tree before the
# hash shape gave them on an NVIDIA H100 80GB HBM3: adding the hash shape
# changed none of their bits
TRIPLANE_DIGESTS = {
    "flag": {"field_forward": "712e261c65ff1a80",
             "field_forward_sdf": "63330de3e57ded2e",
             "decoder_backward": "75d4cd5224edd850",
             "decoder_backward_go": "bcaffe7d64e56488"},
    "cp": {"field_forward": "71059552a2ab6c1d",
           "field_forward_sdf": "22ae15bf314ef220",
           "decoder_backward": "7dabe9ee8d476e7e",
           "decoder_backward_go": "fa87a0e52ecc43b7"},
    "fcl": {"field_forward": "d7d7c902561fbc3d",
            "field_forward_sdf": "af9d4ccef357621d",
            "decoder_backward": "2301c8b2d211c335",
            "decoder_backward_go": "e8d2c7c18e0b17b0"},
}


def test_triplane_k1_k2_bits_are_unchanged(hash_card):
    """Every Triplane shape's K1 and K2 outputs at the smoke's labels carry
    the digests recorded before the hash shape existed (on an H100)."""
    if "H100" not in torch.cuda.get_device_name(0):
        pytest.skip("the digests were recorded on an H100")
    assert chip_smoke.triplane_digests() == TRIPLANE_DIGESTS
