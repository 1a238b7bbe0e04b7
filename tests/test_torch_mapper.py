"""Parity of the port's optimizers and sampling rules with the JAX package:
the map Adam (two groups: decoder with weight decay 1e-6, planes with
eps 1e-15, betas (0.9, 0.99)) and the pose Adam against optax over fixed
gradient steps, the BA keyframe quotas, the RO/GO pixel grids and the
antithetic particle template."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mipsfusion_tpu.slam import mapper as jmapper
from mipsfusion_tpu.slam import tracker as jtracker
from mipsfusion_tpu_torch.convert import params_from_jax
from mipsfusion_tpu_torch.slam import mapper as tmapper
from mipsfusion_tpu_torch.slam import tracker as ttracker

from test_torch_field import small_fcfg, small_params

torch.set_num_threads(1)


@pytest.mark.parametrize("n_steps", [1, 6])
def test_map_adam_matches_optax(n_steps):
    """After n fixed-gradient steps the params agree to float32 rounding
    (relative 1e-5 of each leaf's scale)."""
    p = small_params(small_fcfg(), scale=False)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.1
                                     ).astype(np.float32), p)
             for _ in range(n_steps)]
    mcfg = jmapper.MapConfig(lr_embed=0.01, lr_decoder=0.02)
    opt = jmapper.make_map_optimizer(mcfg)
    jp = jax.tree.map(jnp.asarray, p)
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)

    field = params_from_jax(p)
    topt = tmapper.make_map_optimizer(
        field, tmapper.MapConfig(lr_embed=0.01, lr_decoder=0.02))
    tp = field.params()
    for g in grads:
        for k, v in tp["planes"].items():
            v.grad = torch.tensor(g["planes"][k])
        for n, d in tp["decoder"].items():
            for k, v in d.items():
                v.grad = torch.tensor(g["decoder"][n][k])
        topt.step()
    pairs = [(tp["planes"][k], jp["planes"][k]) for k in jp["planes"]]
    pairs += [(tp["decoder"][n][k], jp["decoder"][n][k])
              for n in jp["decoder"] for k in ("w", "b")]
    for a, b in pairs:
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_pose_adam_matches_optax():
    """MaskedAdam against optax.adam per group (rot, trans), with a masked
    (discarded) step in the middle as the reference applies it."""
    rng = np.random.default_rng(1)
    q0 = np.array([0.9, 0.1, -0.2, 0.3], np.float32)
    t0 = np.array([0.5, -0.2, 1.0], np.float32)
    gs = [(rng.normal(size=4).astype(np.float32),
           rng.normal(size=3).astype(np.float32)) for _ in range(5)]
    mask = [True, True, False, True, True]
    opt = jtracker._pose_optim(jtracker.GOConfig(lr_rot=0.002,
                                                 lr_trans=0.003))
    jp = {"rot": jnp.asarray(q0), "trans": jnp.asarray(t0)}
    st = opt.init(jp)
    for (gq, gt), do in zip(gs, mask):
        upd, new = opt.update({"rot": gq, "trans": gt}, st, jp)
        if do:
            jp, st = optax.apply_updates(jp, upd), new
    p = [torch.tensor(q0), torch.tensor(t0)]
    adam = ttracker.MaskedAdam(p, [0.002, 0.003])
    for (gq, gt), do in zip(gs, mask):
        p = adam.step(p, [torch.tensor(gq), torch.tensor(gt)],
                      torch.tensor(do))
    np.testing.assert_allclose(p[0].numpy(), np.asarray(jp["rot"]),
                               atol=1e-6)
    np.testing.assert_allclose(p[1].numpy(), np.asarray(jp["trans"]),
                               atol=1e-6)


@pytest.mark.parametrize("n_kf", [1, 2, 5])
def test_kf_sampling_weights(n_kf):
    K = 8
    mask = np.arange(K) < n_kf
    ref, _ = jmapper._kf_sampling_weights(jnp.asarray(mask), 0, n_kf - 1,
                                          1800, 800)
    out = tmapper.kf_sampling_weights(torch.tensor(mask), 0,
                                      torch.tensor(n_kf - 1), 1800, 800)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_pixel_grids():
    """The deterministic pixel sets: RO's grid and GO's grid when the ray
    budget equals the grid (no random pixels)."""
    rcfg_j = jtracker.ROConfig(n_rows=16, n_cols=24)
    rcfg_t = ttracker.ROConfig(n_rows=16, n_cols=24)
    for H, W in ((240, 320), (60, 80), (40, 56)):
        jr, jc = jtracker.ro_pixel_grid(H, W, rcfg_j)
        tr, tc = ttracker.ro_pixel_grid(H, W, rcfg_t)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        depth = np.ones((H, W), np.float32)
        jr, jc = jtracker.sample_pixels_mix(jax.random.PRNGKey(0), H, W, 16,
                                            24, jnp.asarray(depth), 384,
                                            edge_h=20, edge_w=20)
        tr, tc = ttracker.sample_pixels_mix(None, H, W, 16, 24,
                                            torch.tensor(depth), 384,
                                            edge_h=20, edge_w=20)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_make_pst_antithetic():
    g = torch.Generator()
    g.manual_seed(0)
    pst = ttracker.make_pst(g, ttracker.ROConfig(particle_size=2000))
    assert pst.shape == (2000, 6)
    assert torch.all(pst[:2] == 0)                   # identity rows
    assert torch.all(pst.abs() <= 2.0)
    torch.testing.assert_close(pst[2:1001], -pst[1001:])
    assert float(pst.mean(0).abs().max()) < 1e-7
