"""Parity of the port's rendering and losses (models/scene_rep.py,
ops/losses.py) with the JAX package's transposed training path on the
same numpy inputs: z sampling (with the JAX draw of the stratified
perturbation passed in), SDF losses, forward_losses_T + total_loss and
their gradients w.r.t. a pose. Float32 on both sides; tolerance 1e-5
relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.ops import geometry as jgeo
from mipsfusion_tpu.ops import losses as jlosses
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.ops import geometry as tgeo
from mipsfusion_tpu_torch.ops import losses as tlosses

from test_torch_field import small_fcfg, small_params, torch_tree

torch.set_num_threads(1)
LOSS_KEYS = ("rgb_loss", "depth_loss", "sdf_loss", "fs_loss", "psnr")


def port_fcfg(jf):
    """The port's FieldConfig with the JAX config's values."""
    return tsr.FieldConfig(
        tri=tsr.TriplaneConfig(jf.tri.resolutions, jf.tri.n_features,
                               jf.tri.cp_resolution, jf.tri.cp_components),
        freq=tsr.FrequencyConfig(jf.freq.n_frequencies),
        decoder=tsr.DecoderConfig(
            jf.decoder.input_ch, jf.decoder.input_ch_pos, jf.decoder.n_hidden,
            jf.decoder.n_hidden_rgb, jf.decoder.n_hidden_sdf,
            jf.decoder.n_hidden_branch, jf.decoder.n_class),
        n_range_d=jf.n_range_d, range_d=jf.range_d,
        n_samples_d=jf.n_samples_d, near=jf.near, far=jf.far,
        perturb=jf.perturb, trunc=jf.trunc, sc_factor=jf.sc_factor,
        depth_trunc=jf.depth_trunc, rgb_missing=jf.rgb_missing,
        norm_factor=jf.norm_factor)


def _rays(n=37, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.3, 0.5, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = rng.uniform(size=(n, 3))
    depth = rng.uniform(0.3, 1.5, (n, 1))
    depth[1] = 0.0            # invalid depth exercises the masks
    depth[5] = 9.0            # beyond far
    return [a.astype(np.float32) for a in (o, d, rgb, depth)]


@pytest.fixture(scope="module")
def setup():
    jf = dataclasses.replace(small_fcfg(), n_range_d=7, n_samples_d=9,
                             far=2.5)
    return jf, port_fcfg(jf), small_params(jf)


@pytest.mark.parametrize("perturb", [False, True])
def test_sample_z_vals(setup, perturb):
    jf, tf, _ = setup
    jf = dataclasses.replace(jf, perturb=perturb)
    tf = dataclasses.replace(tf, perturb=perturb)
    _, _, _, d = _rays()
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jsr.sample_z_vals(key, jnp.asarray(d), jf))
    # the draw JAX makes inside sample_z_vals, handed to the port
    u = np.asarray(jax.random.uniform(key, ref.shape, dtype=jnp.float32))
    out = tsr.sample_z_vals(torch.tensor(d), tf, u=torch.tensor(u))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("emd_w", [0.0, 0.01])
def test_sdf_loss_T(emd_w):
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(0, 3, (20, 12)), -1).astype(np.float32)
    d = rng.uniform(0.5, 2.5, (20, 1)).astype(np.float32)
    d[3] = 0.0
    sdf = rng.uniform(-1, 1, (20, 12)).astype(np.float32)
    prob = rng.dirichlet(np.ones(5), (20, 12)).transpose(2, 0, 1)
    prob = prob.astype(np.float32)
    ref = jlosses.get_sdf_loss_T(jnp.asarray(z), jnp.asarray(d),
                                 jnp.asarray(sdf), jnp.asarray(prob), 0.1,
                                 emd_w=emd_w)
    out = tlosses.get_sdf_loss_T(torch.tensor(z), torch.tensor(d),
                                 torch.tensor(sdf), torch.tensor(prob), 0.1,
                                 emd_w=emd_w)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_sdf2weights(setup):
    jf, tf, _ = setup
    rng = np.random.default_rng(5)
    z = np.sort(rng.uniform(0, 3, (30, 16)), -1).astype(np.float32)
    sdf = (1.2 - z + rng.normal(size=z.shape) * 0.05).astype(np.float32)
    sdf[4] = 0.3              # no sign change
    ref = np.asarray(jsr.sdf2weights(jnp.asarray(sdf), jnp.asarray(z), jf))
    out = tsr.sdf2weights(torch.tensor(sdf), torch.tensor(z), tf)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-7)


def _pose_losses_jax(jf, p, quat, trans, rays_d, rgb, d, consts):
    def f(q, t):
        T = jgeo.qt_to_matrix(q, t)
        rays_dT = T[:3, :3] @ jnp.asarray(rays_d).T
        rays_oT = jnp.broadcast_to(T[:3, 3][:, None], rays_dT.shape)
        ret = jsr.forward_losses_T(p, jax.random.PRNGKey(0), rays_oT, rays_dT,
                                   jnp.asarray(rgb).T, jnp.asarray(d), jf,
                                   consts, emd_w=0.01)
        return jsr.total_loss(ret, jsr.LossWeights(1.0, 0.1, 1000.0, 10.0)), ret
    (loss, ret), g = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(quat), jnp.asarray(trans))
    return loss, ret, g


def test_forward_losses_and_pose_grads(setup):
    """forward_losses_T + total_loss values, and their gradients w.r.t. a
    (quaternion, translation) pose through the field, perturb off. The
    normalization keeps every sample (the 9 m ray included) inside
    [0, 1]^3: outside it the
    composite JAX path clips (zero coordinate gradient) where the port,
    like the reference kernels, keeps the tent derivative."""
    jf, tf, p = setup
    _, rays_d, rgb, d = _rays()
    quat = np.array([0.99, 0.05, -0.08, 0.02], np.float32)
    trans = np.array([0.4, 0.35, 0.45], np.float32)
    jc = jsr.FieldConsts(jnp.full(3, -10.0), jnp.full(3, 0.047))
    loss_j, ret_j, (gq_j, gt_j) = _pose_losses_jax(jf, p, quat, trans,
                                                   rays_d, rgb, d, jc)
    tc_ = tsr.FieldConsts(torch.full((3,), -10.0), torch.full((3,), 0.047))
    q = torch.tensor(quat, requires_grad=True)
    t = torch.tensor(trans, requires_grad=True)
    T = tgeo.qt_to_matrix(q, t)
    rays_dT = T[:3, :3] @ torch.tensor(rays_d).T
    rays_oT = T[:3, 3][:, None].expand_as(rays_dT)
    ret = tsr.forward_losses_T(torch_tree(p), rays_oT, rays_dT,
                               torch.tensor(rgb).T, torch.tensor(d), tf, tc_,
                               emd_w=0.01)
    loss = tsr.total_loss(ret, tsr.LossWeights(1.0, 0.1, 1000.0, 10.0))
    loss.backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(ret[k].detach()), float(ret_j[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(gq_j), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(gq_j)).max())
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gt_j), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(gt_j)).max())
