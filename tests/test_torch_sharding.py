"""The port's device mesh and sharded steps (``parallel/sharding.py``)
against the JAX package's on its 8-device CPU mesh: ``make_mesh``'s
raising rule and the virtual mesh, where a tensor's blocks land, the
sharded loss at 1, 2 and 4 shards against ``forward_losses_T``, and the
sharded map and refine steps against JAX's on the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from mipsfusion_tpu.models import scene_rep as jsr
from mipsfusion_tpu.parallel import sharding as jsh
from mipsfusion_tpu.slam import mapper as jmapper
from mipsfusion_tpu_torch.convert import params_from_jax, params_to_numpy
from mipsfusion_tpu_torch.models import scene_rep as tsr
from mipsfusion_tpu_torch.parallel import sharding as tsh
from mipsfusion_tpu_torch.slam import mapper as tmapper

from test_torch_field import small_fcfg, small_params
from test_torch_losses import port_fcfg
from test_torch_multi import _rand_rays

torch.set_num_threads(1)
LW = (1.0, 0.1, 1000.0, 10.0)
BOX = (-10.0, 0.047)              # every sample inside [0, 1]^3


def _jmesh(n):
    assert len(jax.devices()) >= n, "conftest must provide 8 CPU devices"
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def _tconsts():
    return tsr.FieldConsts(torch.full((3,), BOX[0]), torch.full((3,), BOX[1]))


def _jconsts():
    return jsr.FieldConsts(jnp.full(3, BOX[0]), jnp.full(3, BOX[1]))


# ------------------------------------------------------------- the mesh

@pytest.mark.parametrize("visible,ask", [(0, None), (0, 1), (1, 2), (2, 4)])
def test_make_mesh_raises_when_fewer_cards_are_visible(monkeypatch, visible,
                                                       ask):
    """With no device list, the mesh takes visible CUDA devices and raises
    when there are fewer than asked (JAX: a mesh that quietly shrinks
    makes the checks vacuous)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: visible > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    with pytest.raises(ValueError, match="CUDA device"):
        tsh.make_mesh(ask)


def test_make_mesh_takes_the_first_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = tsh.make_mesh(2)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tsh.make_mesh().size == 4 and not mesh.virtual


@pytest.mark.parametrize("n,data_axis,shape,axes", [
    (1, None, (1,), ("data",)), (4, None, (4,), ("data",)),
    (8, 2, (2, 4), ("data", "submap")), (8, 8, (8,), ("data",))])
def test_virtual_mesh(n, data_axis, shape, axes):
    """An explicit list may repeat a device: the virtual mesh of the CPU
    tests; its layout is JAX's make_mesh's."""
    mesh = tsh.make_mesh(data_axis=data_axis, devices=["cpu"] * n)
    ref = jsh.make_mesh(n, data_axis)
    assert mesh.shape == shape == ref.devices.shape
    assert mesh.axis_names == axes == ref.axis_names
    assert mesh.primary == torch.device("cpu") and mesh.virtual == (n > 1)
    assert "virtual" in str(mesh) or n == 1
    with pytest.raises(ValueError):
        tsh.make_mesh(n + 1, devices=["cpu"] * n)


def test_mesh_of_mixed_devices_raises():
    with pytest.raises(ValueError, match="one type"):
        tsh.make_mesh(devices=["cpu", "meta"])


@pytest.mark.parametrize("kind,data_axis", [
    ("ray", None), ("column", None), ("submap", None), ("replicated", None),
    ("ray", 2), ("submap", 2)])
def test_blocks_land_where_jax_puts_them(kind, data_axis):
    """Every device's block of a tensor under each sharding equals the
    shard JAX's NamedSharding gives the same device of its 8-device mesh
    (contiguous blocks along the named axis, replicated along the rest)."""
    x = np.arange(16 * 8 * 3, dtype=np.float32).reshape(16, 8, 3)
    ref_mesh = jsh.make_mesh(8, data_axis)
    mesh = tsh.make_mesh(data_axis=data_axis, devices=["cpu"] * 8)
    jspec, tspec = {"ray": (P("data"), tsh.ray_sharded(mesh)),
                    "column": (P(None, "data"), tsh.column_sharded(mesh)),
                    "submap": (jsh.submap_sharded(ref_mesh).spec,
                               tsh.submap_sharded(mesh)),
                    "replicated": (P(), tsh.replicated(mesh))}[kind]
    arr = jax.device_put(jnp.asarray(x), NamedSharding(ref_mesh, jspec))
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    blocks = tspec.place(torch.tensor(x))
    for dev, blk in zip(ref_mesh.devices.reshape(-1), blocks):
        np.testing.assert_array_equal(blk.numpy(), by_dev[dev])
    n_distinct = len({(b.reshape(-1)[0].item(), tuple(b.shape))
                      for b in blocks})
    assert len(tspec.devices()) == n_distinct
    if kind in ("submap", "replicated"):
        trees = tsh.shard_field_params({"t": {"x": torch.tensor(x)}}, mesh,
                                       stacked=kind == "submap")
        for tree, blk in zip(trees, blocks):
            np.testing.assert_array_equal(tree["t"]["x"].numpy(), blk.numpy())


def test_replicate_params_keeps_the_primary_leaves_and_sums_gradients():
    """On the tensors' own device a copy shares their memory (a tensor
    without a gradient is returned as it is); a loss over every copy
    gives each leaf the sum of the copies' gradients; named tuples keep
    their type."""
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    c = torch.tensor([3.0])
    cpu = [torch.device("cpu")] * 3
    reps = tsh.replicate_params({"w": w, "c": c}, cpu)
    assert all(r["w"].data_ptr() == w.data_ptr() and r["c"] is c
               for r in reps)
    sum((k + 1.0) * r["w"].sum() for k, r in enumerate(reps)).backward()
    np.testing.assert_array_equal(w.grad.numpy(), [6.0, 6.0])
    consts = tsr.FieldConsts(torch.zeros(3), torch.ones(3))
    assert all(type(r) is tsr.FieldConsts
               for r in tsh.replicate_params(consts, cpu))


# ---------------------------------------------------------- the losses

@pytest.fixture(scope="module")
def loss_setup():
    jf = dataclasses.replace(small_fcfg(), n_range_d=5, n_samples_d=6,
                             range_d=0.25, near=0.0, far=2.5, perturb=True)
    rng = np.random.default_rng(11)
    rays = _rand_rays(rng, (48,)).astype(np.float32)
    rays[:5, 6] = 0.0                                   # invalid depths
    u = rng.uniform(size=(48, 11)).astype(np.float32)
    return port_fcfg(jf), small_params(jf), rays, u


def _leaves(p):
    return ([p["planes"][k] for k in sorted(p["planes"])]
            + [p["decoder"][n][k] for n in sorted(p["decoder"])
               for k in ("w", "b")])


@pytest.mark.parametrize("emd_w", [0.01, 0.0])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_loss_matches_forward_losses(loss_setup, n, emd_w):
    """The loss terms and the gradients of the total (field parameters
    and the ray origins and directions) at n shards of a virtual CPU mesh
    against forward_losses_T on the whole batch with the same z
    perturbation: loss rtol 1e-6, gradients atol 1e-6."""
    tf, p, rays, u = loss_setup
    lw = tsr.LossWeights(*LW)
    consts = _tconsts()

    def run(shards):
        field = params_from_jax(p)
        r = torch.tensor(rays)
        o = torch.full((3, r.shape[0]), 0.02, requires_grad=True)
        d = r[:, :3].T.clone().requires_grad_(True)
        if shards is None:
            ret = tsr.forward_losses_T(field.params(), o, d, r[:, 3:6].T,
                                       r[:, 6:7], tf, consts, emd_w=emd_w,
                                       u=torch.tensor(u))
        else:
            devs = [torch.device("cpu")] * shards
            ret = tsr.forward_losses_T_sharded(
                tsh.replicate_params(field.params(), devs),
                tsh.split(o, devs, 1), tsh.split(d, devs, 1),
                tsh.split(r[:, 3:6].T, devs, 1), tsh.split(r[:, 6:7], devs),
                tf, tsh.replicate_params(consts, devs), emd_w=emd_w,
                u=torch.tensor(u))
        total = tsr.total_loss(ret, lw)
        total.backward()
        terms = [float(ret[k].detach()) for k in ("rgb_loss", "depth_loss",
                                         "sdf_loss", "fs_loss", "psnr")]
        return terms, [t.grad for t in _leaves(field.params())] + [o.grad,
                                                                  d.grad]

    ref_terms, ref_grads = run(None)
    terms, grads = run(n)
    np.testing.assert_allclose(terms, ref_terms, rtol=1e-6)
    assert all(abs(t) > 0 for t in ref_terms[:4])
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_sharded_sdf_query_matches(loss_setup):
    """RO's query split by columns over 4 virtual devices gives the
    unsharded sdf."""
    tf, p, _, _ = loss_setup
    params = params_from_jax(p).params(detach=True)
    x = torch.tensor(np.random.default_rng(2).uniform(
        -9.0, 9.0, (3, 96)).astype(np.float32))
    devs = [torch.device("cpu")] * 4
    out = tsr.run_network_sdf_T_sharded(
        tsh.replicate_params(params, devs), x, tf,
        tsh.replicate_params(_tconsts(), devs), devs)
    ref = tsr.run_network_sdf_T(params, x, tf, _tconsts())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


# ----------------------------------------------------- the train steps

@pytest.fixture(scope="module")
def step_setup():
    jf = dataclasses.replace(small_fcfg(), n_range_d=5, n_samples_d=6,
                             range_d=0.25, near=0.0, far=2.5, perturb=False)
    mcfg = dict(lr_embed=0.01, lr_decoder=0.02)
    return jf, port_fcfg(jf), mcfg


def _close_params(field, ref, atol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=atol), params_to_numpy(field), ref)


def test_sharded_map_step_matches_jax(step_setup):
    """One data-parallel map step over 64 rays: JAX's on its 8-device
    mesh, the port's on 8 virtual CPU devices (no draws: perturb off).
    The loss to rtol 1e-5. The parameters: the port's 8-shard step
    against its 1-shard step to 1e-5, and against JAX's 8-shard step to
    1e-4. Adam's first step moves a coordinate by about its lr (1e-2,
    2e-2) whatever its gradient's size, so where a gradient is near zero
    the two packages' roundings show: their unsharded steps differ by
    4.1e-5 on these inputs, their sharded and unsharded steps by 3.7e-6
    (the port) and 5.1e-6 (JAX)."""
    jf, tf, mc = step_setup
    p = small_params(jf)
    rays = _rand_rays(np.random.default_rng(4), (64,)).astype(np.float32)
    jm = jmapper.MapConfig(**mc)
    opt = jmapper.make_map_optimizer(jm)
    jp = jax.tree.map(jnp.asarray, p)
    jp2, _, jloss = jsh.sharded_map_step(
        _jmesh(8), jf, jsr.LossWeights(*LW), opt, jp, opt.init(jp),
        jax.random.PRNGKey(0), jnp.asarray(rays), _jconsts())
    out = {}
    for n in (8, 1):
        field = params_from_jax(p)
        topt = tmapper.make_map_optimizer(field, tmapper.MapConfig(**mc))
        mesh = tsh.make_mesh(devices=["cpu"] * n)
        out[n] = (field, tsh.sharded_map_step(
            mesh, tf, tsr.LossWeights(*LW), field, topt, torch.tensor(rays),
            _tconsts()))
    field, loss = out[8]
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert np.abs(params_to_numpy(field)["decoder"]["sdf1"]["b"]
                  - p["decoder"]["sdf1"]["b"]).max() > 1e-3     # it moved
    _close_params(field, params_to_numpy(out[1][0]), 1e-5)
    _close_params(field, jp2, 1e-4)


def test_sharded_refine_step_matches_jax(step_setup):
    """Eight stacked submaps, each with its own params, rays and consts,
    one step: JAX's vmap over the submap axis on its 8-device mesh, the
    port's loop over slots (slot s on device s % 4 of a virtual CPU
    mesh). Each submap's loss to rtol 1e-5, its parameters to 1e-4 (the
    bound of the map step above: one Adam step on gradients near zero)."""
    jf, tf, mc = step_setup
    M, N = 8, 32
    ps = [small_params(jf, seed=m) for m in range(M)]
    rng = np.random.default_rng(5)
    rays = _rand_rays(rng, (M, N)).astype(np.float32)
    lo = np.full((M, 3), BOX[0], np.float32) + rng.uniform(
        -0.5, 0.5, (M, 1)).astype(np.float32)
    inv = np.full((M, 3), BOX[1], np.float32)
    jm = jmapper.MapConfig(**mc)
    opt = jmapper.make_map_optimizer(jm)
    stacked = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x)
                                                  for x in xs]), *ps)
    state = jax.vmap(opt.init)(stacked)
    step = jsh.make_sharded_refine_step(_jmesh(8), jf, jsr.LossWeights(*LW),
                                        opt)
    jp2, _, jloss = step(stacked, state,
                         jax.random.split(jax.random.PRNGKey(0), M),
                         jnp.asarray(rays), jnp.asarray(lo), jnp.asarray(inv))
    mesh = tsh.make_mesh(devices=["cpu"] * 4)
    fields = [params_from_jax(pm) for pm in ps]
    opts = [tmapper.make_map_optimizer(f, tmapper.MapConfig(**mc))
            for f in fields]
    consts = [tsr.FieldConsts(torch.tensor(lo[m]), torch.tensor(inv[m]))
              for m in range(M)]
    losses = tsh.make_sharded_refine_step(mesh, tf, tsr.LossWeights(*LW))(
        fields, opts, torch.tensor(rays), consts)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jloss), rtol=1e-5)
    for m in range(M):
        _close_params(fields[m], jax.tree.map(lambda x: x[m], jp2), 1e-4)
