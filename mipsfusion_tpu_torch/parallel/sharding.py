"""Multi-device parallelism: the device mesh, how a tensor splits over it,
and the sharded train steps.

Port of ``mipsfusion_tpu/parallel/sharding.py``. The JAX system is one
controller: the manager, ICP, PGO, checkpoints and the mesher run once,
and XLA inserts the collectives from sharding annotations. The port keeps
that shape: one process drives a ``Mesh`` of devices, and data moves
between them with differentiable ``.to(device)``. Autograd sums each
replica's gradient into the primary device's leaf, which plays the part
of JAX's gradient all-reduce.

  * **Ray data-parallelism** (the ``data`` axis): a ray batch splits into
    contiguous blocks, one per device (as ``P("data")`` places it); field
    and pose parameters are replicated; each loss term comes back to the
    primary device as a partial sum (``scene_rep.forward_losses_T_sharded``).
  * **Submap parallelism**: background refinement of every inactive submap
    in one step, slot ``s`` on device ``s % n`` with no traffic between
    slots (``make_sharded_refine_step``; the system's
    ``_inactive_refine_sharded``).

A mesh is an explicit device list and may name a device more than once: a
virtual mesh (``["cpu"] * n`` in the CPU tests, ``["cuda:0", "cuda:0"]``
on a one-card machine) runs every line of the sharded path, and its copies
between devices are no-ops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _device(d) -> torch.device:
    """``d`` as a torch.device with its CUDA ordinal filled in."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out row-major over ``axis_names``: ("data",) with
    shape (n,), or ("data", "submap") with shape (data, n // data).
    ``devices[0]`` is the primary device, where the host's state and the
    parameters' leaves live."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    shape: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (len(self.devices),))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        return self.devices[0]

    @property
    def virtual(self) -> bool:
        """Some device appears more than once."""
        return len(set(self.devices)) < self.size

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coords(self, k: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(k, self.shape))

    def __str__(self) -> str:
        axes = " x ".join(f"{a}={n}" for a, n in zip(self.axis_names,
                                                      self.shape))
        return (f"Mesh({axes}: {', '.join(str(d) for d in self.devices)}"
                f"{', virtual' if self.virtual else ''})")


def make_mesh(n_devices: Optional[int] = None,
              data_axis: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1D or 2D device mesh: (data,) or (data, submap).

    Without ``devices``: the first ``n_devices`` visible CUDA devices (all
    of them by default). Raises if fewer are visible: a mesh that quietly
    shrinks would make the sharding checks vacuous. ``devices`` is an
    explicit list, which may repeat a device (a virtual mesh); it is for
    a caller, never read from a config."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or count
        if n < 1 or count < n:
            raise ValueError(f"make_mesh({n_devices}) needs {max(n, 1)} CUDA "
                             f"device(s) but {count} are visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [_device(d) for d in devices]
        n = n_devices or len(devs)
        if len(devs) < n or n < 1:
            raise ValueError(f"make_mesh({n}) needs {n} devices but the list "
                             f"names {len(devs)}")
        devs = devs[:n]
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a mesh holds devices of one type: {devs}")
    if data_axis is None or data_axis == n:
        return Mesh(tuple(devs), ("data",), (n,))
    if n % data_axis:
        raise ValueError(f"data axis {data_axis} does not divide {n} devices")
    return Mesh(tuple(devs), ("data", "submap"), (data_axis, n // data_axis))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor splits over a mesh: ``spec[d]`` names the mesh axis
    that splits dimension d into contiguous blocks (None: not split), as
    a JAX PartitionSpec does; a tensor is replicated over the axes its
    spec does not name."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def _block(self, k: int) -> Tuple[int, ...]:
        c = self.mesh.coords(k)
        return tuple(None if a is None else c[self.mesh.axis_names.index(a)]
                     for a in self.spec)

    def place(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Each mesh device's block of ``t``, on that device
        (differentiable copies; no copy where it already lies there)."""
        out = []
        for k, dev in enumerate(self.mesh.devices):
            b = t
            for dim, (a, i) in enumerate(zip(self.spec, self._block(k))):
                if a is not None:
                    n = self.mesh.axis_size(a)
                    if b.shape[dim] % n:
                        raise ValueError(
                            f"dimension {dim} of size {b.shape[dim]} does not "
                            f"split over the {n} devices of axis {a!r}")
                    b = b.chunk(n, dim)[i]
            out.append(b.to(dev))
        return out

    def devices(self) -> List[torch.device]:
        """The first device holding each distinct block, in block order:
        the devices a data-parallel computation runs its blocks on."""
        seen, out = set(), []
        for k, dev in enumerate(self.mesh.devices):
            blk = self._block(k)
            if blk not in seen:
                seen.add(blk)
                out.append(dev)
        return out


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def ray_sharded(mesh: Mesh) -> Sharding:
    """Split the leading (ray-batch) axis along the data axis."""
    return Sharding(mesh, ("data",))


def column_sharded(mesh: Mesh) -> Sharding:
    """Split the second axis (points of a [3, N] array) along the data
    axis: JAX's ``PartitionSpec(None, "data")``."""
    return Sharding(mesh, (None, "data"))


def submap_sharded(mesh: Mesh) -> Sharding:
    """Split a stacked submap axis [M, ...] along the mesh's last axis."""
    axis = mesh.axis_names[-1] if len(mesh.axis_names) > 1 else "data"
    return Sharding(mesh, (axis,))


def _tree_map(fn, tree):
    """fn on every tensor of a tree of dicts, lists and (named) tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_unzip(tree, n: int) -> List:
    """A tree (dicts, named tuples) of length-n lists -> n trees."""
    if isinstance(tree, dict):
        parts = {k: _tree_unzip(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [_tree_unzip(v, n) for v in tree]
        return [type(tree)(*[p[i] for p in parts]) for i in range(n)]
    return list(tree)


def shard_field_params(params: Dict, mesh: Mesh,
                       stacked: bool = False) -> List[Dict]:
    """Place field params (detached copies), one tree per mesh device:
    replicated, or with ``stacked`` leaves [M, ...] split along the
    submap axis."""
    sh = submap_sharded(mesh) if stacked else replicated(mesh)
    return _tree_unzip(_tree_map(lambda t: sh.place(t.detach()), params),
                       mesh.size)


class _Broadcast(torch.autograd.Function):
    """A tensor on each of ``devices`` (a view of it where it already
    lies). The gradient is the sum of the copies' gradients taken in
    device order on the tensor's device: autograd would add them in the
    order each device's backward thread delivers them, and the bits of a
    run would change from run to run."""

    @staticmethod
    def forward(ctx, t, devices):
        ctx.device = t.device
        return tuple(t.view_as(t) if d == t.device else t.to(d)
                     for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                g = g.to(ctx.device)
                total = g if total is None else total + g
        return total, None


def replicate_params(params, devices: Sequence[torch.device]) -> List:
    """Copies of a tree of tensors (or of one tensor), one per device;
    where a device is the tensors' own (the primary's, every slot of a
    virtual mesh) the copy shares its memory. A tensor that requires a
    gradient gets the sum of its copies' gradients, in device order."""
    devices = tuple(devices)

    def copies(t):
        if t.requires_grad:
            return list(_Broadcast.apply(t, devices))
        return [t.to(d) for d in devices]

    return _tree_unzip(_tree_map(copies, params), len(devices))


def split(t: torch.Tensor, devices: Sequence[torch.device],
          dim: int = 0) -> List[torch.Tensor]:
    """Contiguous blocks of ``t`` along ``dim``, block k on devices[k]
    (differentiable); the size must divide."""
    n = len(devices)
    if t.shape[dim] % n:
        raise ValueError(f"{t.shape[dim]} along dimension {dim} does not "
                         f"split over {n} devices")
    return [b.to(d) for b, d in zip(t.chunk(n, dim), devices)]


def divides(mesh: Optional[Mesh], n: int) -> bool:
    """Whether a batch of n splits over a mesh of more than one device
    (JAX applies its sharding constraint only then)."""
    return mesh is not None and mesh.size > 1 and n % mesh.size == 0


def slot_device(mesh: Mesh, slot: int) -> torch.device:
    """The device of stacked-submap slot ``slot``."""
    return mesh.devices[slot % mesh.size]


# ---------------------------------------------------------------------------
# Sharded mapping step (data-parallel over rays)
# ---------------------------------------------------------------------------

def make_sharded_map_step(mesh: Mesh, fcfg, lw):
    """A data-parallel training step: rays split over the mesh, params
    replicated. Returns step(field, opt, rays [N, 7], consts,
    generator=None, u=None) -> loss, which steps ``opt`` (the field's map
    optimizer on the primary device) once. N must divide by the data axis
    size. ``u``: the z perturbation [N, S] (drawn from ``generator`` on
    the primary device when not given)."""
    from ..models import scene_rep as sr
    devices = ray_sharded(mesh).devices()

    def step(field, opt, rays, consts, generator=None, u=None):
        rays_s = split(rays, devices)
        dirsT = [r[:, :3].T for r in rays_s]
        ret = sr.forward_losses_T_sharded(
            replicate_params(field.params(), devices),
            [torch.zeros_like(d) for d in dirsT], dirsT,
            [r[:, 3:6].T for r in rays_s], [r[:, 6:7] for r in rays_s],
            fcfg, replicate_params(consts, devices), generator=generator,
            u=u)
        loss = sr.total_loss(ret, lw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def sharded_map_step(mesh: Mesh, fcfg, lw, field, opt, rays, consts,
                     generator=None, u=None):
    """One-shot convenience wrapper around make_sharded_map_step."""
    return make_sharded_map_step(mesh, fcfg, lw)(field, opt, rays, consts,
                                                  generator, u)


# ---------------------------------------------------------------------------
# Sharded submap refinement (submap parallelism)
# ---------------------------------------------------------------------------

def make_sharded_refine_step(mesh: Mesh, fcfg, lw):
    """A step refining M submaps concurrently, slot s on device s % n:
    each submap trains against its own rays with its own optimizer, with
    no traffic between slots (JAX: a vmap over the stacked submap axis,
    sharded). Returns step(fields, opts, rays [M, N, 7], consts,
    generators=None, us=None) -> losses [M] on the primary device;
    ``fields[s]`` and ``opts[s]`` live on slot s's device, ``consts[s]``
    too."""
    from ..models import scene_rep as sr

    def step(fields, opts, rays, consts, generators=None, us=None):
        losses = []
        for s, (field, opt) in enumerate(zip(fields, opts)):
            dev = slot_device(mesh, s)
            r = rays[s].to(dev)
            dirsT = r[:, :3].T
            ret = sr.forward_losses_T(
                field.params(), torch.zeros_like(dirsT), dirsT,
                r[:, 3:6].T, r[:, 6:7], fcfg, consts[s],
                generator=None if generators is None else generators[s],
                u=None if us is None else us[s].to(dev))
            loss = sr.total_loss(ret, lw)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach().to(mesh.primary))
        return torch.stack(losses)

    return step
