"""Checkpoints: SLAM state tensors, per-submap fields, the map optimizer.

Port of ``mipsfusion_tpu/slam/checkpoint.py`` with the same files and
keys, so either package reads the other's checkpoints:
``<out>/ckpt_<frame|final>/`` holds one ``model_<i>.npz`` per used submap
(the JAX-layout parameters flattened to ``planes/s0``,
``decoder/trunk0/w``, ...), one ``ckpt.npz`` with every state field as
``state/<field>`` (the JAX package's dtypes: int32 for the integer
tables and registers) plus ``extra/active_id``, and ``opt_state.npz``
with the active submap's Adam moments as ``leaf_<j>`` in the JAX
package's leaf order.

Optimizer state: the JAX map optimizer (``optax.multi_transform`` of
``scale_by_adam`` per parameter group) and the port's ``torch.optim.Adam``
(one group per JAX group, the same betas, eps and weight decay) hold the
same numbers: optax's ``count``, ``mu`` and ``nu`` are Adam's ``step``,
``exp_avg`` and ``exp_avg_sq``. The leaves are, group by group in sorted
order (``decoder``, then ``embed``), the group's count, then its ``mu``
and its ``nu`` over the group's parameters in sorted key order (decoder
layers ``rgb, sdf0, sdf1, trunk0, trunk1``, each ``b, w``; planes
``cp, s0, s1``). A file whose leaves do not match that layout gives a
fresh optimizer, as the JAX package's ``load_opt_state`` does.

Capacity: the JAX package rounds its frame capacity up to a multiple of
256 (and its keyframe capacity with it); the port's state holds exactly
the run's frames and keyframes. Loading into a run keeps the run's rows
and checks that every row beyond them is empty; rows the checkpoint lacks
stay empty.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import params_from_jax, params_to_numpy
from ..models.decoder import LAYERS
from ..models.scene_rep import Field
from .state import SlamState

_INT_SCALARS = ("n_kf", "active_submap_id", "prev_active_submap_id",
                "last_switch_frame")
_FRAME_AXIS = ("est_c2w", "est_c2w_rel")
_KF_AXIS = ("kf_rays", "kf_frame_ids", "kf_c2w", "keyframe_ref",
            "keyframe_localMLP")
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SlamState))


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ------------------------------------------------------------------ state

def state_to_numpy(state: SlamState) -> Dict[str, np.ndarray]:
    """Every state field as numpy in the JAX package's dtype."""
    out = {}
    for name in STATE_FIELDS:
        v = getattr(state, name)
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
        else:
            a = np.asarray(v)
        if a.dtype.kind in "iu":
            a = a.astype(np.int32)
        out[name] = a
    return out


def _empty_rows(name: str, a: np.ndarray) -> np.ndarray:
    """Bool per row of a padded table: the row is what init_state puts
    there (identity poses, -1 ids, zeros)."""
    flat = a.reshape(a.shape[0], -1)
    if name in ("est_c2w", "est_c2w_rel", "kf_c2w"):
        return (flat == np.eye(4, dtype=a.dtype).reshape(-1)).all(1)
    if name in ("kf_frame_ids", "keyframe_localMLP"):
        return (flat == -1).all(1)
    return (flat == 0).all(1)


def state_from_numpy(data: Dict[str, np.ndarray], like: Optional[SlamState]
                     = None, device=None) -> SlamState:
    """A SlamState from numpy fields (any integer dtype). With ``like``
    the frame and keyframe axes take like's sizes (rows beyond the
    checkpoint's stay as like's empty rows; checkpoint rows beyond like's
    must be empty) and the tensors go to like's device."""
    missing = set(STATE_FIELDS) - set(data)
    if missing:
        raise ValueError(f"checkpoint lacks state fields {sorted(missing)}")
    if like is not None:
        device = like.kf_rays.device
    fields = {}
    for name in STATE_FIELDS:
        a = np.asarray(data[name])
        if name in _INT_SCALARS:
            fields[name] = int(a)
            continue
        dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
        if like is not None and (name in _FRAME_AXIS or name in _KF_AXIS):
            ref = getattr(like, name)
            n = ref.shape[0]
            if a.shape[1:] != tuple(ref.shape[1:]):
                raise ValueError(f"state/{name}: shape {a.shape} does not "
                                 f"fit the run's {tuple(ref.shape)}")
            if a.shape[0] > n and not _empty_rows(name, a[n:]).all():
                raise ValueError(
                    f"state/{name}: rows {n}..{a.shape[0] - 1} of the "
                    "checkpoint are not empty, and the run holds only "
                    f"{n}")
            t = ref.detach().clone()
            k = min(n, a.shape[0])
            t[:k] = torch.as_tensor(a[:k], dtype=dtype, device=device)
            fields[name] = t
            continue
        if like is not None and a.shape != tuple(getattr(like, name).shape):
            raise ValueError(f"state/{name}: shape {a.shape} against the "
                             f"run's {tuple(getattr(like, name).shape)}")
        fields[name] = torch.as_tensor(a, dtype=dtype, device=device).clone()
    return SlamState(**fields)


# -------------------------------------------------------------- optimizer

def _jax_group_order(field: Field):
    """[(group index in the port's Adam, [parameters in JAX leaf order])]
    for the JAX groups in sorted order: decoder, embed."""
    dec = [field.decoder[n][k] for n in sorted(LAYERS) for k in ("b", "w")]
    planes = [field.planes[k] for k in sorted(field.planes.keys())]
    return [(0, dec), (1, planes)]


def adam_to_leaves(opt: torch.optim.Adam, field: Field) -> List[np.ndarray]:
    """The port's map optimizer state as the JAX package's leaves."""
    leaves = []
    for _, params in _jax_group_order(field):
        states = [opt.state.get(p, {}) for p in params]
        steps = {int(s["step"]) for s in states if "step" in s}
        if len(steps) > 1:
            raise ValueError(f"Adam steps differ within a group: {steps}")
        leaves.append(np.asarray(steps.pop() if steps else 0, np.int32))
        for key in ("exp_avg", "exp_avg_sq"):
            leaves += [s[key].detach().cpu().numpy() if key in s
                       else np.zeros(tuple(p.shape), np.float32)
                       for s, p in zip(states, params)]
    return leaves


def adam_from_leaves(opt: torch.optim.Adam, field: Field,
                     leaves: List[np.ndarray]) -> bool:
    """Load JAX-order leaves into the port's Adam (in place); False (and
    nothing loaded) when they do not fit the layout."""
    groups = _jax_group_order(field)
    want = []
    for _, params in groups:
        want.append(())
        want += [tuple(p.shape) for p in params] * 2
    if len(leaves) != len(want) or any(
            tuple(np.shape(l)) != w for l, w in zip(leaves, want)):
        return False
    it = iter(leaves)
    for _, params in groups:
        step = float(next(it))
        mu = [next(it) for _ in params]
        nu = [next(it) for _ in params]
        for p, m, v in zip(params, mu, nu):
            opt.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": torch.as_tensor(m, dtype=p.dtype,
                                           device=p.device).clone(),
                "exp_avg_sq": torch.as_tensor(v, dtype=p.dtype,
                                              device=p.device).clone()}
    return True


# ------------------------------------------------------------- save, load

def save_ckpt(ckpt_dir: str, state: SlamState,
              fields: List[Optional[Field]], extra: Optional[Dict] = None,
              opt: Optional[torch.optim.Adam] = None,
              opt_field: Optional[Field] = None) -> None:
    """Write a checkpoint directory (see the module docstring); ``opt`` is
    the map optimizer of ``opt_field``, the active submap's field."""
    os.makedirs(ckpt_dir, exist_ok=True)
    for i, field in enumerate(fields):
        if field is None:
            continue
        np.savez_compressed(os.path.join(ckpt_dir, f"model_{i}.npz"),
                            **_flatten(params_to_numpy(field)))
    tensors = {f"state/{k}": v for k, v in state_to_numpy(state).items()}
    if extra:
        tensors.update({f"extra/{k}": np.asarray(v)
                        for k, v in extra.items()})
    np.savez_compressed(os.path.join(ckpt_dir, "ckpt.npz"), **tensors)
    if opt is not None:
        leaves = adam_to_leaves(opt, opt_field)
        np.savez_compressed(os.path.join(ckpt_dir, "opt_state.npz"),
                            **{f"leaf_{j}": l for j, l in enumerate(leaves)})


def load_opt_state(ckpt_dir: str, opt: torch.optim.Adam,
                   field: Field) -> bool:
    """Restore the active submap's Adam moments saved by either package
    into ``opt`` (in place). False when the file is absent or its leaves
    do not fit: the optimizer stays fresh."""
    path = os.path.join(ckpt_dir, "opt_state.npz")
    if not os.path.exists(path):
        return False
    data = np.load(path)
    leaves = [data[f"leaf_{j}"] for j in range(len(data.files))]
    return adam_from_leaves(opt, field, leaves)


def load_ckpt(ckpt_dir: str, like: Optional[SlamState] = None, device=None
              ) -> Tuple[SlamState, List[Optional[Field]], Dict]:
    """(state, per-submap fields or None, extra) of a checkpoint written by
    either package; ``like`` as in ``state_from_numpy``."""
    data = np.load(os.path.join(ckpt_dir, "ckpt.npz"))
    fields, extra = {}, {}
    for k in data.files:
        if k.startswith("state/"):
            fields[k[len("state/"):]] = data[k]
        elif k.startswith("extra/"):
            extra[k[len("extra/"):]] = data[k]
    state = state_from_numpy(fields, like, device)
    dev = state.kf_rays.device
    n_submaps = state.localMLP_info.shape[0]
    submaps: List[Optional[Field]] = [None] * n_submaps
    for i in range(n_submaps):
        path = os.path.join(ckpt_dir, f"model_{i}.npz")
        if os.path.exists(path):
            flat = np.load(path)
            submaps[i] = params_from_jax(
                _unflatten({k: flat[k] for k in flat.files}), dev)
    return state, submaps, extra
