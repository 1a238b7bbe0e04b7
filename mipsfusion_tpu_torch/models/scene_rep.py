"""Per-submap neural field: encode -> decode -> volume render -> losses.

Port of the transposed (points-minor) training path of
``mipsfusion_tpu/models/scene_rep.py``: rays [3, N], points [3, N*S],
raw outputs [5 + C, N, S]. The field's encoding is ``FieldConfig.enc``:

  * ``"Triplane"`` (Triplane+CP): every query goes through the kernel
    wrappers of ``ops/field_cuda.py``, the differentiable ``FieldQueryT``
    for training (GO, BA, init) and K1 for gradient-free queries (RO
    fitness, the mesher);
  * ``"HashGrid"`` (the reference paper's field, and the JAX package's
    default): ``ops/encoding.hash_encode`` + the frequency encoding + the
    decoder in plain torch on every device, as in the JAX package (which
    has no kernel for it), float32 with TF32 off.

Over a mesh of devices (``parallel/sharding.py``), the loss of a ray batch
split in shards is ``forward_losses_T_sharded``: each shard renders its
rays where they lie and sends back only its partial sums
(``loss_sums_T``), from which ``losses_from_sums`` forms the terms; RO's
sdf queries split by columns (``run_network_sdf_T_sharded``).

Field parameters are a tree in the JAX layout, ``{"planes": {"s0",
"s1"(, "s2"), "cp"}, "decoder": {layer: {"w", "b"}}}`` or ``{"hash":
[L, T, F], "decoder": ...}``; ``Field`` holds them as ``nn.Parameter``s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..ops.encoding import (FrequencyConfig, HashGridConfig, TriplaneConfig,
                            frequency_encode, hash_encode, init_hash_table,
                            init_triplane)
from ..ops.field_cuda import field_forward, field_query_T
from ..ops.losses import (compute_loss, emd_terms, get_masks, get_sdf_loss_T,
                          mse2psnr)
from ..parallel.sharding import split
from .decoder import LAYERS, DecoderConfig, decoder_apply, init_decoder

ENCODINGS = ("HashGrid", "Triplane")


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    # the constructor's default stays the port's first field; from_dict
    # defaults to "HashGrid", as the JAX package's does
    enc: str = "Triplane"
    grid: HashGridConfig = HashGridConfig()
    tri: TriplaneConfig = TriplaneConfig()
    freq: FrequencyConfig = FrequencyConfig()
    decoder: DecoderConfig = DecoderConfig()
    n_range_d: int = 25
    range_d: float = 0.2
    n_samples_d: int = 50
    near: float = 0.0
    far: float = 5.0
    perturb: bool = True
    trunc: float = 0.1
    sc_factor: float = 1.0
    depth_trunc: float = 100.0
    rgb_missing: float = 0.0
    norm_factor: float = 1.0
    use_bound_normalize: bool = True

    @property
    def n_scales(self) -> int:
        return len(self.tri.resolutions)

    @property
    def meta(self):
        return (self.n_scales, self.freq.n_frequencies, self.decoder.n_class)

    @staticmethod
    def from_dict(cfg: dict) -> "FieldConfig":
        """The JAX package's ``FieldConfig.from_dict``: ``grid.enc``
        defaults to "HashGrid" (16 levels x 2 features from base 16 to
        256, 2^hash_size rows), ``grid.tri_resolutions`` to (32, 64, 128,
        256)."""
        g = cfg["grid"]
        enc = g.get("enc", "HashGrid")
        if enc not in ENCODINGS:
            raise ValueError(f"grid.enc {enc!r}: the field is one of "
                             f"{ENCODINGS}")
        grid = HashGridConfig(
            log2_hashmap_size=g.get("hash_size",
                                    HashGridConfig.log2_hashmap_size),
            desired_resolution=256)
        tri = TriplaneConfig(
            resolutions=tuple(g.get("tri_resolutions", (32, 64, 128, 256))),
            n_features=g.get("tri_features", 4),
            cp_resolution=g.get("cp_resolution", 0),
            cp_components=g.get("cp_components", 32))
        freq = FrequencyConfig(n_frequencies=cfg["pos"]["n_bins"])
        dec = cfg.get("decoder", {})
        decoder = DecoderConfig(
            input_ch=tri.out_dim if enc == "Triplane" else grid.out_dim,
            input_ch_pos=freq.out_dim + 3,
            n_hidden=dec.get("hidden_dim", 128),
            n_hidden_branch=dec.get("hidden_dim", 128),
            n_hidden_rgb=dec.get("hidden_dim_color", 64),
            n_hidden_sdf=dec.get("geo_feat_dim", 64))
        t = cfg["training"]
        return FieldConfig(
            enc=enc, grid=grid, tri=tri, freq=freq, decoder=decoder,
            n_range_d=t["n_range_d"], range_d=t["range_d"],
            n_samples_d=t["n_samples_d"],
            near=cfg["cam"]["near"], far=cfg["cam"]["far"],
            perturb=bool(t["perturb"]), trunc=t["trunc"],
            sc_factor=cfg["data"]["sc_factor"],
            depth_trunc=cfg["cam"]["depth_trunc"],
            rgb_missing=t["rgb_missing"], norm_factor=t["norm_factor"],
            use_bound_normalize=bool(cfg["grid"]["use_bound_normalize"]))


class FieldConsts(NamedTuple):
    """Normalization x_norm = (x - bb_lo) * bb_inv_extent."""
    bb_lo: torch.Tensor          # [3]
    bb_inv_extent: torch.Tensor  # [3]

    @staticmethod
    def from_bound(bound: torch.Tensor) -> "FieldConsts":
        return FieldConsts(bound[:, 0], 1.0 / (bound[:, 1] - bound[:, 0]))

    @staticmethod
    def from_norm_factor(nf: torch.Tensor) -> "FieldConsts":
        return FieldConsts(-nf, 1.0 / (2.0 * nf))


def init_field(cfg: FieldConfig, generator: torch.Generator,
               device=None) -> Dict:
    """Random field params (the reference's init scales) as a tree."""
    if cfg.enc == "HashGrid":
        enc = {"hash": init_hash_table(cfg.grid, generator, device)}
    else:
        enc = {"planes": init_triplane(cfg.tri, generator, device)}
    return {**enc, "decoder": init_decoder(cfg.decoder, generator, device)}


class Field(nn.Module):
    """The encoding (the planes and CP lines, or the hash table) and the
    decoder of one submap as parameters."""

    def __init__(self, params: Dict):
        super().__init__()
        self.planes, self.hash = None, None
        if "hash" in params:
            self.hash = nn.Parameter(params["hash"].detach().clone())
        else:
            self.planes = nn.ParameterDict(
                {k: nn.Parameter(v.detach().clone())
                 for k, v in params["planes"].items()})
        self.decoder = nn.ModuleDict({
            name: nn.ParameterDict({k: nn.Parameter(t.detach().clone())
                                    for k, t in params["decoder"][name].items()})
            for name in LAYERS})

    def embed_params(self) -> List[nn.Parameter]:
        """The encoding's parameters (the map optimizer's embed group)."""
        if self.hash is not None:
            return [self.hash]
        return list(self.planes.values())

    def params(self, detach: bool = False) -> Dict:
        f = (lambda t: t.detach()) if detach else (lambda t: t)
        enc = ({"hash": f(self.hash)} if self.hash is not None else
               {"planes": {k: f(v) for k, v in self.planes.items()}})
        return {**enc, "decoder": {n: {k: f(t) for k, t in d.items()}
                                   for n, d in self.decoder.items()}}


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def normalize_T(ptsT: torch.Tensor, consts: FieldConsts) -> torch.Tensor:
    return (ptsT - consts.bb_lo[:, None]) * consts.bb_inv_extent[:, None]


def hash_field(params: Dict, x: torch.Tensor, cfg: FieldConfig,
               sdf_only: bool = False) -> torch.Tensor:
    """The HashGrid field at points x [N, 3] (already divided by the
    norm factor) -> [N, 5 + C] (or [N, 1] sdf), the JAX package's
    ``query_color_sdf`` composite."""
    embed = hash_encode(params["hash"], x, cfg.grid)
    pe = torch.cat([x, frequency_encode(x, cfg.freq.n_frequencies)], dim=-1)
    return decoder_apply(params["decoder"], embed, pe, cfg.decoder.n_class,
                         sdf_only=sdf_only)


def query_color_sdf_T(params: Dict, ptsT_norm: torch.Tensor,
                      cfg: FieldConfig) -> torch.Tensor:
    """Differentiable query of normalized points [3, M] -> [5 + C, M]."""
    if cfg.enc == "HashGrid":
        return hash_field(params, (ptsT_norm / cfg.norm_factor).T, cfg).T
    return field_query_T(params, ptsT_norm / cfg.norm_factor, *cfg.meta)


def field_outputs_T(params: Dict, ptsT_norm: torch.Tensor, cfg: FieldConfig,
                    sdf_only: bool = False) -> torch.Tensor:
    """Gradient-free query of normalized points [3, M] -> [5 + C, M] (or
    [1, M] with ``sdf_only``): K1 on the Triplane field, the plain hash
    grid on the HashGrid field."""
    xg = (ptsT_norm / cfg.norm_factor).contiguous()
    with torch.no_grad():
        if cfg.enc == "HashGrid":
            return hash_field(params, xg.T, cfg, sdf_only=sdf_only).T
        return field_forward(xg, params["planes"], params["decoder"],
                             *cfg.meta, sdf_only=sdf_only)


def run_network_sdf_T(params: Dict, ptsT: torch.Tensor, cfg: FieldConfig,
                      consts: FieldConsts) -> torch.Tensor:
    """SDF-only query (no gradient) of local-frame points [3, N] -> [N]."""
    return field_outputs_T(params, normalize_T(ptsT, consts), cfg,
                           sdf_only=True)[0]


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def sdf2weights(sdf: torch.Tensor, z_vals: torch.Tensor,
                cfg: FieldConfig) -> torch.Tensor:
    """SDF [N, S] -> normalized compositing weights, masked after the first
    sign crossing plus sc_factor * trunc."""
    weights = torch.sigmoid(sdf / cfg.trunc) * torch.sigmoid(-sdf / cfg.trunc)
    signs = sdf[:, 1:] * sdf[:, :-1]
    mask = (signs < 0.0).to(sdf.dtype)
    inds = torch.argmax(mask, dim=1, keepdim=True)     # first crossing
    z_min = torch.gather(z_vals, 1, inds)
    mask = (z_vals < z_min + cfg.sc_factor * cfg.trunc).to(sdf.dtype)
    weights = weights * mask
    return weights / (weights.sum(-1, keepdim=True) + 1e-8)


def ray_samples(cfg: FieldConfig) -> int:
    """Samples a ray: the depth-guided ones, then the uniform ones."""
    return cfg.n_range_d + max(cfg.n_samples_d, 0)


def draw_u(n: int, cfg: FieldConfig,
           generator: Optional[torch.Generator], device
           ) -> Optional[torch.Tensor]:
    """The stratified z perturbation of n rays, [n, S] uniform in [0, 1),
    as ``sample_z_vals`` draws it (None when ``cfg.perturb`` is off)."""
    if not cfg.perturb:
        return None
    return torch.rand((n, ray_samples(cfg)), generator=generator,
                      device=device)


def sample_z_vals(target_d: torch.Tensor, cfg: FieldConfig,
                  generator: Optional[torch.Generator] = None,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depth-guided + uniform z samples [N, n_range_d + n_samples_d],
    sorted, then stratified-perturbed with ``u`` (drawn from
    ``generator`` when not given) if ``cfg.perturb``. The reference's
    ``_merge_sorted_z`` is a TPU sort workaround; torch.sort gives the
    same values."""
    n = target_d.shape[0]
    dev, dt = target_d.device, target_d.dtype
    z_near = torch.linspace(-cfg.range_d, cfg.range_d, cfg.n_range_d,
                            device=dev, dtype=dt)
    z_fallback = torch.linspace(cfg.near, cfg.far, cfg.n_range_d,
                                device=dev, dtype=dt)
    z_samples = torch.where(target_d > 0.0, z_near[None] + target_d,
                            z_fallback[None])
    if cfg.n_samples_d > 0:
        z_uniform = torch.linspace(cfg.near, cfg.far, cfg.n_samples_d,
                                   device=dev, dtype=dt).expand(n, -1)
        z_vals = torch.sort(torch.cat([z_uniform, z_samples], -1), -1).values
    else:
        z_vals = z_samples
    if cfg.perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        if u is None:
            u = draw_u(n, cfg, generator, dev)
        z_vals = lower + (upper - lower) * u
    return z_vals


def raw2outputs_T(rawT: torch.Tensor, z_vals: torch.Tensor,
                  cfg: FieldConfig):
    """[5 + C, N, S] raw -> (rgb [3, N], depth [N]). The reference also
    returns the weights and the depth variance, which the slice never
    reads."""
    rgbT = torch.sigmoid(rawT[:3])
    weights = sdf2weights(rawT[3], z_vals, cfg)
    rgb_mapT = (weights[None] * rgbT).sum(-1)
    depth_map = (weights * z_vals).sum(-1)
    return rgb_mapT, depth_map


def render_rays_T(params: Dict, rays_oT: torch.Tensor, rays_dT: torch.Tensor,
                  target_d: torch.Tensor, cfg: FieldConfig,
                  consts: FieldConsts,
                  generator: Optional[torch.Generator] = None,
                  u: Optional[torch.Tensor] = None) -> Dict:
    z_vals = sample_z_vals(target_d, cfg, generator, u)          # [N, S]
    ptsT = rays_oT[:, :, None] + rays_dT[:, :, None] * z_vals[None]
    n, s = z_vals.shape
    xT = normalize_T(ptsT.reshape(3, n * s), consts)
    rawT = query_color_sdf_T(params, xT, cfg).reshape(-1, n, s)
    rgb_mapT, depth_map = raw2outputs_T(rawT, z_vals, cfg)
    return {"rgbT": rgb_mapT, "depth": depth_map, "z_vals": z_vals,
            "rawT": rawT}


def forward_losses_T(params: Dict, rays_oT: torch.Tensor,
                     rays_dT: torch.Tensor, target_rgbT: torch.Tensor,
                     target_d: torch.Tensor, cfg: FieldConfig,
                     consts: FieldConsts, emd_w: float = 0.01,
                     generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None) -> Dict:
    """Render [3, N] rays and compute the training loss dict."""
    rend = render_rays_T(params, rays_oT, rays_dT, target_d, cfg, consts,
                         generator, u)
    td = target_d[..., 0]
    valid = (td > 0.0) & (td < cfg.depth_trunc)
    validf = valid.to(td.dtype)
    rgb_weight = torch.where(valid[None], torch.ones_like(validf),
                             torch.full_like(validf, cfg.rgb_missing))
    rgb_loss = compute_loss(rend["rgbT"] * rgb_weight,
                            target_rgbT * rgb_weight)
    nvalid = torch.clamp(validf.sum(), min=1.0)
    depth_loss = (((rend["depth"] - td) ** 2) * validf).sum() / nvalid
    fs_loss, sdf_loss = get_sdf_loss_T(
        rend["z_vals"], target_d, rend["rawT"][3], rend["rawT"][5:],
        cfg.trunc * cfg.sc_factor, cate_num=cfg.decoder.n_class, emd_w=emd_w)
    return {"rgbT": rend["rgbT"], "depth": rend["depth"],
            "rgb_loss": rgb_loss, "depth_loss": depth_loss,
            "sdf_loss": sdf_loss, "fs_loss": fs_loss,
            "psnr": mse2psnr(rgb_loss)}


# ---------------------------------------------------------------------------
# The sharded loss: each shard's partial sums, the losses from their total
# ---------------------------------------------------------------------------

# the partial sums and counts of one shard, in the order loss_sums_T
# stacks them
SUM_TERMS = ("rgb", "depth", "n_valid", "fs", "sdf", "n_fs", "n_sdf",
             "fs_emd", "sdf_emd")


def loss_sums_T(rend: Dict, target_rgbT: torch.Tensor,
                target_d: torch.Tensor, cfg: FieldConfig,
                emd_w: float = 0.01) -> torch.Tensor:
    """One shard's share of ``forward_losses_T``'s terms: every sum over
    its rays and samples, and the counts its means and weights divide by
    (``SUM_TERMS``; the EMD sums only when emd_w > 0), one vector."""
    td = target_d[..., 0]
    valid = (td > 0.0) & (td < cfg.depth_trunc)
    validf = valid.to(td.dtype)
    rgb_weight = torch.where(valid[None], torch.ones_like(validf),
                             torch.full_like(validf, cfg.rgb_missing))
    z_vals, sdf = rend["z_vals"], rend["rawT"][3]
    trunc = cfg.trunc * cfg.sc_factor
    front, sdf_mask, _, _ = get_masks(z_vals, target_d, trunc)
    sums = [((rend["rgbT"] * rgb_weight - target_rgbT * rgb_weight) ** 2
             ).sum(),
            (((rend["depth"] - td) ** 2) * validf).sum(), validf.sum(),
            ((sdf * front - front) ** 2).sum(),
            (((z_vals + sdf * trunc) * sdf_mask - target_d * sdf_mask) ** 2
             ).sum(),
            torch.count_nonzero(front).to(td.dtype),
            torch.count_nonzero(sdf_mask).to(td.dtype)]
    if emd_w > 0:
        fs_all, sdf_all = emd_terms(z_vals, target_d, front, sdf_mask,
                                    rend["rawT"][5:], trunc,
                                    cfg.decoder.n_class)
        sums += [fs_all.sum(), sdf_all.sum()]
    return torch.stack(sums)


def losses_from_sums(sums: torch.Tensor, n_rays: int, n_samples: int,
                     emd_w: float = 0.01) -> Dict:
    """``forward_losses_T``'s loss terms from the total of every shard's
    ``loss_sums_T``: the means over all 3N colours and all N x S samples,
    the depth term's mean over the valid rays, the free-space and band
    weights from the global counts."""
    s = dict(zip(SUM_TERMS, sums))
    n_pts = n_rays * n_samples
    rgb_loss = s["rgb"] / (3 * n_rays)
    num = s["n_fs"] + s["n_sdf"]
    fs_loss = s["fs"] / n_pts * (1.0 - s["n_fs"] / num)
    sdf_loss = s["sdf"] / n_pts * (1.0 - s["n_sdf"] / num)
    if emd_w > 0:
        fs_loss = fs_loss + s["fs_emd"] / n_pts / 250.0 * emd_w
        sdf_loss = sdf_loss + s["sdf_emd"] / n_pts / 5000.0 * emd_w
    return {"rgb_loss": rgb_loss,
            "depth_loss": s["depth"] / torch.clamp(s["n_valid"], min=1.0),
            "sdf_loss": sdf_loss, "fs_loss": fs_loss,
            "psnr": mse2psnr(rgb_loss)}


def forward_losses_T_sharded(params_reps: Sequence[Dict],
                             rays_oT: Sequence[torch.Tensor],
                             rays_dT: Sequence[torch.Tensor],
                             target_rgbT: Sequence[torch.Tensor],
                             target_d: Sequence[torch.Tensor],
                             cfg: FieldConfig,
                             consts_reps: Sequence[FieldConsts],
                             emd_w: float = 0.01,
                             generator: Optional[torch.Generator] = None,
                             u: Optional[torch.Tensor] = None) -> Dict:
    """``forward_losses_T``'s loss terms over a batch split in shards:
    shard k's rays ([3, N_k], targets [3, N_k] and [N_k, 1]) and its
    replicas of the params and consts lie on one device, and the first
    shard's device is the primary one. The z perturbation u [N, S] is
    drawn once for the whole batch on the primary device (as the
    unsharded path draws it) and each shard gets its slice; each shard
    renders its rays, and only its vector of partial sums comes back to
    the primary device. The terms and their gradients match the
    unsharded call's up to the order of the sums."""
    primary = target_d[0].device
    sizes = [t.shape[0] for t in target_d]
    n = sum(sizes)
    us = [None] * len(sizes)
    if cfg.perturb:
        if u is None:
            u = draw_u(n, cfg, generator, primary)
        us = [b.to(t.device) for b, t in zip(u.split(sizes), target_d)]
    total = None
    for k in range(len(sizes)):
        rend = render_rays_T(params_reps[k], rays_oT[k], rays_dT[k],
                             target_d[k], cfg, consts_reps[k], u=us[k])
        sums = loss_sums_T(rend, target_rgbT[k], target_d[k], cfg,
                           emd_w).to(primary)
        total = sums if total is None else total + sums
    return losses_from_sums(total, n, ray_samples(cfg), emd_w)


def run_network_sdf_T_sharded(params_reps: Sequence[Dict], ptsT: torch.Tensor,
                              cfg: FieldConfig,
                              consts_reps: Sequence[FieldConsts],
                              devices: Sequence[torch.device]
                              ) -> torch.Tensor:
    """``run_network_sdf_T`` with the points [3, N] split by columns over
    ``devices`` (params and consts replicated there); the sdf [N] is
    gathered on the points' device."""
    out = [run_network_sdf_T(p, x, cfg, c).to(ptsT.device)
           for p, x, c in zip(params_reps, split(ptsT, devices, 1),
                              consts_reps)]
    return torch.cat(out)


class LossWeights(NamedTuple):
    rgb: float = 1.0
    depth: float = 0.0
    sdf: float = 1000.0
    fs: float = 10.0

    @staticmethod
    def from_dict(cfg: dict) -> "LossWeights":
        t = cfg["training"]
        return LossWeights(rgb=t["rgb_weight"], depth=t["depth_weight"],
                           sdf=t["sdf_weight"], fs=t["fs_weight"])


def total_loss(ret: Dict, w: LossWeights) -> torch.Tensor:
    return (w.rgb * ret["rgb_loss"] + w.depth * ret["depth_loss"]
            + w.sdf * ret["sdf_loss"] + w.fs * ret["fs_loss"])
