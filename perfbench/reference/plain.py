"""The plain reference of the neural field and its training losses:
float32 PyTorch, no kernel, no cache, no batching across calls.

The field's encoding is the module that the configuration's ``grid.enc``
names (``encodings/<enc>.py``: Triplane + CP, the hash grid); shared by
every encoding are the 8-band tcnn-layout frequency encoding, the
decoder (trunk 51 -> 128 -> 64 + 64; rgb 64 + 51 -> 3; sdf 64 + E -> 128
-> 5 classes, the sdf their expectation), the depth-guided + uniform z
ladder, SDF-to-weight compositing and the free-space, truncation-band,
EMD, colour and depth losses. It follows the MIPS-Fusion field as the JAX
package states it. The code is a frozen copy of the port's plain (CPU)
functions, so it imports nothing of the program. Quaternions are
real-first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Hashable, Optional

import torch

from . import encodings

LAYERS = ("trunk0", "trunk1", "rgb", "sdf0", "sdf1")
N_CLASS = 5


# ------------------------------------------------------------- geometry ---

def _bottom_row(top):
    row = torch.eye(4, dtype=top.dtype, device=top.device)[3:]
    return row.expand(top.shape[:-2] + (1, 4))


def quaternion_to_matrix(quat):
    q = quat / (torch.linalg.norm(quat, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def matrix_to_quaternion(m):
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.sqrt(torch.clamp(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1), min=0.0))
    cands = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    cands = cands / (2.0 * torch.clamp(q_abs, min=0.1))[..., None]
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    quat = torch.gather(cands, -2, idx)[..., 0, :]
    return torch.where(quat[..., 0:1] < 0, -quat, quat)


def qt_to_matrix(rot_quat, trans):
    top = torch.cat([quaternion_to_matrix(rot_quat), trans[..., :, None]], -1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def pose_inverse(T):
    R_T = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([R_T, -(R_T @ T[..., :3, 3:])], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], dim=-2)


def se3_exp(xi):
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-10
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    wx = _skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(wx.shape)
    wx2 = phi[..., :, None] * phi[..., None, :] - theta2[..., None, None] * eye
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2_safe)
    R = eye + A[..., None, None] * wx + B[..., None, None] * wx2
    V = eye + B[..., None, None] * wx + C[..., None, None] * wx2
    top = torch.cat([R, (V @ rho[..., None])], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_log(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    w_hat = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                         R[..., 0, 2] - R[..., 2, 0],
                         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    w2 = torch.sum(w_hat * w_hat, dim=-1)
    small = w2 < 1e-10
    one = torch.ones_like(w2)
    sin_theta = torch.where(small, torch.zeros_like(w2),
                            0.5 * torch.sqrt(torch.where(small, one, w2)))
    theta = torch.atan2(sin_theta, cos_theta)
    sin_safe = torch.where(small, one, sin_theta)
    scale = torch.where(small, 0.5 + theta ** 2 / 12.0,
                        theta / (2.0 * sin_safe))
    phi = w_hat * scale[..., None]
    wx = _skew(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta2_safe = torch.where(small, one, theta2)
    th = torch.sqrt(theta2_safe)
    A = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - (th * torch.cos(th / 2.0))
                     / (2.0 * torch.sin(th / 2.0))) / theta2_safe)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(wx.shape)
    V_inv = eye - 0.5 * wx + A[..., None, None] * (wx @ wx)
    return torch.cat([(V_inv @ t[..., None])[..., 0], phi], dim=-1)


# ---------------------------------------------------------- the field ---

@dataclasses.dataclass(frozen=True)
class FieldCfg:
    enc: str
    enc_spec: Hashable
    n_freq: int
    n_range_d: int
    range_d: float
    n_samples_d: int
    near: float
    far: float
    perturb: bool
    trunc: float
    sc_factor: float
    depth_trunc: float
    rgb_missing: float
    norm_factor: float

    @staticmethod
    def from_config(cfg: Dict, tracking: bool = False) -> "FieldCfg":
        t = cfg["training"]
        z = cfg["tracking"] if tracking else {}
        enc = encodings.name_of(cfg)
        return FieldCfg(
            enc=enc, enc_spec=encodings.load(enc).spec(cfg),
            n_freq=int(cfg["pos"]["n_bins"]),
            n_range_d=int(z.get("n_range_d", t["n_range_d"])),
            range_d=float(t["range_d"]),
            n_samples_d=int(z.get("n_samples_d", t["n_samples_d"])),
            near=float(cfg["cam"]["near"]), far=float(cfg["cam"]["far"]),
            perturb=bool(t["perturb"]), trunc=float(t["trunc"]),
            sc_factor=float(cfg["data"]["sc_factor"]),
            depth_trunc=float(cfg["cam"]["depth_trunc"]),
            rgb_missing=float(t["rgb_missing"]),
            norm_factor=float(t["norm_factor"]))


def bound_consts(cfg: Dict, device):
    """(low corner, 1 / extent) of the normalization into [0, 1]^3."""
    b = torch.tensor(cfg["mapping"]["bound"], dtype=torch.float32,
                     device=device)
    return b[:, 0], 1.0 / (b[:, 1] - b[:, 0])


def frequency_encode(x, n_freq: int):
    freqs = (2.0 ** torch.arange(n_freq, dtype=x.dtype, device=x.device)
             ) * math.pi
    ang = x[..., :, None] * freqs
    enc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return enc.reshape(x.shape[:-1] + (x.shape[-1] * n_freq * 2,))


def _dense(p, x):
    return x @ p["w"] + p["b"]


def decoder(dec: Dict, embed, pe, sdf_only: bool = False):
    h = _dense(dec["trunk1"], torch.relu(_dense(dec["trunk0"], pe)))
    n_sdf = dec["sdf0"]["w"].shape[0] - embed.shape[1]
    h2 = torch.relu(_dense(dec["sdf0"], torch.cat([h[:, :n_sdf], embed], -1)))
    prob = torch.softmax(_dense(dec["sdf1"], h2), dim=-1)
    ids = torch.arange(N_CLASS, dtype=prob.dtype, device=prob.device)
    sdf = ((prob * ids).sum(-1, keepdim=True) / (N_CLASS - 1) - 0.5) * 2.0
    if sdf_only:
        return sdf
    rgb = _dense(dec["rgb"], torch.cat([h[:, n_sdf:], pe], dim=-1))
    entropy = -(prob * torch.log2(prob + 1e-5)).sum(-1, keepdim=True)
    return torch.cat([rgb, sdf, entropy, prob], dim=-1)


def field(params: Dict, xT, fc: FieldCfg, sdf_only: bool = False,
          chunk: int = 1 << 18):
    """The field at normalized points [3, N] -> [10, N] (or [1, N]),
    ``chunk`` points at a time so a large query fits beside its graph."""
    enc = encodings.load(fc.enc)
    outs = []
    for xs in torch.split(xT / fc.norm_factor, chunk, dim=1):
        x = xs.T
        pe = torch.cat([x, frequency_encode(x, fc.n_freq)], dim=-1)
        outs.append(decoder(params["decoder"],
                            enc.encode(params, x, fc.enc_spec), pe,
                            sdf_only).T)
    return torch.cat(outs, dim=1)


def normalize_T(ptsT, consts):
    lo, inv = consts
    return (ptsT - lo[:, None]) * inv[:, None]


# ------------------------------------------------- rendering and losses ---

def ray_samples(fc: FieldCfg) -> int:
    return fc.n_range_d + max(fc.n_samples_d, 0)


def draw_u(n: int, fc: FieldCfg, generator, device) -> Optional[torch.Tensor]:
    if not fc.perturb:
        return None
    return torch.rand((n, ray_samples(fc)), generator=generator,
                      device=device)


def sample_z_vals(target_d, fc: FieldCfg, u):
    n = target_d.shape[0]
    dev, dt = target_d.device, target_d.dtype
    z_near = torch.linspace(-fc.range_d, fc.range_d, fc.n_range_d,
                            device=dev, dtype=dt)
    z_fallback = torch.linspace(fc.near, fc.far, fc.n_range_d, device=dev,
                                dtype=dt)
    z = torch.where(target_d > 0.0, z_near[None] + target_d, z_fallback[None])
    if fc.n_samples_d > 0:
        z_uni = torch.linspace(fc.near, fc.far, fc.n_samples_d, device=dev,
                               dtype=dt).expand(n, -1)
        z = torch.sort(torch.cat([z_uni, z], -1), -1).values
    if fc.perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * u
    return z


def sdf2weights(sdf, z_vals, fc: FieldCfg):
    w = torch.sigmoid(sdf / fc.trunc) * torch.sigmoid(-sdf / fc.trunc)
    mask = ((sdf[:, 1:] * sdf[:, :-1]) < 0.0).to(sdf.dtype)
    z_min = torch.gather(z_vals, 1, torch.argmax(mask, dim=1, keepdim=True))
    w = w * (z_vals < z_min + fc.sc_factor * fc.trunc).to(sdf.dtype)
    return w / (w.sum(-1, keepdim=True) + 1e-8)


def _masks(z_vals, target_d, trunc: float):
    front = (z_vals < (target_d - trunc)).to(z_vals.dtype)
    back = (z_vals > (target_d + trunc)).to(z_vals.dtype)
    band = (1.0 - front) * (1.0 - back) * (target_d > 0.0).to(z_vals.dtype)
    n_fs = torch.count_nonzero(front).to(z_vals.dtype)
    n_sdf = torch.count_nonzero(band).to(z_vals.dtype)
    return front, band, 1.0 - n_fs / (n_fs + n_sdf), 1.0 - n_sdf / (
        n_fs + n_sdf)


def _sdf_losses(z_vals, target_d, sdf, probT, trunc: float, emd_w: float):
    front, band, fs_w, sdf_w = _masks(z_vals, target_d, trunc)
    fs_loss = torch.mean((sdf * front - front) ** 2) * fs_w
    sdf_loss = torch.mean(((z_vals + sdf * trunc) * band
                           - target_d * band) ** 2) * sdf_w
    if emd_w > 0:
        top = N_CLASS - 1
        idx = torch.arange(N_CLASS, dtype=z_vals.dtype,
                           device=z_vals.device)[:, None, None]
        fs_all = (probT * (top - idx) * front[None]).sum(0)
        gt = (((target_d - z_vals) + trunc) / (2.0 * trunc)) * top
        sdf_all = (torch.abs(gt[None] - idx) * band[None] * probT).sum(0)
        fs_loss = fs_loss + torch.mean(fs_all) / 250.0 * emd_w
        sdf_loss = sdf_loss + torch.mean(sdf_all) / 5000.0 * emd_w
    return fs_loss, sdf_loss


def forward_losses(params, rays_oT, rays_dT, target_rgbT, target_d,
                   fc: FieldCfg, consts, u, emd_w: float = 0.01) -> Dict:
    """Render rays [3, N] (targets rgb [3, N], depth [N, 1]) and their
    loss terms."""
    z_vals = sample_z_vals(target_d, fc, u)
    n, s = z_vals.shape
    ptsT = rays_oT[:, :, None] + rays_dT[:, :, None] * z_vals[None]
    rawT = field(params, normalize_T(ptsT.reshape(3, n * s), consts),
                 fc).reshape(-1, n, s)
    weights = sdf2weights(rawT[3], z_vals, fc)
    rgbT = (weights[None] * torch.sigmoid(rawT[:3])).sum(-1)
    depth = (weights * z_vals).sum(-1)
    td = target_d[..., 0]
    valid = (td > 0.0) & (td < fc.depth_trunc)
    validf = valid.to(td.dtype)
    rgb_w = torch.where(valid[None], torch.ones_like(validf),
                        torch.full_like(validf, fc.rgb_missing))
    rgb_loss = torch.mean((rgbT * rgb_w - target_rgbT * rgb_w) ** 2)
    depth_loss = (((depth - td) ** 2) * validf).sum() / torch.clamp(
        validf.sum(), min=1.0)
    fs_loss, sdf_loss = _sdf_losses(z_vals, target_d, rawT[3], rawT[5:],
                                    fc.trunc * fc.sc_factor, emd_w)
    return {"rgb_loss": rgb_loss, "depth_loss": depth_loss,
            "sdf_loss": sdf_loss, "fs_loss": fs_loss}


def loss_weights(cfg: Dict):
    t = cfg["training"]
    return (float(t["rgb_weight"]), float(t["depth_weight"]),
            float(t["sdf_weight"]), float(t["fs_weight"]))


def total_loss(ret: Dict, w) -> torch.Tensor:
    return (w[0] * ret["rgb_loss"] + w[1] * ret["depth_loss"]
            + w[2] * ret["sdf_loss"] + w[3] * ret["fs_loss"])
