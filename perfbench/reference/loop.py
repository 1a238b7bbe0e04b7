"""The plain reference of the loop-closure chain the benchmark checks:
the verification that a keyframe re-observes an earlier submap with the
ICP rectification of its pose, and the switch BA (the loop keyframe's
pose refined against the switched-to submap's frozen field).

Each follows MIPS-Fusion as the JAX package states it, in float32 plain
PyTorch (a frozen copy of the port's plain functions). The state tables
are a dict of tensors (``est_c2w``, ``kf_c2w``, ``keyframe_ref``,
``keyframe_localMLP``, ``localMLP_first_kf``, ``localMLP_info``); the
keyframe store is a function ``kf_rays(slot, ray)`` of the benchmark's
own stream. Normals come from ``torch.linalg.eigh`` and the normal
equations from ``torch.linalg.solve``.
"""

from __future__ import annotations

from typing import Dict

import torch

from .plain import (FieldCfg, bound_consts, draw_u, forward_losses,
                    loss_weights, matrix_to_quaternion, pose_inverse,
                    qt_to_matrix, se3_exp, total_loss)
from .stages import MaskedAdam, pose_rows


# ------------------------------------------------------------ geometry ---

def _anchor(st: Dict, submap_id: int):
    return st["kf_c2w"][st["localMLP_first_kf"][submap_id]]


def submap_kf_poses(st: Dict, submap_id: int, kf_frames) -> torch.Tensor:
    """Local poses [K, 4, 4] of every keyframe slot in submap_id's frame:
    ordinary keyframes as stored, first keyframes of other submaps from
    their world anchors, overlapping keyframes first-bound elsewhere
    through both anchors, the submap's own first keyframe the identity."""
    poses = st["est_c2w"][kf_frames]
    K = poses.shape[0]
    M = st["localMLP_first_kf"].shape[0]
    anchor_inv = pose_inverse(_anchor(st, submap_id))
    kf_ref = st["keyframe_ref"]
    first_kf = st["localMLP_first_kf"][submap_id]
    idx = torch.arange(K, device=poses.device)
    other_first = (kf_ref == -1) & (idx != first_kf)
    poses = torch.where(other_first[:, None, None],
                        anchor_inv @ st["kf_c2w"][:K], poses)
    bind = st["keyframe_localMLP"][:, 0]
    other = st["kf_c2w"][st["localMLP_first_kf"][torch.clamp(bind, 0,
                                                             M - 1)]]
    ovlp_other = (kf_ref == -2) & (bind != submap_id)
    poses = torch.where(ovlp_other[:, None, None],
                        anchor_inv @ (other @ st["est_c2w"][kf_frames]),
                        poses)
    eye = torch.eye(4, device=poses.device)
    return torch.where((idx == first_kf)[:, None, None], eye, poses)


def _project(K_mat, pts_cam):
    """OpenGL camera points -> pixels (x flipped before K)."""
    flipped = torch.cat([-pts_cam[..., :1], pts_cam[..., 1:]], dim=-1)
    uvw = flipped @ K_mat.T
    return uvw[..., :2] / (uvw[..., 2:3] + 1e-5)


# -------------------------------------------------------- verification ---

def overlap_verify(st: Dict, n_kf: int, depth, rays_d, pose_world,
                   mo_id: int, active_id: int, rows, cols, K_mat, kf_frames,
                   k: int, edge: int, H: int, W: int) -> Dict:
    """The k keyframes of submap mo_id (not first-bound to the active one)
    nearest the current keyframe's surface centre, the grid's surface
    points each sees, and those inside mo_id's box."""
    K = kf_frames.shape[0]
    M = st["localMLP_first_kf"].shape[0]
    dev = depth.device
    bound = (st["keyframe_localMLP"] == mo_id).any(-1)
    rel = ((torch.arange(K, device=dev) < n_kf) & bound
           & (st["keyframe_localMLP"][:, 0] != active_id))
    bind = st["keyframe_localMLP"][:, 0]
    anchors = st["kf_c2w"][st["localMLP_first_kf"][torch.clamp(bind, 0,
                                                               M - 1)]]
    world = anchors @ st["est_c2w"][kf_frames]
    world = torch.where((st["keyframe_ref"] == -1)[:, None, None],
                        st["kf_c2w"][:K], world)
    d = depth[rows, cols][:, None]
    pts = pose_world[:3, 3] + (rays_d[rows, cols] @ pose_world[:3, :3].T) * d
    dists = torch.linalg.norm(world[:, :3, 3] - pts.mean(0), dim=-1)
    dists = torch.where(rel, dists, torch.full_like(dists, 1e9))
    top = torch.sort(dists, stable=True).indices[:k]
    top_valid = dists[top] < 1e9
    w2c = pose_inverse(world[top])
    pts_cam = (torch.einsum("kij,nj->kni", w2c[:, :3, :3], pts)
               + w2c[:, None, :3, 3])
    uv = _project(K_mat, pts_cam)
    vis = ((uv[..., 0] > edge) & (uv[..., 0] < W - edge)
           & (uv[..., 1] > edge) & (uv[..., 1] < H - edge)
           & (pts_cam[..., 2] < 0) & top_valid[:, None])
    info = st["localMLP_info"][mo_id]
    lo = info[1:4] - 0.5 * info[4:7]
    hi = info[1:4] + 0.5 * info[4:7]
    inside = ((pts > lo) & (pts < hi)).all(-1)
    final = vis.any(0) & inside & (d[:, 0] > 0)
    return {"top_kf_ids": top, "top_valid": top_valid, "counts": vis.sum(-1),
            "n_related": rel.sum(), "n_valid": final.sum()}


def _sq_dists(p, q):
    return ((p[:, None, :] - q[None, :, :]) ** 2).sum(-1)


def normals(pts, k: int = 10):
    """Per-point normals (up to sign): the k nearest neighbours' PCA."""
    idx = torch.topk(_sq_dists(pts, pts), k, dim=-1, largest=False).indices
    nb = pts[idx]
    c = nb - nb.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", c, c)
    return torch.linalg.eigh(cov).eigenvectors[:, :, 0]


def _nearest(p, dst, dst_valid):
    d2 = _sq_dists(p, dst)
    d2 = torch.where(dst_valid[None, :], d2, torch.full_like(d2, 1e10))
    dmin2, j = d2.min(dim=-1)
    return j, torch.sqrt(dmin2)


def icp_point_to_plane(src, src_valid, dst, dst_valid, dst_normals,
                       threshold: float, n_iters: int, rel_damping: float):
    """Gauss-Newton point-to-plane ICP over nearest neighbours within the
    threshold, damped by rel_damping x tr(H) / 6 (+ 1e-6). Returns (the
    transform src -> dst, the inliers of the last transform)."""
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    for _ in range(n_iters):
        p = src @ T[:3, :3].T + T[:3, 3]
        j, dmin = _nearest(p, dst, dst_valid)
        w = (src_valid & (dmin < threshold)).to(src.dtype)
        n = dst_normals[j]
        r = ((p - dst[j]) * n).sum(-1)
        J = torch.cat([n, torch.linalg.cross(p, n)], dim=-1)
        Jw = J * w[:, None]
        Hm = Jw.T @ J
        Hm = Hm + (1e-6 + rel_damping * torch.trace(Hm) / 6.0) * eye6
        T = se3_exp(-torch.linalg.solve(Hm, Jw.T @ r)) @ T
    p = src @ T[:3, :3].T + T[:3, 3]
    _, dmin = _nearest(p, dst, dst_valid)
    return T, (src_valid & (dmin < threshold)).sum()


def verify_icp(st: Dict, n_kf: int, kf_rays, depth, rays_d, pose_world,
               mo_id: int, active_id: int, rows, cols, K_mat, kf_frames,
               cur_frame: int, rr_src, cc_src, sub_incl, s: Dict) -> Dict:
    """The verification, the choice of the keyframes that see more than
    min_count of its points (all valid ones where none does) cycled over
    the k slots, each slot taking its own segment of an even spread over
    the ray store, and the ICP of the current keyframe's grid (plus the
    last n_incl keyframes' rays) onto their points. ``s``: the stage's
    constants (threshold, min_trans, min_count, k, edge, H, W, n_per,
    n_incl, keyframe_every, R, n_iters, rel_damping)."""
    ver = overlap_verify(st, n_kf, depth, rays_d, pose_world, mo_id,
                         active_id, rows, cols, K_mat, kf_frames, s["k"],
                         s["edge"], s["H"], s["W"])
    dev = depth.device
    top, top_valid = ver["top_kf_ids"], ver["top_valid"]
    k = top.shape[0]
    sel = (ver["counts"] > s["min_count"]) & top_valid
    sel = sel if bool(sel.any()) else top_valid
    order = torch.sort((~sel).to(torch.int32), stable=True).indices
    n_used = max(int(sel.sum()), 1)
    slots = torch.arange(k, device=dev)
    use = top[order[slots % n_used]]
    n_per, R = s["n_per"], s["R"]
    total = n_per * ((k + n_used - 1) // n_used)
    pos = ((slots[:, None] // n_used) * n_per
           + torch.arange(n_per, device=dev)[None, :])
    sub = torch.clamp((pos * max(R - 1, 1)) // max(total - 1, 1), 0, R - 1)

    anchor_prev, anchor_aft = _anchor(st, active_id), _anchor(st, mo_id)
    ini = pose_inverse(anchor_aft) @ (anchor_prev @ st["est_c2w"][cur_frame])
    locals_mo = submap_kf_poses(st, mo_id, kf_frames)
    dst_rays = kf_rays(use[:, None], sub).reshape(-1, 7)
    T = locals_mo[use[:, None].expand(-1, n_per).reshape(-1)]
    dd = dst_rays[:, 6:7]
    dst = T[:, :3, 3] + torch.einsum("nj,nij->ni", dst_rays[:, :3],
                                     T[:, :3, :3]) * dd
    dst_valid = dd[:, 0] > 0.0
    d = depth[rr_src, cc_src][:, None]
    src = [ini[:3, 3] + (rays_d[rr_src, cc_src] @ ini[:3, :3].T) * d]
    src_valid = [d[:, 0] > 0]
    if s["n_incl"] > 0:
        cur_kf = cur_frame // s["keyframe_every"]
        locals_prev = submap_kf_poses(st, active_id, kf_frames)
        rel = pose_inverse(anchor_aft) @ anchor_prev
        for j in range(1, s["n_incl"] + 1):
            kj = max(cur_kf - j, 0)
            P = rel @ locals_prev[kj]
            rk = kf_rays(torch.tensor(kj, device=dev), sub_incl)
            src.append(P[:3, 3] + (rk[:, :3] @ P[:3, :3].T) * rk[:, 6:7])
            src_valid.append((rk[:, 6] > 0) & (cur_kf - j >= 0))
    Tm, n_in = icp_point_to_plane(
        torch.cat(src), torch.cat(src_valid), dst, dst_valid,
        normals(dst, k=10), s["threshold"], s["n_iters"], s["rel_damping"])
    if float(torch.linalg.norm(Tm[:3, 3])) >= s["min_trans"]:
        Tm = torch.eye(4, device=dev)
    return {"top_kf_ids": top, "top_valid": top_valid,
            "counts": ver["counts"], "n_related": ver["n_related"],
            "n_valid": ver["n_valid"], "n_inliers": n_in,
            "pose_final": Tm @ ini, "pose_ini": ini}


# ----------------------------------------------------------- switch BA ---

def switch_ba(params: Dict, cfg: Dict, kf_rays, R: int, kf_mask,
              kf_poses_local, ovlp_rays, ovlp_pose_local, lr_rot: float,
              lr_trans: float, n_iters: int, n_total: int,
              pose_accum_step: int, generator):
    """The loop keyframe's pose refined against a frozen field: rays
    uniform over the keyframes of kf_mask (their poses fixed) plus a
    quota max(1/n, 1/5) of n_total from the loop keyframe's own rays
    ovlp_rays [P, 7]; a fresh pose Adam stepped every pose_accum_step
    iterations on the summed gradient. Returns (pose [4, 4], last loss)."""
    fc = FieldCfg.from_config(cfg)
    consts = bound_consts(cfg, ovlp_rays.device)
    lw = loss_weights(cfg)
    K = kf_mask.shape[0]
    dev = kf_mask.device
    n = torch.clamp(kf_mask.sum(), min=1).to(torch.float32)
    w_kf = kf_mask.to(torch.float32)
    w_kf = w_kf / torch.clamp(w_kf.sum(), min=1.0)
    w = torch.cat([w_kf, (torch.clamp(n_total / n, min=n_total / 5.0)
                          / n_total)[None]])
    draws, us = [], []
    for _ in range(n_iters):
        draws.append((torch.multinomial(w, n_total, replacement=True,
                                        generator=generator),
                      torch.randint(0, R, (n_total,), generator=generator,
                                    device=dev),
                      torch.randint(0, ovlp_rays.shape[0], (n_total,),
                                    generator=generator, device=dev)))
        us.append(draw_u(n_total, fc, generator, dev))
    p = [matrix_to_quaternion(ovlp_pose_local[:3, :3]),
         ovlp_pose_local[:3, 3]]
    opt = MaskedAdam(p, [lr_rot, lr_trans])
    kq = matrix_to_quaternion(kf_poses_local[:, :3, :3])
    kt = kf_poses_local[:, :3, 3]
    accum = [torch.zeros_like(t) for t in p]
    loss = None
    for i in range(n_iters):
        src, ray_idx, ovlp_idx = draws[i]
        rays = torch.where((src == K)[:, None], ovlp_rays[ovlp_idx],
                           kf_rays(torch.clamp(src, max=K - 1), ray_idx))
        rot = p[0].detach().requires_grad_(True)
        trans = p[1].detach().requires_grad_(True)
        T = pose_rows(qt_to_matrix(torch.cat([kq, rot[None]]),
                                   torch.cat([kt, trans[None]])), src)
        rays_dT = torch.einsum("nj,nij->in", rays[:, :3], T[:, :3, :3])
        ret = forward_losses(params, T[:, :3, 3].T, rays_dT, rays[:, 3:6].T,
                             rays[:, 6:7], fc, consts, us[i])
        loss = total_loss(ret, lw)
        g = torch.autograd.grad(loss, [rot, trans])
        accum = [a + gg for a, gg in zip(accum, g)]
        if (i + 1) % pose_accum_step == 0:
            p = opt.step(p, accum, True)
            accum = [torch.zeros_like(a) for a in accum]
    return qt_to_matrix(p[0], p[1]).detach(), loss.detach()
