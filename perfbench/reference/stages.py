"""The plain reference of the SLAM stages the benchmark checks: local
bundle adjustment (map and keyframe poses), the tracker's pose update
(random optimization, then gradient optimization) and the pose-graph
optimization of a loop closure.

Each follows MIPS-Fusion as the JAX package states it, in float32 plain
PyTorch (a frozen copy of the port's plain functions, stripped of the
sharded and lever paths the benchmark's configurations leave off). A
stage draws its random numbers from the generator it is given, in the
program's order, so the reference given the generator state of a
program call draws what that call drew.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import encodings
from .plain import (FieldCfg, draw_u, field, forward_losses,
                    matrix_to_quaternion, normalize_T, pose_inverse,
                    qt_to_matrix, quaternion_to_matrix, se3_exp, se3_log,
                    total_loss)


# ----------------------------------------------------------- optimizers ---

class MapAdam:
    """Adam as the map optimizer applies it: two groups (decoder with
    weight decay 1e-6 added to the gradient, eps 1e-8; the encoding's
    tables, eps 1e-15), betas (0.9, 0.99), one float32 step count a group
    and the bias corrections in float32."""

    def __init__(self, groups: List[Dict], betas=(0.9, 0.99)):
        self.groups = groups
        self.b1, self.b2 = betas

    @torch.no_grad()
    def step(self):
        for g in self.groups:
            ps = [p for p in g["params"] if p.grad is not None]
            if not ps:
                continue
            g["count"] = g["count"] + 1.0
            c1 = 1.0 - torch.pow(self.b1, g["count"])
            c2 = 1.0 - torch.pow(self.b2, g["count"])
            for p in ps:
                grad = p.grad
                if g["weight_decay"]:
                    grad = grad + g["weight_decay"] * p
                st = g["state"][id(p)]
                st["m"] = self.b1 * st["m"] + (1.0 - self.b1) * grad
                st["v"] = self.b2 * st["v"] + (1.0 - self.b2) * grad * grad
                p -= g["lr"] * (st["m"] / c1) / (torch.sqrt(st["v"] / c2)
                                                 + g["eps"])

    def zero_grad(self):
        for g in self.groups:
            for p in g["params"]:
                p.grad = None


class MaskedAdam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over a list of tensors, each step
    applied where the bool ``do`` holds."""

    def __init__(self, params, lrs, b1=0.9, b2=0.999, eps=1e-8):
        self.lrs, self.b1, self.b2, self.eps = list(lrs), b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = torch.zeros((), device=params[0].device)

    def step(self, params, grads, do):
        if do is True:
            do = torch.ones((), dtype=torch.bool, device=self.count.device)
        count = self.count + 1.0
        c1 = 1.0 - torch.pow(self.b1, count)
        c2 = 1.0 - torch.pow(self.b2, count)
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            m = self.b1 * self.m[i] + (1.0 - self.b1) * g
            v = self.b2 * self.v[i] + (1.0 - self.b2) * g * g
            upd = -self.lrs[i] * (m / c1) / (torch.sqrt(v / c2) + self.eps)
            out.append(torch.where(do, p + upd, p))
            self.m[i] = torch.where(do, m, self.m[i])
            self.v[i] = torch.where(do, v, self.v[i])
        self.count = torch.where(do, count, self.count)
        return out


def map_optimizer(params: Dict, cfg: Dict, moments: Optional[Dict] = None
                  ) -> MapAdam:
    """The map optimizer over the leaves of ``params`` (made leaves that
    require a gradient): the decoder, and as the embed group every leaf
    outside it, as the configuration's encoding names them. The moments
    and counts are those of ``moments`` ({"decoder"/"embed": {"count",
    "m", "v"}} by leaf name) or fresh."""
    m = cfg["mapping"]
    dec = [params["decoder"][n][k] for n in params["decoder"]
           for k in params["decoder"][n]]
    dec_names = [f"{n}.{k}" for n in params["decoder"]
                 for k in params["decoder"][n]]
    emb_names, emb = zip(*encodings.load(encodings.name_of(cfg))
                         .embed_leaves(params))
    groups = []
    for name, ps, names, lr, wd, eps in (
            ("decoder", dec, dec_names, m["lr_decoder"], 1e-6, 1e-8),
            ("embed", emb, emb_names, m["lr_embed"], 0.0, 1e-15)):
        mom = (moments or {}).get(name)
        dev = ps[0].device
        state = {id(p): ({"m": mom["m"][n].clone(), "v": mom["v"][n].clone()}
                         if mom else {"m": torch.zeros_like(p),
                                      "v": torch.zeros_like(p)})
                 for p, n in zip(ps, names)}
        count = (mom["count"].clone() if mom
                 else torch.zeros((), device=dev))
        groups.append({"params": ps, "lr": float(lr), "weight_decay": wd,
                       "eps": eps, "state": state, "count": count})
    return MapAdam(groups)


# ------------------------------------------------------------- local BA ---

def kf_sampling_weights(kf_mask, first_kf, last_kf, sample: int,
                        pixels_cur: float):
    """Expected rays a keyframe slot [K + 1]; slot K the current frame."""
    K = kf_mask.shape[0]
    n = torch.clamp(kf_mask.sum(), min=1)
    nf = n.to(torch.float32)
    big = n > 2
    q_first = torch.clamp(sample / nf, min=sample / 10.0)
    q_last = torch.where(big, torch.clamp(sample / nf, min=sample / 5.0),
                         torch.zeros_like(nf))
    n_other = torch.clamp(nf - 1.0 - big.to(nf.dtype), min=1.0)
    q_other = torch.clamp(sample - q_first - q_last, min=0.0) / n_other
    idx = torch.arange(K, device=kf_mask.device)
    w = torch.where(idx == first_kf, q_first,
                    torch.where((idx == last_kf) & big, q_last, q_other))
    w = w * kf_mask.to(w.dtype)
    w_cur = (torch.clamp(sample / nf, min=float(pixels_cur))
             if pixels_cur > 0 else torch.zeros_like(nf))
    return torch.cat([w, w_cur[None]])


def ba_draws(w, n_iters: int, n_total: int, sizes, fc: FieldCfg, generator):
    """Per iteration (source slot, keyframe ray, current-frame ray), and
    per iteration the z perturbation."""
    draws, us = [], []
    for _ in range(n_iters):
        draws.append((torch.multinomial(w, n_total, replacement=True,
                                        generator=generator),)
                     + tuple(torch.randint(0, s, (n_total,),
                                           generator=generator,
                                           device=w.device) for s in sizes))
        us.append(draw_u(n_total, fc, generator, w.device))
    return draws, us


def pose_rows(T, src):
    onehot = torch.nn.functional.one_hot(src, T.shape[0]).to(T.dtype)
    return (onehot @ T.reshape(T.shape[0], 16)).reshape(-1, 4, 4)


def local_ba(params: Dict, opt: MapAdam, kf_ray_fn, R: int, kf_mask,
             first_kf, last_kf, kf_poses, cur_rays, cur_pose, cfg: Dict,
             n_total: int, generator, include_current: bool,
             optim_cur: bool):
    """Joint map and keyframe-pose BA over one submap. ``kf_ray_fn(slot,
    ray)`` gives the stored rays [N, 7] of keyframe slots at ray indices
    (R a keyframe). Returns (keyframe quaternions [K, 4], translations
    [K, 3], current quaternion, translation, last loss, and per keyframe
    coordinate the largest accumulated pose gradient a pose step took,
    [K, 4] and [K, 3]);
    ``params`` are stepped in place."""
    m = cfg["mapping"]
    fc = FieldCfg.from_config(cfg)
    lw = (float(cfg["training"]["rgb_weight"]),
          float(cfg["training"]["depth_weight"]),
          float(cfg["training"]["sdf_weight"]),
          float(cfg["training"]["fs_weight"]))
    from .plain import bound_consts
    consts = bound_consts(cfg, kf_poses.device)
    K = kf_mask.shape[0]
    dev = kf_mask.device
    w = kf_sampling_weights(kf_mask, first_kf, last_kf, int(m["sample"]),
                            m["pixels_cur"] if include_current else 0)
    draws, us = ba_draws(w, int(m["iters"]), n_total, (R, cur_rays.shape[0]),
                         fc, generator)
    pose_p = [torch.cat([matrix_to_quaternion(kf_poses[:, :3, :3]),
                         matrix_to_quaternion(cur_pose[:3, :3])[None]]),
              torch.cat([kf_poses[:, :3, 3], cur_pose[None, :3, 3]])]
    pose_opt = MaskedAdam(pose_p, [m["lr_rot"], m["lr_trans"]])
    idx = torch.arange(K, device=dev)
    free = torch.cat([kf_mask & (idx != first_kf),
                      torch.full((1,), bool(optim_cur), device=dev)]
                     ).to(torch.float32)[:, None]
    accum = [torch.zeros_like(p) for p in pose_p]
    loss = pose_grads = None
    for i in range(int(m["iters"])):
        src, ray_idx, cur_idx = draws[i]
        from_cur = src == K
        rays = torch.where(from_cur[:, None], cur_rays[cur_idx],
                           kf_ray_fn(torch.clamp(src, max=K - 1), ray_idx))
        rot = pose_p[0].detach().requires_grad_(True)
        trans = pose_p[1].detach().requires_grad_(True)
        T = pose_rows(qt_to_matrix(rot, trans), src)
        rays_dT = torch.einsum("nj,nij->in", rays[:, :3], T[:, :3, :3])
        ret = forward_losses(params, T[:, :3, 3].T, rays_dT, rays[:, 3:6].T,
                             rays[:, 6:7], fc, consts, us[i])
        loss = total_loss(ret, lw)
        opt.zero_grad()
        loss.backward()
        if ((i + 1) % int(m["map_accum_step"]) == 0
                and (i + 1) > int(m["map_wait_step"])):
            opt.step()
        accum = [a + g * free for a, g in zip(accum, (rot.grad, trans.grad))]
        if (i + 1) % int(m["pose_accum_step"]) == 0:
            step_g = [a.detach()[:K].abs() for a in accum]
            pose_grads = step_g if pose_grads is None else [
                torch.maximum(a, b) for a, b in zip(pose_grads, step_g)]
            pose_p = pose_opt.step(pose_p, accum, True)
            accum = [torch.zeros_like(a) for a in accum]
    return (pose_p[0][:K].detach(), pose_p[1][:K].detach(),
            pose_p[0][K].detach(), pose_p[1][K].detach(), loss.detach(),
            pose_grads)


# ------------------------------------------------------------- tracking ---

def _linspace_idx(lo: int, hi: int, n: int, device):
    return torch.linspace(lo, hi, n, device=device).long()


def _pose_6d_to_7d(p6):
    imag_sq = (p6[:, :3] ** 2).sum(-1)
    qw = torch.where(imag_sq <= 1.0,
                     torch.sqrt(torch.clamp(1.0 - imag_sq, min=0.0)),
                     torch.zeros_like(imag_sq))
    return torch.cat([qw[:, None], p6], dim=-1)


def ro_optimize(params, fc: FieldCfg, consts, cfg: Dict, pst, depth_img,
                rays_dir_img, initial_pose, n_iters: int):
    """Particle search: each iteration scores every particle's pose by
    the mean |sdf| at the shifted pixel grid's back-projected points and
    moves to the fitness-weighted mean of the particles better than the
    current pose."""
    ro = cfg["tracking"]["RO"]
    H, W = depth_img.shape
    dev = pst.device
    rows = _linspace_idx(0, H - 1, int(ro["n_rows"]), dev)
    cols = _linspace_idx(0, W - 1, int(ro["n_cols"]), dev)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    row_idx = torch.clamp(rr.reshape(-1), 0, H - 5)
    col_idx = torch.clamp(cc.reshape(-1), 0, W - 5)
    sdf_weight = 1000.0
    rot, trans = initial_pose[:3, :3], initial_pose[:3, 3]
    search = torch.full((1, 6), float(ro["initial_scaling_factor"]),
                        device=dev)
    identity7 = torch.eye(1, 7, device=dev)[0]
    for i in range(n_iters):
        off = i % 5
        d = depth_img[row_idx + off, col_idx + off][:, None]
        ptsT = (rays_dir_img[row_idx + off, col_idx + off] * d).T
        valid = (d[:, 0] > 0.0).to(d.dtype)
        pst7 = _pose_6d_to_7d(pst * search)
        abs_rot = rot[None] @ quaternion_to_matrix(pst7[:, :4])
        abs_trans = trans[None] + pst7[:, 4:]
        n = abs_rot.shape[0]
        worldT = (abs_rot @ ptsT + abs_trans[:, :, None]).permute(
            1, 0, 2).reshape(3, -1)
        with torch.no_grad():
            sdf = field(params, normalize_T(worldT, consts), fc,
                        sdf_only=True)[0]
        sdf = sdf.reshape(n, -1) * fc.trunc
        mean_sdf = (valid[None] * sdf.abs()).mean(-1)
        fit = mean_sdf * sdf_weight
        f0 = fit[0]
        better = (fit < f0).to(fit.dtype)
        weights = (f0 - fit) * better
        wsum = weights.sum() + 1e-5
        success = better.sum() > 0
        mean_aps = torch.where(success, (weights * mean_sdf).sum() / wsum,
                               mean_sdf[0])
        mean_tf = (pst7 * weights[:, None]).sum(0) / wsum
        quat = mean_tf[:4] / (torch.linalg.norm(mean_tf[:4]) + 1e-5)
        mean_tf = torch.where(success, torch.cat([quat, mean_tf[4:]]),
                              identity7)
        dR = quaternion_to_matrix(mean_tf[:4])
        rot = torch.where(success, rot @ dR, rot)
        trans = torch.where(success, trans + mean_tf[4:], trans)
        s = mean_tf[1:].abs() + 1e-4
        ss = (float(ro["rescaling_factor"]) * mean_aps * s
              / torch.linalg.norm(s) + 1e-4)
        search = torch.where(success, ss, ss * 2.0)[None]
    T = torch.eye(4, device=dev)
    T[:3, :3] = rot
    T[:3, 3] = trans
    return T


def sample_pixels(noise, H: int, W: int, n_rows: int, n_cols: int,
                  depth_img, n_total: int, edge_h: int, edge_w: int):
    """The grid of n_rows x n_cols pixels plus the valid-first random
    pixels (by the uniform score ``noise``) up to n_total, inside the
    border."""
    dev = depth_img.device
    edge_h = min(edge_h, max((H - 8) // 2, 0))
    edge_w = min(edge_w, max((W - 8) // 2, 0))
    Hi, Wi = H - 2 * edge_h, W - 2 * edge_w
    rr, cc = torch.meshgrid(edge_h + _linspace_idx(0, Hi - 1, n_rows, dev),
                            edge_w + _linspace_idx(0, Wi - 1, n_cols, dev),
                            indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    n_rand = n_total - rr.shape[0]
    if n_rand <= 0:
        return rr[:n_total], cc[:n_total]
    interior = depth_img[edge_h:H - edge_h, edge_w:W - edge_w]
    score = (interior > 0.0).to(torch.float32).reshape(-1) + noise
    idx = torch.topk(score, n_rand).indices
    return (torch.cat([rr, edge_h + idx // Wi]),
            torch.cat([cc, edge_w + idx % Wi]))


def go_optimize(params, fc: FieldCfg, consts, cfg: Dict, rays_d_cam,
                target_rgb, target_d, initial_pose, us, lw):
    """Adam on (quaternion, translation) against the rendering losses; the
    pose of the best loss seen before an update is kept. Returns (pose,
    its loss, and with ``best`` every iterate (pose, loss) the search
    kept alive, else the final pose alone)."""
    t = cfg["tracking"]
    p = [matrix_to_quaternion(initial_pose[:3, :3]), initial_pose[:3, 3]]
    opt = MaskedAdam(p, [t["lr_rot"], t["lr_trans"]])
    dev = rays_d_cam.device
    best_loss = torch.full((), float("inf"), device=dev)
    best_p = list(p)
    thresh = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    wait = int(t.get("wait_iters", 100))
    iterates = []
    for i, u in enumerate(us):
        rot = p[0].detach().requires_grad_(True)
        trans = p[1].detach().requires_grad_(True)
        T = qt_to_matrix(rot, trans)
        rays_dT = T[:3, :3] @ rays_d_cam.T
        ret = forward_losses(params, T[:3, 3][:, None].expand_as(rays_dT),
                             rays_dT, target_rgb.T, target_d, fc, consts, u,
                             emd_w=0.0)
        loss = total_loss(ret, lw)
        g = torch.autograd.grad(loss, [rot, trans])
        loss = loss.detach()
        if bool(alive):
            iterates.append((T.detach(), loss))
        improved = alive & (loss < best_loss)
        best_loss = torch.where(improved, loss, best_loss)
        best_p = [torch.where(improved, c, b) for c, b in zip(p, best_p)]
        thresh = torch.where(alive, torch.where(improved & (i > 0),
                                                torch.zeros_like(thresh),
                                                thresh + 1), thresh)
        do = alive & (thresh <= wait)
        p = opt.step(p, list(g), do)
        alive = do
    if not bool(t["best"]):
        T = qt_to_matrix(p[0], p[1])
        return T, best_loss, [(T, best_loss)]
    return qt_to_matrix(best_p[0], best_p[1]), best_loss, iterates


def track_pose(params, cfg: Dict, pst, packed, prev_pose, prev_prev,
               use_const_speed: bool, generator, loss_ewma,
               tie_rel: float = 0.0):
    """Motion model -> RO -> GO -> pose gate of one frame ([H, W, 7]
    packed: direction, rgb, depth). Returns (pose, loss, ties): ties the
    gated poses of the GO iterates whose loss lies within ``tie_rel`` of
    the best (relative), the best's among them: the choices that
    round-off in the losses can make."""
    t = cfg["tracking"]
    fc = FieldCfg.from_config(cfg, tracking=True)
    from .plain import bound_consts, loss_weights
    consts = bound_consts(cfg, packed.device)
    lw = loss_weights(cfg)
    rgb, depth, dirs = packed[..., 3:6], packed[..., 6], packed[..., :3]
    H, W = depth.shape
    dev = depth.device
    ro = t["RO"]
    # the draws, in the program's order: the pixel score, then GO's z
    edge_h = min(int(t["ignore_edge_H"]), max((H - 8) // 2, 0))
    edge_w = min(int(t["ignore_edge_W"]), max((W - 8) // 2, 0))
    noise = None
    n_go = int(t["sample"])
    if n_go > int(ro["n_rows"]) * int(ro["n_cols"]):
        noise = torch.rand(((H - 2 * edge_h) * (W - 2 * edge_w),),
                           generator=generator, device=dev)
    us = [draw_u(n_go, fc, generator, dev) for _ in range(int(t["iter"]))]
    pred = ((prev_pose @ pose_inverse(prev_prev)) @ prev_pose
            if use_const_speed else prev_pose)
    pose = pred
    if int(t["iter_RO"]) > 0:
        pose = ro_optimize(params, fc, consts, cfg, pst, depth, dirs, pose,
                           int(t["iter_RO"]))
    rr, cc = sample_pixels(noise, H, W, int(ro["n_rows"]), int(ro["n_cols"]),
                           depth, n_go, int(t["ignore_edge_H"]),
                           int(t["ignore_edge_W"]))
    pose, loss, iterates = go_optimize(
        params, fc, consts, cfg, dirs[rr, cc], rgb[rr, cc],
        depth[rr, cc][:, None], pose, us, lw)
    gate = t.get("pose_gate", {}) or {}
    rel, abs_ = float(gate.get("rel", 0.0)), float(gate.get("abs", 0.0))

    def gated(T, L):
        if rel <= 0.0:
            return T
        ok = (loss_ewma <= 0.0) | (L <= abs_) | (L <= rel * loss_ewma)
        return torch.where(ok, T, pred)
    ties = [gated(T, L) for T, L in iterates
            if bool(L <= loss * (1.0 + tie_rel))]
    return gated(pose, loss), loss, ties


# ------------------------------------------------------------------ PGO ---

def _residuals(xi, nodes, edges, rel_poses, weights):
    n = se3_exp(xi) @ nodes
    ni, nj = n[edges[:, 0]], n[edges[:, 1]]
    err = se3_log(rel_poses @ (pose_inverse(ni) @ nj))
    return (err * weights[:, None]).reshape(-1)


def optimize_pose_graph(nodes, edges, rel_poses, weights, node_mask,
                        n_iters: int = 10):
    """Damped Gauss-Newton over the node poses; frozen nodes keep theirs."""
    M = nodes.shape[0]
    free = node_mask.to(nodes.dtype)
    free6 = free[:, None].expand(M, 6).reshape(1, M * 6)
    eye = torch.eye(M * 6, dtype=nodes.dtype, device=nodes.device)
    xi0 = torch.zeros((M, 6), dtype=nodes.dtype, device=nodes.device)
    jac = torch.func.jacfwd(_residuals)
    for _ in range(n_iters):
        r = _residuals(xi0, nodes, edges, rel_poses, weights)
        J = jac(xi0, nodes, edges, rel_poses, weights).reshape(-1, M * 6)
        Jm = J * free6
        xi = (-torch.linalg.solve(Jm.T @ Jm + 1e-6 * eye, Jm.T @ r)
              ).reshape(M, 6) * free[:, None]
        nodes = se3_exp(xi) @ nodes
    return nodes


def pgo_anchors(kf_c2w, first_kf_table, adjacency, local_prev, local_aft,
                aft_id: int, prev_id: int, used: int, key_w: float):
    """The anchor table after the loop closure's pose-graph optimization:
    nodes are the submaps' first-keyframe world poses, one edge a pair
    (weight 1 where adjacent and used) at its current relative pose, and
    the key edge observed as local_prev local_aft^-1; submap 0 fixed."""
    M = first_kf_table.shape[0]
    Nk = kf_c2w.shape[0]
    dev = kf_c2w.device
    first_kf = torch.clamp(first_kf_table, 0, Nk - 1)
    anchors = kf_c2w[first_kf]
    pairs = torch.tensor([(i, j) for i in range(M) for j in range(i + 1, M)],
                         dtype=torch.int64, device=dev).reshape(-1, 2)
    edges = torch.cat([pairs, torch.tensor([[aft_id, prev_id]],
                                           device=dev)])
    pi, pj = pairs[:, 0], pairs[:, 1]
    rels = torch.cat([pose_inverse(anchors[pj]) @ anchors[pi],
                      (local_prev @ pose_inverse(local_aft))[None]])
    w = ((adjacency[pi, pj] > 0) & (pi < used) & (pj < used)).to(
        anchors.dtype)
    weights = torch.cat([w, torch.full((1,), float(key_w), device=dev)])
    ar = torch.arange(M, device=dev)
    nodes = optimize_pose_graph(anchors, edges, rels, weights,
                                (ar >= 1) & (ar < used))
    out = kf_c2w.clone()
    for mi in range(min(used, M)):
        k = int(first_kf_table[mi])
        if 0 <= k < Nk:
            out[k] = nodes[mi]
    return out
