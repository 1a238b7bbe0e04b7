"""Mesh extraction: per-submap and joint (entropy/distance-fused) meshes.

Port of ``mipsfusion_tpu/mesher/mesher.py``:

  * per-submap: a uniform grid over the submap's box (or the observed-
    surface box), SDF queries in chunks of ``query_chunk`` points through
    K1 (``ops/field_cuda.field_forward``, full outputs, no embed), marching
    cubes on the host (``marching.py``), a per-vertex colour query;
  * joint: the fused TSDF volume is computed on the device: grid points
    are generated from the flat index, every submap is queried (one K1
    call per submap per chunk), and the weights
    ``exp(-10 entropy) * gauss(dist / sigma) * mask`` fuse the SDFs; the
    volume goes to the host in float16, as the JAX package sends it, so
    marching cubes sees the same volume;
  * the visibility filters (small components, faces no keyframe sees)
    and the PLY reader and writer are numpy and scipy code, copied.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import scene_rep as sr
from ..ops.field_cuda import field_forward
from .marching import marching_cubes


@dataclasses.dataclass
class MeshConfig:
    voxel_size: float = 0.05
    query_chunk: int = 131072
    iso: float = 0.0


def _grid_points(lo: np.ndarray, hi: np.ndarray, voxel: float):
    xs = np.arange(lo[0], hi[0] + voxel, voxel, dtype=np.float32)
    ys = np.arange(lo[1], hi[1] + voxel, voxel, dtype=np.float32)
    zs = np.arange(lo[2], hi[2] + voxel, voxel, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    return pts, (len(xs), len(ys), len(zs)), (xs, ys, zs)


def surface_occupancy(points_w: np.ndarray, lo: np.ndarray,
                      hi: np.ndarray, cvox: float = 0.2,
                      dilate: int = 1):
    """Coarse occupancy of observed surface (cvox voxels, grown by
    ``dilate`` voxels) as a point -> bool query. Grid points it rejects
    are invalid for the extractor: the SDF is supervised only near
    observed surface, so far from it the field's crossings are spurious."""
    lo = np.asarray(lo, np.float64) - cvox * (dilate + 1)
    hi = np.asarray(hi, np.float64) + cvox * (dilate + 1)
    dims = np.maximum(((hi - lo) / cvox).astype(int) + 1, 1)
    occ = np.zeros(dims, bool)
    idx = np.floor((points_w - lo) / cvox).astype(int)
    ok = ((idx >= 0) & (idx < dims)).all(axis=1)
    idx = idx[ok]
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    if dilate:
        from scipy.ndimage import binary_dilation
        occ = binary_dilation(occ, iterations=dilate)
    return _Occupancy(occ, lo.astype(np.float32), float(cvox))


class _Occupancy:
    """Callable point -> bool occupancy query exposing its grid (the device
    fused volume uploads .occ / .lo / .cvox once)."""

    def __init__(self, occ: np.ndarray, lo: np.ndarray, cvox: float):
        self.occ, self.lo, self.cvox = occ, lo, cvox

    def __call__(self, q: np.ndarray) -> np.ndarray:
        dims = np.asarray(self.occ.shape)
        qi = np.floor((q - self.lo) / self.cvox).astype(int)
        inb = ((qi >= 0) & (qi < dims)).all(axis=1)
        qi = np.clip(qi, 0, dims - 1)
        return inb & self.occ[qi[:, 0], qi[:, 1], qi[:, 2]]


def kf_surface_points(kf_world: np.ndarray, kf_rays: np.ndarray
                      ) -> np.ndarray:
    """Back-project stored keyframe rays to world surface points.
    kf_world [K,4,4], kf_rays [K,R,7] = (dir, rgb, depth); zero-depth rays
    dropped."""
    dirs_w = np.einsum("kij,krj->kri", kf_world[:, :3, :3],
                       kf_rays[..., :3])
    pts = kf_world[:, None, :3, 3] + dirs_w * kf_rays[..., 6:7]
    return pts.reshape(-1, 3)[kf_rays[..., 6].reshape(-1) > 0]


def keyframe_occupancies(kf_world: np.ndarray, kf_rays: np.ndarray,
                         kf_bind: np.ndarray, n_submaps: int,
                         bound: np.ndarray, cvox: float = 0.2,
                         dilate: int = 1):
    """The extractor's validity and extent from the keyframes' observed
    surface: (the occupancy of every keyframe's surface points, one per
    submap from the keyframes bound to it (the global one where none is),
    the in-bound surface box grown by 2 cvox or None). A submap's field is
    supervised wherever its keyframes' rays land, so the grid spans the
    observed surface and each submap is valid near its own."""
    surf = kf_surface_points(kf_world, kf_rays)
    observed = surface_occupancy(surf, bound[:, 0], bound[:, 1], cvox=cvox,
                                 dilate=dilate)
    inb = ((surf > bound[:, 0]) & (surf < bound[:, 1])).all(axis=1)
    grid_bounds = ((surf[inb].min(axis=0) - 2 * cvox,
                    surf[inb].max(axis=0) + 2 * cvox) if inb.any() else None)
    per_submap = []
    for m in range(n_submaps):
        sel = (kf_bind[:, 0] == m) | (kf_bind[:, 1] == m)
        per_submap.append(surface_occupancy(
            kf_surface_points(kf_world[sel], kf_rays[sel]), bound[:, 0],
            bound[:, 1], cvox=cvox, dilate=dilate) if sel.any() else observed)
    return observed, per_submap, grid_bounds


class Mesher:
    """Meshes of submap fields; queries run on the device of ``consts``.

    ``times`` holds the last extraction's wall seconds per step
    (``volume``: the fused volume's queries and copies; ``marching``;
    ``colors``) and, on the card, ``volume_device_ms``: the device time of
    the volume's queries and fusion between CUDA events, so that
    ``volume`` less it is the host's share and the copies."""

    def __init__(self, fcfg: sr.FieldConfig, consts: sr.FieldConsts,
                 mesh_cfg: Optional[MeshConfig] = None):
        self.fcfg = fcfg
        self.consts = consts
        self.cfg = mesh_cfg or MeshConfig()
        self.device = consts.bb_lo.device
        self.times: Dict[str, float] = {}

    def _query_T(self, params: Dict, ptsT: torch.Tensor) -> torch.Tensor:
        """K1 on local-frame points [3, n] -> [5 + C, n] (rows 0-2 rgb,
        3 sdf, 4 entropy)."""
        xg = (sr.normalize_T(ptsT, self.consts)
              / self.fcfg.norm_factor).contiguous()
        return field_forward(xg, params["planes"], params["decoder"],
                             *self.fcfg.meta)

    @torch.no_grad()
    def query_grid(self, params: Dict, pts_local: np.ndarray) -> np.ndarray:
        """Chunked device query -> [N, 5] (rgb, sdf, entropy)."""
        n = pts_local.shape[0]
        out = np.empty((n, 5), np.float32)
        chunk = self.cfg.query_chunk
        for s in range(0, n, chunk):
            seg = torch.as_tensor(np.ascontiguousarray(
                pts_local[s:s + chunk], np.float32), device=self.device)
            out[s:s + chunk] = self._query_T(params, seg.T)[:5].T.cpu().numpy()
        return out

    def query_grid_masked(self, params: Dict, pts_local: np.ndarray,
                          mask: np.ndarray, fill: float = 0.0
                          ) -> np.ndarray:
        """query_grid over pts_local[mask] only, scattered back to [N, 5]
        (unqueried rows = fill)."""
        out = np.full((pts_local.shape[0], 5), fill, np.float32)
        if mask.any():
            out[mask] = self.query_grid(params, pts_local[mask])
        return out

    # ------------------------------------------------------------------
    # per-submap mesh
    # ------------------------------------------------------------------

    def extract_single_mesh(self, params: Dict, anchor_world: np.ndarray,
                            center_world: np.ndarray, length: np.ndarray,
                            trunc: float = 0.3, with_color: bool = True,
                            bound_world: Optional[np.ndarray] = None,
                            observed_fn=None, grid_bounds=None):
        """Mesh one submap. The box (center, length) is in world coords;
        grid points go to the submap's local frame for the queries, and
        vertices come back in world coords. ``grid_bounds`` (lo, hi)
        overrides the box. ``observed_fn`` (points -> bool, see
        surface_occupancy) marks unobserved grid points invalid; observed
        SDF values are clipped inside the truncation band, so saturated
        free space next to surface stays valid."""
        if grid_bounds is not None:
            lo, hi = np.asarray(grid_bounds[0]), np.asarray(grid_bounds[1])
        else:
            lo = center_world - 0.5 * length
            hi = center_world + 0.5 * length
        if bound_world is not None:
            lo = np.maximum(lo, bound_world[:, 0])
            hi = np.minimum(hi, bound_world[:, 1])
        pts_w, shape, _ = _grid_points(lo, hi, self.cfg.voxel_size)

        w2l = np.linalg.inv(anchor_world)
        pts_l = pts_w @ w2l[:3, :3].T + w2l[:3, 3]
        if observed_fn is not None:
            obs = observed_fn(pts_w)
            raw = self.query_grid_masked(params, pts_l.astype(np.float32),
                                         obs)
            sdf = np.where(obs, np.clip(raw[:, 3], -0.98 * trunc,
                                        0.98 * trunc), 2.0 * trunc)
        else:
            raw = self.query_grid(params, pts_l.astype(np.float32))
            sdf = raw[:, 3]
        sdf = sdf.reshape(shape)

        verts_g, faces = marching_cubes(sdf, self.cfg.iso, trunc)
        if len(verts_g) == 0:
            return (np.zeros((0, 3)), np.zeros((0, 3), np.int64),
                    np.zeros((0, 3)))
        verts_w = lo[None, :] + verts_g * self.cfg.voxel_size

        colors = np.zeros_like(verts_w)
        if with_color:
            v_l = verts_w @ w2l[:3, :3].T + w2l[:3, 3]
            raw_v = self.query_grid(params, v_l.astype(np.float32))
            colors = 1.0 / (1.0 + np.exp(-raw_v[:, :3]))  # sigmoid
        return verts_w, faces, colors

    # ------------------------------------------------------------------
    # the fused TSDF volume on the device
    # ------------------------------------------------------------------

    @torch.no_grad()
    def fused_sdf_volume_device(self, submap_params, anchors_world,
                                centers, sigma, observed: "_Occupancy",
                                submap_observed, lo, shape,
                                voxel: float, trunc: float) -> np.ndarray:
        """Fused TSDF volume [nx, ny, nz] computed on the device, chunk by
        chunk; each chunk comes back to the host as float16."""
        dev = self.device

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=dev)

        w2l = f32(np.linalg.inv(anchors_world))                  # [M, 4, 4]
        occ_m = torch.as_tensor(np.stack(
            [s.occ for s in submap_observed]).astype(np.bool_), device=dev)
        occ_glob = torch.as_tensor(observed.occ.astype(np.bool_), device=dev)
        dims = torch.as_tensor(occ_glob.shape, dtype=torch.int64, device=dev)
        occ_lo, centers_d, lo_d = f32(observed.lo), f32(centers), f32(lo)
        cvox, voxel_d, sigma_d = f32(observed.cvox), f32(voxel), f32(sigma)
        nx, ny, nz = shape
        N = nx * ny * nz
        out = np.empty(N, np.float16)
        events = []
        for s in range(0, N, self.cfg.query_chunk):
            if dev.type == "cuda":
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            idx = torch.arange(s, min(s + self.cfg.query_chunk, N),
                               device=dev)
            ijk = torch.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz],
                              -1)
            pts = lo_d + voxel_d * ijk.to(torch.float32)         # [B, 3]
            qi = torch.floor((pts - occ_lo) / cvox).to(torch.int64)
            inb = ((qi >= 0) & (qi < dims)).all(-1)
            qc = torch.minimum(torch.clamp(qi, min=0), dims - 1)
            obs = inb & occ_glob[qc[:, 0], qc[:, 1], qc[:, 2]]
            occ_pm = occ_m[:, qc[:, 0], qc[:, 1], qc[:, 2]]      # [M, B]
            sdf_m, ent_m = [], []
            for p, T in zip(submap_params, w2l):
                pl = pts @ T[:3, :3].T + T[:3, 3]
                raw = self._query_T(p, pl.T)
                sdf_m.append(raw[3])
                ent_m.append(raw[4])
            sdf_m, ent_m = torch.stack(sdf_m), torch.stack(ent_m)
            dist = torch.linalg.norm(pts[None] - centers_d[:, None], dim=-1)
            mask = occ_pm & obs[None]
            w = (torch.exp(-10.0 * ent_m)
                 * torch.exp(-0.5 * (dist / sigma_d) ** 2) * mask)
            wsum = w.sum(0)
            fused = (w * sdf_m).sum(0) / torch.clamp(wsum, min=1e-12)
            fused = torch.clamp(fused, -0.98 * trunc, 0.98 * trunc)
            fused = torch.where(mask.any(0), fused,
                                torch.full_like(fused, 2.0 * trunc))
            fused = fused.to(torch.float16)
            if events:
                events[-1][1].record()
            out[s:s + len(idx)] = fused.cpu().numpy()
        if events:
            self.times["volume_device_ms"] = sum(a.elapsed_time(b)
                                                 for a, b in events)
        return out.reshape(nx, ny, nz).astype(np.float32)

    # ------------------------------------------------------------------
    # joint mesh
    # ------------------------------------------------------------------

    def extract_mesh_jointly(self, submap_params: List[Dict],
                             anchors_world: np.ndarray,
                             centers: np.ndarray, lengths: np.ndarray,
                             trunc: float = 0.3, with_color: bool = True,
                             bound_world: Optional[np.ndarray] = None,
                             observed_fn=None,
                             submap_observed_fns=None, grid_bounds=None):
        """Fuse all submaps' SDFs into one mesh.

        anchors_world [M,4,4]; centers/lengths [M,3] world boxes.
        ``observed_fn``: coarse surface-occupancy visibility;
        ``submap_observed_fns`` [M] replaces the per-submap box masks with
        each submap's own observed-surface occupancy; ``grid_bounds``
        (lo, hi) overrides the grid extent. With occupancies of one shape
        the volume is fused on the device, else on the host.
        """
        M = len(submap_params)
        lo = np.min(centers - 0.5 * lengths, axis=0)
        hi = np.max(centers + 0.5 * lengths, axis=0)
        if grid_bounds is not None:
            lo, hi = np.asarray(grid_bounds[0]), np.asarray(grid_bounds[1])
        if bound_world is not None:
            lo = np.maximum(lo, bound_world[:, 0])
            hi = np.minimum(hi, bound_world[:, 1])
        # sigma of the Gaussian distance weights: the largest distance from
        # a submap center to the grid (attained at a corner) over 3
        corners = np.stack(np.meshgrid([lo[0], hi[0]], [lo[1], hi[1]],
                                       [lo[2], hi[2]], indexing="ij"),
                           axis=-1).reshape(-1, 3)
        max_d = max(float(np.linalg.norm(corners - c, axis=1).max())
                    for c in centers)
        sigma = max(max_d, 1e-6) / 3.0

        device_path = (isinstance(observed_fn, _Occupancy)
                       and submap_observed_fns is not None
                       and all(isinstance(f, _Occupancy)
                               for f in submap_observed_fns)
                       and len({f.occ.shape for f in submap_observed_fns}
                               | {observed_fn.occ.shape}) == 1)
        self.times = {}
        t0 = time.perf_counter()
        if device_path:
            # _grid_points uses arange(lo, hi + voxel): the same dims
            shape = tuple(len(np.arange(lo[a], hi[a] + self.cfg.voxel_size,
                                        self.cfg.voxel_size,
                                        dtype=np.float32))
                          for a in range(3))
            sdf_grid = self.fused_sdf_volume_device(
                submap_params, anchors_world, centers, sigma,
                observed_fn, list(submap_observed_fns), lo, shape,
                self.cfg.voxel_size, trunc)
        else:
            pts_w, shape, _ = _grid_points(lo, hi, self.cfg.voxel_size)
            n = pts_w.shape[0]
            obs = observed_fn(pts_w) if observed_fn is not None \
                else np.ones(n, bool)

            sdf_all = np.zeros((n, M), np.float32)
            ent_all = np.zeros((n, M), np.float32)
            mask_all = np.zeros((n, M), bool)
            dist_all = np.zeros((n, M), np.float32)
            for m in range(M):
                w2l = np.linalg.inv(anchors_world[m])
                if submap_observed_fns is not None:
                    mask_all[:, m] = submap_observed_fns[m](pts_w) & obs
                else:
                    inlo = centers[m] - 0.5 * lengths[m]
                    inhi = centers[m] + 0.5 * lengths[m]
                    mask_all[:, m] = ((pts_w > inlo)
                                      & (pts_w < inhi)).all(-1) & obs
                pts_l = pts_w @ w2l[:3, :3].T + w2l[:3, 3]
                raw = self.query_grid_masked(submap_params[m],
                                             pts_l.astype(np.float32),
                                             mask_all[:, m])
                sdf_all[:, m] = raw[:, 3]
                ent_all[:, m] = raw[:, 4]
                dist_all[:, m] = np.linalg.norm(pts_w - centers[m],
                                                axis=-1)

            gauss = np.exp(-0.5 * (dist_all / sigma) ** 2)
            w = np.exp(-10.0 * ent_all) * gauss * mask_all
            wsum = w.sum(axis=1, keepdims=True)
            visible = mask_all.any(axis=1)
            w = np.where(wsum > 1e-12, w / np.maximum(wsum, 1e-12), 0.0)
            fused = (w * sdf_all).sum(axis=1)
            fused = np.clip(fused, -0.98 * trunc, 0.98 * trunc)
            fused = np.where(visible, fused, np.inf)   # invalid -> skipped
            sdf_grid = fused.reshape(shape).astype(np.float32)
        self.times["volume"] = time.perf_counter() - t0
        self.times["grid_shape"] = tuple(int(n) for n in shape)

        t0 = time.perf_counter()
        verts_g, faces = marching_cubes(sdf_grid, self.cfg.iso, trunc)
        self.times["marching"] = time.perf_counter() - t0
        if len(verts_g) == 0:
            return (np.zeros((0, 3)), np.zeros((0, 3), np.int64),
                    np.zeros((0, 3)))
        verts_w = lo[None, :] + verts_g * self.cfg.voxel_size

        t0 = time.perf_counter()
        colors = np.zeros_like(verts_w)
        if with_color:
            # per-vertex fused colour with the same weighting scheme
            nv = verts_w.shape[0]
            rgb_v = np.zeros((nv, M, 3), np.float32)
            wv = np.zeros((nv, M), np.float32)
            for m in range(M):
                w2l = np.linalg.inv(anchors_world[m])
                v_l = verts_w @ w2l[:3, :3].T + w2l[:3, 3]
                raw = self.query_grid(submap_params[m],
                                      v_l.astype(np.float32))
                rgb_v[:, m] = 1.0 / (1.0 + np.exp(-raw[:, :3]))
                d = np.linalg.norm(verts_w - centers[m], axis=-1)
                inlo = centers[m] - 0.5 * lengths[m]
                inhi = centers[m] + 0.5 * lengths[m]
                msk = ((verts_w > inlo) & (verts_w < inhi)).all(-1)
                wv[:, m] = np.exp(-10.0 * raw[:, 4]) * np.exp(
                    -0.5 * (d / sigma) ** 2) * msk
            wvs = wv.sum(axis=1, keepdims=True)
            wv = np.where(wvs > 1e-12, wv / np.maximum(wvs, 1e-12),
                          1.0 / M)
            colors = (wv[..., None] * rgb_v).sum(axis=1)
        self.times["colors"] = time.perf_counter() - t0
        return verts_w, faces, colors


def point_seen_mask(verts_w: np.ndarray, kf_poses_w: np.ndarray,
                    K: np.ndarray, H: int, W: int,
                    kf_max_depths: np.ndarray,
                    edge: Optional[int] = None) -> np.ndarray:
    """Bool [V]: vertex visible from at least one keyframe: projected
    (OpenGL, z < 0 in front) inside an ``edge`` margin (~3% of the short
    side) with |z| within (0, that keyframe's max depth)."""
    if edge is None:
        edge = max(2, min(20, int(round(0.03 * min(H, W)))))
    seen = np.zeros(verts_w.shape[0], bool)
    for c2w, max_d in zip(kf_poses_w, kf_max_depths):
        w2c = np.linalg.inv(c2w)
        pc = verts_w @ w2c[:3, :3].T + w2c[:3, 3]          # [V, 3]
        z = pc[:, 2]
        # the x-flip projection of ops.geometry.project_to_pixel
        uvw = (pc * np.asarray([-1.0, 1.0, 1.0])) @ K.T
        zz = uvw[:, 2] + 1e-5
        u, v = uvw[:, 0] / zz, uvw[:, 1] / zz
        m = ((u > edge) & (u < W - edge) & (v > edge) & (v < H - edge)
             & (z < 0) & (np.abs(z) > 0) & (np.abs(z) < max_d))
        seen |= m
        if seen.all():
            break
    return seen


def filter_unseen_faces(faces: np.ndarray,
                        seen_mask: np.ndarray) -> np.ndarray:
    """Drop faces whose vertices are ALL unseen."""
    unseen = ~seen_mask
    face_unseen = unseen[faces].all(axis=1)
    return faces[~face_unseen]


def remove_small_components(verts: np.ndarray, faces: np.ndarray,
                            colors: Optional[np.ndarray] = None,
                            min_area: float = 0.5):
    """Drop connected components with total triangle area <= min_area."""
    if len(faces) == 0:
        return verts, faces, colors
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    V = len(verts)
    e0 = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    e1 = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix((np.ones(len(e0)), (e0, e1)), shape=(V, V))
    _, labels = connected_components(adj, directed=False)

    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    tri_area = 0.5 * np.linalg.norm(np.cross(a, b), axis=1)
    face_label = labels[faces[:, 0]]
    comp_area = np.bincount(face_label, weights=tri_area,
                            minlength=labels.max() + 1)
    keep_face = comp_area[face_label] > min_area
    faces = faces[keep_face]

    used = np.zeros(V, bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    verts2 = verts[used]
    colors2 = colors[used] if colors is not None and len(colors) == V \
        else colors
    return verts2, remap[faces], colors2


def apply_visibility_filters(verts: np.ndarray, faces: np.ndarray,
                             colors: Optional[np.ndarray],
                             kf_poses_w: np.ndarray, K: np.ndarray,
                             H: int, W: int, kf_max_depths: np.ndarray,
                             min_component_area: float = 0.5):
    """Small-component removal, then unseen-face culling against the
    keyframe set. Returns the filtered (verts, faces, colors)."""
    if len(verts) == 0 or len(kf_poses_w) == 0:
        return verts, faces, colors
    verts, faces, colors = remove_small_components(
        verts, faces, colors, min_component_area)
    if len(verts) == 0:
        return verts, faces, colors
    seen = point_seen_mask(verts, kf_poses_w, K, H, W, kf_max_depths)
    faces = filter_unseen_faces(faces, seen)
    used = np.zeros(len(verts), bool)
    used[faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    colors = colors[used] if colors is not None \
        and len(colors) == len(verts) else colors
    return verts[used], remap[faces], colors


def load_mesh_ply(path: str):
    """Read an ascii PLY written by save_mesh_ply (or compatible).

    Returns (verts [N,3] f32, faces [F,3] i32, colors [N,3] f32 in [0,1]
    or None).
    """
    with open(path) as f:
        if f.readline().strip() != "ply":
            raise ValueError(f"{path}: not a PLY file")
        n_vert = n_face = 0
        has_color = False
        for line in f:
            tok = line.strip().split()
            if tok[:2] == ["element", "vertex"]:
                n_vert = int(tok[2])
            elif tok[:2] == ["element", "face"]:
                n_face = int(tok[2])
            elif tok[:2] == ["property", "uchar"] and tok[2] in (
                    "red", "green", "blue"):
                has_color = True
            elif tok[0] == "format" and tok[1] != "ascii":
                raise ValueError("only ascii PLY is supported")
            elif tok[0] == "end_header":
                break
        verts = np.empty((n_vert, 3), np.float32)
        colors = np.empty((n_vert, 3), np.float32) if has_color else None
        for i in range(n_vert):
            vals = f.readline().split()
            verts[i] = [float(v) for v in vals[:3]]
            if has_color:
                colors[i] = [float(v) / 255.0 for v in vals[3:6]]
        faces = np.empty((n_face, 3), np.int32)
        for i in range(n_face):
            vals = f.readline().split()
            if vals[0] != "3":
                raise ValueError(f"{path}: only triangle faces are "
                                 "supported")
            faces[i] = [int(v) for v in vals[1:4]]
    return verts, faces, colors


def concat_meshes(meshes):
    """Concatenate (verts, faces, colors) triples with index offsets."""
    verts_l, faces_l, colors_l = [], [], []
    off = 0
    any_color = any(c is not None for _, _, c in meshes)
    for v, fcs, c in meshes:
        verts_l.append(v)
        faces_l.append(np.asarray(fcs) + off)
        if any_color:
            colors_l.append(c if c is not None
                            else np.full((len(v), 3), 0.5, np.float32))
        off += len(v)
    verts = np.concatenate(verts_l) if verts_l else np.zeros((0, 3))
    faces = np.concatenate(faces_l) if faces_l else np.zeros((0, 3), np.int32)
    colors = np.concatenate(colors_l) if any_color else None
    return verts, faces, colors


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                  colors: Optional[np.ndarray] = None) -> None:
    """Minimal ascii PLY writer."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None and len(colors) == len(verts):
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None and len(colors) == len(verts):
            c8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
            for v, c in zip(verts, c8):
                f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
