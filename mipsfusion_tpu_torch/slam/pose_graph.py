"""Pose-graph optimization over submap anchor poses (loop closure).

Port of ``mipsfusion_tpu/slam/pose_graph.py``. Nodes are the world poses
of each submap's first keyframe; edges carry the current relative pose of
adjacent submap pairs plus one down-weighted key edge from the loop
observation; the residual of edge (i, j) with observation Z is
log(Z node_i^-1 node_j) in se(3). The problem is tiny (at most
``localMLP_num`` nodes), so a damped Gauss-Newton with a forward-mode
Jacobian over tangent increments (``torch.func.jacfwd``) and a dense
solve of at most 6M x 6M (``icp.solve``: no host read, so the PGO program
of ``slam/programs.py`` can capture it) converges in a few iterations.
The ids, the used count and the key edge's weight may be device tensors,
as the JAX program traces them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.geometry import pose_inverse, se3_exp, se3_log
from .icp import solve


def _residuals(xi: torch.Tensor, nodes: torch.Tensor, edges: torch.Tensor,
               rel_poses: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Stacked weighted residuals [E*6] at tangent offsets xi [M, 6]."""
    n = se3_exp(xi) @ nodes
    ni, nj = n[edges[:, 0]], n[edges[:, 1]]
    err = se3_log(rel_poses @ (pose_inverse(ni) @ nj))        # [E, 6]
    return (err * weights[:, None]).reshape(-1)


def optimize_pose_graph(nodes: torch.Tensor, edges: torch.Tensor,
                        rel_poses: torch.Tensor, weights: torch.Tensor,
                        node_mask: torch.Tensor, n_iters: int = 10
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped Gauss-Newton over node poses [M, 4, 4]; edges [E, 2],
    observations [E, 4, 4], weights [E]; node_mask [M] False freezes a
    node (node 0 is the gauge anchor). Returns (nodes, final cost)."""
    M = nodes.shape[0]
    free = node_mask.to(nodes.dtype)
    free6 = free[:, None].expand(M, 6).reshape(1, M * 6)
    eye = torch.eye(M * 6, dtype=nodes.dtype, device=nodes.device)
    xi0 = torch.zeros((M, 6), dtype=nodes.dtype, device=nodes.device)
    jac = torch.func.jacfwd(_residuals)
    for _ in range(n_iters):
        r = _residuals(xi0, nodes, edges, rel_poses, weights)
        J = jac(xi0, nodes, edges, rel_poses, weights).reshape(-1, M * 6)
        Jm = J * free6                  # frozen nodes: zero columns
        H = Jm.T @ Jm + 1e-6 * eye
        xi = (-solve(H, Jm.T @ r)).reshape(M, 6) * free[:, None]
        nodes = se3_exp(xi) @ nodes
    cost = (_residuals(xi0, nodes, edges, rel_poses, weights) ** 2).sum()
    return nodes, cost


def edge_pairs(M: int, device=None) -> torch.Tensor:
    """Every submap pair (i < j) [M(M-1)/2, 2] int64, in row-major order."""
    return torch.as_tensor(
        np.asarray([(i, j) for i in range(M) for j in range(i + 1, M)],
                   np.int64).reshape(-1, 2), device=device)


def build_pose_graph_problem(first_kf_poses: torch.Tensor,
                             adjacency: torch.Tensor, key_edge,
                             key_rel_pose: torch.Tensor, key_edge_weight,
                             n_used, pairs: Optional[torch.Tensor] = None):
    """Edges, observations and weights as the reference assembles them:
    one edge per pair carrying its CURRENT relative pose (zero residual at
    the start), weight 1 where the pair is adjacent and used, plus the key
    loop edge with its observed relative pose. E = M(M-1)/2 + 1.
    ``key_edge`` (two ids), ``key_edge_weight`` and ``n_used`` are host
    numbers or device tensors; ``pairs``: ``edge_pairs`` (made here when
    not given)."""
    M = first_kf_poses.shape[0]
    dev = first_kf_poses.device
    if pairs is None:
        pairs = edge_pairs(M, dev)
    key = torch.as_tensor(key_edge, device=dev).to(pairs.dtype)
    edges = torch.cat([pairs, key.reshape(1, 2)])
    pi, pj = pairs[:, 0], pairs[:, 1]
    rels = pose_inverse(first_kf_poses[pj]) @ first_kf_poses[pi]
    rels = torch.cat([rels, key_rel_pose[None]])
    w = ((adjacency[pi, pj] > 0) & (pi < n_used) & (pj < n_used)).to(
        first_kf_poses.dtype)
    key_w = torch.as_tensor(key_edge_weight, device=dev).to(w.dtype)
    weights = torch.cat([w, key_w.reshape(1)])
    return edges, rels, weights
