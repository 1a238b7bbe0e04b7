"""SDF/RGB decoder MLP with the 5-class SDF classification head.

Port of ``mipsfusion_tpu/models/decoder.py``. Weights keep the reference's
layout (``w`` [in, out], ``b`` [out]) so the CUDA kernels and the JAX
parameter tree read the same arrays:

  * trunk: Linear(PE+3 -> 128) -> ReLU -> Linear(-> sdf 64 + rgb 64);
  * rgb: Linear(rgb 64 + PE+3 -> 3) (sigmoid applied by the renderer);
  * sdf: Linear(sdf 64 + embed -> 128) -> ReLU -> Linear(-> 5) -> softmax;
  * output [N, 10] = rgb 3, sdf (sum_i p_i i / 4 - 0.5) * 2, entropy,
    prob 5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

LAYERS = ("trunk0", "trunk1", "rgb", "sdf0", "sdf1")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    input_ch: int = 48          # triplane feature dim
    input_ch_pos: int = 51      # frequency PE dim + 3 (raw xyz included)
    n_hidden: int = 128
    n_hidden_rgb: int = 64
    n_hidden_sdf: int = 64
    n_hidden_branch: int = 128
    n_class: int = 5

    def layer_shapes(self) -> Dict[str, tuple]:
        d_pe = self.input_ch_pos
        return {
            "trunk0": (d_pe, self.n_hidden),
            "trunk1": (self.n_hidden, self.n_hidden_sdf + self.n_hidden_rgb),
            "rgb": (self.n_hidden_rgb + d_pe, 3),
            "sdf0": (self.n_hidden_sdf + self.input_ch, self.n_hidden_branch),
            "sdf1": (self.n_hidden_branch, self.n_class),
        }


def init_decoder(cfg: DecoderConfig, generator: torch.Generator,
                 device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    layers = {}
    for name, (fi, fo) in cfg.layer_shapes().items():
        bound = 1.0 / math.sqrt(fi)
        w = (torch.rand((fi, fo), generator=generator, device=device)
             * 2 - 1) * bound
        b = (torch.rand((fo,), generator=generator, device=device)
             * 2 - 1) * bound
        layers[name] = {"w": w, "b": b}
    return layers


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def decoder_apply(dec: Dict[str, Dict[str, torch.Tensor]],
                  embed: torch.Tensor, pe: torch.Tensor, n_class: int,
                  sdf_only: bool = False) -> torch.Tensor:
    """``dec`` is {layer: {"w", "b"}} (the JAX tree's layout); embed [N, E],
    pe [N, 3 + PE] (raw xyz first) -> [N, 5 + n_class] (or [N, 1] sdf
    with ``sdf_only``)."""
    h = torch.relu(_dense(dec["trunk0"], pe))
    h = _dense(dec["trunk1"], h)
    n_sdf = dec["sdf0"]["w"].shape[0] - embed.shape[1]
    sdf_emb, rgb_emb = h[:, :n_sdf], h[:, n_sdf:]
    h2 = torch.relu(_dense(dec["sdf0"], torch.cat([sdf_emb, embed], dim=-1)))
    prob = torch.softmax(_dense(dec["sdf1"], h2), dim=-1)
    class_ids = torch.arange(n_class, dtype=prob.dtype, device=prob.device)
    sdf = ((prob * class_ids).sum(-1, keepdim=True) / (n_class - 1)
           - 0.5) * 2.0
    if sdf_only:
        return sdf
    rgb = _dense(dec["rgb"], torch.cat([rgb_emb, pe], dim=-1))
    entropy = -(prob * torch.log2(prob + 1e-5)).sum(-1, keepdim=True)
    return torch.cat([rgb, sdf, entropy, prob], dim=-1)
