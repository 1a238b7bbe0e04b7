"""The reference's field encodings: the plain hash grid against the port's
``hash_encode``, and the Triplane field's reads (the reference field, its
gradients and the work count) pinned to the bits recorded before the
encoding became a module of its own."""

import hashlib
import json
import os

import pytest
import torch

from conftest import PB
from harness import work
from reference import plain
from reference.encodings import HashGrid


@pytest.mark.parametrize("hash_size", [12, 15])
def test_hash_grid_matches_the_port(hash_size):
    """At 2^12 rows a level (1 dense level, 15 hashed) and 2^15 (4 dense),
    with points in [-0.25, 1.25]^3 and a table drawn U(-1, 1):

    - output: 8 products a level summed in float32, each of size <= 1,
      so the two differ by at most a few ulps of 1: atol 1e-6;
    - table gradient: a row sums the shares of the points that reach it
      (float32 adds here, the port's exact fixed-point sum rounded once),
      a few ulps of the largest row: 2e-6 of the largest |gradient|;
    - point gradient: 16 levels x 8 corners x 2 features of terms up to
      scale_l (255) in size, associated in another order: a few ulps of
      the largest partial sum, about the largest |gradient|: 2e-6 of it.
    """
    from mipsfusion_tpu_torch.ops.encoding import HashGridConfig, hash_encode
    cfg = HashGridConfig(log2_hashmap_size=hash_size)
    gen = torch.Generator().manual_seed(hash_size)
    table = torch.rand((16, 1 << hash_size, 2), generator=gen) * 2 - 1
    x = torch.rand((4096, 3), generator=gen) * 1.5 - 0.25
    cot = torch.rand((4096, 32), generator=gen) * 2 - 1
    got = []
    for fn in (lambda t, p: HashGrid.encode({"hash": t}, p, hash_size),
               lambda t, p: hash_encode(t, p, cfg)):
        t = table.clone().requires_grad_(True)
        p = x.clone().requires_grad_(True)
        y = fn(t, p)
        (y * cot).sum().backward()
        got.append((y.detach(), t.grad, p.grad))
    (y, dt, dx), (y_port, dt_port, dx_port) = got
    assert 0 < cfg.n_dense < 16
    torch.testing.assert_close(y, y_port, rtol=0, atol=1e-6)
    torch.testing.assert_close(dt, dt_port, rtol=0,
                               atol=2e-6 * float(dt_port.abs().max()))
    torch.testing.assert_close(dx, dx_port, rtol=0,
                               atol=2e-6 * float(dx_port.abs().max()))


def _digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def _flag_params(cfg, gen):
    """A Triplane + CP field at the configuration's widths, drawn from
    ``gen``."""
    g, dec = cfg["grid"], cfg["decoder"]
    F, C = int(g["tri_features"]), int(g["cp_components"])

    def u(*shape, s=1.0):
        return (torch.rand(shape, generator=gen) * 2 - 1) * s
    planes = {f"s{i}": u(3, r, r, F, s=0.5)
              for i, r in enumerate(g["tri_resolutions"])}
    planes["cp"] = u(3, int(g["cp_resolution"]), C, s=0.5)
    E = len(g["tri_resolutions"]) * F + C
    pe = 3 + 3 * 2 * int(cfg["pos"]["n_bins"])
    hid, geo = int(dec["hidden_dim"]), int(dec["geo_feat_dim"])
    rgb = int(dec["hidden_dim_color"])
    shapes = {"trunk0": (pe, hid), "trunk1": (hid, geo + rgb),
              "rgb": (rgb + pe, 3), "sdf0": (geo + E, hid), "sdf1": (hid, 5)}
    decoder = {n: {"w": u(i, o, s=(1.0 / i) ** 0.5), "b": u(o, s=0.1)}
               for n, (i, o) in shapes.items()}
    return {"planes": planes, "decoder": decoder}


def _config(name):
    with open(os.path.join(PB, "configs", f"{name}.json")) as f:
        return json.load(f)["config"]


# SHA-256 of the reference field's output and gradients at flag-full's
# widths (4096 points in [-0.1, 1.1]^3, seed 20261018, one CPU thread),
# recorded with the Triplane code inside reference/plain.py
FLAG_DIGESTS = {
    "out": "3805d79e34aef6b538af14059a8685d495a8d4aff78d93c1564cb61edbd60586",
    "x": "6e93b3c5f705d260076f830b639b25b50f51e28a60eecb50eaf2218a053475e7",
    "planes.s0":
        "af0cb278b36d0d832910e442b323e3b9edc8a6f339dbb3b16cd871da50519751",
    "planes.s1":
        "3e2f961b6d2b9ee0639bb0ac9169dc6da410b7946cb25432b813f2d47df9c009",
    "planes.cp":
        "82f5d0e004b76fc211ffacb2f6fe9963455eb99b5ff3f762baca5f12cf5d8560",
    "decoder.trunk0.w":
        "2dcfe17eb650d82ae6166ee903a90a6f6d732f9358eb53b0a92388d55b486e95",
    "decoder.trunk0.b":
        "7abece917cdc9341fd70543af75d41dd5dee9c9d521402fb811addc0688bb424",
    "decoder.trunk1.w":
        "a1e618eb6a6628c3ae71e787b5784ea4a412a841ad8581703e7b78c5bdc03eef",
    "decoder.trunk1.b":
        "1f21d2a64d3f173bfde8ef40d4d7f9e5492ed4f1e607805596f701aa0d0ddd9f",
    "decoder.rgb.w":
        "648cc0890a829f0a8204db910b4a66dad34f695dcf1dc83a7cd77851b4fd5836",
    "decoder.rgb.b":
        "2252f3ce54a9387db1ad672e55de7dcf35da422b2104de53ab61d6f84b2975cb",
    "decoder.sdf0.w":
        "a8ddbc901c804c46cbd7d664ee1b5f4cba1d53f9fb73c714d7e147f7e49530c1",
    "decoder.sdf0.b":
        "00a97e3edfa6c2d3a0100a494f72ba21b0c8f407ade50afe2ea1bed11b5df7eb",
    "decoder.sdf1.w":
        "cb910ab2ca8e9d3b0a99793b0a5793f081c6b4702c27d8f1df96c4a5a5b03c5d",
    "decoder.sdf1.b":
        "e58ffd368b0f0434a2f313babde7cb9641b4c44c014139d7468a53d91e38da8a",
}


def test_triplane_field_reads_pinned():
    cfg = _config("flag-full")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gen = torch.Generator().manual_seed(20261018)
        params = _flag_params(cfg, gen)
        leaves = {f"planes.{k}": v for k, v in params["planes"].items()}
        leaves.update({f"decoder.{n}.{k}": t
                       for n, d in params["decoder"].items()
                       for k, t in d.items()})
        for t in leaves.values():
            t.requires_grad_(True)
        xT = (torch.rand((3, 4096), generator=gen) * 1.2 - 0.1
              ).requires_grad_(True)
        wts = torch.rand((10, 4096), generator=gen)
        y = plain.field(params, xT, plain.FieldCfg.from_config(cfg))
        (y * wts).sum().backward()
    finally:
        torch.set_num_threads(threads)
    got = {"out": _digest(y), "x": _digest(xT.grad)}
    got.update({k: _digest(t.grad) for k, t in leaves.items()})
    assert got == FLAG_DIGESTS


# work.least_times of both configurations at these calls, recorded with
# the Triplane count inside harness/work.py
CALLS = {"ba": 20, "refine": 20, "track": 60, "init_chunk": 8,
         "switch_ba": 1, "keyframe": 6}
WORK = {
    "flag-full": {"arith": 0.16217083047625508, "bytes": 0.06656305945074627,
                  "bound": 0.1780248532374491, "flops": 76471853175000.0,
                  "bytes_moved": 222986249160.0},
    "flag-scale": {"arith": 0.043020403367893624,
                   "bytes": 0.01889307276179105,
                   "bound": 0.047688891033565266,
                   "flops": 20305577881920.0, "bytes_moved": 63291793752.0},
}


@pytest.mark.parametrize("name", sorted(WORK))
def test_triplane_work_pinned(name):
    assert work.least_times(_config(name), CALLS) == WORK[name]


def test_no_count_no_work():
    """A field whose encoding has no count (the hash grid, so far) is not
    counted: the readers that need the work read nothing."""
    cfg = _config("flag-full")
    cfg["grid"] = dict(cfg["grid"], enc="HashGrid")
    assert work.least_times(cfg, CALLS) is None
    del cfg["grid"]["enc"]
    assert work.least_times(cfg, CALLS) is None
