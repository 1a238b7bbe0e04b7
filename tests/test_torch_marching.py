"""The port's marching cubes (``csrc/marching.cpp`` through
``mipsfusion_tpu_torch/mesher/marching.py``, built here with the host
c++), its Python version and the JAX package's ``marching_cubes`` give
the same vertices and faces, bit for bit."""

import numpy as np
import pytest

from mipsfusion_tpu.mesher.marching import marching_cubes as jax_marching
from mipsfusion_tpu_torch.mesher.marching import (marching_cubes,
                                                  marching_cubes_plain)
from mipsfusion_tpu_torch.ops import _build


def sphere_tsdf(n=20, r=0.3, trunc=0.2):
    ax = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    d = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - r
    return np.clip(d, -trunc + 1e-4, trunc - 1e-4).astype(np.float32), ax


def random_volume(seed=0, shape=(14, 15, 16)):
    """Noise with NaN voxels and voxels past the truncation."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 0.3, shape).astype(np.float32)
    v[rng.random(shape) < 0.05] = np.nan
    v[rng.random(shape) < 0.05] = 0.7
    v[rng.random(shape) < 0.03] = np.inf
    return v


@pytest.mark.parametrize("case", ["sphere", "random0", "random1",
                                  "sphere_tight_trunc"])
def test_marching_matches_jax_and_plain(case):
    if case.startswith("sphere"):
        vol, _ = sphere_tsdf()
        trunc = 0.15 if case == "sphere_tight_trunc" else 0.25
    else:
        vol, trunc = random_volume(int(case[-1])), 0.5
    ref = jax_marching(vol, 0.0, trunc)
    out = marching_cubes(vol, 0.0, trunc)
    plain = marching_cubes_plain(vol, 0.0, trunc)
    assert len(out[0]) > 100 and len(out[1]) > 100
    for a, b, c in zip(ref, out, plain):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert np.isfinite(out[0]).all()
    assert out[1].min() >= 0 and out[1].max() < len(out[0])


def test_marching_empty_and_library_is_built_from_the_port():
    """A volume with no crossing gives empty arrays of the right shapes;
    the library is the port's own build of csrc/marching.cpp."""
    v, f = marching_cubes(np.full((5, 5, 5), 0.1, np.float32), 0.0, 1.0)
    assert v.shape == (0, 3) and f.shape == (0, 3) and f.dtype == np.int64
    lib = _build.marching_lib()
    assert lib._name == _build.marching_path()
    assert _build.marching_path().startswith(_build.BUILD_DIR)


def test_marching_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises; nothing falls back to the Python version."""
    bad = tmp_path / "marching.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "MARCHING_SRC", str(bad))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_marching", None)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        marching_cubes(sphere_tsdf(n=6)[0], 0.0, 0.25)
