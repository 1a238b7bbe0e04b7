"""Build and bind the CUDA kernels (nvcc -> shared library -> ctypes) and
the host marching-cubes library (c++ -> shared library -> ctypes), and the
table of field shapes the kernels are compiled for.

The CUDA sources under ``mipsfusion_tpu_torch/csrc`` (``*.cu``, ``*.cuh``)
have a plain C interface, so they compile with nvcc alone (no PyTorch
headers). The kernels are templates over the field shape
(``csrc/common.cuh`` ``FieldShape``). ``SHAPES`` is the one table of the
shapes: ``csrc/shape.cu`` is compiled once per entry with the entry's
``-D`` flags (``FieldShape.defines``), one nvcc process each, all in
parallel, and defines that shape's C entry points ``mf_<fn>_<name>``.
The library is built at first use into ``mipsfusion_tpu_torch/build/``,
named by a hash of the sources and the table, and loaded with ctypes;
every pointer and the stream go as ``c_void_p``. On loading, each
shape's entry points are bound once (``FieldShape.fn``), its size
queries are read once (``FieldShape.size``) and checked against the
table. ``csrc/marching.cpp`` is host code:
``marching_lib`` builds it with the host ``c++`` the same way, on the CPU
as on the card's machine. A failed build raises. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


_P = ctypes.c_void_p
_I = ctypes.c_int
# The C entry points of every shape (each named mf_<fn>_<shape name>).
# Plane pointers: s0, s1, s2 (null with 2 scales), then cp.
_SIGNATURES = {
    "mf_field_packed_size": [],
    "mf_field_pack_weights": [_P] * 10 + [_P, _P],
    "mf_field_forward": ([_P, _I] + [_P] * 4 + [_P] * 10
                         + [_P, _I, _P, _P, _I, _P]),
    "mf_decoder_wt_size": [],
    "mf_decoder_grad_size": [],
    "mf_decoder_backward": ([_P, _P, _P, _I] + [_P] * 10
                            + [_P, _P, _I, _P, _P, _P, _I, _P]),
    "mf_encode_forward": [_P] * 5 + [_I, _P, _P],
    "mf_plane_backward_acc_size": [],
    "mf_plane_backward": [_P, _P, _P, _I] + [_P] * 7,
    "mf_x_backward": [_P] * 6 + [_I, _P, _P, _P],
}

UNIT = os.path.join(CSRC, "shape.cu")
_lib = None
_entries = {}                         # shape name -> {fn name: ctypes fn}
_sizes = {}                           # shape name -> {size name: int}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256()
    for p in _sources():
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    for shape in SHAPES.values():
        h.update(" ".join(shape.defines).encode())
    return os.path.join(BUILD_DIR, f"libmf_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/shape.cu once per shape of SHAPES into the shared
    library unless it exists: one nvcc per shape, all started together,
    then one link."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        jobs = []
        for shape in SHAPES.values():
            obj = os.path.join(tmpdir, f"shape_{shape.name}.o")
            cmd = ([_nvcc()] + ARCH_FLAGS + shape.defines
                   + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v", "-c", "-o", obj, UNIT])
            jobs.append((shape.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed, logs = [], []
        for name, _, proc in jobs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"shape.cu at shape {name} "
                              f"({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        res = subprocess.run([_nvcc()] + ARCH_FLAGS
                             + ["-shared", "-o", tmp]
                             + [obj for _, obj, _ in jobs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    if verbose:
        print("\n".join(logs))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Binds every
    shape's entry points once and reads its sizes, which must be the
    table's."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for shape in SHAPES.values():
            fns = {}
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, f"{name}_{shape.name}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            sizes = {name: fn() for name, fn in fns.items()
                     if name.endswith("_size")}
            want = {"mf_decoder_grad_size": shape.grad_offsets[-1],
                    "mf_plane_backward_acc_size": shape.table_size}
            for name, n in want.items():
                if sizes[name] != n:
                    raise RuntimeError(
                        f"{name}_{shape.name} is {sizes[name]}, the table "
                        f"says {n}: the library disagrees with SHAPES")
            _entries[shape.name] = {k[3:]: v for k, v in fns.items()}
            _sizes[shape.name] = {k[3:]: v for k, v in sizes.items()}
        _lib = handle
    return _lib


MARCHING_SRC = os.path.join(CSRC, "marching.cpp")
MARCHING_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
_marching = None


def _cxx() -> str:
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the "
                           "mesher's marching cubes is built with it")
    return path


def marching_path() -> str:
    h = hashlib.sha256()
    with open(MARCHING_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(MARCHING_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmf_marching_{h.hexdigest()[:16]}.so")


def marching_lib() -> ctypes.CDLL:
    """The host marching-cubes library (built with c++ on first call)."""
    global _marching
    if _marching is not None:
        return _marching
    out = marching_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([_cxx()] + MARCHING_FLAGS
                                 + ["-o", tmp, MARCHING_SRC],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"c++ failed on marching.cpp "
                                   f"({res.returncode}):\n{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    handle = ctypes.CDLL(out)
    handle.mc_extract.restype = ctypes.c_int
    handle.mc_extract.argtypes = [
        _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64)]
    handle.mc_free.restype = None
    handle.mc_free.argtypes = [_P]
    _marching = handle
    return _marching


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# What every shape shares (csrc/common.cuh): F = 4 features a plane, 8 PE
# bands, 5 classes, decoder widths 128 / 64+64 / 128.
N_FEATURES = 4
N_FREQ = 8
N_CLASS = 5
PE_DIM = 3 + 3 * 2 * N_FREQ               # 51: raw xyz + sin/cos


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


@dataclasses.dataclass(frozen=True)
class FieldShape:
    """One field shape the kernels are compiled for (``csrc/shape.cu``
    with the flags ``defines``): plane scales of ``resolutions`` with
    ``N_FEATURES`` features each, and CP lines of ``cp_resolution`` rows x
    ``cp_components`` channels."""

    name: str
    resolutions: tuple
    cp_resolution: int
    cp_components: int
    configs: str                          # the configs that use it

    @functools.cached_property
    def key(self):
        return (self.resolutions, N_FEATURES, self.cp_resolution,
                self.cp_components)

    @functools.cached_property
    def n_scales(self) -> int:
        return len(self.resolutions)

    @functools.cached_property
    def plane_shapes(self):
        return tuple((3, r, r, N_FEATURES) for r in self.resolutions)

    @functools.cached_property
    def cp_shape(self):
        return (3, self.cp_resolution, self.cp_components)

    @functools.cached_property
    def table_size(self) -> int:
        """Floats of every plane and the CP lines (K3's accumulators)."""
        return (sum(3 * r * r * N_FEATURES for r in self.resolutions)
                + 3 * self.cp_resolution * self.cp_components)

    @functools.cached_property
    def defines(self):
        """The nvcc flags that compile csrc/shape.cu at this shape."""
        r = tuple(self.resolutions) + (0,) * (3 - self.n_scales)
        return [f"-DMF_SHAPE={self.name}", f"-DMF_NS={self.n_scales}",
                f"-DMF_R0={r[0]}", f"-DMF_R1={r[1]}", f"-DMF_R2={r[2]}",
                f"-DMF_RCP={self.cp_resolution}",
                f"-DMF_CCP={self.cp_components}"]

    @functools.cached_property
    def embed_dim(self) -> int:
        """E: one row per feature of every scale, then the CP channels."""
        return self.n_scales * N_FEATURES + self.cp_components

    @functools.cached_property
    def embed_pad(self) -> int:
        """E padded to a multiple of 8 (K2's tile rows; JAX's _round8)."""
        return _round8(self.embed_dim)

    @functools.cached_property
    def n_parts(self) -> int:
        """The embed's 4-row parts: one per scale, one per 4 CP channels."""
        return self.embed_dim // 4

    @functools.cached_property
    def k1_embed_kblocks(self) -> int:
        """K1's k-blocks of 8 embed rows: the parts in groups of 4, a group
        in 2 k-blocks (so E is padded to 48 at E 44 and 48, 64 at E 52)."""
        return 2 * ((self.n_parts + 3) // 4)

    @functools.cached_property
    def decoder_shapes(self):
        """(w, b) per layer: trunk0, trunk1, rgb, sdf0, sdf1."""
        E = self.embed_dim
        return (((PE_DIM, 128), (128,)), ((128, 128), (128,)),
                ((64 + PE_DIM, 3), (3,)), ((64 + E, 128), (128,)),
                ((128, N_CLASS), (N_CLASS,)))

    @functools.cached_property
    def decoder_flat_shapes(self):
        """The shapes of w, b of every layer in ``decoder_shapes``' order
        (the order of the kernels' decoder arguments)."""
        return tuple(s for pair in self.decoder_shapes for s in pair)

    @functools.cached_property
    def grad_offsets(self):
        """K2's flat gradient: the offset of each layer's [in + 1, out]
        block (w rows, then the bias row), and the total size last."""
        off = [0]
        for (fi, fo), _ in self.decoder_shapes:
            off.append(off[-1] + (fi + 1) * fo)
        return tuple(off)

    def fn(self, name: str):
        """The C entry point ``mf_<name>_<shape name>``, bound when the
        library loads (built on first use)."""
        if _lib is None:
            lib()
        return _entries[self.name][name]

    def size(self, name: str) -> int:
        """What the size query ``mf_<name>_<shape name>()`` returned when
        the library loaded."""
        if _lib is None:
            lib()
        return _sizes[self.name][name]


SHAPES = {s.key: s for s in (
    FieldShape("flag", (32, 64), 384, 40,
               "configs/base.yaml and every config inheriting its grid"),
    FieldShape("cp", (32, 64, 128), 512, 32,
               "configs/synthetic/orbit_fast_cp.yaml"),
    FieldShape("fcl", (32, 64, 128), 384, 40,
               "configs/FastCaMo-large/*.yaml"),
)}


def _table() -> str:
    return "; ".join(
        f"{list(s.resolutions)} x F{N_FEATURES} + CP {s.cp_resolution} x "
        f"{s.cp_components} ({s.configs})" for s in SHAPES.values())


_SCALE_KEYS = ("s0", "s1", "s2")


def kernel_shape(planes=None, n_scales: int = 0, n_freq: int = N_FREQ,
                 n_class: int = N_CLASS, embed_dim: int = None) -> FieldShape:
    """The table's entry for a field's planes ({"s0".., "cp"}: tensors),
    or, for the decoder alone (K2, which depends on the field only through
    E), the first entry of embed width ``embed_dim``. Raises a ValueError
    naming the shapes the kernels take: there is no fallback, a CUDA
    tensor of another shape cannot be served."""
    if (n_freq, n_class) != (N_FREQ, N_CLASS):
        raise ValueError(f"the field kernels take {N_FREQ} PE bands and "
                         f"{N_CLASS} classes; got {n_freq} and {n_class}")
    if planes is None:
        for s in SHAPES.values():
            if s.embed_dim == embed_dim:
                return s
        raise ValueError(f"the field kernels take these shapes only: "
                         f"{_table()}; got embed width {embed_dim}")
    if not 1 <= n_scales <= len(_SCALE_KEYS):
        raise ValueError(f"the field kernels take these shapes only: "
                         f"{_table()}; got {n_scales} plane scales")
    res = tuple([planes[k].shape[1] for k in _SCALE_KEYS[:n_scales]])
    n_feat = planes["s0"].shape[-1]
    cp = planes["cp"].shape if "cp" in planes else (0, 0, 0)
    shape = SHAPES.get((res, n_feat, cp[1], cp[2]))
    if shape is None:
        raise ValueError(
            f"the field kernels take these shapes only: {_table()}; got "
            f"Triplane {list(res)} x F{n_feat} + CP {cp[1]} x {cp[2]}")
    return shape


def ptr(t, name: str, shape=None) -> int:
    """Validate a tensor for a kernel argument and return its address."""
    import torch
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: kernel takes shape {tuple(shape)}, got "
                         f"{tuple(t.shape)} (the CUDA kernels are compiled "
                         "for the shapes of _build.SHAPES)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte alignment")
    return t.data_ptr()


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


_sm_counts = {}


def sm_count(device) -> int:
    """The device's number of SMs (the size of a persistent grid)."""
    import torch
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]
