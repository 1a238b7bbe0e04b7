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
table. ``csrc/marching.cpp`` and ``csrc/image.cpp`` are host code:
``marching_lib`` and ``image_lib`` build them with the host ``c++`` the
same way, on the CPU as on the card's machine. A failed build raises. Nothing here runs at
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
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


_P = ctypes.c_void_p
_I = ctypes.c_int
# The C entry points of a shape (each named mf_<fn>_<shape name>): those
# of every shape (K1's packer, K2), then those of a Triplane + CP shape
# (K1 on the planes, K0, K3, K4) or of a hash-grid shape (K1 on a given
# embed, H1-H3). Plane pointers: s0, s1, s2 (null with 2 scales), then cp.
# A hash entry point takes the grid's levels as log2 T, the dense levels
# and host pointers to the L scales and resolutions.
_COMMON_SIGNATURES = {
    "mf_field_packed_size": [],
    "mf_field_pack_weights": [_P] * 10 + [_P, _P],
    "mf_decoder_wt_size": [],
    "mf_decoder_grad_size": [],
    "mf_decoder_pack_weights": [_P] * 10 + [_P, _P],
    "mf_decoder_backward": ([_P, _P, _P, _I] + [_P] * 10
                            + [_P, _P, _I, _P, _P, _P, _I, _P]),
}
_TRIPLANE_SIGNATURES = {
    "mf_field_forward": ([_P, _I] + [_P] * 4 + [_P] * 10
                         + [_P, _I, _P, _P, _I, _P]),
    "mf_encode_forward": [_P] * 5 + [_I, _P] + [_I] * 4 + [_P],
    "mf_encode_setup": [],
    "mf_encode_smem_size": [],
    "mf_plane_backward_acc_size": [],
    "mf_plane_backward": [_P, _P, _P, _I] + [_P] * 7,
    "mf_x_backward": [_P] * 6 + [_I, _P, _P, _P],
}
_HASH_SIGNATURES = {
    "mf_field_forward_embed": ([_P, _I, _P] + [_P] * 10
                               + [_P, _I, _P, _I, _P]),
    "mf_hash_embed_size": [],
    "mf_hash_forward": [_P, _I, _P, _I, _I, _P, _P, _P, _P],
    "mf_hash_table_backward": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "mf_hash_x_backward": [_P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P],
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
            for name, argtypes in shape.signatures.items():
                fn = getattr(handle, f"{name}_{shape.name}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            sizes = {name: fn() for name, fn in fns.items()
                     if name.endswith("_size")}
            want = {"mf_decoder_grad_size": shape.grad_offsets[-1],
                    "mf_decoder_wt_size": shape.k2_packed_size}
            if shape.hash_levels:
                want["mf_hash_embed_size"] = shape.embed_dim
            else:
                want["mf_plane_backward_acc_size"] = shape.table_size
                want["mf_encode_smem_size"] = shape.encode_smem
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
IMAGE_SRC = os.path.join(CSRC, "image.cpp")
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
_marching = None
_image = None
# the readers' prefetch thread may ask for a host library first
_host_lock = threading.Lock()


def _cxx() -> str:
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the "
                           "mesher's marching cubes and the image decoders "
                           "are built with it")
    return path


def host_lib_path(src: str) -> str:
    """Where the host source ``src`` is built: named by its stem and a hash
    of the source and the flags."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(HOST_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"libmf_{stem}_{h.hexdigest()[:16]}.so")


def marching_path() -> str:
    return host_lib_path(MARCHING_SRC)


def _build_host(src: str) -> str:
    """Build ``src`` with the host c++ unless its library exists; returns
    the library's path. A failed build raises."""
    out = host_lib_path(src)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([_cxx()] + HOST_FLAGS + ["-o", tmp, src],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"c++ failed on {os.path.basename(src)} "
                                   f"({res.returncode}):\n{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def marching_lib() -> ctypes.CDLL:
    """The host marching-cubes library (built with c++ on first call)."""
    global _marching
    with _host_lock:
        if _marching is None:
            handle = ctypes.CDLL(_build_host(MARCHING_SRC))
            handle.mc_extract.restype = ctypes.c_int
            handle.mc_extract.argtypes = [
                _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.c_int64)]
            handle.mc_free.restype = None
            handle.mc_free.argtypes = [_P]
            _marching = handle
        return _marching


def image_lib() -> ctypes.CDLL:
    """The host image decoders, ``csrc/image.cpp``: PNG unfiltering and
    baseline JPEG (built with c++ on first call)."""
    global _image
    with _host_lock:
        if _image is None:
            handle = ctypes.CDLL(_build_host(IMAGE_SRC))
            i64, s = ctypes.c_int64, ctypes.c_char_p
            pint = ctypes.POINTER(_I)
            handle.png_unfilter.restype = _I
            handle.png_unfilter.argtypes = [_P, i64, i64, i64, _I, _P]
            handle.jpeg_info.restype = _I
            handle.jpeg_info.argtypes = [_P, i64, pint, pint, pint, s, _I]
            handle.jpeg_decode.restype = _I
            handle.jpeg_decode.argtypes = [_P, i64, _I, _I, _P, s, _I]
            _image = handle
        return _image


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# What every shape shares (csrc/common.cuh): F = 4 features a plane, 8 PE
# bands, 5 classes, decoder widths 128 / 64+64 / 128; a hash grid's
# levels hold 2 features each.
N_FEATURES = 4
HASH_FEATURES = 2
N_FREQ = 8
N_CLASS = 5
PE_DIM = 3 + 3 * 2 * N_FREQ               # 51: raw xyz + sin/cos


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


# K0's launch plan (csrc/triplane.cuh encode_fwd_kernel). The encode is cut
# into roles, one a plane scale (a lane a point) and one for the CP lines
# (a lane a point's group of 4 channels); a block takes one role and walks
# that role's tiles of K0_THREADS items. A role whose table fits in a
# block's shared memory stages it there once (FieldShape.encode_staged, the
# kernel's k0_staged). ENCODE_ROLES orders the roles as the kernel's grid
# does.
ENCODE_ROLES = ("s0", "s1", "s2", "cp")
K0_THREADS = 512
SMEM_MAX = 232_448                   # shared memory a block can use (sm_90)
K0_BARRIER = 16                      # the staging mbarrier, behind the table
# The relative cost of one 16-byte tap read, (staged, from L2), by which
# encode_plan splits the SMs (a scale lane reads 12 taps, a CP lane 6): a
# scale's taps fall on random banks, a point's CP groups read one
# contiguous stretch of a line row, and an L2 read costs twice a staged
# one. The weights were set by timing the plan on the card at each
# shape's labels (tools/k0_plans.py; PERF.md section 6): the split by the
# plain count of taps (every weight 1) is slower at every label, and no
# move of 8 blocks to or from the CP role is faster at every label of a
# shape.
K0_TAP_COST = {"scale": (1.5, 3.0), "cp": (1.0, 2.0)}


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """K0's launch plan at a shape on a card of ``n_sm`` SMs: ``blocks``
    per role (ENCODE_ROLES' order, 0 for a scale the shape lacks; together
    one block an SM, the most the shared memory allows) and the dynamic
    shared memory of a block."""

    blocks: tuple
    smem: int

    def grid(self, shape, n: int) -> tuple:
        """The blocks launched per role for n points: no more than the
        role's tiles (what csrc/triplane.cuh encode_forward launches)."""
        return tuple(min(b, -(-items // K0_THREADS))
                     for b, items in zip(self.blocks,
                                         shape.encode_items(n)))


def split_blocks(n_sm: int, cost) -> tuple:
    """n_sm blocks split across roles in proportion to their cost, at least
    one to each role with a cost above 0, none to the others."""
    active = [r for r, c in enumerate(cost) if c > 0]
    if n_sm < len(active):
        raise ValueError(f"K0 needs {len(active)} SMs, got {n_sm}")
    total = sum(cost)
    share = [n_sm * c / total for c in cost]
    blocks = [max(1, int(share[r])) if r in active else 0
              for r in range(len(cost))]
    # the blocks left to the largest remainders, or taken back from the
    # largest roles
    while sum(blocks) < n_sm:
        r = max(active, key=lambda r: share[r] - blocks[r])
        blocks[r] += 1
    while sum(blocks) > n_sm:
        r = max(active, key=lambda r: blocks[r] - share[r])
        blocks[r] -= 1
    return tuple(blocks)


@dataclasses.dataclass(frozen=True)
class FieldShape:
    """One field shape the kernels are compiled for (``csrc/shape.cu``
    with the flags ``defines``): plane scales of ``resolutions`` with
    ``N_FEATURES`` features each, and CP lines of ``cp_resolution`` rows x
    ``cp_components`` channels; or, with ``hash_levels``, the embed of a
    multiresolution hash grid of that many levels of ``HASH_FEATURES``
    (no planes: H1 writes the embed, K1 reads it)."""

    name: str
    resolutions: tuple
    cp_resolution: int
    cp_components: int
    configs: str                          # the configs that use it
    hash_levels: int = 0

    @functools.cached_property
    def key(self):
        if self.hash_levels:
            return ("HashGrid", self.hash_levels, HASH_FEATURES)
        return (self.resolutions, N_FEATURES, self.cp_resolution,
                self.cp_components)

    @functools.cached_property
    def signatures(self):
        """The ctypes signatures of the shape's C entry points."""
        return {**_COMMON_SIGNATURES,
                **(_HASH_SIGNATURES if self.hash_levels
                   else _TRIPLANE_SIGNATURES)}

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
        if self.hash_levels:
            return [f"-DMF_SHAPE={self.name}",
                    f"-DMF_HASH_L={self.hash_levels}"]
        r = tuple(self.resolutions) + (0,) * (3 - self.n_scales)
        return [f"-DMF_SHAPE={self.name}", f"-DMF_NS={self.n_scales}",
                f"-DMF_R0={r[0]}", f"-DMF_R1={r[1]}", f"-DMF_R2={r[2]}",
                f"-DMF_RCP={self.cp_resolution}",
                f"-DMF_CCP={self.cp_components}"]

    @functools.cached_property
    def embed_dim(self) -> int:
        """E: one row per feature of every scale, then the CP channels; a
        hash grid's features level by level."""
        return (self.n_scales * N_FEATURES + self.cp_components
                + HASH_FEATURES * self.hash_levels)

    @functools.cached_property
    def embed_pad(self) -> int:
        """E padded to a multiple of 8 (K2's tile rows; JAX's _round8)."""
        return _round8(self.embed_dim)

    @functools.cached_property
    def n_parts(self) -> int:
        """The embed's 4-row parts: one per scale, one per 4 CP channels
        (a hash grid's: one per two levels)."""
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
    def k2_layers(self):
        """K2's packed weights, layer by layer in the kernel's order
        (``csrc/field.cuh`` K2Layout): (name, k-blocks of 8 input rows,
        pairs of 8-column tiles). The forward's W0, W1, Ws0 (the embed's
        rows padded to 8), Ws1; the backward's transposes Ws1^T, Ws0^T,
        Wr[:64]^T, W1^T and [W0^T; Wr[64:]^T]."""
        n_in = 64 + self.embed_dim
        return (("w0", 7, 8), ("w1", 16, 8),
                ("ws0", (64 + _round8(self.embed_dim)) // 8, 8),
                ("ws1", 16, 1), ("ws1_t", 1, 8),
                ("ws0_t", 16, (n_in + 15) // 16), ("wr_t", 1, 4),
                ("w1_t", 16, 8), ("w0_wr_t", 17, 4))

    @functools.cached_property
    def k2_packed_size(self) -> int:
        """Floats of K2's packed weights (``mf_decoder_wt_size``): a hi
        and a lo part of every B fragment."""
        return sum(kb * pairs * 256 for _, kb, pairs in self.k2_layers)

    @functools.cached_property
    def grad_offsets(self):
        """K2's flat gradient: the offset of each layer's [in + 1, out]
        block (w rows, then the bias row), and the total size last."""
        off = [0]
        for (fi, fo), _ in self.decoder_shapes:
            off.append(off[-1] + (fi + 1) * fo)
        return tuple(off)

    @functools.cached_property
    def encode_tables(self) -> tuple:
        """Bytes of each K0 role's table (ENCODE_ROLES' order): a scale's
        three planes (0 for a scale the shape lacks), the CP lines."""
        planes = [3 * r * r * N_FEATURES * 4 for r in self.resolutions]
        planes += [0] * (3 - len(planes))
        return (*planes, 4 * 3 * self.cp_resolution * self.cp_components)

    @functools.cached_property
    def encode_staged(self) -> tuple:
        """Whether each K0 role stages its table in shared memory: where it
        fits beside the barrier (the kernel's k0_staged)."""
        return tuple(0 < b <= SMEM_MAX - K0_BARRIER
                     for b in self.encode_tables)

    @functools.cached_property
    def encode_smem(self) -> int:
        """K0's dynamic shared memory a block: the largest staged table,
        then the barrier."""
        return K0_BARRIER + max(b for b, st in zip(self.encode_tables,
                                                   self.encode_staged) if st)

    def encode_items(self, n: int) -> tuple:
        """Lanes of work per role for n points."""
        return (*[n if s < self.n_scales else 0 for s in range(3)],
                n * (self.cp_components // 4))

    def encode_taps(self) -> tuple:
        """16-byte tap reads a point per role: 12 a scale lane, 6 a CP lane
        (one lane per group of 4 channels)."""
        return tuple(items * (6 if r == 3 else 12)
                     for r, items in enumerate(self.encode_items(1)))

    @functools.lru_cache(maxsize=None)
    def encode_plan(self, n_sm: int) -> EncodePlan:
        """The n_sm blocks split across the roles in proportion to their
        tap reads (K0_TAP_COST, staged or from L2), at least one each."""
        cost = [taps * K0_TAP_COST["cp" if r == 3 else "scale"][
                    0 if self.encode_staged[r] else 1]
                for r, taps in enumerate(self.encode_taps())]
        return EncodePlan(split_blocks(n_sm, cost), self.encode_smem)

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
    FieldShape("hash", (), 0, 0,
               "grid.enc HashGrid: configs/base.yaml's hash grid, "
               "perfbench/configs/hash-full.json", hash_levels=16),
)}


def _describe(s: FieldShape) -> str:
    if s.hash_levels:
        return (f"HashGrid {s.hash_levels} x {HASH_FEATURES} levels "
                f"({s.configs})")
    return (f"{list(s.resolutions)} x F{N_FEATURES} + CP {s.cp_resolution} "
            f"x {s.cp_components} ({s.configs})")


def _table() -> str:
    return "; ".join(_describe(s) for s in SHAPES.values())


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


def hash_shape(n_levels: int, n_features: int) -> FieldShape:
    """The table's entry for a hash grid of ``n_levels`` levels of
    ``n_features``; a ValueError naming the shapes the kernels take where
    there is none."""
    shape = SHAPES.get(("HashGrid", n_levels, n_features))
    if shape is None:
        raise ValueError(f"the field kernels take these shapes only: "
                         f"{_table()}; got HashGrid {n_levels} x "
                         f"{n_features} levels")
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


def stream(device) -> int:
    """The current stream of ``device`` (the tensor's device, not the
    current one) as the kernels take it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


count_lock = threading.Lock()


def count_launch(fn, device) -> None:
    """One more launch of a kernel wrapper ``fn``, in total (``launches``)
    and on the device's ordinal (``launches_by_device``). Autograd runs
    each device's backward on its own thread, hence the lock."""
    with count_lock:
        fn.launches += 1
        fn.launches_by_device[device.index] = \
            fn.launches_by_device.get(device.index, 0) + 1


_encode_args = {}


def encode_args(shape: FieldShape, device) -> tuple:
    """K0's plan arguments at a shape on a device (``EncodePlan.blocks``),
    worked out once per shape and device, when its shared-memory limit is
    raised for the kernel."""
    key = (shape.name, device)
    args = _encode_args.get(key)
    if args is None:
        import torch
        with torch.cuda.device(device):
            check(shape.fn("encode_setup")(), "encode_setup")
        args = _encode_args[key] = shape.encode_plan(sm_count(device)).blocks
    return args


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
