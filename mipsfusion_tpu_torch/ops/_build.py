"""Build and bind the CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``mipsfusion_tpu_torch/csrc`` have a plain C interface,
so they compile with nvcc alone in seconds (no PyTorch headers), one nvcc
process per source in parallel. The library is built at first use into
``mipsfusion_tpu_torch/build/``, named by a hash of the sources, and
loaded with ctypes; every pointer and the
stream go as ``c_void_p``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
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
_SIGNATURES = {
    "mf_field_forward": [_P, _I] + [_P] * 3 + [_P] * 10 + [_P, _P, _I, _P],
    "mf_decoder_wt_size": [],
    "mf_decoder_backward": ([_P, _P, _P, _I] + [_P] * 10
                            + [_P, _P, _I, _P, _P, _P, _I, _P]),
    "mf_encode_forward": [_P, _P, _P, _P, _I, _P, _P],
    "mf_plane_backward_acc_size": [],
    "mf_plane_backward": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "mf_x_backward": [_P, _P, _P, _P, _P, _I, _P, _P],
}

_lib = None


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
    return os.path.join(BUILD_DIR, f"libmf_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the shared library unless it exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [p for p in _sources() if p.endswith(".cu")]
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        jobs = []
        for src in cu:
            obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
            cmd = ([_nvcc()] + ARCH_FLAGS
                   + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v", "-c", "-o", obj, src])
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed, logs = [], []
        for src, _, proc in jobs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} "
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
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# flagship widths the kernels are specialised to (csrc/common.cuh)
PLANE_SHAPES = ((3, 32, 32, 4), (3, 64, 64, 4))
CP_SHAPE = (3, 384, 40)
EMBED_DIM = 48
N_FREQ = 8
N_CLASS = 5
DECODER_SHAPES = (            # (w, b) per layer: trunk0, trunk1, rgb, sdf0, sdf1
    ((51, 128), (128,)), ((128, 128), (128,)), ((115, 3), (3,)),
    ((112, 128), (128,)), ((128, 5), (5,)),
)


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
                         f"{tuple(t.shape)} (the CUDA kernels are "
                         "specialised to the flagship widths)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte alignment")
    return t.data_ptr()


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
