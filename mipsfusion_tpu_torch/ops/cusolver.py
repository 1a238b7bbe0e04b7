"""Batched symmetric eigendecomposition on the card without a host read.

``torch.linalg.eigh`` on a CUDA batch of small matrices runs cuSOLVER's
``cusolverDnXsyevBatched`` and then reads the solver's ``info`` on the
host to raise on a failure; that read waits for the device and ends a
CUDA graph's capture. ``syev_batched`` makes the same cuSOLVER call, in
the library PyTorch loaded, on the same column-major copies of the lower
triangles, with default parameters: the same eigenvalues and eigenvectors
bit for bit, and no host read (``info`` stays on the device, unchecked).
It is what the loop closure's and the drift gate's normals run on the
card (``slam/icp.estimate_normals``); on the CPU they run ``eigh``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SZ = ctypes.c_size_t
_INT = ctypes.c_int
# cuSOLVER / cuBLAS enums
_EIG_MODE_VECTOR = 1
_FILL_MODE_LOWER = 0
_CUDA_R_32F = 0

_lib = None
_handles: Dict[int, Tuple[ctypes.c_void_p, ctypes.c_void_p]] = {}


def _library(device: torch.device):
    """The cuSOLVER PyTorch loaded (it loads it at its first linear-algebra
    call on the card; a 1 x 1 solve makes sure), with the signatures
    declared."""
    global _lib
    if _lib is not None:
        return _lib
    torch.linalg.solve_ex(torch.ones((1, 1), device=device),
                          torch.ones((1,), device=device))
    with open("/proc/self/maps") as f:
        paths = sorted({line.split()[-1] for line in f
                        if "libcusolver.so" in line})
    if not paths:
        raise RuntimeError("cuSOLVER is not loaded in this process")
    lib = ctypes.CDLL(paths[0])
    lib.cusolverDnCreate.argtypes = [ctypes.POINTER(_P)]
    lib.cusolverDnCreateParams.argtypes = [ctypes.POINTER(_P)]
    lib.cusolverDnSetStream.argtypes = [_P, _P]
    lib.cusolverDnXsyevBatched_bufferSize.argtypes = [
        _P, _P, _INT, _INT, _I64, _INT, _P, _I64, _INT, _P, _INT,
        ctypes.POINTER(_SZ), ctypes.POINTER(_SZ), _I64]
    lib.cusolverDnXsyevBatched.argtypes = [
        _P, _P, _INT, _INT, _I64, _INT, _P, _I64, _INT, _P, _INT, _P, _SZ,
        _P, _SZ, _P, _I64]
    for fn in (lib.cusolverDnCreate, lib.cusolverDnCreateParams,
               lib.cusolverDnSetStream, lib.cusolverDnXsyevBatched_bufferSize,
               lib.cusolverDnXsyevBatched):
        fn.restype = _INT
    _lib = lib
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} returned cuSOLVER status {status}")


def _handle(lib, device: torch.device) -> Tuple[ctypes.c_void_p,
                                                 ctypes.c_void_p]:
    """(solver handle, default parameters) of a device, made at its first
    call (a program's warm-up, before any capture)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _handles:
        handle, params = _P(), _P()
        with torch.cuda.device(idx):
            _check(lib.cusolverDnCreate(ctypes.byref(handle)),
                   "cusolverDnCreate")
            _check(lib.cusolverDnCreateParams(ctypes.byref(params)),
                   "cusolverDnCreateParams")
        _handles[idx] = (handle, params)
    return _handles[idx]


def syev_batched(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues [B, n] (ascending) and eigenvectors [B, n, n] (columns)
    of a CUDA float32 batch of symmetric matrices A [B, n, n], from their
    lower triangles, as ``torch.linalg.eigh(A)`` gives them. The solver's
    per-matrix status is not read."""
    if not A.is_cuda or A.dtype != torch.float32 or A.dim() != 3:
        raise ValueError("syev_batched takes a CUDA float32 [B, n, n] batch")
    lib = _library(A.device)
    handle, params = _handle(lib, A.device)
    B, n = A.shape[0], A.shape[-1]
    vectors = A.transpose(1, 2).contiguous()      # column-major copies
    values = torch.empty((B, n), dtype=torch.float32, device=A.device)
    info = torch.empty((B,), dtype=torch.int32, device=A.device)
    _check(lib.cusolverDnSetStream(
        handle, torch.cuda.current_stream(A.device).cuda_stream),
        "cusolverDnSetStream")
    dev_bytes, host_bytes = _SZ(), _SZ()
    _check(lib.cusolverDnXsyevBatched_bufferSize(
        handle, params, _EIG_MODE_VECTOR, _FILL_MODE_LOWER, n, _CUDA_R_32F,
        vectors.data_ptr(), n, _CUDA_R_32F, values.data_ptr(), _CUDA_R_32F,
        ctypes.byref(dev_bytes), ctypes.byref(host_bytes), B),
        "cusolverDnXsyevBatched_bufferSize")
    work = torch.empty((max(dev_bytes.value, 1),), dtype=torch.uint8,
                       device=A.device)
    host_work = ctypes.create_string_buffer(max(host_bytes.value, 1))
    _check(lib.cusolverDnXsyevBatched(
        handle, params, _EIG_MODE_VECTOR, _FILL_MODE_LOWER, n, _CUDA_R_32F,
        vectors.data_ptr(), n, _CUDA_R_32F, values.data_ptr(), _CUDA_R_32F,
        work.data_ptr(), dev_bytes.value, ctypes.cast(host_work, _P),
        host_bytes.value, info.data_ptr(), B), "cusolverDnXsyevBatched")
    return values, vectors.transpose(1, 2)
