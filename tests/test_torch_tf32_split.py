"""Why K2 splits each float32 operand into two TF32 parts (3xTF32).

TF32 keeps 10 mantissa bits. The tensor-core products of K2 take
a = a_hi + a_lo with a_hi = tf32(a) and a_lo = a - a_hi (which the tensor
core reads truncated to TF32), and sum a_lo b_hi + a_hi b_lo + a_hi b_hi
in float32. Here TF32 rounding is emulated in torch as ``cvt.rna.tf32.f32``
does it (round to nearest, ties away from zero; the kernel computes the
same with two integer instructions) and, at each decoder product's shape,
the error is
measured as chip_smoke._err measures it (max abs error / max |reference|)
against a float64 reference: the split stays within 2e-6, single TF32
does not."""

import numpy as np
import pytest
import torch

import chip_smoke


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), ties away from zero."""
    bits = a.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-0x80000000, dtype=torch.int32)
    mag = bits & 0x7FFFFFFF
    mag = (mag + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """The tensor core's reading of a float32 operand as TF32: the low 13
    mantissa bits dropped."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    """K2's split: hi = rna(a) (two integer instructions), lo = a - hi
    exactly, which the tensor core then reads truncated."""
    hi = tf32_rna(a)
    return hi, tf32_trunc(a - hi)


def mma_f32(a: torch.Tensor, b: torch.Tensor, terms) -> torch.Tensor:
    """sum over k of a[:, k] b[k, :] as the tensor cores take it: k in
    steps of 8, each step's products added to a float32 accumulator."""
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        for ta, tb in terms:
            c = c + ta[:, k0:k0 + 8] @ tb[k0:k0 + 8]
    return c


def products(a: torch.Tensor, b: torch.Tensor):
    ah, al = split(a)
    bh, bl = split(b)
    three = mma_f32(a, b, [(al, bh), (ah, bl), (ah, bh)])
    single = mma_f32(a, b, [(ah, bh)])
    return three, single


def test_tf32_rounding_matches_rna():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10),
            1.0, 3.0]
    assert tf32_rna(x).tolist() == want


# (K, N) of each decoder product: trunk0 (PE 51 -> 56), trunk1, sdf0, rgb
# (115 -> 120), sdf1; the points are the other dimension (a 64-point tile)
SHAPES = [(56, 128), (128, 128), (112, 128), (120, 3), (128, 5)]


@pytest.mark.parametrize("k,n", SHAPES)
def test_split_keeps_float32_accuracy_on_decoder_products(k, n):
    rng = np.random.default_rng(k * 1000 + n)
    a = np.maximum(rng.normal(size=(64, k)), 0.0).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    ref = torch.tensor(a.astype(np.float64) @ w.astype(np.float64))
    three, single = products(torch.tensor(a), torch.tensor(w))
    assert chip_smoke._err(three, ref)[1] < 2e-6
    assert chip_smoke._err(single, ref)[1] > 2e-6


@pytest.mark.parametrize("m,n", [(56, 128), (128, 128), (112, 128),
                                 (120, 3), (128, 5)])
def test_split_keeps_float32_accuracy_on_weight_gradients(m, n):
    """dW = sum over a tile's 64 points of a d^T."""
    rng = np.random.default_rng(m * 7 + n)
    a = np.maximum(rng.normal(size=(m, 64)), 0.0).astype(np.float32)
    d = (rng.normal(size=(64, n)) * 0.01).astype(np.float32)
    ref = torch.tensor(a.astype(np.float64) @ d.astype(np.float64))
    three, single = products(torch.tensor(a), torch.tensor(d))
    assert chip_smoke._err(three, ref)[1] < 2e-6
    assert chip_smoke._err(single, ref)[1] > 2e-6
