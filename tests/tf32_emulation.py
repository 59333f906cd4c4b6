"""The arithmetic of the port's tensor-core kernels, emulated on the CPU
(``recboard_tpu_torch/ops/csrc/mma_tf32.cuh``): TF32 rounding done on the
bits, and products in one TF32 pass or in split precision (3xTF32). Shared
by the tests that emulate K1-K3's and K5's kernels."""

import torch


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits'
    weight to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def mm_tf32(a, b):
    """a @ b from one TF32 product: each operand rounded to about three
    digits."""
    return tf32(a) @ tf32(b)


def mm_split(a, b):
    """a @ b as the tensor cores compute it in split precision: lo*hi +
    hi*lo + hi*hi with hi = tf32(x) and lo = tf32(x - hi), each product
    exact, summed in float32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
