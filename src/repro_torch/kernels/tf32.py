"""TF32 roundings in plain torch: the operand splits of the port's 3xTF32
kernels (``gram/csrc/gram.cu``, ``flash_attention/csrc/flash_attention.cu``),
for the emulations of their arithmetic that the CPU tests check.

A TF32 value is an fp32 value whose low 13 mantissa bits are zero (10
mantissa bits). The product of two TF32 values is exact in fp32, so
x·y = hi·hi' + hi·lo' + lo·hi' + lo·lo' with hi, lo the splits below.
"""
from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), to nearest, ties away from zero:
    cvt.rna.tf32.f32 with the low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 toward zero: the low 13 bits cleared. It is what the
    flash kernel's split takes as hi, and what the tensor cores read of an
    fp32 register given as a TF32 operand."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)
