"""Peaks of the card and the work of one scan cell, counted from its shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W power
limit, dense rates without sparsity.  The run prints the card's power limit
beside every number read against them.  Both the product's roofline and the
scan's MFU use the bf16 tensor rate as the one compute peak: a later kernel
that computes the fp32 contract another way (3xTF32, split bf16, int8 on
codes) reads the same work against the same yardstick, and none can pass
100%.
"""
from __future__ import annotations

import math

PEAK_FLOPS = 989e12   # bf16 dense tensor rate, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bandwidth, B/s


def product_flops(m: int, n: int, p: int) -> float:
    """Multiply-adds of ``R = G Y``: ``(m, n) x (n, p)``, two FLOP each."""
    return 2.0 * m * n * p


def product_bytes(m: int, n: int, p: int) -> float:
    """Least bytes of one cell's product: the packed genotype codes read once
    (2 bits a sample), the float32 panel read once, the float32 r tile
    written once."""
    return m * math.ceil(n / 4) + 4.0 * n * p + 4.0 * m * p


def product_least_s(m: int, n: int, p: int) -> float:
    """The least time the card could take for one cell's product: the larger
    of its operations over the compute peak and its bytes over bandwidth."""
    return max(product_flops(m, n, p) / PEAK_FLOPS, product_bytes(m, n, p) / PEAK_BYTES)
