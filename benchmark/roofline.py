"""The yardstick of the kernel and whole-step metrics: the card's peaks
and the least time an operation can take on it.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit
(a card set to a lower limit reads lower shares; every result names the
card and its limit).  A least time is the larger of the bytes the
operation must move over HBM and the operations it must compute over the
dtype's peak, counting each input byte read once and each output byte
written once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: tensor cores, bf16 and f16 (the rate the whole-step metrics use)
BF16_FLOPS = 989.4e12
TF32_FLOPS = 494.7e12


def bound_s(nbytes: float, ops: float, itemsize: int) -> Tuple[float, str]:
    """Least seconds for ``nbytes`` over HBM and ``ops`` over the dtype's
    peak, and which of the two bounds it.  f32 operations take the lesser
    of the CUDA cores' rate and three TF32 products a product."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if itemsize == 4:
        t_ops = min(ops / F32_FLOPS, 3 * ops / TF32_FLOPS)
    else:
        t_ops = ops / BF16_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def percent(least_s: float, took_s: float):
    """The roofline share in percent, or None where nothing was timed."""
    if took_s <= 0:
        return None
    return 100.0 * least_s / took_s
