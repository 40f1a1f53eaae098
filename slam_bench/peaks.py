"""The yardstick of the kernels' roofline shares: the card's published peaks
and the operation and byte counts of each hand-written kernel, frozen here
so that a change to the program cannot move them.

Peaks: one NVIDIA H100 SXM (data sheet, dense rates), at its full 700 W
power limit; a card set below it reaches less, so a share is read beside the
card's power limit, which every run prints.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12      # HBM3
H100_INT8_OPS_PER_S = 1979e12   # int8 tensor cores, dense


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes over the memory rate or
    int8 operations over the tensor cores' rate, whichever is larger."""
    return max(n_bytes / H100_BYTES_PER_S, n_ops / H100_INT8_OPS_PER_S)


def hamming_best2_counts(n: int, m: int, t: int):
    """(bytes, operations) of one `hamming_best2` call: a [n, 8] int32
    against t sets of [m, 8] under a [t, n, m] bool mask. Each input byte is
    read once (both packed descriptor sets and the mask) and each output
    written once (best and second index as int64, distance as int16: 20
    bytes a row and set); 2 * 256 int8 operations per (row, column, set)."""
    n_bytes = n * 32 + t * m * 32 + t * n * m + t * n * 20
    return n_bytes, 2 * t * n * m * 256


def hamming_best2_bound_s(n: int, m: int, t: int) -> float:
    return bound_s(*hamming_best2_counts(n, m, t))
