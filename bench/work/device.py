"""The card's peaks (NVIDIA H100 SXM data sheet, dense, at its 700 W
limit) and the least time of a piece of work."""
from __future__ import annotations

#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, operations/s; 32-bit integer work is
#: held to the same rate (the card issues fewer integer operations a
#: clock, so a share against it is never too high)
CUDA_CORE_OPS_PER_S = 67e12

#: 32-bit operations of one Threefry-2x32 hash: two key adds, 20 rounds
#: of add, rotate (two shifts and an or) and xor, five key injections of
#: three adds
THREEFRY_OPS = 2 + 20 * 5 + 5 * 3
#: one random word: a hash and the xor of its two halves
BITS_OPS = THREEFRY_OPS + 1
#: one float32 uniform: a random word, a shift, an or and a subtract
UNIFORM_OPS = BITS_OPS + 3
#: one integer below a bound from two random words: a split of the key
#: (two hashes), two remainders, a multiply, an add and a remainder
RANDINT_OPS = 2 * THREEFRY_OPS + 2 * BITS_OPS + 5


def least_seconds(nbytes: float, ops: float) -> float:
    """max(bytes / bandwidth, operations / rate)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S)
