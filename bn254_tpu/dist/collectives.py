"""Cross-chip collectives for BN254 batch verification.

The key reduction is an **all-reduce whose monoid is Fq12 multiplication**
(element-wise field product of Miller-loop values). XLA's `psum` only
knows +/min/max, so the product-reduce is built from `ppermute` rounds +
local Fq12 multiplication (XLA hands the permutes to NCCL between
cards), exactly the structure SURVEY.md §5.8 prescribes. Each round's
fq12_mul renormalises the limb representation, so no carry drift
accumulates across rounds.

Supports ANY axis size, not just powers of two: the reduction follows the
binary expansion of n — `acc` doubles its covered cyclic segment each
round (recursive doubling), and whenever a bit of n is set, the current
segment is grafted onto the result at the running offset. Every rank ends
holding the product of all n contributions exactly once. Round count is
floor(log2(n)) doubling steps plus one extra permute per extra set bit
(log2(n) total for powers of two — identical to classic recursive
doubling).
"""

from __future__ import annotations

import jax

from ..errors import InvalidLengthError
from ..fields import tower as T


def _ppermute_shift(x, axis_name: str, axis_size: int, shift: int):
    """Cyclic shift: rank i receives the value held by rank (i - shift)."""
    perm = [(i, (i + shift) % axis_size) for i in range(axis_size)]
    return jax.tree_util.tree_map(
        lambda a: jax.lax.ppermute(a, axis_name, perm), x
    )


def allreduce_monoid(x, mul_fn, axis_name: str, axis_size: int):
    """All-reduce `x` over the named mesh axis under an arbitrary
    associative `mul_fn`, for ANY axis size.

    Invariant: after k doubling rounds, acc(i) = prod_{j<2^k} x_{i-j}
    (cyclic). The result stitches together segments of sizes equal to the
    set bits of n at consecutive offsets, covering [0, n) exactly once.
    """
    if axis_size < 1:
        raise InvalidLengthError(f"axis size must be >= 1, got {axis_size}")
    if axis_size == 1:
        return x
    res = None
    acc = x
    offset = 0
    k = 0
    rem = axis_size
    while rem:
        if rem & 1:
            seg = (
                acc
                if offset == 0
                else _ppermute_shift(acc, axis_name, axis_size, offset)
            )
            res = seg if res is None else mul_fn(res, seg)
            offset += 1 << k
        rem >>= 1
        if rem:
            acc = mul_fn(
                acc, _ppermute_shift(acc, axis_name, axis_size, 1 << k)
            )
        k += 1
    return res


def jacobian_allreduce_add(p, add_fn, axis_name: str, axis_size: int):
    """All-reduce a (per-shard) Jacobian point by group addition.

    Same structure as `fq12_allreduce_mul`, with the branch-free point add
    as the monoid. Used to combine the per-shard weighted-signature sums
    in sharded aggregate verification.
    """
    return allreduce_monoid(p, add_fn, axis_name, axis_size)


def fq12_allreduce_mul(f: T.Fq12, axis_name: str, axis_size: int) -> T.Fq12:
    """Product of f over the named mesh axis, available on every member."""
    return allreduce_monoid(f, T.fq12_mul, axis_name, axis_size)
