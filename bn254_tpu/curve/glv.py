"""GLV endomorphism Shamir ladder for RLC batch-verification weights.

The fused batch-verification tiers (dist/batch_verify.py, BASELINE
configs 4-5) weight every tuple by a random scalar w_i and compute
[w_i]H_i and [w_i]sig_i. With plain 128-bit weights that is a 128-step
double-and-add ladder per point. This module halves the ladder:

**Weights are drawn directly in GLV form** w = a + λ·b (mod r) with a, b
uniform 64-bit, where λ is an eigenvalue of the curve endomorphism
φ(x, y) = (β·x, y) on G1 (β a primitive cube root of unity mod p;
φ(P) = [λ]P for all P since the cofactor is 1). Then

    [w]P = [a]P + [b]φ(P)

computed by ONE 64-step Shamir (joint double-and-add) ladder over the
precomputed table {O, P, φ(P), P + φ(P)} — per step one Jacobian
doubling plus one complete addition of a mask-selected table entry,
exactly half the steps of the 128-bit generic ladder at the same
soundness.

Soundness: the map (a, b) -> a + λb mod r is INJECTIVE on [0, 2^64)^2,
so w is uniform over a set of size 2^128 and the RLC forgery bound stays
2^-128 (tests/test_glv.py pins the argument numerically): if two pairs
collided, (Δa, Δb) would be a nonzero vector of the lattice
{(x, y) : x + λy ≡ 0 mod r} with both coordinates < 2^64, i.e. Euclidean
norm < sqrt(2)·2^64 — but Lagrange-Gauss reduction of that lattice gives
shortest vector (-(2u+1), 6u^2+4u+1) of norm ≈ 2^127.

Batch-first structure: the ladder is branch-free (masked 4-way table
select), fixed-schedule, batch-leading: one `lax.scan` over the bits.

Reference parity note: the reference has no batch verification at all
(its verify is the sequential 2-pair check, ecdsa.rs:49-64); weights and
their GLV form are new-build territory per SURVEY §2.4/§5.7.
"""

from __future__ import annotations

import dataclasses
import secrets

import jax
import jax.numpy as jnp

from ..constants import LIMB_BITS, P, R
from ..fields import limbs as L
from ..fields import tower as T
from . import jacobian as J
from .ops import FqOps

# beta: primitive cube root of unity mod p, paired with LAMBDA such that
# (beta*x, y) == [LAMBDA](x, y) on E(Fq) (verified in tests/test_glv.py
# against the host oracle; derivation: beta = (-1 - sqrt(-3))/2 mod p,
# lambda = (-1 - sqrt(-3))/2 mod r, the (beta1, lam2) matching pair).
BETA = 0x59E26BCEA0D48BACD4F263F1ACDB5C4F5763473177FFFFFE
LAMBDA = 0xB3C4D79D41A917585BFC41088D8DAAA78B17EA66B99C90DD

assert (BETA * BETA + BETA + 1) % P == 0
assert (LAMBDA * LAMBDA + LAMBDA + 1) % R == 0


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class GlvWeights:
    """RLC weights in GLV form: w_i = a_i + λ·b_i (mod r).

    a, b: (18, B) canonical limb tensors, each value < 2^(bits//2).
    bits: total soundness width (static) — the ladder runs bits//2 steps.
    """

    a: L.El
    b: L.El
    bits: int

    def tree_flatten(self):
        return (self.a, self.b), (self.bits,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    @property
    def half_bits(self) -> int:
        return self.bits // 2


def random_glv_weights(n: int, bits: int | None = None) -> GlvWeights:
    """Draw n RLC weights in GLV form (first fixed to w_0 = 1 = (1, 0)).

    bits: total soundness width (default config.rlc_bits; must be even,
    with bits//2 <= 126 so the injectivity lattice argument above holds).
    (a_i, b_i) is uniform over [0, 2^(bits//2))^2 \\ {(0, 0)} — the zero
    pair is redrawn (probability 2^-bits) because w = 0 would leave that
    tuple unweighted in the fused check; every other pair is fine since
    injectivity makes w != 0 for (a, b) != (0, 0). The weight set
    therefore has 2^bits - 1 elements and the forgery bound is the
    advertised ~2^-bits (forcing weights odd would halve it).
    """
    if bits is None:
        from .. import config as C

        bits = C.DEFAULT.rlc_bits
    if bits % 2 != 0 or bits < 2:
        raise ValueError(
            f"rlc_bits must be even and >= 2 for GLV weights, got {bits}"
        )
    half = bits // 2
    if half > 126:
        raise ValueError(
            f"rlc_bits {bits} too wide: the GLV injectivity bound "
            "(shortest lattice vector ~2^127) only guarantees a "
            "collision-free weight set for bits//2 <= 126"
        )

    def draw():
        while True:
            a, b = secrets.randbits(half), secrets.randbits(half)
            if a or b:
                return a, b

    pairs = [(1, 0)] + [draw() for _ in range(n - 1)]
    return glv_weights_to_device(pairs, bits)


def glv_weights_to_device(pairs, bits: int) -> GlvWeights:
    """Host (a, b) int pairs -> validated device GlvWeights."""
    half = bits // 2
    for a, b in pairs:
        if (int(a) >> half) or (int(b) >> half):
            raise ValueError(
                f"GLV weight half ({int(a):#x}, {int(b):#x}) exceeds "
                f"{half} bits; the {half}-step Shamir ladder would "
                "truncate it"
            )
    # vmax PINNED to the validated bound, not the data-dependent default
    # (max value + 1): El bounds are static jit-cache metadata, so a
    # data-dependent vmax gives every fresh weight draw a NEW program
    # signature and silently recompiles the whole weight-ladder stage
    # (~minutes) on every run.
    return GlvWeights(
        L.from_ints([int(a) for a, _ in pairs], vmax=1 << half),
        L.from_ints([int(b) for _, b in pairs], vmax=1 << half),
        bits,
    )


def weight_values(w: GlvWeights):
    """Host ints w_i = a_i + λ b_i mod r (for oracle cross-checks)."""
    a = L.to_ints(w.a)
    b = L.to_ints(w.b)
    return [(int(x) + LAMBDA * int(y)) % R for x, y in zip(a.ravel(), b.ravel())]


def phi(p: J.JPoint) -> J.JPoint:
    """The GLV endomorphism on Jacobian coords: (X, Y, Z) -> (βX, Y, Z).

    x = X/Z^2 -> βx, so only X scales; identity (Z=0) maps to itself.
    """
    beta = T.mont_const(BETA)
    return J.JPoint(L.mont_mul(p.x, beta), p.y, p.z)


# ---------------------------------------------------------------------------
# Shamir ladder (MSB-first, fixed schedule, branch-free)
# ---------------------------------------------------------------------------


def _pin(e: L.El) -> L.El:
    """Pin (vmax, lmax) to the (STD_BOUND, 2^16) fixed point (the same
    stabilisation the Miller loop uses — see miller._pin_el)."""
    if e.vmax > L.STD_BOUND:
        e = L.vreduce(e)
    if e.lmax > (1 << 16):
        e = L.norm_limbs(e)
    return L.retag(e, L.STD_BOUND, 1 << 16)


def _pin_point(p: J.JPoint) -> J.JPoint:
    return J.JPoint(_pin(p.x), _pin(p.y), _pin(p.z))


def _select_point(mask, t: J.JPoint, f: J.JPoint) -> J.JPoint:
    return J.JPoint(
        L.select(mask, t.x, f.x),
        L.select(mask, t.y, f.y),
        L.select(mask, t.z, f.z),
    )


def _table(p: J.JPoint):
    """{O, P, φP, P+φP} with every entry bound-pinned."""
    bs = p.x.batch_shape
    p1 = _pin_point(p)
    p2 = _pin_point(phi(p1))
    p3 = _pin_point(J.add(FqOps, p1, p2))
    ident = _pin_point(J.identity(FqOps, bs))
    return ident, p1, p2, p3


def _select_entry(bit_a, bit_b, table):
    """table[2*bit_b + bit_a] via 3 masked point selects."""
    ident, p1, p2, p3 = table
    lo = _select_point(bit_b, p2, ident)  # a=0 half
    hi = _select_point(bit_b, p3, p1)  # a=1 half
    return _select_point(bit_a, hi, lo)


def shamir_scalar_mul(p: J.JPoint, w: GlvWeights) -> J.JPoint:
    """[a]P + [b]φ(P) by a (bits//2)-step MSB-first Shamir ladder.

    p: batched Jacobian point (coords broadcastable against w's batch).
    Each step: Jacobian doubling + COMPLETE masked addition of the
    table entry — the addition handles identity operands and the
    acc == ±sel edge cases, so adversarially chosen batch points cannot
    derail the ladder. `lax.scan` with dynamic bit indexing.
    """
    return _shamir_scan(_table(p), w, w.half_bits)


def _shamir_scan(table, w: GlvWeights, nbits: int) -> J.JPoint:
    ident = table[0]

    def bit_at(arr, i):
        limb = jax.lax.dynamic_index_in_dim(
            arr, i // LIMB_BITS, axis=0, keepdims=False
        )
        return (limb >> (i % LIMB_BITS).astype(jnp.uint32)) & jnp.uint32(1)

    def step(acc, i):
        ba = bit_at(w.a.arr, i) != 0
        bb = bit_at(w.b.arr, i) != 0
        sel = _select_entry(ba, bb, table)
        acc = J.double(FqOps, acc)
        acc = J.add(FqOps, acc, sel)
        return _pin_point(acc), None

    idx = jnp.arange(nbits - 1, -1, -1, dtype=jnp.uint32)
    acc, _ = jax.lax.scan(step, ident, idx)
    return acc
