"""Device pairing API: single, batched, and product-reduced pairings.

Mirrors the reference's `pairing_batch(&[(G1, G2)]) -> Gt` semantics
(/root/reference/src/ecdsa.rs:57,86): multiply the per-pair Miller values
in Fq12, then ONE shared final exponentiation — the structure the whole
multi-chip scaling design rides on (SURVEY.md §5.7/§5.8): per-shard
Miller loops, Fq12-product reduction (a commutative monoid), one final
exponentiation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..fields import limbs as L
from ..fields import tower as T
from . import final_exp as FE
from . import miller as M

Fq12 = T.Fq12


def pairing(px, py, qx, qy, inf_mask=None) -> Fq12:
    """Full pairing e(P, Q) for affine Montgomery-domain inputs."""
    return FE.final_exp(M.miller_loop(px, py, qx, qy, inf_mask))


def miller_product(px, py, qx, qy, pair_axis: int = 0) -> Fq12:
    """Miller values for a batch of pairs, multiplied along `pair_axis`.

    Inputs carry a leading 'pair' batch dim at tensor axis 1 (the first
    batch dim); the product reduces it. Used for the 2-pair verify check
    and for shard-local reduction in distributed batch verification.
    """
    f = M.miller_loop(px, py, qx, qy)
    return fq12_reduce_mul(f, axis=pair_axis)


def fq12_reduce_mul(f: Fq12, axis: int = 0) -> Fq12:
    """Tree-reduce an Fq12 batch axis by field multiplication.

    log2(n) sequential fq12_mul rounds, each on half the remaining batch —
    the on-chip analogue of the cross-chip Fq12 all-reduce.
    `axis` indexes the batch dims (0 = tensor axis 1, after limbs).
    """
    taxis = axis + 1  # tensor axis (axis 0 is limbs)

    def take(x, sl):
        idx = (slice(None),) * taxis + (sl,)
        return x[idx]

    def length(x):
        return x.shape[taxis]

    def cat_els(a, b):
        """El-aware concat: merged (max) static bounds — tree_map alone
        would reject trees whose El aux tags differ (a product's bounds
        vs a leftover slice's; hit whenever n is odd, e.g. the fused
        tier's B+1 batches)."""
        if isinstance(a, L.El):
            return L.El(
                jnp.concatenate([a.arr, b.arr], axis=taxis),
                max(a.vmax, b.vmax),
                max(a.lmax, b.lmax),
            )
        return type(a)(*[cat_els(x, y) for x, y in zip(a, b)])

    leaf = jax.tree_util.tree_leaves(f)[0]
    n = leaf.shape[taxis]
    while n > 1:
        half = n // 2
        lo = jax.tree_util.tree_map(lambda x: take(x, slice(0, half)), f)
        hi = jax.tree_util.tree_map(
            lambda x: take(x, slice(half, 2 * half)), f
        )
        prod = T.fq12_mul(lo, hi)
        if n % 2:
            rest = jax.tree_util.tree_map(
                lambda x: take(x, slice(2 * half, n)), f
            )
            prod = cat_els(prod, rest)
            n = half + 1
        else:
            n = half
        f = prod
    return jax.tree_util.tree_map(
        lambda x: jnp.squeeze(x, axis=taxis), f
    )


def pairing_check(px, py, qx, qy) -> jnp.ndarray:
    """prod_i e(P_i, Q_i) == 1 with one shared final exponentiation.

    Pair axis is the first batch dim; remaining batch dims are preserved
    (vmap-style). Returns a bool per remaining batch element.
    """
    reduced = miller_product(px, py, qx, qy)
    return T.fq12_is_one(FE.final_exp(reduced))


# ---------------------------------------------------------------------------
# staged pipeline (separately jitted stages — see final_exp.py docstring)
# ---------------------------------------------------------------------------

_miller_jit = jax.jit(M.miller_loop)
_reduce_jit = jax.jit(lambda f: T.fq12_retag(fq12_reduce_mul(f, axis=0)))
_is_one_jit = jax.jit(T.fq12_is_one)


def pairing_check_staged(px, py, qx, qy) -> jnp.ndarray:
    """Staged `pairing_check`: same result, compiled as a pipeline of
    small programs (miller -> pair-product -> staged final exp -> cmp)."""
    f = _miller_jit(px, py, qx, qy)
    reduced = _reduce_jit(f)
    return _is_one_jit(FE.final_exp_staged(reduced))
