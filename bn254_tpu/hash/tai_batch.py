"""Batched (device) SHA-256 try-and-increment hash-to-G1.

The masked K-candidate search of SURVEY.md §3.5: for each message compute
K counter candidates in parallel, validate each (rejection bound, field
membership, quadratic residuosity), then select the FIRST valid counter —
branch-free and bit-exact w.r.t. the reference's sequential search
(/root/reference/src/hash.rs:29-63), including the `mod_u256` strict-`>`
edge (a hash that reduces to exactly p fails decompression and skips the
counter: here it canonicalises to x = 0, and x=0 fails the QR check since
3 is a non-residue mod p — the same skip outcome).

With success probability ~1/2 per counter, K = 8 leaves ~0.4% of messages
unresolved; callers fall back to the host search for those (the returned
`found` mask says which).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import B as CURVE_B
from ..constants import LAST_MULTIPLE_OF_P_BELOW_2_256, P
from ..fields import limbs as L
from . import sha256 as SHA


def prepare_blocks_host(messages: list[bytes]):
    """Host prep: messages (equal length) -> (blocks, ctr_word, ctr_shift).

    Appends the 0x00 counter byte (reference hash.rs:33-34) before SHA
    padding and reports where the counter byte lives in the word grid.
    """
    mlen = len(messages[0])
    assert all(len(m) == mlen for m in messages), "equal lengths required"
    padded = [bytes(m) + b"\x00" for m in messages]
    blocks = SHA.pad_messages_host(padded)
    pos = mlen  # byte index of the ctr within the padded message
    word_flat = pos // 4  # flat word index across blocks
    shift = (3 - pos % 4) * 8  # big-endian byte within the word
    return blocks, word_flat, shift


def hash_to_g1_batch(blocks: jnp.ndarray, ctr_word: int, ctr_shift: int,
                     k_candidates: int = 8):
    """Device search over K counters.

    blocks: (B, nblocks, 16) uint32 from `prepare_blocks_host` (ctr = 0).
    Returns (x_mont, y_mont, found, ctr): Montgomery affine G1 coords
    (limbs.El of shape (18, B)), a (B,) bool mask, (B,) uint32 counters.
    """
    Bn, nblocks, _ = blocks.shape
    nb_word = ctr_word // 16
    w_in_block = ctr_word % 16

    # (B, K, nblocks, 16): add ctr << shift to the counter word
    ctrs = jnp.arange(k_candidates, dtype=jnp.uint32)
    blocks_k = jnp.broadcast_to(
        blocks[:, None], (Bn, k_candidates, nblocks, 16)
    )
    bump = jnp.zeros((k_candidates, nblocks, 16), jnp.uint32)
    bump = bump.at[:, nb_word, w_in_block].set(ctrs << ctr_shift)
    blocks_k = blocks_k + bump[None]

    digests = SHA.sha256_blocks(blocks_k)  # (B, K, 8)
    attempted = SHA.digest_words_to_limbs(digests)  # El (18, B, K)

    # rejection bound (hash.rs:49-51)
    accept = L.lt_const(attempted, LAST_MULTIPLE_OF_P_BELOW_2_256)

    # reduce mod p: attempted < 2^256 < 8p
    x = attempted
    for m in (4 * P, 2 * P, P):
        x = L.cond_sub(x, m)
    x_mont = L.to_mont(x)

    # y^2 = x^3 + 3; sqrt candidate via x^((p+1)/4)
    y2 = L.add_mod(
        L.mont_mul(L.mont_sqr(x_mont), x_mont),
        L.mul_small(L.mont_one(x_mont.batch_shape), CURVE_B),
    )
    s = L.sqrt_candidate(y2)
    is_qr = L.eq(L.mont_sqr(s), y2)
    valid = accept & is_qr  # (B, K)

    # even-y selection (sign byte 0x02, utils.rs:56-63)
    s_canon = L.from_mont(s)
    odd = (s_canon.arr[0] & 1) != 0
    y_mont = L.select(odd, L.neg_mod(s), s)

    # first valid counter per message
    found = jnp.any(valid, axis=-1)  # (B,)
    first = jnp.argmax(valid, axis=-1).astype(jnp.uint32)  # (B,)
    idx = first[None, :, None]
    x_sel = L.elmap(
        lambda a: jnp.take_along_axis(a, idx, axis=2)[:, :, 0], x_mont
    )
    y_sel = L.elmap(
        lambda a: jnp.take_along_axis(a, idx, axis=2)[:, :, 0], y_mont
    )
    # The odd-y branch is `neg_mod` of a STD_BOUND-tagged pow output, so
    # the select carries vmax slightly above STD_BOUND — crush it back
    # below the pairing pipeline's carrier bound here, post-selection
    # (cost: ONE leaf mul on (18, B), not (18, B, K)). This was the
    # trace-time regression (tests/test_bound_pinning.py).
    y_sel = L.maybe_vreduce(y_sel, L.STD_BOUND)
    return x_sel, y_sel, found, first


def hash_to_g1_device(messages: list[bytes], k_candidates: int | None = None):
    """End-to-end batched hash-to-G1 with host fallback for rare misses.

    Returns (x_mont, y_mont) limbs.El of shape (18, B), bit-exact with the
    host `hash_to_g1_affine` for every message. k_candidates defaults to
    config.DEFAULT.k_candidates.

    Mixed-length batches are supported by bucketing per message length
    (the counter-byte position in the SHA word grid is a per-program
    static); each bucket runs one device program, and the results are
    re-stitched in input order.
    """
    from .. import config as C
    from .tai import hash_to_g1_affine

    if k_candidates is None:
        k_candidates = C.DEFAULT.k_candidates

    lengths = {len(m) for m in messages}
    if len(lengths) > 1:
        buckets: dict[int, list[int]] = {}
        for i, m in enumerate(messages):
            buckets.setdefault(len(m), []).append(i)
        xs, ys, order = [], [], []
        for mlen in sorted(buckets):
            idx = buckets[mlen]
            bx, by = hash_to_g1_device(
                [messages[i] for i in idx], k_candidates
            )
            xs.append(bx)
            ys.append(by)
            order.extend(idx)
        inv = np.empty(len(messages), dtype=np.int64)
        inv[np.array(order)] = np.arange(len(messages))
        cat = lambda els: L.El(
            jnp.concatenate([e.arr for e in els], axis=1)[:, inv],
            max(e.vmax for e in els),
            max(e.lmax for e in els),
        )
        return cat(xs), cat(ys)

    blocks, w, s = prepare_blocks_host(messages)
    x, y, found, _ = hash_to_g1_batch(
        jnp.asarray(blocks), w, s, k_candidates
    )
    found_np = np.asarray(found)
    if not found_np.all():
        misses = np.nonzero(~found_np)[0]
        xs_fix, ys_fix = [], []
        for i in misses:
            ax, ay = hash_to_g1_affine(messages[int(i)])
            xs_fix.append(ax)
            ys_fix.append(ay)
        fx = L.to_mont(L.from_ints(xs_fix, vmax=P))
        fy = L.to_mont(L.from_ints(ys_fix, vmax=P))
        midx = jnp.asarray(misses)
        x = L.El(x.arr.at[:, midx].set(fx.arr), max(x.vmax, fx.vmax), x.lmax)
        y = L.El(y.arr.at[:, midx].set(fy.arr), max(y.vmax, fy.vmax), y.lmax)
    return x, y
