"""Batched and mesh-sharded BLS verification (the throughput workload).

Three tiers, matching the driver benchmark configs (BASELINE.md):

1. `verify_batch_independent` — N independent (H(m), sig, pk) tuples on
   one chip: each tuple is its own 2-pair product check with its own
   final exponentiation (vmap-style via the pair axis + batch axis).
2. `verify_batch_fused` — N tuples fused into ONE pairing-product check
   with random linear-combination weights (soundness per SURVEY.md §3.2
   note): prod_i e([w_i]H_i, pk_i) * e(-sum_i [w_i]sig_i, G2) == 1,
   a single shared final exponentiation.
3. `make_sharded_verifier` — tier 2 sharded over a `jax.sharding.Mesh`
   batch axis with shard-local Miller loops + tree product, a cross-chip
   Fq12-product all-reduce, and one replicated final exp.

The reference has no batching beyond its sequential 2-pair loop
(ecdsa.rs:49-64); this module is the batch-first scaling design the
survey's §7 step 5-6 calls for.
"""

from __future__ import annotations

import dataclasses
import functools
import secrets

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from ..constants import NLIMBS
from ..curve import g1 as DG1
from ..curve import glv as GLV
from ..errors import InvalidLengthError
from ..curve import jacobian as J
from ..fields import limbs as L
from ..fields import tower as T
from ..host import curve as HC
from ..pairing import final_exp as FE
from ..pairing import miller as M
from ..pairing import pairing as DP
from ..utils import convert as CV
from . import collectives as COLL
from . import mesh as MESH


def _neg_g2_one(batch_shape):
    return CV.g2_const_affine(HC.g2_neg(HC.G2_ONE), batch_shape)


# ---------------------------------------------------------------------------
# Tier 1: independent batch verification (one chip, vmapped)
# ---------------------------------------------------------------------------


def verify_batch_independent(hx, hy, sx, sy, pqx, pqy) -> jnp.ndarray:
    """N independent verifies -> bool (B,).

    hx/hy: hash points H(m_i) (18, B); sx/sy: signatures (18, B);
    pqx/pqy: public keys (tower.Fq2 with (18, B) components).
    Each tuple checks e(H, pk) * e(sig, -G2::one) == 1 with its own
    final exponentiation (exact per-tuple accept/reject semantics,
    matching reference `verify` one-by-one).
    """
    px, py, qx, qy = _independent_pairs(hx, hy, sx, sy, pqx, pqy)
    return DP.pairing_check(px, py, qx, qy)


def _independent_pairs(hx, hy, sx, sy, pqx, pqy):
    B = hx.batch_shape[-1]
    # pair axis in front of the batch axis: (18, 2, B)
    px = L.stack([hx, sx])
    py = L.stack([hy, sy])
    ngx, ngy = _neg_g2_one((B,))
    qx = T.fq2_stack([pqx, ngx])
    qy = T.fq2_stack([pqy, ngy])
    return px, py, qx, qy


_independent_pairs_jit = jax.jit(_independent_pairs)


def verify_batch_independent_staged(hx, hy, sx, sy, pqx, pqy) -> jnp.ndarray:
    """Staged-pipeline variant of `verify_batch_independent` (same result,
    several small jitted programs instead of one huge one)."""
    px, py, qx, qy = _independent_pairs_jit(hx, hy, sx, sy, pqx, pqy)
    return DP.pairing_check_staged(px, py, qx, qy)


# ---------------------------------------------------------------------------
# Tier 2: fused batch verification (random linear combination, one final exp)
# ---------------------------------------------------------------------------


def random_weights(n: int, bits: int | None = None):
    """Host-side random combination weights in GLV form (first fixed
    to 1): each w_i = a_i + λ b_i mod r with a_i, b_i uniform
    (bits//2)-bit — uniform over a 2^bits-size set (curve/glv.py), so a
    forgery passes the fused check with probability ~2^-bits while the
    weight ladder runs only bits//2 Shamir steps.

    Width defaults to config.DEFAULT.rlc_bits. Returns a GlvWeights;
    plain int weight lists (random_weights_plain) are still accepted by
    every verify entrypoint and validated against the ladder length."""
    if bits is None:
        from .. import config as C

        bits = C.DEFAULT.rlc_bits
    return GLV.random_glv_weights(n, bits)


def random_weights_plain(n: int, bits: int | None = None):
    """Plain int weights, uniform over [1, 2^bits) (the non-GLV path;
    first fixed to 1). Zero is redrawn — an unweighted tuple would drop
    out of the fused check — so the full 2^bits - 1 weight set backs the
    ~2^-bits forgery bound (forcing weights odd would halve it)."""
    if bits is None:
        from .. import config as C

        bits = C.DEFAULT.rlc_bits

    def draw():
        while True:
            w = secrets.randbits(bits)
            if w:
                return w

    return [1] + [draw() for _ in range(n - 1)]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PlainWeights:
    """Device-resident plain RLC weights, validated at conversion time.

    Construct via `weights_to_device` — the only way to get a
    pre-converted weight tensor into the verify entrypoints (raw El
    tensors are rejected, see `_resolve_weights`). `bits` is the ladder
    length the values were validated against.
    """

    w: L.El
    bits: int

    def tree_flatten(self):
        return (self.w,), (self.bits,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])


def weights_to_device(weights, bits: int | None = None) -> PlainWeights:
    """Validate host int weights against `bits` (default config.rlc_bits)
    and convert ONCE to a device tensor reusable across many calls."""
    if bits is None:
        from .. import config as C

        bits = min(int(C.DEFAULT.rlc_bits), 256)
    return PlainWeights(
        CV.scalars_to_device(_check_weights(weights, bits)), bits
    )


def _check_weights(weights, bits: int):
    """Host-side guard: every RLC weight must fit the ladder length."""
    for w in weights:
        if int(w) >> bits:
            raise ValueError(
                f"RLC weight {int(w):#x} exceeds {bits} bits "
                "(config.rlc_bits); the weight ladder would truncate it"
            )
    return weights


def _resolve_weights(weights, nbits: int | None):
    """Normalise a weights argument to (device weights, ladder bits).

    weights: GlvWeights (preferred, carries its own validated width), a
    PlainWeights (validated at `weights_to_device` conversion), or a
    host list/sequence of ints, validated HERE against the ladder
    length. Raw El limb tensors are rejected: a
    pre-converted tensor cannot be bound-checked without a device round
    trip, and an oversize weight would silently truncate in the ladder —
    silently degrading the advertised 2^-rlc_bits forgery bound. Every
    accepted input form is validated; there is no unchecked door.
    nbits: ladder length for plain weights; defaults to
    config.DEFAULT.rlc_bits.
    """
    if isinstance(weights, GLV.GlvWeights):
        return weights, weights.half_bits
    if isinstance(weights, PlainWeights):
        return weights.w, weights.bits
    if isinstance(weights, L.El):
        raise TypeError(
            "raw El weight tensors are not accepted (their < 2^rlc_bits "
            "bound cannot be validated host-side); pass a GlvWeights or "
            "a host list of ints"
        )
    if nbits is None:
        from .. import config as C

        nbits = min(int(C.DEFAULT.rlc_bits), 256)
    weights = CV.scalars_to_device(_check_weights(weights, nbits))
    return weights, nbits


def _apply_weights(hx, hy, sx, sy, w, nbits: int):
    """([w_i]H_i, [w_i]sig_i) for both weight forms.

    GLV weights run ONE Shamir ladder over the (H, sig) pair axis
    (bits//2 steps, curve/glv.py); plain weights run the generic
    nbits-step ladder.
    """
    p = J.JPoint(
        L.stack([hx, sx]),
        L.stack([hy, sy]),
        L.mont_one((2,) + tuple(hx.batch_shape)),
    )
    if isinstance(w, GLV.GlvWeights):
        wp = GLV.shamir_scalar_mul(p, w)
    else:
        wp = DG1.scalar_mul(p, w, nbits)
    xs = L.unstack(wp.x, 2)
    ys = L.unstack(wp.y, 2)
    zs = L.unstack(wp.z, 2)
    wh = J.JPoint(xs[0], ys[0], zs[0])
    ws = J.JPoint(xs[1], ys[1], zs[1])
    return wh, ws


def _el_append(a: L.El, b: L.El) -> L.El:
    """Concat a scalar-batch El onto the trailing batch axis of `a`."""
    bb = b.arr.reshape(b.arr.shape + (1,) * (a.arr.ndim - b.arr.ndim))
    bb = jnp.broadcast_to(bb, a.arr.shape[:-1] + (1,))
    return L.El(
        jnp.concatenate([a.arr, bb], axis=-1),
        max(a.vmax, b.vmax),
        max(a.lmax, b.lmax),
    )


def _fused_points(hx, hy, sx, sy, pqx, pqy, w, nbits: int):
    """Stage A of the fused check: weight ladders, signature tree-sum,
    and the (B+1)-row point batch — the B weighted hash points plus the
    signature-sum row S = sum_i [w_i]sig_i appended with -G2::one as its
    G2 partner. Everything affinizes in ONE batched pass.

    The S pair rides INSIDE the batched Miller loop (bilinearity: after
    the shared final exponentiation, e(sum_j S_j, -G2) ==
    prod_j e(S_j, -G2), so per-shard/per-chunk S rows compose across
    shards by Fq12 product alone — no G1 collective), and no batch-1
    Miller program exists anywhere (a batch-1 Miller loop costs as many
    launches as a full-width one).
    """
    wh, ws = _apply_weights(hx, hy, sx, sy, w, nbits)
    s_sum = _g1_tree_sum(ws)

    p_all = J.JPoint(
        _el_append(wh.x, s_sum.x),
        _el_append(wh.y, s_sum.y),
        _el_append(wh.z, s_sum.z),
    )
    px, py, inf = DG1.to_affine(p_all)

    ngx, ngy = _neg_g2_one((1,))
    qx = T.Fq2(_el_append(pqx.c0, ngx.c0), _el_append(pqx.c1, ngx.c1))
    qy = T.Fq2(_el_append(pqy.c0, ngy.c0), _el_append(pqy.c1, ngy.c1))
    return px, py, qx, qy, inf


def _miller_reduce(px, py, qx, qy, inf):
    """Stage B: batched Miller loop + Fq12 product -> scalar Fq12.

    The inf mask makes an identity row (e.g. S = O for a cancelling
    batch) contribute 1, matching e(O, Q) == 1.
    """
    f = M.miller_loop(px, py, qx, qy, inf_mask=inf)
    return T.fq12_retag(DP.fq12_reduce_mul(f, axis=0))


def _fused_local_product(hx, hy, sx, sy, pqx, pqy, w, nbits: int):
    """Stages A+B in one traced program (the shard_map / monolithic
    form). Returns a SCALAR (batch-()) Fq12; combine across shards or
    chunks by fq12_mul, then ONE final_exp + is_one."""
    return _miller_reduce(
        *_fused_points(hx, hy, sx, sy, pqx, pqy, w, nbits)
    )


_fused_points_jit = jax.jit(
    lambda *args, nbits: _fused_points(*args, nbits),
    static_argnames=("nbits",),
)
_miller_reduce_jit = jax.jit(_miller_reduce)


def verify_batch_fused(hx, hy, sx, sy, pqx, pqy, weights,
                       nbits: int | None = None) -> jnp.ndarray:
    """Fused check: prod_i e([w_i]H_i, pk_i) * e(S, -G2) == 1 where
    S = sum_i [w_i]sig_i. Returns a scalar bool.

    weights: GlvWeights / list of ints / (18, B) El limb tensor (see
    `_resolve_weights` for the validation contract).
    One shared final exponentiation for the whole batch.
    """
    w, nb = _resolve_weights(weights, nbits)
    f_red = _fused_local_product(hx, hy, sx, sy, pqx, pqy, w, nb)
    return T.fq12_is_one(FE.final_exp(f_red))


def _weight_and_sum(hx, hy, sx, sy, w, nbits=256):
    """Weight ladders + signature tree-sum + affinization (kept as the
    profiling/testing surface for the weighting stage; the production
    pipeline runs `_fused_local_product`, which keeps the S row batched
    through the Miller loop instead)."""
    wh, ws = _apply_weights(hx, hy, sx, sy, w, nbits)
    s_sum = _g1_tree_sum(ws)
    whx, why, _ = DG1.to_affine(wh)
    ssx, ssy, _ = DG1.to_affine(s_sum)
    return whx, why, ssx, ssy


_weight_jit = jax.jit(_weight_and_sum, static_argnames=("nbits",))


def verify_batch_fused_staged(hx, hy, sx, sy, pqx, pqy, weights,
                              nbits: int | None = None):
    """Staged-pipeline variant of `verify_batch_fused`."""
    from ..pairing.pairing import _is_one_jit

    w, nb = _resolve_weights(weights, nbits)
    pts = _fused_points_jit(hx, hy, sx, sy, pqx, pqy, w, nbits=nb)
    f_red = _miller_reduce_jit(*pts)
    return _is_one_jit(FE.final_exp_staged(f_red))


def _slice_batch(x, sl: slice):
    """Slice the trailing batch dim of an El / Fq2 / GlvWeights tree."""
    if isinstance(x, GLV.GlvWeights):
        return GLV.GlvWeights(
            _slice_batch(x.a, sl), _slice_batch(x.b, sl), x.bits
        )
    return jax.tree_util.tree_map(lambda a: a[..., sl], x)


def verify_batch_fused_chunked(hx, hy, sx, sy, pqx, pqy, weights,
                               chunk: int, nbits: int | None = None):
    """`verify_batch_fused` for batches too large for one program
    (BASELINE config 5 at batch-1M on a single chip).

    The fused check's reduction is a MONOID (the Fq12 Miller-product;
    each chunk's signature-sum pair rides inside its own Miller batch —
    see `_fused_points`), so the batch streams through in `chunk`-sized
    pieces: every chunk runs the same compiled stage programs and a
    single O(1)-state Fq12 accumulator combines chunks. ONE shared
    final exponentiation at the end, identical accept/reject semantics
    to the unchunked check.

    Peak memory is O(chunk), so batch size is bounded by input HBM
    (~1 GB per million tuples), not by pipeline intermediates.
    """
    from ..pairing.pairing import _is_one_jit

    w, nb = _resolve_weights(weights, nbits)
    B = hx.batch_shape[-1]
    if B % chunk != 0:
        raise InvalidLengthError(
            f"batch {B} must be a multiple of chunk {chunk}"
        )

    f_acc = None
    for off in range(0, B, chunk):
        sl = slice(off, off + chunk)
        pts = _fused_points_jit(
            _slice_batch(hx, sl),
            _slice_batch(hy, sl),
            _slice_batch(sx, sl),
            _slice_batch(sy, sl),
            _slice_batch(pqx, sl),
            _slice_batch(pqy, sl),
            _slice_batch(w, sl),
            nbits=nb,
        )
        f_c = _miller_reduce_jit(*pts)
        f_acc = f_c if f_acc is None else _chunk_combine_jit(f_acc, f_c)

    return _is_one_jit(FE.final_exp_staged(f_acc))


_chunk_combine_jit = jax.jit(
    lambda f_acc, f_c: T.fq12_retag(T.fq12_mul(f_acc, f_c))
)


def _g1_tree_sum(p: J.JPoint, axis: int = 0) -> J.JPoint:
    """Tree-sum a batched Jacobian G1 point along a batch axis."""
    taxis = axis + 1

    def take(x, sl):
        idx = (slice(None),) * taxis + (sl,)
        return x[idx]

    def cat_els(a, b):
        """El-aware concat (merged bounds) — plain tree_map rejects
        trees whose El aux tags differ (sum outputs vs leftover slices
        at odd widths)."""
        if isinstance(a, L.El):
            return L.El(
                jnp.concatenate([a.arr, b.arr], axis=taxis),
                max(a.vmax, b.vmax),
                max(a.lmax, b.lmax),
            )
        return type(a)(*[cat_els(x, y) for x, y in zip(a, b)])

    n = p.x.arr.shape[taxis]
    while n > 1:
        half = n // 2
        lo = jax.tree_util.tree_map(lambda x: take(x, slice(0, half)), p)
        hi = jax.tree_util.tree_map(lambda x: take(x, slice(half, 2 * half)), p)
        s = DG1.add(lo, hi)
        if n % 2:
            rest = jax.tree_util.tree_map(lambda x: take(x, slice(2 * half, n)), p)
            s = cat_els(s, rest)
            n = half + 1
        else:
            n = half
        p = s
    return jax.tree_util.tree_map(lambda x: jnp.squeeze(x, axis=taxis), p)


class AdaptiveResult:
    """Deferred result of `verify_batch_adaptive(defer=True)` — created
    WITHOUT any host synchronisation, so a caller streaming batches can
    enqueue the next batch's pipeline before this one's pre-check bit
    crosses the device->host link; the readback then overlaps device
    compute instead of stalling it.

    per_tuple: device (B,) bool array — the pre-check bit broadcast
      batch-wide on DEVICE. For a batch that passes the pre-check this
      IS the final answer (all True); no readback was needed to make it.
    resolve(): host-syncs the pre-check bit; on rejection runs the exact
      independent fallback and returns its per-tuple bools instead.
      `np.asarray(result)` is equivalent.
    """

    def __init__(self, per_tuple, ok, fallback):
        self.per_tuple = per_tuple
        self._ok = ok
        self._fallback = fallback
        self._resolved = None

    def resolve(self):
        if self._resolved is None:
            if bool(jax.device_get(self._ok)):
                self._resolved = self.per_tuple
            else:
                self._resolved = self._fallback()
        return self._resolved

    def __array__(self, dtype=None, copy=None):
        import numpy as np

        a = np.asarray(jax.device_get(self.resolve()))
        return a if dtype is None else a.astype(dtype)


_bcast_ok_jit = jax.jit(
    lambda ok, n: jnp.broadcast_to(ok, (n,)), static_argnames=("n",)
)


def verify_batch_adaptive(hx, hy, sx, sy, pqx, pqy,
                          weights=None, nbits: int | None = None,
                          defer: bool = False):
    """Per-tuple results at fused-tier cost for the common all-valid
    case: run the fused RLC check first (ONE shared final exp); if it
    accepts, every tuple is valid (up to the 2^-rlc_bits RLC soundness
    bound) and the per-tuple final exponentiations are skipped entirely.
    On rejection, fall back to the exact independent tier to report
    WHICH tuples failed.

    Semantics vs `verify_batch_independent`: identical outputs except
    that a forged batch passes the RLC pre-check (and returns all-True)
    with probability ~2^-rlc_bits over the weight draw — the same bound
    the fused/sharded tiers carry.

    weights=None draws fresh ones per config.DEFAULT.glv_weights (GLV
    Shamir form, or plain ints under BN254_DISABLE_GLV).

    defer=False (default): returns a (B,) bool array (host-syncs once on
    the pre-check bit to decide whether the fallback is needed).
    defer=True: returns an `AdaptiveResult` immediately — the per-tuple
    answer is materialised on DEVICE (pre-check bit broadcast) and the
    decision readback rides asynchronously, so back-to-back batches
    pipeline without a mid-path stall; call .resolve() (or np.asarray)
    for the final bools.
    """
    B = hx.batch_shape[-1]
    if weights is None:
        from .. import config as C

        if C.DEFAULT.glv_weights:
            weights = random_weights(B, nbits)
        else:
            weights = random_weights_plain(B, nbits)
    ok = verify_batch_fused_staged(hx, hy, sx, sy, pqx, pqy, weights,
                                   nbits=nbits)
    per_tuple = _bcast_ok_jit(ok, B)
    try:  # start the decision readback without blocking on it
        ok.copy_to_host_async()
    except Exception:
        pass
    res = AdaptiveResult(
        per_tuple,
        ok,
        lambda: verify_batch_independent_staged(hx, hy, sx, sy, pqx, pqy),
    )
    return res if defer else res.resolve()


# ---------------------------------------------------------------------------
# Tier 3: mesh-sharded fused verification
# ---------------------------------------------------------------------------


def make_sharded_verifier(
    mesh: Mesh,
    axis_name: str = "batch",
    monolithic: bool = False,
    nbits: int | None = None,
):
    """Build an SPMD fused verifier over `mesh`'s `axis_name` axis.

    Full data-parallel pipeline:
      1. weight application: [w_i]H_i and [w_i]sig_i (local GLV ladders)
      2. local Miller loops over the shard's tuples, WITH the shard's
         weighted-signature-sum pair e(S_shard, -G2::one) as an extra
         row (bilinearity makes per-shard S rows compose by product —
         no G1 collective needed; see `_fused_points`)
      3. shard-local Fq12 tree product
      4. cross-chip Fq12 product all-reduce — the ONLY
         collective
      5. ONE shared final exponentiation on the replicated reduction.

    By default the pipeline is compiled as THREE programs — (1-3) local
    shard_map, (4-5) collective shard_map, (6) replicated staged final —
    because separately compiled stages keep each XLA program small (and
    the same stage programs serve the one-card tiers).
    `monolithic=True` builds the single-program variant (everything,
    collectives included, in one shard_map jit).

    Returns run(hx..sy, pqx, pqy, weights) -> scalar bool: call with
    full-batch device tensors whose trailing batch dim divides the axis
    size. Weights may be a GlvWeights (its own width), an El limb
    tensor, or a list of ints (validated against `nbits`, which defaults
    to config.rlc_bits at build time).
    """
    if nbits is None:
        from .. import config as C

        nbits = min(int(C.DEFAULT.rlc_bits), 256)
    n_dev = mesh.shape[axis_name]
    batch_spec = PSpec(None, axis_name)  # (18, B): shard the batch dim
    rep = PSpec()

    if monolithic:

        def shard_fn(hx, hy, sx, sy, pqx, pqy, w):
            f_local = _fused_local_product(
                hx, hy, sx, sy, pqx, pqy, w, nbits
            )
            f_all = COLL.fq12_allreduce_mul(f_local, axis_name, n_dev)
            return T.fq12_is_one(FE.final_exp(f_all))

        sharded = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(batch_spec,) * 7,
                out_specs=rep,
                check_vma=False,
            )
        )

        def run_mono(hx, hy, sx, sy, pqx, pqy, weights):
            w, _ = _resolve_weights(weights, nbits)
            if hx.batch_shape[-1] % n_dev != 0:
                raise InvalidLengthError(
                    f"batch {hx.batch_shape[-1]} must divide the mesh "
                    f"axis size {n_dev}"
                )
            hx, hy, sx, sy, pqx, pqy, w = MESH.shard_tree(
                (hx, hy, sx, sy, pqx, pqy, w), mesh, axis_name
            )
            return sharded(hx, hy, sx, sy, pqx, pqy, w)

        return run_mono

    # ---- staged pipeline ----

    def local_fn(hx, hy, sx, sy, pqx, pqy, w):
        f_local = _fused_local_product(hx, hy, sx, sy, pqx, pqy, w, nbits)
        # re-expose per-shard scalars as a size-1 batch dim so the stage
        # boundary is an ordinary sharded global array of size n_dev
        return jax.tree_util.tree_map(lambda x: x[..., None], f_local)

    local_jit = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(batch_spec,) * 7,
            out_specs=batch_spec,
            check_vma=False,
        )
    )

    def reduce_fn(f_local):
        f_local = jax.tree_util.tree_map(lambda x: x[..., 0], f_local)
        f_all = COLL.fq12_allreduce_mul(f_local, axis_name, n_dev)
        return T.fq12_retag(f_all)

    reduce_jit = jax.jit(
        jax.shard_map(
            reduce_fn,
            mesh=mesh,
            in_specs=(batch_spec,),
            out_specs=rep,
            check_vma=False,
        )
    )

    def run(hx, hy, sx, sy, pqx, pqy, weights, chunk: int | None = None):
        """hx..sy: limbs.El (18, B); pqx/pqy: tower.Fq2 of El; weights:
        GlvWeights, PlainWeights, or a list of ints. Returns a scalar
        bool.

        chunk: stream the batch through the mesh in `chunk`-sized pieces
        — the full BASELINE config-5 structure (large batch x mesh) with
        peak memory O(chunk) instead of O(B). Each piece runs only the
        SHARD-LOCAL stage; pieces combine into a per-shard Fq12
        accumulator ELEMENTWISE (sharded, no communication), so the
        cross-chip/cross-host product all-reduce runs exactly ONCE per
        job, after the last chunk, followed by ONE shared final
        exponentiation. Collective cost therefore amortizes over the
        whole stream. chunk=None runs the one-shot form.
        """
        from ..pairing.pairing import _is_one_jit

        B = hx.batch_shape[-1]
        if B % n_dev != 0:
            raise InvalidLengthError(
                f"batch {B} must divide the mesh axis size {n_dev}"
            )
        w, _ = _resolve_weights(weights, nbits)
        if chunk is None:
            chunks = [(hx, hy, sx, sy, pqx, pqy, w)]
        else:
            if B % chunk != 0 or chunk % n_dev != 0:
                raise InvalidLengthError(
                    f"batch {B} must be a multiple of chunk {chunk}, "
                    f"which must divide the mesh axis size {n_dev}"
                )
            chunks = [
                tuple(
                    _slice_batch(x, slice(off, off + chunk))
                    for x in (hx, hy, sx, sy, pqx, pqy, w)
                )
                for off in range(0, B, chunk)
            ]
        f_acc = None
        for piece in chunks:
            # place inputs as GLOBAL batch-sharded arrays: required for
            # multi-process (every process passes the same full-batch
            # host values), a cheap no-op resharding hint otherwise
            piece = MESH.shard_tree(piece, mesh, axis_name)
            f_local = local_jit(*piece)
            # per-shard (axis-sharded) accumulator: elementwise Fq12
            # mul, identical shardings in and out -> zero communication
            f_acc = (
                f_local if f_acc is None
                else _chunk_combine_jit(f_acc, f_local)
            )
        f_all = reduce_jit(f_acc)  # the ONLY collective, once per job
        return _is_one_jit(FE.final_exp_staged(f_all))

    return run
