"""Lane-packed 256-bit lazy Montgomery limb engine.

The device replacement for the reference dependency's `arith::U256` /
Montgomery field core (SURVEY.md §2.3). Field elements are little-endian
**15-bit limbs in uint32 tensors of shape (18, *batch)** with Montgomery
radix R = 2^270.

Why this layout:

* **Redundancy buys laziness.** 15-bit limbs in 32-bit lanes leave one
  bit of limb headroom and ~14 bits of value headroom (values stay below
  ~2^258, capacity is 2^270). Consequences:
    - **Addition is ONE vector op** (limb-wise add, no carry, no
      conditional subtract).
    - **Subtraction is one signed carry chain** plus a static
      multiple-of-p offset — no conditional subtracts.
    - **REDC needs no final conditional subtract**, and no value
      reduction appears anywhere in the hot path; canonicalisation
      happens only at codec/compare boundaries.
  Every limb product a_i * b_j is exact in a uint32 lane, so the whole
  engine is exact integer arithmetic: results are bit-identical on every
  backend.
* **Exact static bound tracking.** Every element (`El`) carries its
  exact value bound and limb bound as *static* pytree metadata; overflow
  is a Python assertion at trace time, costing nothing at runtime.
  `mont_mul` auto-normalises limb-lazy inputs with a single carry chain
  over the stacked operand.
* **One form on every backend**: every carry chain and the CIOS multiply
  are `lax.scan`s over the limb axis — tiny loop bodies, so compile time
  stays bounded. (Straight-line unrolled forms took XLA:GPU ~10 s of
  compile per unrolled multiply on an H100 and over 200 s for two Fq12
  multiplies, and were removed; PERF.md, H100 bring-up.)
* **Limbs lead, batch trails**: elementwise ops map the batch onto the
  device's parallel lanes and the limb axis onto separate values.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    LIMB_BITS,
    LIMB_MASK,
    MONT_NEG_P_INV,
    MONT_R,
    MONT_R2_MOD_P,
    MONT_R_MOD_P,
    NLIMBS,
    P,
    from_limbs,
    to_limbs,
)

U32 = jnp.uint32
I32 = jnp.int32
MASK = np.uint32(LIMB_MASK)
CAPACITY = 1 << (LIMB_BITS * NLIMBS)  # 2^270
_PROD_LIMIT = 1 << 32  # a_i * b_j must stay below this (uint32 exact)
_COL_LIMIT = 1 << 26  # column values entering a carry chain
# T = a*b + m*p must fit 2*NLIMBS limbs (2^540) with margin
_T_LIMIT = 1 << 538

# standard carrier bound used to stabilise scan carriers (see retag):
# tower-op outputs on STD-bound inputs stay below ~2^263.5 (the worst
# chain is mul-out -> xi-mul (x9 + sub offset) -> adds), so 2^264 is a
# stable fixed point.
STD_BOUND = 1 << 262


# ---------------------------------------------------------------------------
# Element type: array + static exact bounds
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class El:
    """A (batched) bigint in limb form with static bounds.

    arr: (NLIMBS, *batch) uint32 limbs, little-endian, radix 2^15.
    vmax: exclusive upper bound on the represented value (exact int).
    lmax: exclusive upper bound on every limb (exact int).
    """

    arr: jnp.ndarray
    vmax: int
    lmax: int

    def tree_flatten(self):
        return (self.arr,), (self.vmax, self.lmax)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    @property
    def batch_shape(self):
        return self.arr.shape[1:]


def retag(a: El, vmax: int, lmax: int | None = None) -> El:
    """Coerce bounds UP (for scan-carrier stability). Asserts validity."""
    lm = lmax if lmax is not None else a.lmax
    assert a.vmax <= vmax and a.lmax <= lm, (a.vmax, vmax, a.lmax, lm)
    return El(a.arr, vmax, lm)


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def from_ints(values, vmax: int | None = None) -> El:
    """Python ints (scalar or nested lists) -> normalised El."""
    arr = np.array(values, dtype=object)
    out = np.zeros((NLIMBS,) + arr.shape, dtype=np.uint32)
    flat = arr.reshape(-1)
    oflat = out.reshape(NLIMBS, -1)
    mx = 0
    for j in range(flat.shape[0]):
        v = int(flat[j])
        mx = max(mx, v)
        for i in range(NLIMBS):
            oflat[i, j] = (v >> (LIMB_BITS * i)) & LIMB_MASK
    bound = vmax if vmax is not None else mx + 1
    assert bound <= CAPACITY
    return El(jnp.asarray(out), bound, 1 << LIMB_BITS)


def to_ints(a) -> np.ndarray:
    """El or raw (NLIMBS, *batch) limbs -> object ndarray of ints."""
    host = np.asarray(a.arr if isinstance(a, El) else a).astype(object)
    weights = np.array([1 << (LIMB_BITS * i) for i in range(host.shape[0])],
                       dtype=object)
    return np.tensordot(weights, host, axes=(0, 0))


def to_int(a) -> int:
    return int(to_ints(a).reshape(-1)[0])


def const_el(x: int) -> El:
    """Compile-time constant -> (NLIMBS,) El (canonical limbs).

    The array is a NumPy ndarray, not a device array, so XLA folds it
    into the programs that use it."""
    return El(np.array(to_limbs(x, NLIMBS), dtype=np.uint32), x + 1,
              1 << LIMB_BITS)


def _bc(x: jnp.ndarray, ndim: int) -> jnp.ndarray:
    """Append singleton batch dims so (18, ...) broadcasts against rank ndim."""
    if x.ndim < ndim:
        return x.reshape(x.shape + (1,) * (ndim - x.ndim))
    return x


def _bc2(a: jnp.ndarray, b: jnp.ndarray):
    nd = max(a.ndim, b.ndim)
    return _bc(a, nd), _bc(b, nd)


# ---------------------------------------------------------------------------
# Carry chains (lax.scan over the limb axis)
# ---------------------------------------------------------------------------


def _pad_cols(cols: jnp.ndarray, out_len: int) -> jnp.ndarray:
    k = cols.shape[0]
    if out_len > k:
        pad = jnp.zeros((out_len - k,) + cols.shape[1:], cols.dtype)
        cols = jnp.concatenate([cols, pad], axis=0)
    return cols[:out_len]


def _carry_u_step(c, col):
    t = col + c
    return t >> LIMB_BITS, t & MASK


def _carry_s_step(c, col):
    t = col + c
    return t >> LIMB_BITS, (t & I32(LIMB_MASK)).astype(U32)


# Module-level jits so EAGER calls (stage boundaries, codecs) hit one
# cached executable per shape instead of re-tracing + re-compiling a
# fresh scan closure on every call.
@jax.jit
def _carry_u_scan(cols: jnp.ndarray) -> jnp.ndarray:
    _, limbs = jax.lax.scan(
        _carry_u_step, jnp.zeros(cols.shape[1:], U32), cols
    )
    return limbs


@jax.jit
def _carry_s_scan(cols: jnp.ndarray) -> jnp.ndarray:
    _, limbs = jax.lax.scan(
        _carry_s_step, jnp.zeros(cols.shape[1:], I32), cols
    )
    return limbs


def _carry_u(cols: jnp.ndarray, out_len: int, col_max: int) -> jnp.ndarray:
    """Unsigned carry propagation: (K, *b) columns -> (out_len, *b) limbs."""
    assert col_max < 1 << 31
    cols = _pad_cols(cols, out_len)
    return _carry_u_scan(cols)


def _carry_s(cols: jnp.ndarray, out_len: int) -> jnp.ndarray:
    """Signed carry propagation for int32 columns (arithmetic shifts
    propagate negative carries); total value must be non-negative."""
    cols = _pad_cols(cols.astype(I32), out_len)
    return _carry_s_scan(cols)


def norm_limbs(a: El) -> El:
    """Carry-normalise limbs to < 2^15 (value unchanged; must fit capacity)."""
    if a.lmax <= (1 << LIMB_BITS):
        return a
    assert a.vmax <= CAPACITY and a.lmax <= _COL_LIMIT
    return El(_carry_u(a.arr, NLIMBS, a.lmax), a.vmax, 1 << LIMB_BITS)


# ---------------------------------------------------------------------------
# Lazy add / offset sub / small-constant mul
# ---------------------------------------------------------------------------


def add_mod(a: El, b: El) -> El:
    """Lazy modular add: one vector op. Limbs and value bounds sum."""
    aa, ba = _bc2(a.arr, b.arr)
    out = El(aa + ba, a.vmax + b.vmax, a.lmax + b.lmax)
    assert out.lmax <= _COL_LIMIT and out.vmax <= CAPACITY
    return out


def double_mod(a: El) -> El:
    return add_mod(a, a)


def _sub_offset(bound: int) -> tuple[int, El]:
    """Smallest multiple of p >= bound (static, exact — overshoot < p)."""
    k = -(-bound // P)
    c = k * P
    return c, const_el(c)


def sub_mod(a: El, b: El) -> El:
    """a - b + 2^j p (signed carry chain; output limb-normalised)."""
    c_val, c_el = _sub_offset(b.vmax)
    assert a.lmax + (1 << LIMB_BITS) + b.lmax < (1 << 31)
    aa, ba = _bc2(a.arr, b.arr)
    out_v = a.vmax + c_val
    assert out_v <= CAPACITY
    ca = _bc(c_el.arr, max(aa.ndim, ba.ndim))
    cols = aa.astype(I32) + ca.astype(I32) - ba.astype(I32)
    return El(_carry_s(cols, NLIMBS), out_v, 1 << LIMB_BITS)


def neg_mod(a: El) -> El:
    """(2^j p) - a."""
    c_val, c_el = _sub_offset(a.vmax)
    ca = _bc(c_el.arr, a.arr.ndim)
    cols = ca.astype(I32) - a.arr.astype(I32)
    return El(_carry_s(cols, NLIMBS), c_val + 1, 1 << LIMB_BITS)


def mul_small(a: El, k: int) -> El:
    """a * k for a small positive constant (carry-normalised output)."""
    assert 0 < k and a.lmax * k < _COL_LIMIT
    out_v = a.vmax * k
    assert out_v <= CAPACITY
    return El(_carry_u(a.arr * U32(k), NLIMBS, a.lmax * k), out_v, 1 << LIMB_BITS)


# ---------------------------------------------------------------------------
# Montgomery multiplication (radix 2^270)
# ---------------------------------------------------------------------------

P_EL = const_el(P)
PINV_EL = const_el(MONT_NEG_P_INV)
R_MOD_P_EL = const_el(MONT_R_MOD_P)
R2_EL = const_el(MONT_R2_MOD_P)
ONE_EL = const_el(1)


# -p^{-1} mod 2^15 for the per-limb CIOS reduction digit
PINV0 = np.uint32((-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS))


def mont_mul(a: El, b: El) -> El:
    """REDC(a*b) with R = 2^270, interleaved CIOS as a scan over a's limbs.

    Per scan step: T += a_i * b; m_i = -T[0]/p mod 2^15; T += m_i * p;
    T >>= one limb. After 18 steps T = (a*b + m*p) / R. Column values
    stay below 2^22 (lazy accumulation, no per-step carries); one final
    carry chain normalises the limbs. No conditional subtraction.

    Inputs may be limb-lazy (limbs < 2^16 used directly; lazier inputs
    are carry-normalised first) and value-lazy (values < ~2^262).
    Output: limbs < 2^15, value < a.vmax*b.vmax/R + p — in practice
    < 2^258 for all closed-loop uses.
    """
    if a.lmax * b.lmax > _PROD_LIMIT:
        a = norm_limbs(a)
        if a.lmax * b.lmax > _PROD_LIMIT:
            b = norm_limbs(b)
    assert a.lmax * b.lmax <= _PROD_LIMIT
    assert a.vmax * b.vmax + MONT_R * P <= _T_LIMIT

    out_v = a.vmax * b.vmax // MONT_R + P + 1
    assert out_v <= CAPACITY

    aa, bb = _bc2(a.arr, b.arr)

    return El(_mont_mul_scan(aa, bb), out_v, 1 << LIMB_BITS)


# Module-level jit for the same reason as _carry_u_scan: EAGER mont_mul
# calls (stage boundaries, codecs, tests, host-side tooling) would
# otherwise re-trace + re-XLA-compile a fresh scan closure per call —
# each eager call paid a full compile, making eager field code ~100x
# slower than the math itself.
@jax.jit
def _mont_mul_scan(aa: jnp.ndarray, bb: jnp.ndarray) -> jnp.ndarray:
    shape = jnp.broadcast_shapes(aa.shape, bb.shape)
    batch = shape[1:]
    aa = jnp.broadcast_to(aa, shape)
    bb = jnp.broadcast_to(bb, shape)
    p_arr = _bc(P_EL.arr, 1 + len(batch))

    t0 = jnp.zeros((NLIMBS + 1,) + batch, U32)
    zrow = jnp.zeros((1,) + batch, U32)

    def step(t, a_i):
        prod = a_i[None] * bb  # (18, *batch), exact in uint32
        t = t.at[:NLIMBS].add(prod & MASK)
        t = t.at[1 : NLIMBS + 1].add(prod >> LIMB_BITS)
        m_i = (t[0] * PINV0) & MASK  # (*batch,)
        prod2 = m_i[None] * p_arr
        t = t.at[:NLIMBS].add(prod2 & MASK)
        t = t.at[1 : NLIMBS + 1].add(prod2 >> LIMB_BITS)
        carry0 = t[0] >> LIMB_BITS  # t[0] & MASK == 0 by construction
        t = jnp.concatenate([t[1:], zrow], axis=0)
        t = t.at[0].add(carry0)
        return t, None

    t, _ = jax.lax.scan(step, t0, aa)
    return _carry_u(t, NLIMBS, _COL_LIMIT)


def mont_sqr(a: El) -> El:
    return mont_mul(a, a)


# threshold above which tower ops squeeze values back down (see vreduce)
VREDUCE_THRESHOLD = 1 << 261


def vreduce(a: El) -> El:
    """Crush the value bound to ~p without changing the residue.

    mont_mul by the plain constant (R mod p) maps stored value s to
    s * (R mod p) / R ≡ s (mod p), with output bound vmax*p/R + p ≈ p.
    One leaf multiplication; tower ops apply it only when static bounds
    exceed VREDUCE_THRESHOLD (the xi-multiplication inflation points), so
    it costs nothing on the common path.
    """
    return mont_mul(a, R_MOD_P_EL)


def maybe_vreduce(a: El, threshold: int = VREDUCE_THRESHOLD) -> El:
    return vreduce(a) if a.vmax > threshold else a


# ---------------------------------------------------------------------------
# Canonicalisation, comparison, selection
# ---------------------------------------------------------------------------


def cond_sub(a: El, m: int, m_el: El | None = None) -> El:
    """a - m if a >= m else a (m a static int). Requires normalised limbs."""
    a = norm_limbs(a)
    me = m_el if m_el is not None else const_el(m)
    out_v = min(a.vmax, max(m, a.vmax - m))

    ma = jnp.broadcast_to(_bc(me.arr, a.arr.ndim), a.arr.shape)
    return El(_cond_sub_scan(a.arr, ma), out_v, 1 << LIMB_BITS)


@jax.jit  # module-level: eager calls (canon ladders) hit one executable
def _cond_sub_scan(arr: jnp.ndarray, ma: jnp.ndarray) -> jnp.ndarray:
    def step(borrow, pair):
        av, mv = pair
        t = av + U32(1 << LIMB_BITS) - mv - borrow
        return U32(1) - (t >> LIMB_BITS), t & MASK

    borrow, diff = jax.lax.scan(
        step, jnp.zeros(arr.shape[1:], U32), (arr, ma)
    )
    keep = (borrow != 0)[None]  # borrow -> a < m -> keep a
    return jnp.where(keep, arr, diff)


def canon(a: El) -> El:
    """Full reduction to the canonical representative < p.

    Binary conditional-subtract ladder: ceil(log2(vmax/p)) rounds, each
    halving the bound. Boundary-only cost (codecs, comparisons)."""
    a = norm_limbs(a)
    j = 0
    while (P << j) < a.vmax:
        j += 1
    for jj in range(j - 1, -1, -1):
        a = cond_sub(a, P << jj)
    return El(a.arr, P, a.lmax)


def lt_const(a: El, m: int) -> jnp.ndarray:
    """a < m (batch bool)."""
    a = norm_limbs(a)

    me = jnp.broadcast_to(_bc(const_el(m).arr, a.arr.ndim), a.arr.shape)
    return _lt_scan(a.arr, me)


@jax.jit  # module-level: eager calls hit one cached executable per shape
def _lt_scan(arr: jnp.ndarray, me: jnp.ndarray) -> jnp.ndarray:
    def step(borrow, pair):
        av, mv = pair
        t = av + U32(1 << LIMB_BITS) - mv - borrow
        return U32(1) - (t >> LIMB_BITS), None

    borrow, _ = jax.lax.scan(
        step, jnp.zeros(arr.shape[1:], U32), (arr, me)
    )
    return borrow != 0


def eq(a: El, b: El) -> jnp.ndarray:
    ca, cb = canon(a).arr, canon(b).arr
    ca, cb = _bc2(ca, cb)
    return jnp.all(ca == cb, axis=0)


def is_zero(a: El) -> jnp.ndarray:
    return jnp.all(canon(a).arr == 0, axis=0)


def select(mask: jnp.ndarray, t: El, f: El) -> El:
    ta, fa = _bc2(t.arr, f.arr)
    return El(jnp.where(mask[None], ta, fa), max(t.vmax, f.vmax),
              max(t.lmax, f.lmax))


# ---------------------------------------------------------------------------
# Montgomery domain conversion, powers
# ---------------------------------------------------------------------------


def to_mont(x: El) -> El:
    """Canonical x -> Montgomery form xR mod p (+ small multiple of p)."""
    return mont_mul(x, R2_EL)


def from_mont(a: El) -> El:
    """Montgomery form -> canonical value < p."""
    return canon(mont_mul(a, ONE_EL))


def mont_one(batch_shape=()) -> El:
    arr = jnp.broadcast_to(
        _bc(R_MOD_P_EL.arr, 1 + len(batch_shape)),
        (NLIMBS,) + tuple(batch_shape),
    )
    return El(arr, MONT_R_MOD_P + 1, 1 << LIMB_BITS)


def mont_zero(batch_shape=()) -> El:
    return El(jnp.zeros((NLIMBS,) + tuple(batch_shape), U32), 1, 1 << LIMB_BITS)


def bcast_to(a: El, batch_shape) -> El:
    arr = jnp.broadcast_to(
        _bc(a.arr, 1 + len(batch_shape)), (NLIMBS,) + tuple(batch_shape)
    )
    return El(arr, a.vmax, a.lmax)


def stack(els, axis: int = 1) -> El:
    """Stack elements along a new batch axis (default: first batch dim)."""
    shapes = jnp.broadcast_shapes(*[e.arr.shape for e in els])
    arrs = [jnp.broadcast_to(e.arr, shapes) for e in els]
    return El(
        jnp.stack(arrs, axis=axis),
        max(e.vmax for e in els),
        max(e.lmax for e in els),
    )


def unstack(a: El, n: int, axis: int = 1):
    idx = [slice(None)] * a.arr.ndim
    outs = []
    for i in range(n):
        idx[axis] = i
        outs.append(El(a.arr[tuple(idx)], a.vmax, a.lmax))
    return outs


def elmap(fn, a: El, vmax: int | None = None, lmax: int | None = None) -> El:
    """Apply an array-level transform (reshape/index/broadcast) to an El."""
    return El(fn(a.arr), vmax or a.vmax, lmax or a.lmax)


def pow_fixed(a: El, exponent: int) -> El:
    """a^exponent (Montgomery domain), compile-time exponent.

    A `lax.scan` over the exponent's bits with a masked multiply.
    """
    if exponent == 0:
        return mont_one(a.batch_shape)
    base = retag(norm_limbs(a), STD_BOUND)
    bits = [int(c) for c in bin(exponent)[2:]]
    bits_arr = jnp.array(bits[1:], dtype=jnp.uint32)

    def step(res, bit):
        res = mont_sqr(res)
        res = select(bit != 0, mont_mul(res, base), res)
        return retag(res, STD_BOUND), None

    result, _ = jax.lax.scan(step, base, bits_arr)
    return result


def inv_mod(a: El) -> El:
    """a^{-1} in the Montgomery domain (Fermat)."""
    return pow_fixed(a, P - 2)


def sqrt_candidate(a: El) -> El:
    """a^((p+1)/4) — the square root if a is a QR (p ≡ 3 mod 4)."""
    return pow_fixed(a, (P + 1) // 4)
