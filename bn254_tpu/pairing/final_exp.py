"""Device final exponentiation f^((p^12-1)/r) for BN254.

Easy part (p^6-1)(p^2+1) followed by the Devegili-style hard-part chain
(validated bit-for-bit against the canonical generic pow by the host
oracle's `structured_final_exp`; the final-exp exponent is canonical so
all correct algorithms agree).

Two entry points:
  * `final_exp(f)` — monolithic, for use inside a single traced program
    (e.g. the shard_map'd multi-chip step).
  * `final_exp_staged(f)` — the same math as a pipeline of separately
    jitted stages: easy part, one shared `exp_u` compilation reused for
    all three u-exponentiations, and the combination chain. XLA compile
    time for this workload is superlinear in program size, so staging
    compiles several small programs instead of one huge one.

u-exponentiations run as `lax.scan`s over the fixed 63-bit pattern of
u = 4965661367192848881 with a masked multiply — constant schedule,
branch-free, batched.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import U
from ..fields import limbs as L
from ..fields import tower as T

Fq12 = T.Fq12

_U_BITS = [int(b) for b in bin(U)[2:]][1:]  # MSB consumed by init
assert len(_U_BITS) % 2 == 0  # 62 bits -> 31 two-bit windows
_U_WINDOWS = [
    2 * _U_BITS[i] + _U_BITS[i + 1] for i in range(0, len(_U_BITS), 2)
]


def exp_u(f: Fq12, window_digits=None) -> Fq12:
    """f^u for a CYCLOTOMIC f (all final-exp call sites qualify).

    2-bit windowed square-and-multiply over the fixed bits of u:
    31 scan steps of (2 Granger-Scott cyclotomic squarings + one
    table multiply), with the {1, f, f^2, f^3} table selected by the
    static window digits — half the leaf multiplications of the
    bit-serial masked form.

    window_digits: schedule override (tests run a truncated prefix).
    """
    f = T.fq12_retag(f)
    f2 = T.fq12_retag(T.fq12_cyc_sq(f))
    f3 = T.fq12_retag(T.fq12_mul(f2, f))
    one = T.fq12_retag(T.fq12_one(f.c0.c0.c0.batch_shape))
    windows = jnp.array(
        _U_WINDOWS if window_digits is None else window_digits,
        dtype=jnp.uint32,
    )

    def body(acc, w):
        acc = T.fq12_cyc_sq(acc)
        acc = T.fq12_cyc_sq(T.fq12_retag(acc))
        lo = T.fq12_select(w & 1 != 0, f, one)
        hi = T.fq12_select(w & 1 != 0, f3, f2)
        m = T.fq12_select(w >> 1 != 0, hi, lo)
        acc = T.fq12_mul(T.fq12_retag(acc), m)
        return T.fq12_retag(acc), None

    acc, _ = jax.lax.scan(body, f, windows)
    return acc


def easy_part(f: Fq12) -> Fq12:
    """f^((p^6-1)(p^2+1)) — lands in the cyclotomic subgroup."""
    f = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))  # f^(p^6-1)
    return T.fq12_mul(T.fq12_frob(f, 2), f)  # ^(p^2+1)


def hard_combine(f: Fq12, ft1: Fq12, ft2: Fq12, ft3: Fq12) -> Fq12:
    """Hard part (p^4-p^2+1)/r given f (cyclotomic) and its u-powers."""
    fp1 = T.fq12_frob(f, 1)
    fp2 = T.fq12_frob(f, 2)
    fp3 = T.fq12_frob(f, 3)
    y0 = T.fq12_mul(T.fq12_mul(fp1, fp2), fp3)
    y1 = T.fq12_conj(f)
    y2 = T.fq12_frob(ft2, 2)
    y3 = T.fq12_conj(T.fq12_frob(ft1, 1))
    y4 = T.fq12_conj(T.fq12_mul(ft1, T.fq12_frob(ft2, 1)))
    y5 = T.fq12_conj(ft2)
    y6 = T.fq12_conj(T.fq12_mul(ft3, T.fq12_frob(ft3, 1)))
    # every operand here is cyclotomic (f is an easy-part output and the
    # subgroup is closed under mul/conj/Frobenius) -> cyclotomic squares
    t0 = T.fq12_mul(T.fq12_mul(T.fq12_cyc_sq(y6), y4), y5)
    t1 = T.fq12_mul(T.fq12_mul(y3, y5), t0)
    t0 = T.fq12_mul(t0, y2)
    t1 = T.fq12_cyc_sq(T.fq12_mul(T.fq12_cyc_sq(T.fq12_retag(t1)), t0))
    return T.fq12_mul(
        T.fq12_mul(t1, y0), T.fq12_cyc_sq(T.fq12_mul(T.fq12_retag(t1), y1))
    )


def final_exp(f: Fq12) -> Fq12:
    """Monolithic final exponentiation (single traced program)."""
    f = easy_part(f)
    ft1 = exp_u(f)
    ft2 = exp_u(ft1)
    ft3 = exp_u(ft2)
    return hard_combine(f, ft1, ft2, ft3)


# ---------------------------------------------------------------------------
# staged variant: separate jit units, exp_u compiled once and reused 3x
# ---------------------------------------------------------------------------

# Each stage retags ITS OWN output inside the jit: stage boundaries are
# then metadata-only on the host (no eager norm_limbs — an eager carry
# chain used to re-trace + re-compile on every call, dominating runtime)
# and every call presents the same pytree signature (one cache entry).
def _max_vmax(a) -> int:
    """Largest El.vmax in a tower element (exact static bound)."""
    if isinstance(a, L.El):
        return a.vmax
    return max(_max_vmax(c) for c in a)


def _retag_tight(a: T.Fq12) -> T.Fq12:
    """Retag with the element's own exact bound instead of STD_BOUND.

    hard_combine's natural output bound (~2^258) is tighter than
    STD_BOUND (2^262); keeping it exact saves ~4 cond_sub rounds in every
    downstream canon/is_one. Deterministic given the (stable) input tags,
    so the jit cache signature is unaffected.
    """
    return T.fq12_retag(a, _max_vmax(a))


_easy_jit = jax.jit(lambda f: T.fq12_retag(easy_part(f)))
_exp_u_jit = jax.jit(lambda f: T.fq12_retag(exp_u(f)))
_hard_jit = jax.jit(
    lambda f, t1, t2, t3: _retag_tight(hard_combine(f, t1, t2, t3))
)


def final_exp_staged(f: Fq12) -> Fq12:
    f = _easy_jit(T.fq12_retag(f))
    ft1 = _exp_u_jit(f)
    ft2 = _exp_u_jit(ft1)
    ft3 = _exp_u_jit(ft2)
    return _hard_jit(f, ft1, ft2, ft3)
