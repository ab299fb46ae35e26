// Native host-side BN254 core: fields, towers, curves, optimal-ate pairing,
// SHA-256 try-and-increment hash-to-G1.
//
// This is the framework's host runtime — the role the reference's Rust
// math dependency plays for single-operation paths (key derivation, sign,
// verify, fixture generation), re-implemented natively (SURVEY.md §2.3).
// The batched/throughput paths run on the device (bn254_tpu/pairing, /dist); this
// library serves the protocol layer's scalar paths at native speed through
// a small C ABI (ctypes binding in bn254_tpu/host/native.py).
//
// Representation: 4x64-bit little-endian limbs, Montgomery form (R = 2^256),
// CIOS multiplication with 128-bit partials. All exported buffers are
// big-endian 32-byte field elements; G1 points are x||y (64B), G2 points
// x.re||x.im||y.re||y.im (128B) matching the reference's uncompressed layout
// (reference utils.rs:107-127).
//
// Algorithms mirror the (test-vector-validated) structures of the Python
// oracle and device pipeline: dbl-2009-l / add-2007-bl Jacobian arithmetic,
// homogeneous-projective D-twist Miller loop with 034-sparse line folding,
// easy-part + Devegili hard-part final exponentiation.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;

// ---------------------------------------------------------------------------
// U256 bigint
// ---------------------------------------------------------------------------

struct U256 {
  uint64_t w[4];  // little-endian
};

static inline bool u256_eq(const U256 &a, const U256 &b) {
  return a.w[0] == b.w[0] && a.w[1] == b.w[1] && a.w[2] == b.w[2] &&
         a.w[3] == b.w[3];
}

static inline bool u256_is_zero(const U256 &a) {
  return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

// a < b
static inline bool u256_lt(const U256 &a, const U256 &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i];
  }
  return false;
}

// a += b, returns carry
static inline uint64_t u256_add(U256 &a, const U256 &b) {
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (u128)a.w[i] + b.w[i];
    a.w[i] = (uint64_t)c;
    c >>= 64;
  }
  return (uint64_t)c;
}

// a -= b, returns borrow
static inline uint64_t u256_sub(U256 &a, const U256 &b) {
  u128 br = 0;
  for (int i = 0; i < 4; ++i) {
    u128 t = (u128)a.w[i] - b.w[i] - br;
    a.w[i] = (uint64_t)t;
    br = (t >> 64) ? 1 : 0;
  }
  return (uint64_t)br;
}

static inline void u256_from_be(U256 &o, const uint8_t *be) {
  for (int i = 0; i < 4; ++i) {
    uint64_t v = 0;
    for (int j = 0; j < 8; ++j) v = (v << 8) | be[(3 - i) * 8 + j];
    o.w[i] = v;
  }
}

static inline void u256_to_be(const U256 &a, uint8_t *be) {
  for (int i = 0; i < 4; ++i) {
    uint64_t v = a.w[i];
    for (int j = 7; j >= 0; --j) {
      be[(3 - i) * 8 + j] = (uint8_t)v;
      v >>= 8;
    }
  }
}

static inline int u256_bit(const U256 &a, int i) {
  return (a.w[i >> 6] >> (i & 63)) & 1;
}

static inline int u256_bitlen(const U256 &a) {
  for (int i = 3; i >= 0; --i) {
    if (a.w[i]) return 64 * i + 64 - __builtin_clzll(a.w[i]);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Field constants (values generated from the standard alt_bn128 parameters;
// see bn254_tpu/constants.py for the same values in Python)
// ---------------------------------------------------------------------------

static const U256 P_MOD = {{0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                            0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
static const uint64_t P_N0 = 0x87d20782e4866389ULL;
static const U256 P_R1 = {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                           0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}};
static const U256 P_R2 = {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                           0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}};

static const U256 FR_MOD = {{0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                             0xb85045b68181585dULL, 0x30644e72e131a029ULL}};

static const U256 FIVE_P = {{0x2ca2bc723a70f263ULL, 0xf58714d70a38f4c2ULL,
                             0x99915c908786b9d3ULL, 0xf1f5883e65f820d0ULL}};
static const U256 SQRT_EXP = {{0x4f082305b61f3f52ULL, 0x65e05aa45a1c72a3ULL,
                               0x6e14116da0605617ULL, 0x0c19139cb84c680aULL}};
static const U256 P_MINUS_2 = {{0x3c208c16d87cfd45ULL, 0x97816a916871ca8dULL,
                                0xb85045b68181585dULL, 0x30644e72e131a029ULL}};

// BN parameter u and the ate loop count 6u+2 (fit in 64 bits)
static const uint64_t BN_U = 4965661367192848881ULL;
// 6u+2 = 29793968203157093288 is a 65-bit value: it does NOT fit uint64_t.
static const u128 ATE_LOOP = (u128)6 * BN_U + 2;
static const int ATE_BITS = 65;

// ---------------------------------------------------------------------------
// Fq: Montgomery arithmetic mod p
// ---------------------------------------------------------------------------

struct Fq {
  U256 v;  // Montgomery form, < p
};

static inline Fq fq_zero() { return Fq{{{0, 0, 0, 0}}}; }
static inline Fq fq_one() { return Fq{P_R1}; }
static inline bool fq_is_zero(const Fq &a) { return u256_is_zero(a.v); }
static inline bool fq_eq(const Fq &a, const Fq &b) { return u256_eq(a.v, b.v); }

static inline void fq_add(Fq &o, const Fq &a, const Fq &b) {
  o.v = a.v;
  uint64_t c = u256_add(o.v, b.v);
  if (c || !u256_lt(o.v, P_MOD)) u256_sub(o.v, P_MOD);
}

static inline void fq_sub(Fq &o, const Fq &a, const Fq &b) {
  o.v = a.v;
  if (u256_sub(o.v, b.v)) u256_add(o.v, P_MOD);
}

static inline void fq_neg(Fq &o, const Fq &a) {
  // alias-safe: compute into a temporary before writing o
  if (u256_is_zero(a.v)) {
    o = a;
  } else {
    U256 t = P_MOD;
    u256_sub(t, a.v);
    o.v = t;
  }
}

static inline void fq_dbl(Fq &o, const Fq &a) { fq_add(o, a, a); }

// CIOS Montgomery multiplication (4 limbs, 128-bit partials)
static inline void fq_mul(Fq &o, const Fq &a, const Fq &b) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    // t += a.w[i] * b
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      c += (u128)t[j] + (u128)a.v.w[i] * b.v.w[j];
      t[j] = (uint64_t)c;
      c >>= 64;
    }
    c += t[4];
    t[4] = (uint64_t)c;
    t[5] = (uint64_t)(c >> 64);
    // m = t[0] * n0 mod 2^64 ; t += m * p ; t >>= 64
    uint64_t m = t[0] * P_N0;
    c = (u128)t[0] + (u128)m * P_MOD.w[0];
    c >>= 64;
    for (int j = 1; j < 4; ++j) {
      c += (u128)t[j] + (u128)m * P_MOD.w[j];
      t[j - 1] = (uint64_t)c;
      c >>= 64;
    }
    c += t[4];
    t[3] = (uint64_t)c;
    t[4] = t[5] + (uint64_t)(c >> 64);
  }
  U256 r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || !u256_lt(r, P_MOD)) u256_sub(r, P_MOD);
  o.v = r;
}

static inline void fq_sqr(Fq &o, const Fq &a) { fq_mul(o, a, a); }

static inline void fq_mul_small(Fq &o, const Fq &a, unsigned k) {
  Fq acc = fq_zero();
  Fq base = a;
  while (k) {
    if (k & 1) fq_add(acc, acc, base);
    k >>= 1;
    if (k) fq_add(base, base, base);
  }
  o = acc;
}

static void fq_pow(Fq &o, const Fq &a, const U256 &e) {
  Fq acc = fq_one();
  int n = u256_bitlen(e);
  for (int i = n - 1; i >= 0; --i) {
    fq_sqr(acc, acc);
    if (u256_bit(e, i)) fq_mul(acc, acc, a);
  }
  o = acc;
}

static inline void fq_inv(Fq &o, const Fq &a) { fq_pow(o, a, P_MINUS_2); }

// canonical (non-Montgomery) conversions
static inline void fq_from_u256(Fq &o, const U256 &x) {
  Fq t{x};
  Fq r2{P_R2};
  fq_mul(o, t, r2);
}

static inline void fq_to_u256(U256 &o, const Fq &a) {
  // REDC(a * 1)
  Fq one_raw{{{1, 0, 0, 0}}};
  Fq t;
  fq_mul(t, a, one_raw);
  o = t.v;
}

static inline void fq_from_be(Fq &o, const uint8_t *be) {
  U256 x;
  u256_from_be(x, be);
  fq_from_u256(o, x);
}

static inline void fq_to_be(const Fq &a, uint8_t *be) {
  U256 x;
  fq_to_u256(x, a);
  u256_to_be(x, be);
}

// sqrt (p ≡ 3 mod 4): s = a^((p+1)/4); valid iff s^2 == a
static bool fq_sqrt(Fq &o, const Fq &a) {
  Fq s, s2;
  fq_pow(s, a, SQRT_EXP);
  fq_sqr(s2, s);
  if (!fq_eq(s2, a)) return false;
  o = s;
  return true;
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[i]/(i^2+1)
// ---------------------------------------------------------------------------

struct Fq2 {
  Fq c0, c1;
};

static inline Fq2 fq2_zero() { return Fq2{fq_zero(), fq_zero()}; }
static inline Fq2 fq2_one() { return Fq2{fq_one(), fq_zero()}; }
static inline bool fq2_is_zero(const Fq2 &a) {
  return fq_is_zero(a.c0) && fq_is_zero(a.c1);
}
static inline bool fq2_eq(const Fq2 &a, const Fq2 &b) {
  return fq_eq(a.c0, b.c0) && fq_eq(a.c1, b.c1);
}

static inline void fq2_add(Fq2 &o, const Fq2 &a, const Fq2 &b) {
  fq_add(o.c0, a.c0, b.c0);
  fq_add(o.c1, a.c1, b.c1);
}
static inline void fq2_sub(Fq2 &o, const Fq2 &a, const Fq2 &b) {
  fq_sub(o.c0, a.c0, b.c0);
  fq_sub(o.c1, a.c1, b.c1);
}
static inline void fq2_neg(Fq2 &o, const Fq2 &a) {
  fq_neg(o.c0, a.c0);
  fq_neg(o.c1, a.c1);
}
static inline void fq2_dbl(Fq2 &o, const Fq2 &a) { fq2_add(o, a, a); }
static inline void fq2_conj(Fq2 &o, const Fq2 &a) {
  o.c0 = a.c0;
  fq_neg(o.c1, a.c1);
}

static inline void fq2_mul(Fq2 &o, const Fq2 &a, const Fq2 &b) {
  Fq t0, t1, t2, s1, s2;
  fq_mul(t0, a.c0, b.c0);
  fq_mul(t1, a.c1, b.c1);
  fq_add(s1, a.c0, a.c1);
  fq_add(s2, b.c0, b.c1);
  fq_mul(t2, s1, s2);
  fq_sub(o.c0, t0, t1);
  fq_sub(t2, t2, t0);
  fq_sub(o.c1, t2, t1);
}

static inline void fq2_sqr(Fq2 &o, const Fq2 &a) {
  // (c0+c1 i)^2 = (c0+c1)(c0-c1) + 2 c0 c1 i
  Fq s, d, m;
  fq_add(s, a.c0, a.c1);
  fq_sub(d, a.c0, a.c1);
  fq_mul(m, a.c0, a.c1);
  fq_mul(o.c0, s, d);
  fq_dbl(o.c1, m);
}

static inline void fq2_mul_fq(Fq2 &o, const Fq2 &a, const Fq &k) {
  fq_mul(o.c0, a.c0, k);
  fq_mul(o.c1, a.c1, k);
}

static inline void fq2_mul_small(Fq2 &o, const Fq2 &a, unsigned k) {
  fq_mul_small(o.c0, a.c0, k);
  fq_mul_small(o.c1, a.c1, k);
}

// multiply by xi = 9 + i: (9 c0 - c1) + (9 c1 + c0) i
static inline void fq2_mul_xi(Fq2 &o, const Fq2 &a) {
  Fq n0, n1;
  fq_mul_small(n0, a.c0, 9);
  fq_mul_small(n1, a.c1, 9);
  Fq r0, r1;
  fq_sub(r0, n0, a.c1);
  fq_add(r1, n1, a.c0);
  o.c0 = r0;
  o.c1 = r1;
}

static void fq2_inv(Fq2 &o, const Fq2 &a) {
  // 1/(c0 + c1 i) = (c0 - c1 i) / (c0^2 + c1^2)
  Fq n, t0, t1;
  fq_sqr(t0, a.c0);
  fq_sqr(t1, a.c1);
  fq_add(n, t0, t1);
  fq_inv(n, n);
  fq_mul(o.c0, a.c0, n);
  Fq nc1;
  fq_neg(nc1, a.c1);
  fq_mul(o.c1, nc1, n);
}

static void fq2_pow(Fq2 &o, const Fq2 &a, const U256 &e) {
  Fq2 acc = fq2_one();
  int n = u256_bitlen(e);
  for (int i = n - 1; i >= 0; --i) {
    fq2_sqr(acc, acc);
    if (u256_bit(e, i)) fq2_mul(acc, acc, a);
  }
  o = acc;
}

// Fq2 sqrt (for G2 decompression): p ≡ 3 (mod 4) complex method.
static bool fq2_sqrt(Fq2 &o, const Fq2 &a) {
  if (fq2_is_zero(a)) {
    o = fq2_zero();
    return true;
  }
  // norm = c0^2 + c1^2 ; alpha = sqrt(norm) (must exist for a QR)
  Fq t0, t1, norm, alpha;
  fq_sqr(t0, a.c0);
  fq_sqr(t1, a.c1);
  fq_add(norm, t0, t1);
  if (!fq_sqrt(alpha, norm)) return false;
  // delta = (c0 + alpha)/2 ; if not QR, delta = (c0 - alpha)/2
  Fq half_c0a, two_inv;
  {
    Fq two;
    fq_add(two, fq_one(), fq_one());
    fq_inv(two_inv, two);
  }
  fq_add(half_c0a, a.c0, alpha);
  fq_mul(half_c0a, half_c0a, two_inv);
  Fq x0;
  if (!fq_sqrt(x0, half_c0a)) {
    fq_sub(half_c0a, a.c0, alpha);
    fq_mul(half_c0a, half_c0a, two_inv);
    if (!fq_sqrt(x0, half_c0a)) return false;
  }
  // x1 = c1 / (2 x0)
  Fq x0d, x0d_inv, x1;
  fq_dbl(x0d, x0);
  if (fq_is_zero(x0d)) return false;
  fq_inv(x0d_inv, x0d);
  fq_mul(x1, a.c1, x0d_inv);
  Fq2 cand{x0, x1}, cand_sq;
  fq2_sqr(cand_sq, cand);
  if (!fq2_eq(cand_sq, a)) return false;
  o = cand;
  return true;
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v]/(v^3 - xi),  Fq12 = Fq6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fq6 {
  Fq2 c0, c1, c2;
};
struct Fq12 {
  Fq6 c0, c1;
};

static inline Fq6 fq6_zero() { return Fq6{fq2_zero(), fq2_zero(), fq2_zero()}; }
static inline Fq6 fq6_one() { return Fq6{fq2_one(), fq2_zero(), fq2_zero()}; }
static inline Fq12 fq12_one() { return Fq12{fq6_one(), fq6_zero()}; }

static inline void fq6_add(Fq6 &o, const Fq6 &a, const Fq6 &b) {
  fq2_add(o.c0, a.c0, b.c0);
  fq2_add(o.c1, a.c1, b.c1);
  fq2_add(o.c2, a.c2, b.c2);
}
static inline void fq6_sub(Fq6 &o, const Fq6 &a, const Fq6 &b) {
  fq2_sub(o.c0, a.c0, b.c0);
  fq2_sub(o.c1, a.c1, b.c1);
  fq2_sub(o.c2, a.c2, b.c2);
}
static inline void fq6_neg(Fq6 &o, const Fq6 &a) {
  fq2_neg(o.c0, a.c0);
  fq2_neg(o.c1, a.c1);
  fq2_neg(o.c2, a.c2);
}

// v * (a0 + a1 v + a2 v^2) = xi a2 + a0 v + a1 v^2
static inline void fq6_mul_by_v(Fq6 &o, const Fq6 &a) {
  Fq2 t;
  fq2_mul_xi(t, a.c2);
  Fq2 a0 = a.c0, a1 = a.c1;
  o.c0 = t;
  o.c1 = a0;
  o.c2 = a1;
}

static void fq6_mul(Fq6 &o, const Fq6 &a, const Fq6 &b) {
  // Toom/Karatsuba (CH-SQR3 style): 6 Fq2 muls
  Fq2 t0, t1, t2, u0, u1, u2, s, tt;
  fq2_mul(t0, a.c0, b.c0);
  fq2_mul(t1, a.c1, b.c1);
  fq2_mul(t2, a.c2, b.c2);

  Fq2 a01, b01, a12, b12, a02, b02;
  fq2_add(a01, a.c0, a.c1);
  fq2_add(b01, b.c0, b.c1);
  fq2_add(a12, a.c1, a.c2);
  fq2_add(b12, b.c1, b.c2);
  fq2_add(a02, a.c0, a.c2);
  fq2_add(b02, b.c0, b.c2);

  fq2_mul(u1, a01, b01);  // t0 + t1 + cross01
  fq2_mul(u0, a12, b12);  // t1 + t2 + cross12
  fq2_mul(u2, a02, b02);  // t0 + t2 + cross02

  // c0 = t0 + xi*(u0 - t1 - t2)
  fq2_sub(s, u0, t1);
  fq2_sub(s, s, t2);
  fq2_mul_xi(tt, s);
  fq2_add(o.c0, t0, tt);
  // c1 = u1 - t0 - t1 + xi*t2
  fq2_sub(s, u1, t0);
  fq2_sub(s, s, t1);
  fq2_mul_xi(tt, t2);
  fq2_add(o.c1, s, tt);
  // c2 = u2 - t0 - t2 + t1
  fq2_sub(s, u2, t0);
  fq2_sub(s, s, t2);
  fq2_add(o.c2, s, t1);
}

static inline void fq6_sqr(Fq6 &o, const Fq6 &a) { fq6_mul(o, a, a); }

static inline void fq6_mul_fq2(Fq6 &o, const Fq6 &a, const Fq2 &k) {
  fq2_mul(o.c0, a.c0, k);
  fq2_mul(o.c1, a.c1, k);
  fq2_mul(o.c2, a.c2, k);
}

static void fq6_inv(Fq6 &o, const Fq6 &a) {
  // standard cubic-extension inversion
  Fq2 c0, c1, c2, t0, t1, t2, xi_t;
  fq2_sqr(t0, a.c0);
  fq2_mul(t1, a.c1, a.c2);
  fq2_mul_xi(xi_t, t1);
  fq2_sub(c0, t0, xi_t);  // a0^2 - xi a1 a2

  fq2_sqr(t0, a.c2);
  fq2_mul_xi(xi_t, t0);
  fq2_mul(t1, a.c0, a.c1);
  fq2_sub(c1, xi_t, t1);  // xi a2^2 - a0 a1

  fq2_sqr(t0, a.c1);
  fq2_mul(t1, a.c0, a.c2);
  fq2_sub(c2, t0, t1);  // a1^2 - a0 a2

  // n = a0 c0 + xi (a2 c1 + a1 c2)
  Fq2 n, m;
  fq2_mul(t0, a.c2, c1);
  fq2_mul(t1, a.c1, c2);
  fq2_add(t2, t0, t1);
  fq2_mul_xi(m, t2);
  fq2_mul(t0, a.c0, c0);
  fq2_add(n, t0, m);
  fq2_inv(n, n);
  fq2_mul(o.c0, c0, n);
  fq2_mul(o.c1, c1, n);
  fq2_mul(o.c2, c2, n);
}

static void fq12_mul(Fq12 &o, const Fq12 &a, const Fq12 &b) {
  Fq6 t0, t1, s1, s2, t2, vt;
  fq6_mul(t0, a.c0, b.c0);
  fq6_mul(t1, a.c1, b.c1);
  fq6_add(s1, a.c0, a.c1);
  fq6_add(s2, b.c0, b.c1);
  fq6_mul(t2, s1, s2);
  fq6_mul_by_v(vt, t1);
  fq6_add(o.c0, t0, vt);
  fq6_sub(t2, t2, t0);
  fq6_sub(o.c1, t2, t1);
}

static inline void fq12_sqr(Fq12 &o, const Fq12 &a) { fq12_mul(o, a, a); }

static inline void fq12_conj(Fq12 &o, const Fq12 &a) {
  o.c0 = a.c0;
  fq6_neg(o.c1, a.c1);
}

static void fq12_inv(Fq12 &o, const Fq12 &a) {
  // 1/(c0 + c1 w) = (c0 - c1 w) / (c0^2 - v c1^2)
  Fq6 t0, t1, vt, n;
  fq6_sqr(t0, a.c0);
  fq6_sqr(t1, a.c1);
  fq6_mul_by_v(vt, t1);
  fq6_sub(n, t0, vt);
  fq6_inv(n, n);
  fq6_mul(o.c0, a.c0, n);
  Fq6 nc1;
  fq6_neg(nc1, a.c1);
  fq6_mul(o.c1, nc1, n);
}

static inline bool fq12_is_one(const Fq12 &a) {
  return fq2_eq(a.c0.c0, fq2_one()) && fq2_is_zero(a.c0.c1) &&
         fq2_is_zero(a.c0.c2) && fq2_is_zero(a.c1.c0) &&
         fq2_is_zero(a.c1.c1) && fq2_is_zero(a.c1.c2);
}

// ---------------------------------------------------------------------------
// Frobenius: gamma_m = xi^{m (p-1)/6}; frob(c_m w^m) = conj(c_m) gamma_m w^m
// with the w-basis mapping (1, w, v, vw, v^2, v^2 w) <-> m = 0..5.
// ---------------------------------------------------------------------------

static Fq2 FROB_GAMMA[6];  // m = 0..5 (gamma_0 = 1)
static bool frob_init_done = false;

static void frob_init() {
  if (frob_init_done) return;
  // (p-1)/6
  U256 e = P_MOD;
  U256 one = {{1, 0, 0, 0}};
  u256_sub(e, one);
  // divide by 6: 256-bit / small
  u128 rem = 0;
  U256 q = {{0, 0, 0, 0}};
  for (int i = 3; i >= 0; --i) {
    u128 cur = (rem << 64) | e.w[i];
    q.w[i] = (uint64_t)(cur / 6);
    rem = cur % 6;
  }
  Fq2 xi{fq_zero(), fq_zero()};
  {
    U256 nine = {{9, 0, 0, 0}};
    fq_from_u256(xi.c0, nine);
    U256 u1 = {{1, 0, 0, 0}};
    fq_from_u256(xi.c1, u1);
  }
  FROB_GAMMA[0] = fq2_one();
  fq2_pow(FROB_GAMMA[1], xi, q);
  for (int m = 2; m < 6; ++m)
    fq2_mul(FROB_GAMMA[m], FROB_GAMMA[m - 1], FROB_GAMMA[1]);
  frob_init_done = true;
}

static void fq12_frob1(Fq12 &o, const Fq12 &a) {
  // coefficient of w^m: m=0:a.c0.c0, 1:a.c1.c0, 2:a.c0.c1, 3:a.c1.c1,
  //                      4:a.c0.c2, 5:a.c1.c2
  const Fq2 *in[6] = {&a.c0.c0, &a.c1.c0, &a.c0.c1,
                      &a.c1.c1, &a.c0.c2, &a.c1.c2};
  Fq2 *out[6] = {&o.c0.c0, &o.c1.c0, &o.c0.c1, &o.c1.c1, &o.c0.c2, &o.c1.c2};
  for (int m = 0; m < 6; ++m) {
    Fq2 c;
    fq2_conj(c, *in[m]);
    fq2_mul(*out[m], c, FROB_GAMMA[m]);
  }
}

static void fq12_frob(Fq12 &o, const Fq12 &a, int power) {
  frob_init();
  Fq12 t = a;
  for (int i = 0; i < power; ++i) fq12_frob1(t, t);
  o = t;
}

// ---------------------------------------------------------------------------
// G1 (Jacobian over Fq) and G2 (Jacobian over Fq2)
// ---------------------------------------------------------------------------

template <typename F>
struct FOps;

template <>
struct FOps<Fq> {
  static void add(Fq &o, const Fq &a, const Fq &b) { fq_add(o, a, b); }
  static void sub(Fq &o, const Fq &a, const Fq &b) { fq_sub(o, a, b); }
  static void mul(Fq &o, const Fq &a, const Fq &b) { fq_mul(o, a, b); }
  static void sqr(Fq &o, const Fq &a) { fq_sqr(o, a); }
  static void neg(Fq &o, const Fq &a) { fq_neg(o, a); }
  static void inv(Fq &o, const Fq &a) { fq_inv(o, a); }
  static void mul_small(Fq &o, const Fq &a, unsigned k) { fq_mul_small(o, a, k); }
  static Fq zero() { return fq_zero(); }
  static Fq one() { return fq_one(); }
  static bool is_zero(const Fq &a) { return fq_is_zero(a); }
  static bool eq(const Fq &a, const Fq &b) { return fq_eq(a, b); }
};

template <>
struct FOps<Fq2> {
  static void add(Fq2 &o, const Fq2 &a, const Fq2 &b) { fq2_add(o, a, b); }
  static void sub(Fq2 &o, const Fq2 &a, const Fq2 &b) { fq2_sub(o, a, b); }
  static void mul(Fq2 &o, const Fq2 &a, const Fq2 &b) { fq2_mul(o, a, b); }
  static void sqr(Fq2 &o, const Fq2 &a) { fq2_sqr(o, a); }
  static void neg(Fq2 &o, const Fq2 &a) { fq2_neg(o, a); }
  static void inv(Fq2 &o, const Fq2 &a) { fq2_inv(o, a); }
  static void mul_small(Fq2 &o, const Fq2 &a, unsigned k) { fq2_mul_small(o, a, k); }
  static Fq2 zero() { return fq2_zero(); }
  static Fq2 one() { return fq2_one(); }
  static bool is_zero(const Fq2 &a) { return fq2_is_zero(a); }
  static bool eq(const Fq2 &a, const Fq2 &b) { return fq2_eq(a, b); }
};

template <typename F>
struct Jac {
  F X, Y, Z;
};

template <typename F>
static inline bool jac_is_identity(const Jac<F> &p) {
  return FOps<F>::is_zero(p.Z);
}

template <typename F>
static inline Jac<F> jac_identity() {
  return Jac<F>{FOps<F>::one(), FOps<F>::one(), FOps<F>::zero()};
}

// dbl-2009-l (a = 0); mirrors bn254_tpu/host/curve.py jac_double
template <typename F>
static void jac_double(Jac<F> &o, const Jac<F> &p) {
  using O = FOps<F>;
  if (O::is_zero(p.Z) || O::is_zero(p.Y)) {
    o = jac_identity<F>();
    return;
  }
  F A, B, C, D, E, Fv, t, X3, Y3, Z3;
  O::sqr(A, p.X);
  O::sqr(B, p.Y);
  O::sqr(C, B);
  O::add(t, p.X, B);
  O::sqr(t, t);
  O::sub(t, t, A);
  O::sub(t, t, C);
  O::add(D, t, t);
  O::mul_small(E, A, 3);
  O::sqr(Fv, E);
  O::add(t, D, D);
  O::sub(X3, Fv, t);
  O::sub(t, D, X3);
  O::mul(t, E, t);
  F c8;
  O::mul_small(c8, C, 8);
  O::sub(Y3, t, c8);
  O::mul(t, p.Y, p.Z);
  O::add(Z3, t, t);
  o.X = X3;
  o.Y = Y3;
  o.Z = Z3;
}

// add-2007-bl; mirrors bn254_tpu/host/curve.py jac_add
template <typename F>
static void jac_add(Jac<F> &o, const Jac<F> &p1, const Jac<F> &p2) {
  using O = FOps<F>;
  if (jac_is_identity(p1)) {
    o = p2;
    return;
  }
  if (jac_is_identity(p2)) {
    o = p1;
    return;
  }
  F Z1Z1, Z2Z2, U1, U2, S1, S2, t;
  O::sqr(Z1Z1, p1.Z);
  O::sqr(Z2Z2, p2.Z);
  O::mul(U1, p1.X, Z2Z2);
  O::mul(U2, p2.X, Z1Z1);
  O::mul(t, p1.Y, p2.Z);
  O::mul(S1, t, Z2Z2);
  O::mul(t, p2.Y, p1.Z);
  O::mul(S2, t, Z1Z1);
  if (O::eq(U1, U2)) {
    if (O::eq(S1, S2)) {
      jac_double(o, p1);
    } else {
      o = jac_identity<F>();
    }
    return;
  }
  F H, I, J, r, V, X3, Y3, Z3;
  O::sub(H, U2, U1);
  O::add(t, H, H);
  O::sqr(I, t);
  O::mul(J, H, I);
  O::sub(t, S2, S1);
  O::add(r, t, t);
  O::mul(V, U1, I);
  O::sqr(X3, r);
  O::sub(X3, X3, J);
  O::add(t, V, V);
  O::sub(X3, X3, t);
  O::sub(t, V, X3);
  O::mul(t, r, t);
  F sj;
  O::mul(sj, S1, J);
  O::add(sj, sj, sj);
  O::sub(Y3, t, sj);
  O::mul(t, p1.Z, p2.Z);
  O::mul(t, t, H);
  O::add(Z3, t, t);
  o.X = X3;
  o.Y = Y3;
  o.Z = Z3;
}

template <typename F>
static void jac_scalar_mul(Jac<F> &o, const Jac<F> &p, const U256 &k) {
  Jac<F> acc = jac_identity<F>();
  int n = u256_bitlen(k);
  for (int i = n - 1; i >= 0; --i) {
    jac_double(acc, acc);
    if (u256_bit(k, i)) jac_add(acc, acc, p);
  }
  o = acc;
}

template <typename F>
static bool jac_to_affine(F &ox, F &oy, const Jac<F> &p) {
  using O = FOps<F>;
  if (jac_is_identity(p)) return false;
  F zi, zi2, zi3;
  O::inv(zi, p.Z);
  O::sqr(zi2, zi);
  O::mul(zi3, zi2, zi);
  O::mul(ox, p.X, zi2);
  O::mul(oy, p.Y, zi3);
  return true;
}

// ---------------------------------------------------------------------------
// Miller loop (homogeneous projective, D-twist, 034-sparse lines) — the same
// structure as bn254_tpu/pairing/miller.py (device) re-expressed sequentially.
// ---------------------------------------------------------------------------

struct ProjG2 {
  Fq2 X, Y, Z;
};

struct Line {
  Fq2 a, b, c;  // l = a + b w + c v w
};

// f *= (a + b w + c v w)
static void fq12_mul_line(Fq12 &f, const Line &l) {
  // t0 = f0 * a  (Fq6 by Fq2 scalar)
  Fq6 t0;
  fq6_mul_fq2(t0, f.c0, l.a);
  // t1 = f1 * (b + c v) — mul_by_01
  Fq6 t1;
  {
    const Fq6 &g = f.c1;
    Fq2 t00, t11, u, g2s0, g2s1, s0b, xi_t;
    fq2_mul(t00, g.c0, l.b);
    fq2_mul(t11, g.c1, l.c);
    fq2_add(s0b, l.b, l.c);
    Fq2 g01;
    fq2_add(g01, g.c0, g.c1);
    fq2_mul(u, g01, s0b);
    fq2_mul(g2s0, g.c2, l.b);
    fq2_mul(g2s1, g.c2, l.c);
    fq2_mul_xi(xi_t, g2s1);
    fq2_add(t1.c0, t00, xi_t);
    fq2_sub(u, u, t00);
    fq2_sub(t1.c1, u, t11);
    fq2_add(t1.c2, g2s0, t11);
  }
  // t2 = (f0 + f1) * ((a+b) + c v)
  Fq6 t2;
  {
    Fq6 s;
    fq6_add(s, f.c0, f.c1);
    Fq2 ab;
    fq2_add(ab, l.a, l.b);
    Fq2 t00, t11, u, g2s0, g2s1, s0b, xi_t;
    fq2_mul(t00, s.c0, ab);
    fq2_mul(t11, s.c1, l.c);
    fq2_add(s0b, ab, l.c);
    Fq2 g01;
    fq2_add(g01, s.c0, s.c1);
    fq2_mul(u, g01, s0b);
    fq2_mul(g2s0, s.c2, ab);
    fq2_mul(g2s1, s.c2, l.c);
    fq2_mul_xi(xi_t, g2s1);
    fq2_add(t2.c0, t00, xi_t);
    fq2_sub(u, u, t00);
    fq2_sub(t2.c1, u, t11);
    fq2_add(t2.c2, g2s0, t11);
  }
  Fq6 vt;
  fq6_mul_by_v(vt, t1);
  fq6_add(f.c0, t0, vt);
  fq6_sub(t2, t2, t0);
  fq6_sub(f.c1, t2, t1);
}

// tangent doubling step; line scaled by 2YZ^2
static void miller_dbl_step(ProjG2 &t, Line &l, const Fq &xp, const Fq &yp) {
  Fq2 xx, yy, xy, yz, x3, yyz, xyz, xxz, yzz;
  fq2_sqr(xx, t.X);
  fq2_sqr(yy, t.Y);
  fq2_mul(xy, t.X, t.Y);
  fq2_mul(yz, t.Y, t.Z);
  fq2_mul(x3, xx, t.X);
  fq2_mul(yyz, yy, t.Z);
  fq2_mul(xyz, xy, t.Z);
  fq2_mul(xxz, xx, t.Z);
  fq2_mul(yzz, yz, t.Z);

  Fq2 nine_x3, eight_yyz, tmp, x_out, y_out, z_out;
  fq2_mul_small(nine_x3, x3, 9);
  fq2_mul_small(eight_yyz, yyz, 8);
  fq2_sub(tmp, nine_x3, eight_yyz);
  fq2_mul(x_out, xyz, tmp);
  fq2_dbl(x_out, x_out);

  Fq2 four_yyz, three_x3, yyz_sq;
  fq2_mul_small(four_yyz, yyz, 4);
  fq2_mul_small(three_x3, x3, 3);
  fq2_sub(tmp, four_yyz, three_x3);
  fq2_mul(y_out, nine_x3, tmp);
  fq2_sqr(yyz_sq, yyz);
  fq2_mul_small(yyz_sq, yyz_sq, 8);
  fq2_sub(y_out, y_out, yyz_sq);

  Fq2 yz_sq;
  fq2_sqr(yz_sq, yz);
  fq2_mul(z_out, yz_sq, yz);
  fq2_mul_small(z_out, z_out, 8);

  // line: A = -2YZ^2 yP ; B = 3X^2 Z xP ; C = 2Y^2 Z - 3X^3
  Fq2 a2;
  fq2_dbl(a2, yzz);
  fq2_neg(a2, a2);
  fq2_mul_fq(l.a, a2, yp);
  Fq2 b2;
  fq2_mul_small(b2, xxz, 3);
  fq2_mul_fq(l.b, b2, xp);
  Fq2 two_yyz;
  fq2_dbl(two_yyz, yyz);
  fq2_sub(l.c, two_yyz, three_x3);

  t.X = x_out;
  t.Y = y_out;
  t.Z = z_out;
}

// chord mixed addition step; line scaled by lam
static void miller_add_step(ProjG2 &t, Line &l, const Fq2 &qx, const Fq2 &qy,
                            const Fq &xp, const Fq &yp) {
  Fq2 theta, lam, cc, dd, ee, ff, gg, hh, tmp;
  fq2_mul(tmp, qy, t.Z);
  fq2_sub(theta, t.Y, tmp);
  fq2_mul(tmp, qx, t.Z);
  fq2_sub(lam, t.X, tmp);
  fq2_sqr(cc, theta);
  fq2_sqr(dd, lam);
  fq2_mul(ee, lam, dd);
  fq2_mul(ff, t.Z, cc);
  fq2_mul(gg, t.X, dd);
  fq2_add(hh, ee, ff);
  Fq2 two_gg;
  fq2_dbl(two_gg, gg);
  fq2_sub(hh, hh, two_gg);

  Fq2 x_out, y_out, z_out;
  fq2_mul(x_out, lam, hh);
  fq2_sub(tmp, gg, hh);
  fq2_mul(y_out, theta, tmp);
  Fq2 eeY;
  fq2_mul(eeY, ee, t.Y);
  fq2_sub(y_out, y_out, eeY);
  fq2_mul(z_out, t.Z, ee);

  // line: A = -lam yP ; B = theta xP ; C = lam qy - theta qx
  Fq2 nlam;
  fq2_neg(nlam, lam);
  fq2_mul_fq(l.a, nlam, yp);
  fq2_mul_fq(l.b, theta, xp);
  Fq2 lq, tq;
  fq2_mul(lq, lam, qy);
  fq2_mul(tq, theta, qx);
  fq2_sub(l.c, lq, tq);

  t.X = x_out;
  t.Y = y_out;
  t.Z = z_out;
}

// twist Frobenius constants (computed on first use)
static Fq2 TW_FROB_X, TW_FROB_Y, TW_FROB_X2, TW_FROB_Y2;
static bool tw_init_done = false;

static void tw_init() {
  if (tw_init_done) return;
  frob_init();
  // xi^((p-1)/3) = gamma_1^2 ; xi^((p-1)/2) = gamma_1^3
  fq2_mul(TW_FROB_X, FROB_GAMMA[1], FROB_GAMMA[1]);
  fq2_mul(TW_FROB_Y, TW_FROB_X, FROB_GAMMA[1]);
  // xi^((p^2-1)/3): norm-based — gamma_1^2 * conj(gamma_1^2) would be
  // xi^{(p-1)(p+1)/3}... compute directly as g2 = conj(g)*g pattern:
  // xi^((p^2-1)/3) = (xi^((p-1)/3))^(p+1) = frob(g) * g with g = TW_FROB_X
  {
    Fq2 cg;
    fq2_conj(cg, TW_FROB_X);  // frob on Fq2 is conjugation
    fq2_mul(TW_FROB_X2, cg, TW_FROB_X);
    Fq2 cgy;
    fq2_conj(cgy, TW_FROB_Y);
    fq2_mul(TW_FROB_Y2, cgy, TW_FROB_Y);
  }
  tw_init_done = true;
}

// Miller loop f_{6u+2,Q}(P); inputs affine, P in G1 (Fq), Q on twist (Fq2).
static void miller_loop(Fq12 &f, const Fq &xp, const Fq &yp, const Fq2 &qx,
                        const Fq2 &qy) {
  tw_init();
  f = fq12_one();
  ProjG2 t{qx, qy, fq2_one()};
  Line l;
  for (int i = ATE_BITS - 2; i >= 0; --i) {
    fq12_sqr(f, f);
    miller_dbl_step(t, l, xp, yp);
    fq12_mul_line(f, l);
    if ((int)((ATE_LOOP >> i) & 1)) {
      miller_add_step(t, l, qx, qy, xp, yp);
      fq12_mul_line(f, l);
    }
  }
  // Frobenius addition steps: +Q1, +(-Q2)
  Fq2 q1x, q1y, q2x, nq2y, c;
  fq2_conj(c, qx);
  fq2_mul(q1x, c, TW_FROB_X);
  fq2_conj(c, qy);
  fq2_mul(q1y, c, TW_FROB_Y);
  fq2_mul(q2x, qx, TW_FROB_X2);
  fq2_mul(nq2y, qy, TW_FROB_Y2);
  fq2_neg(nq2y, nq2y);
  miller_add_step(t, l, q1x, q1y, xp, yp);
  fq12_mul_line(f, l);
  miller_add_step(t, l, q2x, nq2y, xp, yp);
  fq12_mul_line(f, l);
}

// final exponentiation: easy part then Devegili hard part
static void exp_u(Fq12 &o, const Fq12 &a) {
  Fq12 acc = fq12_one();
  int n = 64 - __builtin_clzll(BN_U);
  acc = a;
  for (int i = n - 2; i >= 0; --i) {
    fq12_sqr(acc, acc);
    if ((BN_U >> i) & 1) fq12_mul(acc, acc, a);
  }
  o = acc;
}

static void final_exp(Fq12 &o, const Fq12 &f_in) {
  Fq12 f, finv, t;
  // easy: f^(p^6-1) = conj(f) * f^-1 ; then ^(p^2+1)
  fq12_inv(finv, f_in);
  fq12_conj(t, f_in);
  fq12_mul(f, t, finv);
  Fq12 f2;
  fq12_frob(f2, f, 2);
  fq12_mul(f, f2, f);

  // hard part
  Fq12 ft1, ft2, ft3, fp1, fp2, fp3;
  exp_u(ft1, f);
  exp_u(ft2, ft1);
  exp_u(ft3, ft2);
  fq12_frob(fp1, f, 1);
  fq12_frob(fp2, f, 2);
  fq12_frob(fp3, f, 3);
  Fq12 y0, y1, y2, y3, y4, y5, y6;
  fq12_mul(y0, fp1, fp2);
  fq12_mul(y0, y0, fp3);
  fq12_conj(y1, f);
  fq12_frob(y2, ft2, 2);
  fq12_frob(y3, ft1, 1);
  fq12_conj(y3, y3);
  fq12_frob(t, ft2, 1);
  fq12_mul(t, ft1, t);
  fq12_conj(y4, t);
  fq12_conj(y5, ft2);
  fq12_frob(t, ft3, 1);
  fq12_mul(t, ft3, t);
  fq12_conj(y6, t);

  Fq12 t0, t1;
  fq12_sqr(t0, y6);
  fq12_mul(t0, t0, y4);
  fq12_mul(t0, t0, y5);
  fq12_mul(t1, y3, y5);
  fq12_mul(t1, t1, t0);
  fq12_mul(t0, t0, y2);
  fq12_sqr(t1, t1);
  fq12_mul(t1, t1, t0);
  fq12_sqr(t1, t1);
  fq12_mul(t0, t1, y1);
  fq12_mul(t1, t1, y0);
  fq12_sqr(t0, t0);
  fq12_mul(o, t0, t1);
}

// ---------------------------------------------------------------------------
// SHA-256 (compact, public domain algorithm)
// ---------------------------------------------------------------------------

static const uint32_t SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void sha256(const uint8_t *msg, uint64_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint64_t total = len;
  uint8_t block[64];
  uint64_t i = 0;
  bool appended = false, length_done = false;
  while (!length_done) {
    uint64_t remaining = len - i;
    uint64_t take = remaining < 64 ? remaining : 64;
    memcpy(block, msg + i, take);
    uint64_t pos = take;
    if (pos < 64 && !appended) {
      block[pos++] = 0x80;
      appended = true;
    }
    if (pos <= 56) {
      memset(block + pos, 0, 56 - pos);
      uint64_t bits = total * 8;
      for (int j = 7; j >= 0; --j) block[56 + 7 - j] = (uint8_t)(bits >> (8 * j));
      length_done = true;
    } else if (pos < 64) {
      memset(block + pos, 0, 64 - pos);
    }
    // compress
    uint32_t w[64];
    for (int j = 0; j < 16; ++j)
      w[j] = (block[4 * j] << 24) | (block[4 * j + 1] << 16) |
             (block[4 * j + 2] << 8) | block[4 * j + 3];
    for (int j = 16; j < 64; ++j) {
      uint32_t s0 = rotr(w[j - 15], 7) ^ rotr(w[j - 15], 18) ^ (w[j - 15] >> 3);
      uint32_t s1 = rotr(w[j - 2], 17) ^ rotr(w[j - 2], 19) ^ (w[j - 2] >> 10);
      w[j] = w[j - 16] + s0 + w[j - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int j = 0; j < 64; ++j) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t tmp1 = hh + S1 + ch + SHA_K[j] + w[j];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t tmp2 = S0 + maj;
      hh = g;
      g = f;
      f = e;
      e = d + tmp1;
      d = c;
      c = b;
      b = a;
      a = tmp1 + tmp2;
    }
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
    h[4] += e;
    h[5] += f;
    h[6] += g;
    h[7] += hh;
    i += take;
  }
  for (int j = 0; j < 8; ++j) {
    out[4 * j] = (uint8_t)(h[j] >> 24);
    out[4 * j + 1] = (uint8_t)(h[j] >> 16);
    out[4 * j + 2] = (uint8_t)(h[j] >> 8);
    out[4 * j + 3] = (uint8_t)h[j];
  }
}

// ---------------------------------------------------------------------------
// Point I/O helpers
// ---------------------------------------------------------------------------

static void g1_from_be(Jac<Fq> &o, const uint8_t *xy, int inf) {
  if (inf) {
    o = jac_identity<Fq>();
    return;
  }
  fq_from_be(o.X, xy);
  fq_from_be(o.Y, xy + 32);
  o.Z = fq_one();
}

static int g1_to_be(const Jac<Fq> &p, uint8_t *xy) {
  Fq x, y;
  if (!jac_to_affine(x, y, p)) {
    memset(xy, 0, 64);
    return 1;  // infinity
  }
  fq_to_be(x, xy);
  fq_to_be(y, xy + 32);
  return 0;
}

static void g2_from_be(Jac<Fq2> &o, const uint8_t *b, int inf) {
  if (inf) {
    o = jac_identity<Fq2>();
    return;
  }
  fq_from_be(o.X.c0, b);
  fq_from_be(o.X.c1, b + 32);
  fq_from_be(o.Y.c0, b + 64);
  fq_from_be(o.Y.c1, b + 96);
  o.Z = fq2_one();
}

static int g2_to_be(const Jac<Fq2> &p, uint8_t *b) {
  Fq2 x, y;
  if (!jac_to_affine(x, y, p)) {
    memset(b, 0, 128);
    return 1;
  }
  fq_to_be(x.c0, b);
  fq_to_be(x.c1, b + 32);
  fq_to_be(y.c0, b + 64);
  fq_to_be(y.c1, b + 96);
  return 0;
}

static void fq12_to_be(const Fq12 &a, uint8_t *b) {
  const Fq2 *cs[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2,
                      &a.c1.c0, &a.c1.c1, &a.c1.c2};
  for (int i = 0; i < 6; ++i) {
    fq_to_be(cs[i]->c0, b + 64 * i);
    fq_to_be(cs[i]->c1, b + 64 * i + 32);
  }
}

// ---------------------------------------------------------------------------
// Exported C ABI
// ---------------------------------------------------------------------------

extern "C" {

// out = [k] P ; returns 1 if the result is infinity, else 0.
int bn254_g1_mul(const uint8_t xy[64], int inf, const uint8_t k_be[32],
                 uint8_t out[64]) {
  Jac<Fq> p, r;
  g1_from_be(p, xy, inf);
  U256 k;
  u256_from_be(k, k_be);
  jac_scalar_mul(r, p, k);
  return g1_to_be(r, out);
}

int bn254_g2_mul(const uint8_t b[128], int inf, const uint8_t k_be[32],
                 uint8_t out[128]) {
  Jac<Fq2> p, r;
  g2_from_be(p, b, inf);
  U256 k;
  u256_from_be(k, k_be);
  jac_scalar_mul(r, p, k);
  return g2_to_be(r, out);
}

int bn254_g1_add(const uint8_t a[64], int a_inf, const uint8_t b[64],
                 int b_inf, uint8_t out[64]) {
  Jac<Fq> pa, pb, r;
  g1_from_be(pa, a, a_inf);
  g1_from_be(pb, b, b_inf);
  jac_add(r, pa, pb);
  return g1_to_be(r, out);
}

int bn254_g2_add(const uint8_t a[128], int a_inf, const uint8_t b[128],
                 int b_inf, uint8_t out[128]) {
  Jac<Fq2> pa, pb, r;
  g2_from_be(pa, a, a_inf);
  g2_from_be(pb, b, b_inf);
  jac_add(r, pa, pb);
  return g2_to_be(r, out);
}

// single pairing e(P, Q) -> canonical Fq12 bytes (6 x (c0||c1) x 32B BE,
// ordered c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2)
int bn254_pairing(const uint8_t p[64], int p_inf, const uint8_t q[128],
                  int q_inf, uint8_t out[384]) {
  Fq12 f = fq12_one();
  if (!p_inf && !q_inf) {
    Fq xp, yp;
    fq_from_be(xp, p);
    fq_from_be(yp, p + 32);
    Fq2 qx, qy;
    fq_from_be(qx.c0, q);
    fq_from_be(qx.c1, q + 32);
    fq_from_be(qy.c0, q + 64);
    fq_from_be(qy.c1, q + 96);
    miller_loop(f, xp, yp, qx, qy);
  }
  Fq12 r;
  final_exp(r, f);
  fq12_to_be(r, out);
  return 0;
}

// truncated Miller loop (first nsteps bits, no Frobenius tail) — debug
int bn254_miller_steps(const uint8_t p[64], const uint8_t q[128], int nsteps,
                       uint8_t out[384], uint8_t t_out[192]) {
  tw_init();
  Fq xp, yp;
  fq_from_be(xp, p);
  fq_from_be(yp, p + 32);
  Fq2 qx, qy;
  fq_from_be(qx.c0, q);
  fq_from_be(qx.c1, q + 32);
  fq_from_be(qy.c0, q + 64);
  fq_from_be(qy.c1, q + 96);
  Fq12 f = fq12_one();
  ProjG2 t{qx, qy, fq2_one()};
  Line l;
  int done = 0;
  for (int i = ATE_BITS - 2; i >= 0 && done < nsteps; --i, ++done) {
    fq12_sqr(f, f);
    miller_dbl_step(t, l, xp, yp);
    fq12_mul_line(f, l);
    if ((int)((ATE_LOOP >> i) & 1)) {
      miller_add_step(t, l, qx, qy, xp, yp);
      fq12_mul_line(f, l);
    }
  }
  fq12_to_be(f, out);
  fq_to_be(t.X.c0, t_out);
  fq_to_be(t.X.c1, t_out + 32);
  fq_to_be(t.Y.c0, t_out + 64);
  fq_to_be(t.Y.c1, t_out + 96);
  fq_to_be(t.Z.c0, t_out + 128);
  fq_to_be(t.Z.c1, t_out + 160);
  return 0;
}

// raw Miller value (pre-final-exp) — test/debug surface
int bn254_miller(const uint8_t p[64], const uint8_t q[128], uint8_t out[384]) {
  Fq xp, yp;
  fq_from_be(xp, p);
  fq_from_be(yp, p + 32);
  Fq2 qx, qy;
  fq_from_be(qx.c0, q);
  fq_from_be(qx.c1, q + 32);
  fq_from_be(qy.c0, q + 64);
  fq_from_be(qy.c1, q + 96);
  Fq12 f;
  miller_loop(f, xp, yp, qx, qy);
  fq12_to_be(f, out);
  return 0;
}

static void fq12_from_be(Fq12 &a, const uint8_t *b) {
  Fq2 *cs[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2, &a.c1.c0, &a.c1.c1, &a.c1.c2};
  for (int i = 0; i < 6; ++i) {
    fq_from_be(cs[i]->c0, b + 64 * i);
    fq_from_be(cs[i]->c1, b + 64 * i + 32);
  }
}

// final exponentiation alone — test/debug surface
int bn254_final_exp(const uint8_t in[384], uint8_t out[384]) {
  Fq12 f, r;
  fq12_from_be(f, in);
  final_exp(r, f);
  fq12_to_be(r, out);
  return 0;
}

// fq12 mul — test/debug surface
int bn254_fq12_mul(const uint8_t a[384], const uint8_t b[384],
                   uint8_t out[384]) {
  Fq12 fa, fb, r;
  fq12_from_be(fa, a);
  fq12_from_be(fb, b);
  fq12_mul(r, fa, fb);
  fq12_to_be(r, out);
  return 0;
}

// final_exp checkpoints — test/debug surface
int bn254_final_exp_debug(const uint8_t in[384], uint8_t easy_out[384],
                          uint8_t ft1_out[384], uint8_t y6_out[384],
                          uint8_t t1_out[384]) {
  Fq12 f_in, f, finv, t;
  fq12_from_be(f_in, in);
  fq12_inv(finv, f_in);
  fq12_conj(t, f_in);
  fq12_mul(f, t, finv);
  Fq12 f2;
  fq12_frob(f2, f, 2);
  fq12_mul(f, f2, f);
  fq12_to_be(f, easy_out);
  Fq12 ft1, ft2, ft3, fp1, fp2, fp3;
  exp_u(ft1, f);
  exp_u(ft2, ft1);
  exp_u(ft3, ft2);
  fq12_to_be(ft1, ft1_out);
  fq12_frob(fp1, f, 1);
  fq12_frob(fp2, f, 2);
  fq12_frob(fp3, f, 3);
  Fq12 y0, y1, y2, y3, y4, y5, y6;
  fq12_mul(y0, fp1, fp2);
  fq12_mul(y0, y0, fp3);
  fq12_conj(y1, f);
  fq12_frob(y2, ft2, 2);
  fq12_frob(y3, ft1, 1);
  fq12_conj(y3, y3);
  fq12_frob(t, ft2, 1);
  fq12_mul(t, ft1, t);
  fq12_conj(y4, t);
  fq12_conj(y5, ft2);
  fq12_frob(t, ft3, 1);
  fq12_mul(t, ft3, t);
  fq12_conj(y6, t);
  fq12_to_be(y6, y6_out);
  Fq12 t0, t1;
  fq12_sqr(t0, y6);
  fq12_mul(t0, t0, y4);
  fq12_mul(t0, t0, y5);
  fq12_mul(t1, y3, y5);
  fq12_mul(t1, t1, t0);
  fq12_mul(t0, t0, y2);
  fq12_sqr(t1, t1);
  fq12_mul(t1, t1, t0);
  fq12_sqr(t1, t1);
  fq12_to_be(t1, t1_out);
  return 0;
}

// frobenius / inverse / exp_u — test/debug surface
int bn254_fq12_frob(const uint8_t a[384], int k, uint8_t out[384]) {
  frob_init();
  Fq12 f, r;
  fq12_from_be(f, a);
  fq12_frob(r, f, k);
  fq12_to_be(r, out);
  return 0;
}

int bn254_fq12_inv(const uint8_t a[384], uint8_t out[384]) {
  Fq12 f, r;
  fq12_from_be(f, a);
  fq12_inv(r, f);
  fq12_to_be(r, out);
  return 0;
}

int bn254_fq12_exp_u(const uint8_t a[384], uint8_t out[384]) {
  Fq12 f, r;
  fq12_from_be(f, a);
  exp_u(r, f);
  fq12_to_be(r, out);
  return 0;
}

// prod_i e(P_i, Q_i) as a full Fq12 value (shared final exponentiation) —
// the native `pairing_batch` (reference ecdsa.rs:57,86 semantics).
int bn254_pairing_product(const uint8_t *ps, const uint8_t *qs,
                          const uint8_t *infs, uint64_t n, uint8_t out[384]) {
  Fq12 acc = fq12_one();
  for (uint64_t i = 0; i < n; ++i) {
    if (infs && (infs[i] & 3)) continue;
    Fq xp, yp;
    fq_from_be(xp, ps + 64 * i);
    fq_from_be(yp, ps + 64 * i + 32);
    Fq2 qx, qy;
    fq_from_be(qx.c0, qs + 128 * i);
    fq_from_be(qx.c1, qs + 128 * i + 32);
    fq_from_be(qy.c0, qs + 128 * i + 64);
    fq_from_be(qy.c1, qs + 128 * i + 96);
    Fq12 f;
    miller_loop(f, xp, yp, qx, qy);
    fq12_mul(acc, acc, f);
  }
  Fq12 r;
  final_exp(r, acc);
  fq12_to_be(r, out);
  return 0;
}

// prod_i e(P_i, Q_i) == 1 with one shared final exponentiation.
// ps: n*64 bytes; qs: n*128 bytes; infs: n bytes, bit0 = P_i at infinity,
// bit1 = Q_i at infinity. Returns 1 if the product equals one.
int bn254_pairing_check(const uint8_t *ps, const uint8_t *qs,
                        const uint8_t *infs, uint64_t n) {
  Fq12 acc = fq12_one();
  for (uint64_t i = 0; i < n; ++i) {
    if (infs && (infs[i] & 3)) continue;  // pairing with identity = 1
    Fq xp, yp;
    fq_from_be(xp, ps + 64 * i);
    fq_from_be(yp, ps + 64 * i + 32);
    Fq2 qx, qy;
    fq_from_be(qx.c0, qs + 128 * i);
    fq_from_be(qx.c1, qs + 128 * i + 32);
    fq_from_be(qy.c0, qs + 128 * i + 64);
    fq_from_be(qy.c1, qs + 128 * i + 96);
    Fq12 f;
    miller_loop(f, xp, yp, qx, qy);
    fq12_mul(acc, acc, f);
  }
  Fq12 r;
  final_exp(r, acc);
  return fq12_is_one(r) ? 1 : 0;
}

// SHA-256 try-and-increment hash to G1 (bit-exact with reference hash.rs:29-63
// semantics: ctr byte appended, reject digests >= 5p, reduce mod p with the
// `>`-loop quirk, decompress with even y). Returns the ctr used (0..254),
// or -1 if all 255 candidates fail.
int bn254_hash_to_g1(const uint8_t *msg, uint64_t len, uint8_t out[64]) {
  // v = msg || ctr
  uint8_t stack_buf[512];
  uint8_t *v = stack_buf;
  uint8_t *heap = nullptr;
  if (len + 1 > sizeof(stack_buf)) {
    heap = new uint8_t[len + 1];
    v = heap;
  }
  memcpy(v, msg, len);
  int found = -1;
  for (int ctr = 0; ctr <= 254 && found < 0; ++ctr) {
    v[len] = (uint8_t)ctr;
    uint8_t digest[32];
    sha256(v, len + 1, digest);
    U256 x;
    u256_from_be(x, digest);
    if (!u256_lt(x, FIVE_P)) continue;  // rejection sampling (>= 5p)
    // mod_u256 with `>` loop: value exactly p is NOT reduced
    // (utils.rs:27-37 quirk); such a value then fails decompression.
    while (u256_lt(P_MOD, x)) u256_sub(x, P_MOD);
    if (u256_eq(x, P_MOD)) continue;  // x == p: not a valid Fq element
    // decompress with even y: y = sqrt(x^3 + 3), take even
    Fq fx, rhs, y;
    fq_from_u256(fx, x);
    Fq x2, x3c;
    fq_sqr(x2, fx);
    fq_mul(x3c, x2, fx);
    Fq three;
    fq_mul_small(three, fq_one(), 3);
    fq_add(rhs, x3c, three);
    if (!fq_sqrt(y, rhs)) continue;
    U256 ycan;
    fq_to_u256(ycan, y);
    if (ycan.w[0] & 1) {  // want even y (0x02 prefix)
      Fq ny;
      fq_neg(ny, y);
      y = ny;
    }
    u256_to_be(x, out);
    fq_to_be(y, out + 32);
    found = ctr;
  }
  if (heap) delete[] heap;
  return found;
}

// sign: out = [sk] H(msg). Returns ctr (>=0) on success, -1 on hash failure.
int bn254_sign(const uint8_t *msg, uint64_t len, const uint8_t sk_be[32],
               uint8_t out[64]) {
  uint8_t h[64];
  int ctr = bn254_hash_to_g1(msg, len, h);
  if (ctr < 0) return -1;
  bn254_g1_mul(h, 0, sk_be, out);
  return ctr;
}

// verify: e(H(m), pk) * e(-sig, g2) == 1.
// Returns 1 valid, 0 invalid, -1 hash failure.
int bn254_verify(const uint8_t *msg, uint64_t len, const uint8_t sig[64],
                 int sig_inf, const uint8_t pk[128], int pk_inf) {
  uint8_t h[64];
  if (bn254_hash_to_g1(msg, len, h) < 0) return -1;
  // -G2::one: negate sig instead (e(-sig, g2) == e(sig, -g2))
  uint8_t nsig[64];
  if (!sig_inf) {
    memcpy(nsig, sig, 32);
    Fq y, ny;
    fq_from_be(y, sig + 32);
    fq_neg(ny, y);
    fq_to_be(ny, nsig + 32);
  }
  // standard G2 generator
  static const char *gx0 =
      "1800deef121f1e76426a00665e5c4479674322d4f75edadd46debd5cd992f6ed";
  (void)gx0;
  uint8_t ps[128], qs[256], infs[2];
  memcpy(ps, h, 64);
  memcpy(ps + 64, nsig, sig_inf ? 0 : 64);
  // G2 generator bytes (x.re, x.im, y.re, y.im) big-endian
  static const uint8_t G2_GEN_BE[128] = {
      // x.c0
      0x18, 0x00, 0xde, 0xef, 0x12, 0x1f, 0x1e, 0x76, 0x42, 0x6a, 0x00, 0x66,
      0x5e, 0x5c, 0x44, 0x79, 0x67, 0x43, 0x22, 0xd4, 0xf7, 0x5e, 0xda, 0xdd,
      0x46, 0xde, 0xbd, 0x5c, 0xd9, 0x92, 0xf6, 0xed,
      // x.c1
      0x19, 0x8e, 0x93, 0x93, 0x92, 0x0d, 0x48, 0x3a, 0x72, 0x60, 0xbf, 0xb7,
      0x31, 0xfb, 0x5d, 0x25, 0xf1, 0xaa, 0x49, 0x33, 0x35, 0xa9, 0xe7, 0x12,
      0x97, 0xe4, 0x85, 0xb7, 0xae, 0xf3, 0x12, 0xc2,
      // y.c0
      0x12, 0xc8, 0x5e, 0xa5, 0xdb, 0x8c, 0x6d, 0xeb, 0x4a, 0xab, 0x71, 0x80,
      0x8d, 0xcb, 0x40, 0x8f, 0xe3, 0xd1, 0xe7, 0x69, 0x0c, 0x43, 0xd3, 0x7b,
      0x4c, 0xe6, 0xcc, 0x01, 0x66, 0xfa, 0x7d, 0xaa,
      // y.c1
      0x09, 0x06, 0x89, 0xd0, 0x58, 0x5f, 0xf0, 0x75, 0xec, 0x9e, 0x99, 0xad,
      0x69, 0x0c, 0x33, 0x95, 0xbc, 0x4b, 0x31, 0x33, 0x70, 0xb3, 0x8e, 0xf3,
      0x55, 0xac, 0xda, 0xdc, 0xd1, 0x22, 0x97, 0x5b};
  memcpy(qs, pk, 128);
  memcpy(qs + 128, G2_GEN_BE, 128);
  infs[0] = (uint8_t)(pk_inf ? 2 : 0);
  infs[1] = (uint8_t)(sig_inf ? 1 : 0);
  return bn254_pairing_check(ps, qs, infs, 2);
}

// G2 decompression support: sqrt in Fq2. Input: x (64B BE re||im).
// Output: y (64B). Returns 1 on success, 0 if x^3 + b has no sqrt.
int bn254_g2_y_from_x(const uint8_t x_be[64], uint8_t y_out[64]) {
  Fq2 x, x3, rhs, y;
  fq_from_be(x.c0, x_be);
  fq_from_be(x.c1, x_be + 32);
  fq2_sqr(x3, x);
  fq2_mul(x3, x3, x);
  // b2 = 3/xi
  Fq2 xi, xi_inv, b2;
  {
    U256 nine = {{9, 0, 0, 0}}, one = {{1, 0, 0, 0}};
    fq_from_u256(xi.c0, nine);
    fq_from_u256(xi.c1, one);
  }
  fq2_inv(xi_inv, xi);
  Fq three;
  fq_mul_small(three, fq_one(), 3);
  fq2_mul_fq(b2, xi_inv, three);
  fq2_add(rhs, x3, b2);
  if (!fq2_sqrt(y, rhs)) return 0;
  fq_to_be(y.c0, y_out);
  fq_to_be(y.c1, y_out + 32);
  return 1;
}

// [r]P == identity subgroup check for G2 (r = group order).
int bn254_g2_in_subgroup(const uint8_t b[128]) {
  Jac<Fq2> p, r;
  g2_from_be(p, b, 0);
  U256 order = FR_MOD;
  jac_scalar_mul(r, p, order);
  return jac_is_identity(r) ? 1 : 0;
}

int bn254_g1_on_curve(const uint8_t xy[64]) {
  Fq x, y, x3, y2, rhs, three;
  fq_from_be(x, xy);
  fq_from_be(y, xy + 32);
  fq_sqr(x3, x);
  fq_mul(x3, x3, x);
  fq_mul_small(three, fq_one(), 3);
  fq_add(rhs, x3, three);
  fq_sqr(y2, y);
  return fq_eq(y2, rhs) ? 1 : 0;
}

int bn254_g2_on_curve(const uint8_t b[128]) {
  Fq2 x, y, x3, y2, rhs, xi, xi_inv, b2;
  fq_from_be(x.c0, b);
  fq_from_be(x.c1, b + 32);
  fq_from_be(y.c0, b + 64);
  fq_from_be(y.c1, b + 96);
  fq2_sqr(x3, x);
  fq2_mul(x3, x3, x);
  {
    U256 nine = {{9, 0, 0, 0}}, one = {{1, 0, 0, 0}};
    fq_from_u256(xi.c0, nine);
    fq_from_u256(xi.c1, one);
  }
  fq2_inv(xi_inv, xi);
  Fq three;
  fq_mul_small(three, fq_one(), 3);
  fq2_mul_fq(b2, xi_inv, three);
  fq2_add(rhs, x3, b2);
  fq2_sqr(y2, y);
  return fq2_eq(y2, rhs) ? 1 : 0;
}

}  // extern "C"
