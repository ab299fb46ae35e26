"""High-level batched device API: sign / verify at device throughput.

Bridges protocol objects (Python-int points) and the device pipeline
(Montgomery limb tensors). These are the workloads behind the benchmark
configs (BASELINE.md): batch-64 independent verifies, batch-8192 fused
aggregate verification, and the mesh-sharded variants in `dist`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .curve import g1 as DG1
from .curve import jacobian as J
from .dist import batch_verify as BV
from .fields import limbs as L
from .hash.tai_batch import hash_to_g1_device
from .host import curve as HC
from .protocol.types import PrivateKey, PublicKey, Signature
from .utils import convert as CV


@jax.jit
def _batch_sign_kernel(hx: L.El, hy: L.El, scalars: L.El):
    """[sk_i] H(m_i) for a batch: fixed-ladder scalar mul + affine-ise."""
    h = J.JPoint(hx, hy, L.mont_one(hx.batch_shape))
    sig = DG1.scalar_mul(h, scalars)
    sx, sy, inf = DG1.to_affine(sig)
    return sx, sy, inf


def batch_sign(messages: list[bytes], private_keys: list[PrivateKey]):
    """Sign a batch of equal-length messages on device. Returns Signatures.

    Device pipeline: batched SHA-256 try-and-increment (masked K-candidate
    search) then a batched 256-step scalar ladder. Bit-exact with
    `ECDSA.sign` per message.
    """
    assert len(messages) == len(private_keys)
    hx, hy = hash_to_g1_device(messages)
    sk = CV.scalars_to_device([k.scalar for k in private_keys])
    sx, sy, inf = _batch_sign_kernel(hx, hy, sk)
    xs = L.to_ints(L.from_mont(sx))
    ys = L.to_ints(L.from_mont(sy))
    infs = np.asarray(inf)
    out = []
    for j in range(len(messages)):
        point = (
            HC.G1_IDENTITY
            if infs[j]
            else HC.g1_from_affine((int(xs[j]), int(ys[j])))
        )
        out.append(Signature(point))
    return out


_verify_indep_jit = BV.verify_batch_independent_staged
_verify_fused_jit = BV.verify_batch_fused_staged


def batch_verify(
    messages: list[bytes],
    signatures: list[Signature],
    public_keys: list[PublicKey],
    mode: str = "independent",
    config=None,
):
    """Verify a batch of (message, signature, public key) tuples on device.

    mode="independent": per-tuple accept/reject (np.ndarray of bool),
    exactly matching reference `verify` semantics tuple-by-tuple.
    mode="fused": ONE combined check with random linear-combination
    weights and a single shared final exponentiation (returns scalar
    bool: all-valid). Sound: a forged tuple passes only with probability
    ~2^-rlc_bits over the weight draw (weights are drawn in GLV form —
    same soundness, half the ladder steps; see curve/glv.py).
    config: a config.Config (hash-search width, RLC bits, staging);
    defaults to config.DEFAULT.
    """
    from . import config as CFG

    cfg = config or CFG.DEFAULT
    n = len(messages)
    assert len(signatures) == n and len(public_keys) == n
    hx, hy = hash_to_g1_device(messages, cfg.k_candidates)
    sx, sy = CV.g1_batch_to_device_affine([s.point for s in signatures])
    pqx, pqy = CV.g2_batch_to_device_affine([k.point for k in public_keys])
    if mode == "independent":
        fn = _verify_indep_jit if cfg.staged else BV.verify_batch_independent
        return np.asarray(fn(hx, hy, sx, sy, pqx, pqy))
    elif mode == "adaptive":
        # per-tuple bools; fused-tier cost when all tuples are valid
        # (falls back to the exact independent tier on rejection — see
        # BV.verify_batch_adaptive for the 2^-rlc_bits caveat). Weights
        # follow cfg.glv_weights like mode="fused".
        if cfg.glv_weights:
            w = BV.random_weights(n, cfg.rlc_bits)
        else:
            w = BV.random_weights_plain(n, cfg.rlc_bits)
        return np.asarray(
            BV.verify_batch_adaptive(
                hx, hy, sx, sy, pqx, pqy, weights=w, nbits=cfg.rlc_bits
            )
        )
    elif mode == "fused":
        if cfg.glv_weights:
            w = BV.random_weights(n, cfg.rlc_bits)
        else:
            w = BV.random_weights_plain(n, cfg.rlc_bits)
        fn = _verify_fused_jit if cfg.staged else BV.verify_batch_fused
        return bool(fn(hx, hy, sx, sy, pqx, pqy, w, nbits=cfg.rlc_bits))
    raise ValueError(f"unknown mode {mode!r}")


def aggregate_signatures(signatures: list[Signature]) -> Signature:
    """Tree-aggregate signatures (sum in G1)."""
    pts = [s.point for s in signatures]
    acc = HC.G1_IDENTITY
    for p in pts:
        acc = HC.g1_add(acc, p)
    return Signature(acc)


def aggregate_public_keys(public_keys: list[PublicKey]) -> PublicKey:
    """Tree-aggregate public keys (sum in G2)."""
    acc = HC.G2_IDENTITY
    for k in public_keys:
        acc = HC.g2_add(acc, k.point)
    return PublicKey(acc)


def batch_check_public_keys(public_keys_g2, public_keys_g1):
    """Batched G2<->G1 key-consistency check (reference `check_public_keys`,
    /root/reference/src/ecdsa.rs:78-93): e(G1::one, PK2_i) * e(-PK1_i,
    G2::one) == 1 per pair. Returns np.ndarray of bool, one per pair.
    """
    from .fields import tower as T
    from .pairing import pairing as DP

    n = len(public_keys_g2)
    assert len(public_keys_g1) == n
    B = (n,)
    g1x, g1y = CV.g1_batch_to_device_affine(
        [HC.g1_neg(k.point) for k in public_keys_g1]
    )
    pqx, pqy = CV.g2_batch_to_device_affine([k.point for k in public_keys_g2])

    onex_j, oney_j = CV.g1_batch_to_device_affine([HC.G1_ONE])
    onex = L.bcast_to(L.elmap(lambda a: a[:, 0], onex_j), B)
    oney = L.bcast_to(L.elmap(lambda a: a[:, 0], oney_j), B)

    g2x, g2y = CV.g2_const_affine(HC.G2_ONE, B)
    px = L.stack([onex, g1x])
    py = L.stack([oney, g1y])
    qx = T.fq2_stack([pqx, g2x])
    qy = T.fq2_stack([pqy, g2y])
    return np.asarray(DP.pairing_check_staged(px, py, qx, qy))
