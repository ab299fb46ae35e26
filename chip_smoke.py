#!/usr/bin/env python
"""Smoke run of BLS batch verification on NVIDIA GPUs.

Drives the main path once through the entry points a user calls
(`api.batch_verify`) at the headline width — 8192 (message, signature,
public key) tuples, adaptive tier — and checks what comes out:

  1. the card (`nvidia-smi`), the JAX version and the backend decision;
     exits non-zero when JAX finds no GPU (there is no CPU fallback);
  2. field and pairing arithmetic at 8192 lanes, bit-exact against the
     pure-Python host oracle: a dependent fq12_mul chain, and one
     Miller loop + final exponentiation;
  3. `api.batch_verify(mode="adaptive")` on a valid batch of 8192: all
     True; the same batch with one forged tuple through mode="fused":
     False;
  4. mode="independent" at 64 tuples with one forged tuple: exactly that
     tuple False;
  5. one summary line: warm verifications/s of phase 3, cold (compile +
     first run) seconds per phase, peak device memory, card and power
     limit.

With `--four` it runs only the path users depend on across cards: the
mesh-sharded fused verifier over four GPUs (8192 tuples per card), a
valid and a tampered batch, each verdict compared with the same batch's
fused check on one card.

Any failed check exits non-zero at once. The last line of standard
output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Usage:  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

HEADLINE_B = 8192  # adaptive tier, BASELINE config 4 width
INDEP_B = 64  # BASELINE config 3
PER_CARD = 8192  # --four: tuples per card
FQ12_CHAIN = 4  # dependent fq12_muls in the field check
DISTINCT = 64  # distinct oracle inputs, tiled across the lanes
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    """Stop at the first failed check (non-zero exit, no result line)."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` output, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def require_gpu(devices, count: int = 1) -> None:
    """Refuse anything but `count` GPUs: no CPU fallback."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        fail(f"JAX found no GPU (device platform: {plat})")
    if len(devices) < count:
        fail(f"need {count} GPUs, JAX found {len(devices)}")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
    })


class Phases:
    """Wall seconds of each phase's first (cold: compile + run) call."""

    def __init__(self):
        self.cold: dict[str, float] = {}

    def timed(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        import jax

        out = jax.block_until_ready(out)
        self.cold[name] = round(time.perf_counter() - t0, 2)
        log(f"[{name}] cold {self.cold[name]} s")
        return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


def make_tuples(n: int, seed: int):
    """n valid (message, Signature, PublicKey) tuples from a seed."""
    from bn254_tpu.constants import R
    from bn254_tpu.hash.tai import hash_to_g1
    from bn254_tpu.host import curve as HC
    from bn254_tpu.protocol.types import PublicKey, Signature

    rng = random.Random(seed)
    msgs = [b"chip-smoke-%d-%06d" % (seed, i) for i in range(n)]
    sks = [rng.randrange(1, R) for _ in range(n)]
    sigs = [Signature(HC.g1_mul(hash_to_g1(m), k)) for m, k in zip(msgs, sks)]
    pks = [PublicKey(HC.g2_mul(HC.G2_ONE, k)) for k in sks]
    return msgs, sigs, pks


def forge(sigs, j: int):
    """Copy of `sigs` with tuple j's signature replaced by tuple j+1's (a
    valid curve point, signed over another message)."""
    out = list(sigs)
    out[j] = sigs[j + 1]
    return out


def _fq12_to_device(hs, lanes: int):
    """Host Fq12 values -> device Fq12 of `lanes` lanes (lane i = hs[i % len])."""
    from bn254_tpu.fields import limbs as L
    from bn254_tpu.fields import tower as T
    from bn254_tpu.utils.convert import _host_to_mont

    idx = [i % len(hs) for i in range(lanes)]

    def el(get):
        return L.from_ints([_host_to_mont(get(hs[i])) for i in idx], vmax=L.P)

    return T.Fq12(*[
        T.Fq6(*[
            T.Fq2(el(lambda h, a=a, b=b: h[a][b][0]),
                  el(lambda h, a=a, b=b: h[a][b][1]))
            for b in range(3)
        ])
        for a in range(2)
    ])


def _fq12_lanes(dev):
    """Device Fq12 -> list of host Fq12 tuples, one per lane."""
    from bn254_tpu.fields import tower as T

    h = T.fq12_to_host(dev)
    n = len(h[0][0][0])
    return [
        tuple(tuple((int(h[a][b][0][i]), int(h[a][b][1][i])) for b in range(3))
              for a in range(2))
        for i in range(n)
    ]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_field(ph: Phases) -> None:
    import jax

    from bn254_tpu.constants import P
    from bn254_tpu.fields import tower as T
    from bn254_tpu.host import field as HF

    rng = random.Random(SEED)

    def rnd12():
        return tuple(tuple((rng.randrange(P), rng.randrange(P))
                           for _ in range(3)) for _ in range(2))

    a_h = [rnd12() for _ in range(DISTINCT)]
    b_h = [rnd12() for _ in range(DISTINCT)]
    want = []
    for a, b in zip(a_h, b_h):
        for _ in range(FQ12_CHAIN):
            a = HF.fq12_mul(a, b)
        want.append(a)

    @jax.jit
    def chain(a, b):
        for _ in range(FQ12_CHAIN):
            a = T.fq12_retag(T.fq12_mul(a, b))
        return a

    a_d = T.fq12_retag(_fq12_to_device(a_h, HEADLINE_B))
    b_d = T.fq12_retag(_fq12_to_device(b_h, HEADLINE_B))
    got = _fq12_lanes(ph.timed("fq12_chain", chain, a_d, b_d))
    bad = [i for i, g in enumerate(got) if g != want[i % DISTINCT]]
    check(not bad, f"fq12_mul chain differs from the host oracle in "
          f"{len(bad)} of {HEADLINE_B} lanes (first: {bad[:4]})")
    log(f"fq12_mul chain x{FQ12_CHAIN}: {HEADLINE_B} lanes bit-exact "
        "vs host oracle")


def phase_pairing(ph: Phases) -> None:
    from bn254_tpu.host import curve as HC
    from bn254_tpu.host import pairing as HP
    from bn254_tpu.pairing import final_exp as FE
    from bn254_tpu.pairing import pairing as DP
    from bn254_tpu.utils import convert as CV

    rng = random.Random(SEED + 1)
    k = 4  # distinct pairs: the pure-Python oracle pairing is slow
    g1 = [HC.g1_mul(HC.G1_ONE, rng.randrange(1, 1 << 64)) for _ in range(k)]
    g2 = [HC.g2_mul(HC.G2_ONE, rng.randrange(1, 1 << 64)) for _ in range(k)]
    want = [HP.pairing_batch_py([(p, q)]) for p, q in zip(g1, g2)]

    lanes = [i % k for i in range(HEADLINE_B)]
    px, py = CV.g1_batch_to_device_affine([g1[i] for i in lanes])
    qx, qy = CV.g2_batch_to_device_affine([g2[i] for i in lanes])

    def pairing(px, py, qx, qy):
        return FE.final_exp_staged(DP._miller_jit(px, py, qx, qy))

    got = _fq12_lanes(ph.timed("miller_final_exp", pairing, px, py, qx, qy))
    bad = [i for i, g in enumerate(got) if not HP.gt_eq(g, want[i % k])]
    check(not bad, f"Miller loop + final exp differ from the host oracle "
          f"in {len(bad)} of {HEADLINE_B} lanes (first: {bad[:4]})")
    log(f"Miller loop + final exp: {HEADLINE_B} lanes bit-exact vs host "
        "oracle")


def phase_adaptive(ph: Phases, msgs, sigs, pks) -> float:
    import numpy as np

    from bn254_tpu import api

    B = len(msgs)
    ok = ph.timed("adaptive", api.batch_verify, msgs, sigs, pks,
                  mode="adaptive")
    check(isinstance(ok, np.ndarray) and ok.shape == (B,) and bool(ok.all()),
          f"adaptive: valid batch of {B} not all True")
    t0 = time.perf_counter()
    ok = api.batch_verify(msgs, sigs, pks, mode="adaptive")
    warm = time.perf_counter() - t0
    check(bool(np.asarray(ok).all()), "adaptive (warm): valid batch rejected")
    log(f"adaptive B={B}: all {B} valid; warm {warm:.3f} s")

    forged = forge(sigs, B // 2)
    bad = ph.timed("fused_forged", api.batch_verify, msgs, forged, pks,
                   mode="fused")
    check(bad is False, f"fused: batch with a forged tuple returned {bad!r}")
    log(f"fused B={B}: forged tuple {B // 2} rejected")
    return B / warm


def phase_independent(ph: Phases, msgs, sigs, pks) -> None:
    import numpy as np

    from bn254_tpu import api

    j = 5
    ok = ph.timed("independent", api.batch_verify, msgs, forge(sigs, j), pks,
                  mode="independent")
    ok = np.asarray(ok)
    want = np.ones(len(msgs), bool)
    want[j] = False
    check(ok.shape == want.shape and bool((ok == want).all()),
          f"independent: expected only tuple {j} False, got False at "
          f"{np.flatnonzero(~ok).tolist()}")
    log(f"independent B={len(msgs)}: exactly tuple {j} rejected")


def phase_four(ph: Phases) -> None:
    """make_sharded_verifier over a 4-card mesh vs the one-card fused check."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from bn254_tpu.dist import batch_verify as BV
    from bn254_tpu.hash.tai import hash_to_g1
    from bn254_tpu.utils import convert as CV

    n_dev = 4
    B = PER_CARD * n_dev
    msgs, sigs, pks = make_tuples(B, SEED + 4)
    hx, hy = CV.g1_batch_to_device_affine([hash_to_g1(m) for m in msgs])
    pqx, pqy = CV.g2_batch_to_device_affine([k.point for k in pks])
    w = BV.random_weights(B)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("batch",))
    run = BV.make_sharded_verifier(mesh, "batch")

    for name, batch_sigs, expect in (
        ("valid", sigs, True),
        ("tampered", forge(sigs, B // 3), False),
    ):
        sx, sy = CV.g1_batch_to_device_affine([s.point for s in batch_sigs])
        got4 = bool(ph.timed(f"sharded_{name}", run,
                             hx, hy, sx, sy, pqx, pqy, w))
        got1 = bool(ph.timed(f"one_card_fused_{name}",
                             BV.verify_batch_fused_staged,
                             hx, hy, sx, sy, pqx, pqy, w))
        check(got4 is expect, f"sharded {name} batch of {B}: got {got4}")
        check(got4 == got1, f"sharded ({got4}) and one-card fused ({got1}) "
              f"verdicts differ on the {name} batch")
        log(f"sharded over {n_dev} cards, B={B} ({PER_CARD}/card): "
            f"{name} -> {got4}, matches the one-card fused check")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded verifier over four GPUs")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from bn254_tpu import config as C
    from bn254_tpu.utils.jcache import enable

    devices = jax.devices()
    count = 4 if args.four else 1
    require_gpu(devices, count)
    cards = card_lines()
    for line in cards:
        log(line)
    log(f"jax {jax.__version__}; platform {C.platform()}; "
        f"compile cache: {enable()}")

    ph = Phases()
    summary = {}
    if args.four:
        phase_four(ph)
    else:
        phase_field(ph)
        phase_pairing(ph)
        t0 = time.perf_counter()
        msgs, sigs, pks = make_tuples(HEADLINE_B, SEED)
        log(f"host fixture: {HEADLINE_B} tuples in "
            f"{time.perf_counter() - t0:.1f} s")
        summary["adaptive_verifications_per_s"] = round(
            phase_adaptive(ph, msgs, sigs, pks), 1)
        phase_independent(ph, msgs[:INDEP_B], sigs[:INDEP_B], pks[:INDEP_B])

    stats = devices[0].memory_stats() or {}
    summary.update({
        "cold_s": ph.cold,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "card": cards[:count],
    })
    log("summary " + json.dumps(summary))
    print(result_line(devices[:count]), flush=True)


if __name__ == "__main__":
    main()
