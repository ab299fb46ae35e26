#!/usr/bin/env python
"""Batched BLS verification on a GPU (the throughput workload).

Builds a batch of (message, signature, public key) tuples host-side (native
C++ core), moves them to the device as Montgomery limb tensors, and runs
the staged device pipeline: batched Miller loops, pair-product reduction, and
final exponentiations. Demonstrates both modes:

  * independent — per-tuple accept/reject (exact reference `verify`
    semantics tuple by tuple)
  * fused — one combined product check with random linear-combination
    weights and a single shared final exponentiation

Run on CPU with JAX_PLATFORMS=cpu for a quick functional check.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bn254_tpu import ECDSA, PrivateKey, PublicKey, api  # noqa: E402


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    messages = [b"message-%05d" % i for i in range(n)]
    keys = [PrivateKey(0x1234567 + 977 * i) for i in range(n)]
    pks = [PublicKey.from_private_key(k) for k in keys]

    t0 = time.time()
    sigs = [ECDSA.sign(m, k) for m, k in zip(messages, keys)]
    print(f"signed {n} messages host-side in {time.time() - t0:.2f}s")

    t0 = time.time()
    ok = api.batch_verify(messages, sigs, pks, mode="independent")
    print(f"independent batch verify: all={ok.all()} "
          f"({time.time() - t0:.2f}s incl. compile)")

    t0 = time.time()
    ok_fused = api.batch_verify(messages, sigs, pks, mode="fused")
    print(f"fused batch verify: {ok_fused} ({time.time() - t0:.2f}s)")

    # a tampered signature must be caught
    bad_sigs = list(sigs)
    bad_sigs[3] = sigs[4]
    ok = api.batch_verify(messages, bad_sigs, pks, mode="independent")
    assert not ok[3] and ok.sum() == n - 1
    assert not api.batch_verify(messages, bad_sigs, pks, mode="fused")
    print("tampered tuple correctly rejected in both modes")


if __name__ == "__main__":
    main()
