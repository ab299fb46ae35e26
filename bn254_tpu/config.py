"""Framework configuration (SURVEY.md §5.6).

One frozen dataclass for every tunable the framework exposes — batch
size, hash-search width, RLC weight width, staging —
replacing scattered env vars and kwargs. Env vars are still honoured as
*defaults* (`Config.from_env`) so ops overrides work without code
changes, but all call sites consume a Config.

The backend decision lives here too (`platform`): every code path that
differs between the CPU and the GPU asks it. The field engine itself
takes one form everywhere (`lax.scan` carry chains and CIOS steps); the
straight-line forms that XLA:GPU compiled without bound were removed
(PERF.md, H100 bring-up).

The reference's only config surface is a cargo feature flag
(reference Cargo.toml:15-17); everything here is new-build territory.
"""

from __future__ import annotations

import dataclasses
import os


def platform() -> str:
    """The platform JAX runs on ("cpu", "gpu", "cuda", ...).

    The one backend decision: the persistent compile cache (disabled on
    the CPU) and the bench's parallel AOT prewarm (accelerators only)
    branch on it.

    Read from the `jax_platforms` setting (or `JAX_PLATFORMS`) when one
    is named, which does NOT initialise the XLA backend — so it is safe
    before `jax.distributed.initialize()` in multi-process workers. Only
    when neither names a platform does it ask `jax.default_backend()`,
    which initialises the backend; callers therefore ask lazily (at
    trace time), never at import.
    """
    import jax

    plat = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    plat = plat.split(",")[0].strip().lower()
    return plat or jax.default_backend()


@dataclasses.dataclass(frozen=True)
class Config:
    """Knobs for the batched/sharded verification pipeline."""

    # hash-to-G1: device candidate-counters per message (SURVEY §3.5);
    # miss probability ~2^-K with host fallback for the remainder.
    k_candidates: int = 8

    # random-linear-combination weight width (bits) for fused batch
    # verification; forgery slips through with probability ~2^-bits.
    rlc_bits: int = 128

    # draw RLC weights in GLV form w = a + λb (curve/glv.py): same
    # ~2^-rlc_bits soundness, HALF the weight-ladder steps (a joint
    # Shamir ladder over {P, φP, P+φP}). Mirrors BN254_DISABLE_GLV.
    glv_weights: bool = True

    # staged pipelines (several small jitted programs) vs one monolithic
    # program; staging compiles the pairing pipeline far faster.
    staged: bool = True

    # mesh axis name used by the sharded verifier and collectives.
    axis_name: str = "batch"

    # multi-host (jax.distributed) settings; None = single-process.
    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Defaults from the environment, then explicit overrides."""
        env = {}
        if os.environ.get("BN254_K_CANDIDATES"):
            env["k_candidates"] = int(os.environ["BN254_K_CANDIDATES"])
        if os.environ.get("BN254_RLC_BITS"):
            env["rlc_bits"] = int(os.environ["BN254_RLC_BITS"])
        if os.environ.get("BN254_DISABLE_GLV"):
            env["glv_weights"] = False
        if os.environ.get("BN254_COORDINATOR"):
            env["coordinator_address"] = os.environ["BN254_COORDINATOR"]
            env["num_processes"] = int(os.environ.get("BN254_NUM_PROCESSES", "1"))
            env["process_id"] = int(os.environ.get("BN254_PROCESS_ID", "0"))
        env.update(overrides)
        return cls(**env)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config.from_env()
