"""Multi-host mesh construction and distributed initialisation.

SURVEY.md §5.8's communication backend: `jax.distributed`
for process bootstrap, a process-spanning `jax.sharding.Mesh` over the
global device set, and global-array construction so the sharded verifier
(dist/batch_verify.py) runs unchanged across hosts — shard-local Miller
loops on each host's cards, the Fq12-product all-reduce across them,
one shared final exponentiation.

The reference is a single-process library (no MPI/NCCL anywhere); this
whole layer is new-build territory scaled out from `pairing_batch`'s
product-then-one-final-exp structure (reference src/ecdsa.rs:57).

Works on multi-GPU hosts and on multi-process CPU clusters
(gloo collectives) — the latter is how CI proves the machinery without
hardware (tests/test_multiprocess.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from ..config import Config
from ..errors import InvalidLengthError


def initialize(cfg: Config | None = None, **overrides) -> bool:
    """Initialise `jax.distributed` from a Config (or kwargs).

    Returns True if a multi-process cluster was initialised, False for
    the single-process no-op. On CPU backends the gloo collectives
    implementation is selected (XLA's default CPU runtime has no
    cross-process collectives).

    Call before any other JAX API touches the backend. Safe to call in
    single-process mode (num_processes == 1): does nothing.
    """
    cfg = (cfg or Config.from_env()).replace(**overrides)
    if not cfg.coordinator_address or cfg.num_processes <= 1:
        return False
    try:
        # required for CPU multi-process collectives; harmless elsewhere
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(
        coordinator_address=cfg.coordinator_address,
        num_processes=cfg.num_processes,
        process_id=cfg.process_id,
    )
    return True


def make_mesh(
    n_devices: int | None = None, axis_name: str = "batch"
) -> Mesh:
    """1-D batch mesh over the GLOBAL device set (all processes).

    On a multi-host slice `jax.devices()` already enumerates every
    process's chips, so the same call builds the process-spanning mesh.
    """
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    if n < 1 or n > len(devs):
        raise InvalidLengthError(
            f"need 1..{len(devs)} devices, asked for {n}"
        )
    return Mesh(np.array(devs[:n]), axis_names=(axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = "batch") -> NamedSharding:
    """Sharding for (18, B) limb tensors: batch dim over the mesh axis."""
    return NamedSharding(mesh, PSpec(None, axis_name))


def shard_tree(tree, mesh: Mesh, axis_name: str = "batch"):
    """device_put a pytree of (limbs, batch) tensors with batch sharding.

    In multi-process runs every process must hold the SAME full-batch
    host values (the usual SPMD input contract); device_put then places
    each process's addressable shards. Works identically (and cheaply)
    in single-process mode.
    """
    return jax.device_put(tree, batch_sharding(mesh, axis_name))


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def process_info() -> tuple[int, int]:
    """(process_id, process_count)."""
    return jax.process_index(), jax.process_count()
