"""Persistent XLA compilation cache: location, hygiene, crash-safety.

The pairing programs take minutes to compile cold; the persistent cache
makes warm restarts take seconds.

* **Location.** If `JAX_COMPILATION_CACHE_DIR` is set, JAX uses exactly
  that directory and this module sets no other. Otherwise the cache
  lives at the fixed in-checkout path `.jax_cache/<platform>-jax<version>`
  (gitignored): the path is part of what makes a later process find the
  entries again, so it never depends on a pid, a time or a temp dir, and
  executables of different backends or JAX versions never meet.
* **CPU: disabled.** Persisted XLA:CPU executables are AOT machine code
  whose deserialisation has crashed test sessions (see `enable`); CPU
  runs rely on JAX's in-memory cache.
* **Atomic cache writes** — stock `LRUCache.put` calls
  `Path.write_bytes` directly, so a run killed mid-write leaves a
  truncated file that poisons every later session. `enable()` patches
  `put` to write a temp file in the same directory and `os.replace` it
  into place: readers see either the old state or the complete entry.
* **Size cap with LRU eviction** (`jax_compilation_cache_max_size`).
* **Corrupt-entry tolerance** — `get_executable_and_time` is wrapped:
  any exception while reading/decompressing/deserializing an entry
  EVICTS that entry and falls back to a cache miss (recompile) instead
  of killing the session. (`jax_raise_persistent_cache_errors` is also
  forced off.)
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

_MAX_BYTES = 16 << 30

ENV_DIR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory the persistent cache uses (see module docstring)."""
    import jax

    from .. import config as C

    if os.environ.get(ENV_DIR):
        return os.environ[ENV_DIR]
    return os.path.join(
        _REPO, ".jax_cache", f"{C.platform()}-jax{jax.__version__}"
    )


_patched = False


def _patch_cache_robustness() -> None:
    """Atomic writes + evict-on-corrupt-read for jax's persistent cache."""
    global _patched
    if _patched:
        return
    _patched = True

    import inspect
    import threading

    from jax._src import compilation_cache as cc
    from jax._src import lru_cache as lc

    # Pin the patched private signatures: on a jax upgrade a
    # silent drift would make every wrapped call fail, which the broad
    # except below would misread as per-entry corruption — evicting the
    # whole cache and recompiling cold each session with no visible
    # error. Fail LOUD (skip patching, keep stock behavior) instead.
    try:
        put_params = tuple(
            inspect.signature(lc.LRUCache.put).parameters
        )
        get_params = tuple(
            inspect.signature(cc.get_executable_and_time).parameters
        )
    except (TypeError, ValueError):  # C-level / unsupported callables
        put_params = get_params = None
    if put_params != ("self", "key", "val") or get_params != (
        "cache_key",
        "compile_options",
        "backend",
        "executable_devices",
    ):
        logger.warning(
            "jax private cache internals changed (LRUCache.put%s, "
            "get_executable_and_time%s); skipping the atomic-write/"
            "evict-on-corrupt robustness patch — cache writes are NOT "
            "crash-atomic this session",
            put_params,
            get_params,
        )
        return

    orig_put = lc.LRUCache.put
    put_lock = threading.Lock()  # guards the self.path swap below

    def atomic_put(self, key: str, val: bytes) -> None:
        """`LRUCache.put` with a temp-file + rename write.

        Reuses the stock implementation for validation/locking/eviction
        by handing it a proxy path whose write_bytes is atomic.
        """
        class _AtomicPath(type(self.path)):  # pathlib.Path subclass
            def write_bytes(p, data):  # noqa: N805
                tmp = p.with_name(f".{p.name}.tmp.{os.getpid()}")
                try:
                    # base-class write (tmp is also _AtomicPath; calling
                    # its own write_bytes would recurse)
                    n = super(_AtomicPath, tmp).write_bytes(data)
                    os.replace(tmp, p)
                    return n
                finally:
                    if tmp.exists():
                        try:
                            os.unlink(tmp)
                        except OSError:
                            pass

        with put_lock:
            real_path = self.path
            try:
                self.path = _AtomicPath(real_path)
                return orig_put(self, key, val)
            finally:
                self.path = real_path

    lc.LRUCache.put = atomic_put

    orig_get = cc.get_executable_and_time

    def tolerant_get(cache_key, compile_options, backend, executable_devices):
        try:
            return orig_get(
                cache_key, compile_options, backend, executable_devices
            )
        except TypeError:
            # systematic failure (e.g. a signature drift the pin above
            # missed), not a corrupt entry: surface it
            raise
        except Exception as e:  # corrupt entry: evict + treat as miss
            logger.warning(
                "evicting corrupt compilation-cache entry %s: %r",
                cache_key,
                e,
            )
            try:
                cache = cc._get_cache(backend)
                for suffix in ("-cache", "-atime"):
                    p = cache.path / f"{cache_key}{suffix}"
                    if p.exists():
                        p.unlink()
            except Exception:
                pass
            return None, None

    cc.get_executable_and_time = tolerant_get


def enable() -> str:
    """Point jax at the persistent cache; returns the directory used.

    Accelerators only: persisted XLA:CPU executables are AOT-compiled
    machine code whose deserialization is not robust (a loader warns
    "could lead to execution errors such as SIGILL" when the compiling
    host's CPU features differ, and test sessions crashed inside
    `deserialize_executable` on CPU cache reads). CPU sessions therefore
    run with the persistent cache DISABLED and rely on jax's in-memory
    cache.
    """
    import jax

    from .. import config as C

    if C.platform() == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return "<disabled: cpu executable deserialization is unsafe>"

    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    if not os.environ.get(ENV_DIR):
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_compilation_cache_max_size", _MAX_BYTES)
    jax.config.update("jax_raise_persistent_cache_errors", False)
    _patch_cache_robustness()
    return d
