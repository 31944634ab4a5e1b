"""Persistent-compile-cache helper (shared by tests, tools, bench.py and
chip_smoke.py).

Where the cache lives: ``$JAX_COMPILATION_CACHE_DIR`` when it is set —
nothing here then picks another directory — otherwise the fixed path
``<repo>/.jax_cache`` (gitignored).  A fixed path matters because the
directory is part of what makes a later run find its entries.

jax's file cache writes entries NON-atomically (lru_cache.py put():
plain write_bytes) — a run killed mid-write (timeout/Ctrl-C) leaves a
truncated executable that SEGFAULTS the deserializer on the next run's
cache *read*.  ``enable_compile_cache`` turns the cache on for the
current process AND patches put() to write-to-temp + os.replace (atomic
on the same filesystem), which also makes the cache safe for multiple
concurrent processes (the multi-host workers compile identical
programs): a killed or racing write leaves only an ignored temp file.
"""

from __future__ import annotations

import os
import tempfile

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<repo>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or REPO_CACHE


def _atomic_put(self, key, val):
    """LRUCache.put with the single write_bytes made atomic.

    Everything else — the empty-key guard, the oversized-entry
    rejection, the eviction lock/trigger, and the atime stamp — is the
    ORIGINAL put's behavior, preserved so processes that also enable
    jax_persistent_cache_max_size keep a bounded cache (round-3 review:
    the first version replaced put wholesale and silently disabled
    eviction for every LRUCache in the process)."""
    import warnings

    from jax._src import lru_cache as _lru

    if not key:
        raise ValueError("key cannot be empty")
    if self.eviction_enabled and len(val) > self.max_size:
        warnings.warn(
            f"Cache value for key {key!r} of size {len(val)} bytes "
            f"exceeds the maximum cache size of {self.max_size} bytes"
        )
        return
    cache_path = self.path / f"{key}{_lru._CACHE_SUFFIX}"
    if self.eviction_enabled:
        self.lock.acquire(timeout=self.lock_timeout_secs)
    try:
        if cache_path.exists():
            return
        self._evict_if_needed(additional_size=len(val))
        fd, tmp = tempfile.mkstemp(dir=str(self.path), prefix=".inflight-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(val)
            os.replace(tmp, str(cache_path))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if self.eviction_enabled:
            import time as _time

            timestamp = _time.time_ns().to_bytes(8, "little")
            atime_path = self.path / f"{key}{_lru._ATIME_SUFFIX}"
            atime_path.write_bytes(timestamp)
    finally:
        if self.eviction_enabled:
            self.lock.release()


def enable_compile_cache(path: str | None = None) -> str:
    """Enable jax's persistent compilation cache at ``path`` (default:
    :func:`compile_cache_dir`) with atomic, multi-process-safe writes.
    Returns the cache dir."""
    import jax
    from jax._src import lru_cache as _lru

    cache_dir = path or compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _lru.LRUCache.put = _atomic_put
    return cache_dir
