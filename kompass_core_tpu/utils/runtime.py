"""Runtime setup: the persistent compilation cache.

The reference pays its SYCL JIT cost once per process via a
construction-time warmup (``dwa.cpp:75-91``); here XLA's persistent
compilation cache amortizes compiles across *processes* — the first
construction compiles, later runs (tests, benchmarks, restarts) load the
compiled program from disk.
"""

import os

import jax

# one fixed directory inside the checkout: the path is part of the
# cache's key, so a directory that moves never hits
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)

_cache_enabled = False


def enable_persistent_compilation_cache() -> None:
    """Idempotently turn on JAX's on-disk compilation cache.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses that
    directory and no other is set here; else ``CHECKOUT_CACHE_DIR``.
    Disable with
    ``KOMPASS_TPU_NO_CACHE=1`` (e.g. when measuring cold-compile time).
    """
    global _cache_enabled
    if _cache_enabled or os.environ.get("KOMPASS_TPU_NO_CACHE"):
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _cache_enabled = True
