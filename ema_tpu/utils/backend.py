"""JAX start-up for the align path: allocator tuning and the compile cache.

``JAX_PLATFORMS`` picks the platform, as JAX documents.  A failed
accelerator init is an error: nothing here retries it or falls back to
another platform, so a run never reports one device's numbers while
running on another.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_malloc_tuned = False


def _tune_malloc() -> None:
    """Keep large numpy temporaries on the heap instead of mmap.

    The batched pipeline allocates multi-MB arrays (seed planes, record
    tables, SAM blobs) fresh every chunk; glibc serves >128 KB requests
    via mmap and returns them to the kernel on free, so every chunk
    re-faults its pages.  Raising M_MMAP_THRESHOLD and disabling trim
    makes freed blocks reusable.  mallopt applies to the running
    process, so this works without a launcher env.
    """
    global _malloc_tuned
    if _malloc_tuned:
        return
    _malloc_tuned = True
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 256 << 20)
        libc.mallopt(M_TRIM_THRESHOLD, 256 << 20)
    except Exception:
        pass           # non-glibc platforms: nothing to tune


def compile_cache_dir() -> str:
    """The persistent XLA compile-cache directory.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself);
    otherwise one fixed directory inside the checkout, ``.jax_cache/``
    (gitignored).  The path is part of the cache key, so it never moves.
    """
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def ensure_backend():
    """Tune the allocator, enable the compile cache, return jax.devices().

    Raises whatever JAX raises when the requested platform cannot start.
    """
    import jax

    _tune_malloc()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return jax.devices()


def describe_devices() -> str:
    """One line naming the platform, device kind and device count."""
    import jax

    devs = jax.devices()
    return (f"platform={devs[0].platform} "
            f"device_kind={devs[0].device_kind} count={len(devs)}")
