"""Small shared helpers (shape bucketing / alignment, compile cache)."""

from __future__ import annotations

import os
from pathlib import Path

# The checkout (or install) root: the directory holding darwin_tpu/.
CHECKOUT = Path(__file__).resolve().parent.parent


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m that is >= x."""
    return (x + m - 1) // m * m


def bucket_pow2(n: int, lo: int = 64) -> int:
    """Smallest power-of-two >= n, starting at lo.

    Used to bucket dynamic sizes (call counts, bank lengths, read
    batches) so jitted programs are reusable across similar workloads.
    """
    b = lo
    while b < n:
        b *= 2
    return b


def bucket_steps(n: int, lo: int = 64) -> int:
    """Smallest value >= n from {lo*2^k, lo*3*2^(k-1)}.

    Half-octave buckets: twice the compile variants of bucket_pow2 but
    at most 33% padding waste instead of 50% — used for the engine's
    slot count, where idle slots cost real per-iteration work.
    """
    b = lo
    while b < n:
        if b * 3 // 2 >= n:
            return b * 3 // 2
        b *= 2
    return b


def configure_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its path.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and
    nothing is set here.  Otherwise the cache lives at the fixed path
    <checkout>/.jax_cache (the path is part of the cache key, so it
    must not move between runs)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
