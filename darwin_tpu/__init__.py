"""darwin-tpu: a long-read overlapper/aligner (D-SOFT + GACT) in JAX.

A from-scratch reimplementation of the Darwin seed-and-extend aligner
(D-SOFT diagonal-band seed filtration + GACT constant-memory tiled
alignment) for NVIDIA GPUs: the whole GACT loop runs on the device,
the tile dynamic program is a CUDA kernel called through jax.ffi,
candidate filtration is a segmented-scan formulation, and scaling is
expressed with ``jax.sharding`` meshes rather than threads/streams.

Behavioral reference: Tongdongq/darwin-gpu (C++/CUDA). This package is a
re-design, not a port: see SURVEY.md at the repo root for the layer map
and the parity contract.
"""

__version__ = "0.1.0"


def _disable_numpy_hugepage_madvise() -> None:
    """Keep numpy from MADV_HUGEPAGE-ing large allocations.

    Under THP defrag=madvise (this environment and common prod
    kernels), every first touch of a hugepage-madvised region runs
    synchronous compaction; measured here at 7-22 s per fresh 250 MB
    numpy array vs 0.2 s without the madvise — a 40-100x allocation
    tax on the genome-scale buffers (banks, seed-table keys, fill
    targets).  Set DARWIN_TPU_HUGEPAGE=1 to keep numpy's default.
    """
    import os

    if os.environ.get("DARWIN_TPU_HUGEPAGE") == "1":
        return
    os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    try:  # numpy may already be imported with madvise armed
        from numpy._core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:
        pass


_disable_numpy_hugepage_madvise()

from darwin_tpu.config import Params

__all__ = ["Params", "__version__"]
