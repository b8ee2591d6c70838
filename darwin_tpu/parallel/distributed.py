"""Multi-host data parallelism over read batches.

The reference scales across CPU threads in one process, each thread
owning a contiguous read range and its own output file
(darwin.cpp:619-632, per-thread darwin.<cpu_id>.out at darwin.cpp:174,
merged offline with `cat darwin.*.out | sort | uniq`, README:25).

The multi-host equivalent here keeps exactly that decomposition,
host-sized: every process (host) in a `jax.distributed` job

1. parses the same reference + reads FASTA (deterministic, cheap next
   to alignment) and builds or loads the same seed table,
2. runs the full D-SOFT + GACT pipeline on its contiguous read range
   using its local devices only (the per-host engine is the plain
   single-host one; tile batches shard over local devices via
   parallel.mesh when wanted),
3. contributes its overlap records to a deterministic global
   sorted-unique union — the on-line equivalent of the reference's
   `sort | uniq` merge — via an all-gather across processes.

No cross-host traffic during alignment: reads are embarrassingly
parallel (the seed table is replicated), so scaling is bounded by the
read-range balance, and the only collective is the final merge.
"""

from __future__ import annotations

import os

import numpy as np


def maybe_initialize(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> bool:
    """Initialize the JAX distributed runtime when configured.

    Returns True when a multi-process runtime is (already) up.  With no
    coordinator configured (no args, no JAX_COORDINATOR_ADDRESS env)
    this is a no-op and the job runs single-process.
    """
    import jax

    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    # Failure detection: a dead peer is noticed via missed heartbeats
    # and surfaces as a RuntimeError in every surviving process (at the
    # next collective, or asynchronously from the coordination
    # client) — the job fails loudly instead of hanging at the merge
    # all-gather.  DARWIN_TPU_HEARTBEAT_S tightens the window.
    heartbeat = int(os.environ.get("DARWIN_TPU_HEARTBEAT_S", "100"))
    if local_device_ids is None:
        local_device_ids = pinned_device_ids(coordinator_address,
                                             process_id)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id,
        local_device_ids=local_device_ids,
        heartbeat_timeout_seconds=heartbeat)
    return jax.process_count() > 1


def pinned_device_ids(coordinator_address: str | None,
                      process_id: int | None) -> list[int] | None:
    """The one card this process should own when several processes
    share a host, else None (all local cards).

    A JAX process reserves most of every card it can see, so processes
    on one host must each see one card.  The local rank comes from
    JAX_LOCAL_DEVICE_IDS (JAX's own override, left to JAX), LOCAL_RANK
    (set by common launchers), or, when the coordinator is on this
    host's loopback address, the process id itself.
    """
    if os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        return None
    if os.environ.get("LOCAL_RANK"):
        return [int(os.environ["LOCAL_RANK"])]
    host = (coordinator_address or "").rsplit(":", 1)[0].strip("[]")
    if process_id is not None and (host == "localhost"
                                   or host.startswith("127.")
                                   or host == "::1"):
        return [int(process_id)]
    return None


def process_count() -> int:
    import jax
    try:
        return jax.process_count()
    except RuntimeError:
        return 1


def process_index() -> int:
    import jax
    try:
        return jax.process_index()
    except RuntimeError:
        return 0


def read_range(num_reads: int, index: int | None = None,
               count: int | None = None) -> range:
    """This process's contiguous read range.

    Mirrors the reference's per-thread split `reads_per_thread =
    ceil(num_reads / num_threads)` with the last range truncated
    (darwin.cpp:619-632).
    """
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    per = -(-num_reads // count) if num_reads else 0
    lo = min(index * per, num_reads)
    hi = min(lo + per, num_reads)
    return range(lo, hi)


def allgather_records(records: list[str]) -> list[str]:
    """Deterministic sorted-unique union of records across processes.

    Single-process: plain `sorted(set(...))`.  Multi-process: each
    process newline-joins its records into ONE byte blob, blobs are
    padded to the global max blob size (process_allgather needs equal
    shapes), all-gathered across processes, split, and reduced with the
    same `sorted(set(...))` — byte-identical on every host, and to the
    reference's offline `sort | uniq` merge.

    Memory bound: O(P x max total record bytes on one process) — the
    padding is one-dimensional (to the largest blob), not the earlier
    n_max x len_max rectangle, so skewed record counts or one long
    record no longer inflate every process's buffer quadratically.
    """
    if process_count() == 1:
        return sorted(set(records))

    from jax.experimental import multihost_utils

    blob = "\n".join(records).encode()
    sizes = multihost_utils.process_allgather(
        np.array([len(blob)], dtype=np.int64))      # [P, 1]
    b_max = max(1, int(sizes.max()))

    buf = np.zeros(b_max, dtype=np.uint8)
    buf[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    gathered = multihost_utils.process_allgather(buf)  # [P, b_max]

    out: set[str] = set()
    for p, row in enumerate(np.asarray(gathered).reshape(-1, b_max)):
        n = int(sizes.reshape(-1)[p])
        if n:
            out.update(row[:n].tobytes().decode().split("\n"))
    return sorted(out)


def barrier(name: str = "darwin_tpu") -> None:
    """Cross-process sync point (no-op single-process)."""
    if process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
