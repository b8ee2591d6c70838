"""Multi-device scaling via jax.sharding meshes.

The reference scales with pthreads on one GPU (darwin.cpp:619-632,
one CUDA stream per thread); the equivalents here are:

* data parallelism over tiles: the engine's tile batch is sharded
  across a 1-D 'data' mesh with shard_map — each device runs the DP
  kernel + traceback on its shard, no cross-device traffic;
* data parallelism over reads across hosts: each host's process runs
  D-SOFT + engine on its read range (see parallel/distributed.py);
* deterministic overlap merge: per-device record tensors are
  all-gathered across the mesh and sorted, reproducing the reference's
  `cat darwin.*.out | sort | uniq` merge semantics on device.

The seed table is replicated here; the hash-sharded table with an
all_to_all hit exchange lives in dsoft/sharded_table.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from darwin_tpu.engine.aligner import (TileResult, resolve_backend,
                                      tile_dp_words)
from darwin_tpu.ops.traceback import traceback_packed6_jax


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def sharded_tile_step(mesh: Mesh, *, early_terminate: int, match: int,
                      mismatch: int, gap_open: int, gap_extend: int,
                      backend: str = "auto"):
    """Jitted batch-sharded DP + traceback step.

    Returns fn(ref_tiles[B,T], query_tiles, rlens, qlens, firsts) with B
    sharded over the mesh's data axis; per-device work is the plain
    single-device kernel (shard_map), so the kernel runs unmodified on
    each device.
    """
    backend = resolve_backend(backend)
    axis = mesh.axis_names[0]

    def local_step(ref, query, rlen, qlen, first):
        out, words = tile_dp_words(
            backend, ref, query, rlen, qlen, match=match,
            mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend)
        ops, _mb, i_steps, j_steps = traceback_packed6_jax(
            words, rlen, qlen, first, out["max_i"], out["max_j"],
            early_terminate=early_terminate)
        score = jnp.where(first, out["max_score"], out["pos_score"])
        return (ops.T, i_steps, j_steps, score, out["max_i"],
                out["max_j"])

    spec_b = P(axis)
    spec_bt = P(axis, None)
    fn = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(spec_bt, spec_bt, spec_b, spec_b, spec_b),
        out_specs=(spec_bt, spec_b, spec_b, spec_b, spec_b, spec_b),
        check_vma=False)
    return jax.jit(fn)


class ShardedTileAligner:
    """Engine-compatible aligner that shards the tile batch over a mesh.

    Drop-in for JaxTileAligner: the engine stays oblivious to device
    count.  Batch is padded to a multiple of the device count.
    """

    def __init__(self, mesh: Mesh, *, tile_size: int,
                 early_terminate: int, match: int, mismatch: int,
                 gap_open: int, gap_extend: int, backend: str = "auto"):
        self.mesh = mesh
        self.n_dev = mesh.devices.size
        self.tile_size = tile_size
        self.early_terminate = early_terminate
        self.backend = resolve_backend(backend)
        self._step = sharded_tile_step(
            mesh, early_terminate=early_terminate, match=match,
            mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend,
            backend=self.backend)

    def _pad(self, B: int) -> int:
        return -(-B // self.n_dev) * self.n_dev

    def __call__(self, ref_tiles, query_tiles, ref_lens, query_lens,
                 firsts) -> TileResult:
        B = ref_tiles.shape[0]
        BP = self._pad(B)
        if BP != B:
            pad = ((0, BP - B), (0, 0))
            ref_tiles = np.pad(ref_tiles, pad, constant_values=1)
            query_tiles = np.pad(query_tiles, pad, constant_values=2)
            ref_lens = np.pad(ref_lens, (0, BP - B))
            query_lens = np.pad(query_lens, (0, BP - B))
            firsts = np.pad(firsts, (0, BP - B))
        ops, i_s, j_s, score, mi, mj = jax.device_get(self._step(
            np.asarray(ref_tiles), np.asarray(query_tiles),
            ref_lens.astype(np.int32), query_lens.astype(np.int32),
            firsts.astype(bool)))
        return TileResult(
            ops=np.asarray(ops)[:B], ref_steps=np.asarray(i_s)[:B],
            query_steps=np.asarray(j_s)[:B],
            score=np.asarray(score)[:B],
            max_i=np.asarray(mi)[:B], max_j=np.asarray(mj)[:B])


def merge_overlap_records(mesh: Mesh, local_records: np.ndarray
                          ) -> np.ndarray:
    """Deterministic distributed merge of numeric overlap records.

    Each device contributes [N, 8] int32 rows (ref_id, query_id, ab,
    ae, bb, be, score, comp); rows of all devices are all-gathered over
    the mesh and sorted lexicographically — the device-side analogue of
    the reference's `sort | uniq` merge (README:25).  Padding rows with
    ref_id < 0 are dropped after the gather.
    """
    axis = mesh.axis_names[0]

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis, None),
             out_specs=P(None, None), check_vma=False)
    def gather(rows):
        return jax.lax.all_gather(rows, axis, axis=0, tiled=True)

    rows = np.asarray(gather(local_records))
    rows = rows[rows[:, 0] >= 0]
    order = np.lexsort(rows.T[::-1])
    rows = rows[order]
    keep = np.ones(len(rows), dtype=bool)
    keep[1:] = (rows[1:] != rows[:-1]).any(axis=1)
    return rows[keep]
