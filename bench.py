"""Tile-step benchmark: GACT tile alignment GCUPS on one GPU.

Prints ONE JSON line:
  {"metric": "gact_gcups", "value": <GCUPS>, "unit": "GCUPS",
   "device": {...}, "step_ms": ..., "dp_ms": ..., "traceback_ms": ...}

Measured quantity: the full tile step (DP kernel + packed6 traceback)
on batches of 2048 full T x T tiles at the reference's tile geometry
(T=320, early_terminate=200) — DP cells updated per second.  V distinct
batches are staged on the device and chained in one dispatch
(lax.scan); the time ends at block_until_ready.

Refuses to run without a GPU: a CPU number is not a device metric.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B = 2048
T = 320   # the reference's default tile size
ET = 200  # tile_size - tile_overlap at the reference defaults
V = 16    # distinct batches chained per dispatch


def main() -> int:
    import jax
    import jax.numpy as jnp

    from darwin_tpu.engine.aligner import resolve_backend, tile_dp_words
    from darwin_tpu.ops.traceback import traceback_packed6_jax
    from darwin_tpu.utils import configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(json.dumps({"metric": "gact_gcups", "error":
                          f"no GPU (JAX found {dev.platform})"}))
        return 1
    configure_compile_cache()
    backend = resolve_backend()
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)

    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = alpha[rng.integers(0, 4, size=(V, B, T))]
    queries = refs.copy()
    mut = rng.random((V, B, T)) < 0.1  # ~10% divergence
    queries[mut] = alpha[rng.integers(0, 4, size=int(mut.sum()))]
    rlen = np.full(B, T, dtype=np.int32)
    qlen = np.full(B, T, dtype=np.int32)
    firsts = np.zeros(B, dtype=bool)
    firsts[: B // 2] = True

    def full_step(r, q):
        out, words = tile_dp_words(backend, r, q, rlen, qlen, **kw)
        ops, _mb, i_s, j_s = traceback_packed6_jax(
            words, rlen, qlen, firsts, out["max_i"], out["max_j"],
            early_terminate=ET)
        # Reduce over every output so nothing is dead code.
        return (ops.astype(jnp.int32).sum() + i_s.sum() + j_s.sum()
                + out["max_score"].sum())

    def dp_step(r, q):
        out, words = tile_dp_words(backend, r, q, rlen, qlen, **kw)
        return (words[:, ::37, ::41].sum() + out["max_score"].sum()
                + out["max_i"].sum())

    def chained(step):
        def run(rs, qs):
            def body(carry, rq):
                return carry + step(*rq), None
            return jax.lax.scan(body, jnp.int32(0), (rs, qs))[0]
        return jax.jit(run)

    refs_d, queries_d = jax.device_put(refs), jax.device_put(queries)

    def timed(fn, reps=5):
        fn(refs_d, queries_d).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(refs_d, queries_d)
        out.block_until_ready()
        return (time.perf_counter() - t0) / reps

    dt = timed(chained(full_step))
    dt_dp = timed(chained(dp_step))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({
        "metric": "gact_gcups",
        "value": float(V) * B * T * T / dt / 1e9,
        "unit": "GCUPS",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "nvidia_smi": smi.stdout.strip()},
        "kernel": backend,
        "tile_size": T,
        "step_ms": dt / V * 1e3,
        "dp_ms": dt_dp / V * 1e3,
        "traceback_ms": (dt - dt_dp) / V * 1e3,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
