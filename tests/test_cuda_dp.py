"""CUDA tile-DP kernel: its arithmetic, wrapper, build and dispatch.

The kernel itself runs only on a GPU (it has no interpret mode); the
`gpu`-marked test compares it with align_tiles_jax there and skips
elsewhere.  On the CPU, a NumPy model of the kernel's lane-blocked
formulation (K columns per lane, the deletion recurrence split into a
local pass, a cross-lane max-scan and a fix-up, the packed6 history
shuffles) is checked against align_tiles_jax + pack_dir_words6, so the
algebra the kernel relies on is tested where there is no card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from darwin_tpu.ops import cuda_dp
from darwin_tpu.ops.common import NEG_INF
from darwin_tpu.ops.reference_dp import align_tiles_jax
from darwin_tpu.ops.traceback import pack_dir_words6

from test_dp import make_batch


def kernel_model(ref, query, rlen, qlen, *, match, mismatch, gap_open,
                 gap_extend, G=32):
    """NumPy twin of tile_dp_kernel: vectorized over tiles and lanes,
    stepping rows and per-lane columns exactly as the kernel does."""
    B, T = ref.shape
    C = T + 1
    K = max(2, -(-C // G))
    NEG = np.int32(-NEG_INF)
    go, ge = gap_open, gap_extend
    lane = np.arange(G)[None, :]
    col = lane[..., None] * K + np.arange(K)              # [1, G, K]
    qpad = np.concatenate([np.full((B, 1), -1), query.astype(np.int64),
                           np.full((B, G * K), -1)], axis=1)
    q = qpad[:, np.clip(col[0], 0, T + 1)]                  # [B, G, K]
    q = np.where((col >= 1) & (col <= T), q, -1)
    z = np.zeros((B, G, K), np.int32)
    m, ins, p3, hist = z.copy(), z + NEG, z.copy(), z.copy()
    best = np.full((B, G, K), -1, np.int32)
    best_key = np.full((B, G, K), -1, np.int64)
    pos = np.zeros(B, np.int32)
    words = np.zeros((B, T, G * K), np.int32)

    def from_left(x):  # lane L receives lane L-1's value (lane 0 own)
        return np.concatenate([x[:, :1], x[:, :-1]], axis=1)

    def from_right(x):
        return np.concatenate([x[:, 1:], x[:, -1:]], axis=1)

    rl = rlen[:, None, None]
    ql = qlen[:, None, None]
    for i in range(1, T + 1):
        r = ref[:, i - 1].astype(np.int64)[:, None, None]
        left = np.concatenate([from_left(p3[..., -1])[..., None],
                               p3[..., :-1]], axis=2)
        s = np.where(q == r, match, mismatch).astype(np.int32)
        mn = np.maximum(left + s, 0).astype(np.int32)
        io, ie = m + go, ins + ge
        inn = np.maximum(io, ie)
        fi = io >= ie
        mn[:, 0, 0] = 0
        inn[:, 0, 0] = NEG
        loc = np.full((B, G), NEG, np.int32)
        dl = np.empty_like(mn)
        for k in range(K):
            dl[..., k] = loc
            loc = np.maximum(loc + ge, mn[..., k] + go)
        v = (loc - (lane + 1) * K * ge).astype(np.int32)
        ex = from_left(np.maximum.accumulate(v, axis=1))
        carry = np.where(lane == 0, NEG, lane * K * ge + ex)
        d = np.maximum(dl, carry[..., None] + np.arange(K) * ge)
        fd_first = from_left(mn[..., -1] + go >= d[..., -1] + ge)
        fd = np.concatenate([fd_first[..., None],
                             mn[..., :-1] + go >= d[..., :-1] + ge], axis=2)
        mx = np.maximum(np.maximum(mn, inn), d)
        op = np.where(mn == mx, 3, np.where(inn == mx, 2, 1))
        op = np.where(mx == 0, 0, op)
        op = op + 8 * fi + 4 * fd + 16 * (q == r)
        valid = (col >= 1) & (col <= ql) & (i <= rl)
        op = np.where(valid, op, 0).astype(np.int32)
        key = i * (G * K + 1) + col
        upd = valid & (mx >= best)
        best = np.where(upd, mx, best)
        best_key = np.where(upd, key, best_key)
        at = (i == rl) & (col == ql)
        pos = np.where(at.any(axis=(1, 2)),
                       np.where(at, mx, 0).sum(axis=(1, 2)), pos)
        m, ins, p3 = mn, inn, mx

        right = from_right(op[..., 0] | ((hist[..., 0] & 31) << 5))
        right[:, -1] = 0
        prev = from_left(hist[..., -1] | (hist[..., -2] << 15))
        prev[:, 0] = 0
        dn = np.concatenate([op[..., 1:], (right & 31)[..., None]], axis=2)
        d1 = hist & 31
        d1n = np.concatenate([hist[..., 1:] & 31,
                              ((right >> 5) & 31)[..., None]], axis=2)
        d2 = np.concatenate([((prev >> 5) & 31)[..., None],
                             (hist[..., :-1] >> 5) & 31], axis=2)
        d3 = np.concatenate([((prev >> 25) & 31)[..., None],
                             ((prev >> 10) & 31)[..., None],
                             (hist[..., :-2] >> 10) & 31], axis=2)
        w = op | (dn << 5) | (d1 << 10) | (d1n << 15) | (d2 << 20) | (
            d3 << 25)
        words[:, i - 1] = w.reshape(B, G * K)
        hist = ((hist << 5) | op) & 0x7FFF

    flat_best = best.reshape(B, -1)
    flat_key = best_key.reshape(B, -1)
    score = flat_best.max(axis=1)
    k = np.where(flat_best == score[:, None], flat_key, -1).max(axis=1)
    found = score >= 0
    return dict(dir_words=words[:, :, :C],
                max_score=np.where(found, score, 0),
                max_i=np.where(found, k // (G * K + 1), 0),
                max_j=np.where(found, k % (G * K + 1), 0),
                pos_score=pos)


def _reference(ref, query, rlen, qlen, **kw):
    out = align_tiles_jax(ref, query, rlen, qlen, **kw)
    out = {k: np.asarray(v) for k, v in out.items()}
    out["dir_words"] = np.asarray(pack_dir_words6(out.pop("dir")))
    return out


@pytest.mark.parametrize("T,sc", [
    (24, (1, -1, -1, -1)), (64, (2, -3, -4, -2)), (70, (5, -4, -8, -6)),
    (33, (3, -1, -2, -1)), (200, (1, -1, -1, -1))])
def test_kernel_model_matches_reference(T, sc):
    """Lane widths K = 2, 3, 3, 2 and 7 columns."""
    rng = np.random.default_rng(T)
    ref, query, rlen, qlen = make_batch(rng, 12, T, minlen=0)
    kw = dict(match=sc[0], mismatch=sc[1], gap_open=sc[2],
              gap_extend=sc[3])
    want = _reference(ref, query, rlen, qlen, **kw)
    got = kernel_model(ref, query, rlen, qlen, **kw)
    for k in ("max_score", "max_i", "max_j", "pos_score", "dir_words"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("B,T", [(7, 320), (2048, 64)])
def test_wrapper_shapes(B, T):
    """The FFI call's results: packed6 words at the reference width T+1
    (no lane padding, no batch padding) and int32 stats; lengths of any
    int dtype are accepted."""
    out = jax.eval_shape(
        lambda *a: cuda_dp.align_tiles_cuda(
            *a, match=1, mismatch=-1, gap_open=-1, gap_extend=-1),
        jax.ShapeDtypeStruct((B, T), jnp.uint8),
        jax.ShapeDtypeStruct((B, T), jnp.uint8),
        jax.ShapeDtypeStruct((B,), jnp.int64 if jax.config.x64_enabled
                             else jnp.int16),
        jax.ShapeDtypeStruct((B,), jnp.int32))
    assert out["dir_words"].shape == (B, T, T + 1)
    assert out["dir_words"].dtype == jnp.int32
    for k in ("max_score", "max_i", "max_j", "pos_score"):
        assert out[k].shape == (B,) and out[k].dtype == jnp.int32


def test_wrapper_rejects_oversized_tiles():
    T = cuda_dp.MAX_TILE + 1
    spec = jax.ShapeDtypeStruct((4, T), jnp.uint8)
    lens = jax.ShapeDtypeStruct((4,), jnp.int32)
    with pytest.raises(ValueError, match="tile_size"):
        jax.eval_shape(lambda *a: cuda_dp.align_tiles_cuda(
            *a, match=1, mismatch=-1, gap_open=-1, gap_extend=-1),
            spec, spec, lens, lens)


def test_library_name_tracks_source_and_flags(monkeypatch):
    a = cuda_dp.library_path()
    assert a.parent == cuda_dp.BUILD_DIR and a.suffix == ".so"
    monkeypatch.setattr(cuda_dp, "NVCC_FLAGS", cuda_dp.NVCC_FLAGS + ("-g",))
    assert cuda_dp.library_path() != a


def test_failed_build_raises(monkeypatch, tmp_path):
    """A missing or failing nvcc raises; nothing falls back."""
    monkeypatch.setattr(cuda_dp, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("NVCC", str(tmp_path / "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="build failed"):
        cuda_dp.build()
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: broken' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    with pytest.raises(RuntimeError, match="broken"):
        cuda_dp.build()


@pytest.mark.gpu
def test_kernel_matches_reference_on_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run by chip_smoke.py on the card)")
    cuda_dp.load()
    rng = np.random.default_rng(5)
    ref, query, rlen, qlen = make_batch(rng, 256, 320, minlen=0)
    kw = dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1)
    got = jax.device_get(cuda_dp.align_tiles_cuda(ref, query, rlen, qlen,
                                                  **kw))
    with jax.default_device(jax.devices("cpu")[0]):
        want = _reference(ref, query, rlen, qlen, **kw)
    for k in ("max_score", "max_i", "max_j", "pos_score", "dir_words"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
