// GACT tile DP for NVIDIA Hopper (sm_90a), called from JAX through the
// XLA foreign function interface (darwin_tpu/ops/cuda_dp.py).
//
// Same contract as align_tiles_jax + pack_dir_words6
// (darwin_tpu/ops/reference_dp.py, darwin_tpu/ops/traceback.py): for a
// batch of [B, T] tiles it writes the packed6 traceback words
// [B, T, T+1] int32 and per-tile stats [B, 4] int32
// (max_score, max_i, max_j, pos_score), bit-exact.
//
// Layout.  One warp (G = 32 lanes) owns one tile.  Lane L keeps
// columns [L*K, L*K + K) of the current DP row in registers (the
// reference CUDA kernel's register blocking, with the
// block spread across a warp instead of held by one thread, so that
// 512-2048 tiles still fill 132 SMs).  Rows advance sequentially:
//
// * the match and insertion terms read only the row above, so each
//   lane computes them alone (the left neighbour's max3 arrives by one
//   shuffle);
// * the in-row deletion recurrence d[j] = max(m[j-1]+go, d[j-1]+ge) is
//   a max-plus prefix: each lane runs it over its K columns from a -inf
//   seed, the lanes combine their carries with a shuffle max-scan
//   (the carry into lane L is max over L' < L of A_L' + (L-1-L')*K*ge),
//   and each column takes max(local, carry + k*ge);
// * the max3 / add-max steps use Hopper's DPX instructions
//   (__vimax3_s32, __viaddmax_s32, __vibmax_s32);
// * the packed6 word of a cell needs its right neighbour and diagonal
//   history from up to three rows back; each column keeps its last
//   three direction bytes in one register, and the neighbours across
//   lane boundaries arrive by shuffle;
// * a row of words is staged in shared memory and written to global
//   memory by consecutive lanes, so every store is coalesced.
//
// The handler only enqueues the kernel on XLA's stream.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNegInf = -(1 << 30);  // darwin_tpu.ops.common.NEG_INF
constexpr int kFlagI = 8;            // GAP_OPEN_FLAG_I
constexpr int kFlagD = 4;            // GAP_OPEN_FLAG_D
constexpr int kMatchBit = 16;        // MATCH_BIT
constexpr int kThreadsPerBlock = 128;
constexpr int G = 32;  // lanes per tile: one warp
constexpr unsigned kFull = 0xffffffffu;

struct Scoring {
  int match, mismatch, gap_open, gap_extend;
};

template <int K>
__global__ void __launch_bounds__(kThreadsPerBlock)
    tile_dp_kernel(const uint8_t* __restrict__ ref,
                   const uint8_t* __restrict__ query,
                   const int32_t* __restrict__ ref_len,
                   const int32_t* __restrict__ query_len,
                   int32_t* __restrict__ words, int32_t* __restrict__ stats,
                   int B, int T, Scoring sc) {
  static_assert(K >= 2, "the diagonal history needs two columns per lane");
  constexpr int S = K | 1;  // odd lane stride: conflict-free staging
  constexpr int kGroups = kThreadsPerBlock / G;
  const int C = T + 1;
  const int go = sc.gap_open, ge = sc.gap_extend;

  extern __shared__ int smem[];
  const int lane = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  int* rowbuf = smem + grp * (G * S);
  uint8_t* ref_s = reinterpret_cast<uint8_t*>(smem + kGroups * G * S) +
                   grp * ((T + 3) & ~3);

  // Warps past the batch end run on tile B-1 and store nothing.
  const int tile = blockIdx.x * kGroups + grp;
  const bool live = tile < B;
  const int b = live ? tile : B - 1;
  const int rl = ref_len[b];
  const int ql = query_len[b];

  for (int t = lane; t < T; t += G) ref_s[t] = ref[(size_t)b * T + t];

  int q[K], m[K], ins[K], p3[K], hist[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int col = lane * K + k;
    q[k] = (col >= 1 && col <= T) ? query[(size_t)b * T + col - 1] : -1;
    m[k] = 0;
    ins[k] = kNegInf;
    p3[k] = 0;
    hist[k] = 0;
  }
  int best_s = -1, best_i = 0, best_j = 0, pos = 0;
  int32_t* out = words + (size_t)b * T * C;
  __syncwarp();

  for (int i = 1; i <= T; ++i) {
    const int r = ref_s[i - 1];
    const int left_p3 = __shfl_up_sync(kFull, p3[K - 1], 1, G);
    int mn[K], in[K], dl[K], d[K], op[K];
    bool fi[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int left = k == 0 ? left_p3 : p3[k - 1];
      const int s = q[k] == r ? sc.match : sc.mismatch;
      mn[k] = __viaddmax_s32(left, s, 0);
      in[k] = __vibmax_s32(m[k] + go, ins[k] + ge, &fi[k]);
    }
    if (lane == 0) {  // DP column 0
      mn[0] = 0;
      in[0] = kNegInf;
    }
    // Deletion recurrence: local pass, carry scan, fix-up.
    int loc = kNegInf;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dl[k] = loc;
      loc = __viaddmax_s32(loc, ge, mn[k] + go);
    }
    int v = loc - (lane + 1) * K * ge;
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const int o = __shfl_up_sync(kFull, v, off, G);
      if (lane >= off) v = max(v, o);
    }
    const int ex = __shfl_up_sync(kFull, v, 1, G);
    const int carry = lane == 0 ? kNegInf : lane * K * ge + ex;
#pragma unroll
    for (int k = 0; k < K; ++k) d[k] = max(dl[k], carry + k * ge);
    const int fd_first = __shfl_up_sync(
        kFull, (int)(mn[K - 1] + go >= d[K - 1] + ge), 1, G);

#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int col = lane * K + k;
      const bool fd = k == 0 ? fd_first != 0 : mn[k - 1] + go >= d[k - 1] + ge;
      const int mx = __vimax3_s32(mn[k], in[k], d[k]);
      int o = mn[k] == mx ? 3 : (in[k] == mx ? 2 : 1);
      o = mx == 0 ? 0 : o;  // max(m, i, d) <= 0: ZERO (m >= 0 always)
      o += (fi[k] ? kFlagI : 0) + (fd ? kFlagD : 0) +
           (q[k] == r ? kMatchBit : 0);
      const bool valid = col >= 1 && col <= ql && i <= rl;
      op[k] = valid ? o : 0;
      // Row-major-last maximum: rows ascend, columns ascend per lane.
      if (valid && mx >= best_s) {
        best_s = mx;
        best_i = i;
        best_j = col;
      }
      if (i == rl && col == ql) pos = mx;
      m[k] = mn[k];
      ins[k] = in[k];
      p3[k] = mx;
    }

    // packed6: W = D[r,c] | D[r,c+1]<<5 | D[r-1,c]<<10 | D[r-1,c+1]<<15
    //              | D[r-2,c-1]<<20 | D[r-3,c-2]<<25
    int right = __shfl_down_sync(kFull, op[0] | ((hist[0] & 31) << 5), 1, G);
    if (lane == G - 1) right = 0;
    int prev = __shfl_up_sync(kFull, hist[K - 1] | (hist[K - 2] << 15), 1, G);
    if (lane == 0) prev = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int dn = k < K - 1 ? op[k + 1] : (right & 31);
      const int d1 = hist[k] & 31;
      const int d1n = k < K - 1 ? (hist[k + 1] & 31) : ((right >> 5) & 31);
      const int d2 = k >= 1 ? ((hist[k - 1] >> 5) & 31) : ((prev >> 5) & 31);
      const int d3 = k >= 2   ? ((hist[k - 2] >> 10) & 31)
                     : k == 1 ? ((prev >> 10) & 31)
                              : ((prev >> 25) & 31);
      rowbuf[lane * S + k] = op[k] | (dn << 5) | (d1 << 10) | (d1n << 15) |
                             (d2 << 20) | (d3 << 25);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) hist[k] = ((hist[k] << 5) | op[k]) & 0x7fff;
    __syncwarp();
    if (live) {
      int32_t* row = out + (size_t)(i - 1) * C;
      for (int c = lane; c < C; c += G) row[c] = rowbuf[(c / K) * S + c % K];
    }
    __syncwarp();
  }

  // Row-major-last maximum over the warp: largest score, then row,
  // then column.
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const int os = __shfl_xor_sync(kFull, best_s, off, G);
    const int oi = __shfl_xor_sync(kFull, best_i, off, G);
    const int oj = __shfl_xor_sync(kFull, best_j, off, G);
    const int op_ = __shfl_xor_sync(kFull, pos, off, G);
    const bool take = os > best_s ||
                      (os == best_s && (oi > best_i ||
                                        (oi == best_i && oj > best_j)));
    if (take) {
      best_s = os;
      best_i = oi;
      best_j = oj;
    }
    pos = max(pos, op_);
  }
  if (live && lane == 0) {
    const bool found = best_s >= 0;
    int32_t* st = stats + (size_t)b * 4;
    st[0] = found ? best_s : 0;
    st[1] = found ? best_i : 0;
    st[2] = found ? best_j : 0;
    st[3] = pos;
  }
}

template <int K>
cudaError_t launch(cudaStream_t stream, const uint8_t* ref,
                   const uint8_t* query, const int32_t* rlen,
                   const int32_t* qlen, int32_t* words, int32_t* stats,
                   int B, int T, Scoring sc) {
  constexpr int kGroups = kThreadsPerBlock / G;
  constexpr int S = K | 1;
  const size_t shmem =
      kGroups * (G * S * sizeof(int) + ((T + 3) & ~3));
  const int grid = (B + kGroups - 1) / kGroups;
  tile_dp_kernel<K><<<grid, kThreadsPerBlock, shmem, stream>>>(
      ref, query, rlen, qlen, words, stats, B, T, sc);
  return cudaGetLastError();
}

// Columns per lane: the smallest listed K with 32*K >= T+1 is used, so
// tiles up to T = 1023 are supported.
#define DARWIN_K_LIST(X) \
  X(2) X(3) X(4) X(5) X(6) X(8) X(10) X(11) X(12) X(16) X(24) X(32)

cudaError_t dispatch(cudaStream_t stream, const uint8_t* ref,
                     const uint8_t* query, const int32_t* rlen,
                     const int32_t* qlen, int32_t* words, int32_t* stats,
                     int B, int T, Scoring sc, bool* supported) {
  const int need = (T + 1 + G - 1) / G;
  *supported = true;
#define DARWIN_TRY_K(KK)                                                 \
  if (need <= KK)                                                        \
    return launch<KK>(stream, ref, query, rlen, qlen, words, stats, B, \
                         T, sc);
  DARWIN_K_LIST(DARWIN_TRY_K)
#undef DARWIN_TRY_K
  *supported = false;
  return cudaSuccess;
}

ffi::Error TileDp(cudaStream_t stream, ffi::Buffer<ffi::U8> ref,
                  ffi::Buffer<ffi::U8> query, ffi::Buffer<ffi::S32> rlen,
                  ffi::Buffer<ffi::S32> qlen,
                  ffi::ResultBuffer<ffi::S32> words,
                  ffi::ResultBuffer<ffi::S32> stats, int32_t match,
                  int32_t mismatch, int32_t gap_open, int32_t gap_extend) {
  const auto dims = ref.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("ref must be 2-D");
  const int B = static_cast<int>(dims[0]);
  const int T = static_cast<int>(dims[1]);
  if (B == 0 || T == 0) return ffi::Error::Success();
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  bool supported = false;
  const cudaError_t err =
      dispatch(stream, ref.typed_data(), query.typed_data(),
               rlen.typed_data(), qlen.typed_data(), words->typed_data(),
               stats->typed_data(), B, T, sc, &supported);
  if (!supported)
    return ffi::Error::InvalidArgument("tile size too large for the kernel");
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(DarwinTileDp, TileDp,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()   // ref
                                  .Arg<ffi::Buffer<ffi::U8>>()   // query
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ref_len
                                  .Arg<ffi::Buffer<ffi::S32>>()  // query_len
                                  .Ret<ffi::Buffer<ffi::S32>>()  // words
                                  .Ret<ffi::Buffer<ffi::S32>>()  // stats
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend"));
