// K1: dense probe sweep of the LZ77 match engine, for Hopper (sm_90a).
//
// Replaces the Pallas kernel zlibng_tpu/ops/probe_pallas.py:_probe_kernel
// (entry probe_best_pallas). Computes exactly lz77_jax._probe_best_xla:
// rows are sorted by (hash, pos); for k = 1..dense, row r is compared with
// row r-k. l16 = leading equal bytes over the W probe words (word 0 first,
// ctz/8 inside a word). A candidate is ok when the hashes are equal,
// cpos >= hist_valid_from and 0 < dist <= max_dist; score = (l16 << 20) -
// dist and only a strictly greater score replaces the best. From probe
// gate_depth + 1 on, only rows whose best l16 is below good_l16 update.
//
// What bounds it on this card: integer issue. Each (row, k) probe is ~32
// int32 operations (4 xors, 4 byte-ctz, 3 selects, 3 range tests, score
// arithmetic and the best update), so at dense = 16 a row costs ~512
// operations against 32 bytes of memory traffic (24 B of planes in, 8 B of
// results out): ~16 operations per byte, far above the H100's int32 ops to
// HBM bytes ratio (~5). So the kernel must keep every probe on chip.
//
// Design: one thread per sorted row, TILE rows per block. The block stages
// its tile plus a look-behind halo of `dense` rows of all W + 2 planes into
// shared memory (planar layout: neighbouring threads read neighbouring
// words, no bank conflicts), so every row's W + 2 words are read from HBM
// once (the halo re-reads dense/TILE of them from L2). The k-loop is
// unrolled through the DENSE template parameter and the running best stays
// in registers; only (best_score, best_cand) are written back. The TPU
// kernel's 1-row halo came from its 128-lane roll and does not apply here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;
constexpr int kMaxDense = 64;
constexpr int kNeg = -(1 << 30);

__device__ __forceinline__ int ctz_bytes(int x) {
  // leading equal bytes from an xor word: ctz(x) / 8, 4 when x == 0
  return x == 0 ? 4 : ((__ffs(x) - 1) >> 3);
}

// DENSE > 0: the probe count, unrolled; DENSE == 0: runtime count `dense`.
template <int DENSE, int W>
__global__ void __launch_bounds__(kTile)
probe_kernel(const int* __restrict__ w2, const int* __restrict__ hs,
             const int* __restrict__ ps, const int* __restrict__ hv,
             int* __restrict__ score, int* __restrict__ cand, int N,
             int dense, int gate_depth, int good_l16, int max_dist) {
  constexpr int kHalo = DENSE > 0 ? DENSE : kMaxDense;
  constexpr int kRows = kTile + kHalo;
  __shared__ int s_w[W][kRows];
  __shared__ int s_h[kRows];
  __shared__ int s_p[kRows];

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const size_t lane = (size_t)b * N;
  const int kd = DENSE > 0 ? DENSE : dense;

  for (int i = threadIdx.x; i < kRows; i += kTile) {
    const int r = r0 - kHalo + i;
    if (r >= 0 && r < N) {
      const int* row = w2 + (lane + r) * W;
      if constexpr (W == 4) {   // one 16-byte load per row
        const int4 v = *reinterpret_cast<const int4*>(row);
        s_w[0][i] = v.x;
        s_w[1][i] = v.y;
        s_w[2][i] = v.z;
        s_w[3][i] = v.w;
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) s_w[w][i] = row[w];
      }
      s_h[i] = hs[lane + r];
      s_p[i] = ps[lane + r];
    } else {
      // rows before the lane start never match (the k-guard below skips
      // them); clear them so shared memory holds no stale words
#pragma unroll
      for (int w = 0; w < W; ++w) s_w[w][i] = 0;
      s_h[i] = -1;
      s_p[i] = 0;
    }
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int r = r0 + t;
  if (r >= N) return;
  const int me = t + kHalo;
  int q[W];
#pragma unroll
  for (int w = 0; w < W; ++w) q[w] = s_w[w][me];
  const int qh = s_h[me];
  const int qpos = s_p[me];
  const int hvb = hv[b];

  int bs = kNeg, bc = 0;
  bool hunting = true;
#pragma unroll
  for (int k = 1; k <= (DENSE > 0 ? DENSE : kMaxDense); ++k) {
    if (DENSE == 0 && k > kd) break;
    if (k == gate_depth + 1) {
      const int cur = bs > kNeg ? (bs + (qpos - bc)) >> 20 : 0;
      hunting = cur < good_l16;
    }
    if (r - k < 0) continue;           // no predecessor: score stays NEG
    const int j = me - k;
    int l16 = ctz_bytes(q[W - 1] ^ s_w[W - 1][j]);
#pragma unroll
    for (int w = W - 2; w >= 0; --w) {
      const int x = q[w] ^ s_w[w][j];
      l16 = x != 0 ? ctz_bytes(x) : 4 + l16;
    }
    const int cp = s_p[j];
    const int dist = qpos - cp;
    const bool ok = (qh == s_h[j]) && (cp >= hvb) && (dist <= max_dist) &&
                    (dist > 0);
    const int sc = ok ? (l16 << 20) - dist : kNeg;
    if (sc > bs && hunting) {
      bs = sc;
      bc = cp;
    }
  }
  score[lane + r] = bs;
  cand[lane + r] = bc;
}

template <int DENSE, int W>
void launch(const int* w2, const int* hs, const int* ps, const int* hv,
            int* score, int* cand, int B, int N, int dense, int gate_depth,
            int good_l16, int max_dist, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, B);
  probe_kernel<DENSE, W><<<grid, kTile, 0, stream>>>(
      w2, hs, ps, hv, score, cand, N, dense, gate_depth, good_l16, max_dist);
}

template <int W>
void dispatch(const int* w2, const int* hs, const int* ps, const int* hv,
              int* score, int* cand, int B, int N, int dense, int gate_depth,
              int good_l16, int max_dist, cudaStream_t stream) {
#define ZNG_PROBE_CASE(D)                                                   \
  case D:                                                                   \
    launch<D, W>(w2, hs, ps, hv, score, cand, B, N, dense, gate_depth,      \
                 good_l16, max_dist, stream);                               \
    return;
  switch (dense) {  // the chains of levels 1-9
    ZNG_PROBE_CASE(2)
    ZNG_PROBE_CASE(4)
    ZNG_PROBE_CASE(8)
    ZNG_PROBE_CASE(16)
    ZNG_PROBE_CASE(32)
    ZNG_PROBE_CASE(48)
    ZNG_PROBE_CASE(64)
    default:        // any other tuned chain <= 64
      launch<0, W>(w2, hs, ps, hv, score, cand, B, N, dense, gate_depth,
                   good_l16, max_dist, stream);
  }
#undef ZNG_PROBE_CASE
}

}  // namespace

// w2: (B, N, W) int32 probe words (u32 bits); hs, ps: (B, N) int32 sorted
// hash and position; hv: (B,) int32 hist_valid_from. Outputs (B, N) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int zng_probe_best(const void* w2, const void* hs, const void* ps,
                              const void* hv, void* score, void* cand, int B,
                              int N, int W, int dense, int gate_depth,
                              int good_l16, int max_dist, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (dense < 1 || dense > kMaxDense || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(w2);
  const int* h = static_cast<const int*>(hs);
  const int* p = static_cast<const int*>(ps);
  const int* v = static_cast<const int*>(hv);
  int* o1 = static_cast<int*>(score);
  int* o2 = static_cast<int*>(cand);
  if (W == 4) {
    dispatch<4>(a, h, p, v, o1, o2, B, N, dense, gate_depth, good_l16,
                max_dist, s);
  } else if (W == 2) {
    dispatch<2>(a, h, p, v, o1, o2, B, N, dense, gate_depth, good_l16,
                max_dist, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
