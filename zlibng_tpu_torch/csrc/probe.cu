// K1: the probe walk of the LZ77 match engine, for Hopper (sm_90a).
//
// Replaces the Pallas kernel zlibng_tpu/ops/probe_pallas.py:_probe_kernel
// (entry probe_best_pallas) and, in the same launch, the compacted deep
// probes the reference runs in XLA after it (lz77_jax.py:255-312). Computes
// exactly lz77_jax._probe_best_xla over k = 1..dense followed by the deep
// probes over k = dense+1..chain: rows are sorted by (hash, pos); row r is
// compared with row r-k. l16 = leading equal bytes over the W probe words
// (word 0 first, ctz/8 inside a word). A candidate is ok when the hashes
// are equal, cpos >= hist_valid_from and 0 < dist <= max_dist; score =
// (l16 << 20) - dist and only a strictly greater score replaces the best.
// Dense gate: from probe gate_depth + 1 (<= dense) on, only rows whose best
// l16 is below good_l16 update. Deep gate: past k = dense, only rows whose
// best l16 is below good_l16 and whose position lies in [enc_start,
// enc_end[lane]) go on; the best of their deep probes replaces the best
// only if strictly greater, which k-by-k strict updates give, since two
// distinct candidates of a row never tie on a valid score.
//
// The walk. Rows of one hash are contiguous and, within such a run, their
// positions ascend (the sort is stable over ascending positions). So as k
// grows, cpos falls and dist grows. Row r walks k = 1, 2, ... and stops at
// the first of these, each exact (no later probe could update the best):
//  * run start: r - k < 0 or h[r-k] != h[r]: every earlier row has a
//    smaller hash, so no later k has the same hash;
//  * window or history: cpos < max(hist_valid_from, pos - max_dist). cpos
//    only falls with k, so dist > max_dist and cpos < hist_valid_from hold
//    for every later k too (and dist <= 0 cannot happen inside a run);
//  * saturation: best l16 == 4 * W. A later candidate has l16 <= 4 * W and
//    a larger dist, so a lower score;
//  * dense gate: not hunting at k = gate_depth + 1: no update until dense,
//    and the deep gate, which tests the same unchanged best against the
//    same good_l16, fails too;
//  * deep gate failed at k = dense + 1; chain end at k = chain.
// The same monotone dist also gives a cheap filter: inside a run a
// candidate can beat the best only with l16 > best l16, i.e. when its first
// best_l16 + 1 bytes equal the row's. That is one masked compare per probe
// (xor, and, or: LOP3s); the exact l16 and score are computed only when it
// passes. With max_dist < 2^20 every pass is an update that raises the best
// l16, so that happens at most 4 * W + 1 times per row.
//
// What bounds it on this card: the work is data-dependent, so the bound is
// the bytes each row must read once (the W + 2 int32 planes, 24 B at W = 4)
// and write (8 B): 32 B per row. What holds it back is the walk: a probe
// is a shared-memory load, a few LOP3s and a branch in one dependent chain,
// and a block lives as long as its longest-walking warp, so rows in long
// same-hash runs (text, periodic data) set the time, not the bytes.
//
// Design: one thread per sorted row, kTile rows per block. The block
// stages its tile plus a look-behind halo of min(chain, halo) rows into
// shared memory (the W probe words of a row as one 8- or 16-byte vector,
// hash and position as one int2), so every row's planes are read from HBM
// once (the halo again from L2). Then each row finds how many of the
// staged rows behind it are candidates at all: same hash, inside the
// window and the usable history. That predicate holds for k = 1..K and
// fails after (the exits above), so a galloping then binary search finds K
// in about 2 log2(K) loads (one load for a row with no candidate). The
// walk over those K rows needs no test but the filter: one vector load and
// a few LOP3s per probe, and the exact update only where the filter
// passes. The gates split the walk into at most three stretches. Probes
// deeper than the staged rows (chain > halo) read the planes from global
// memory (__ldg) with the exits tested one by one: an L2 round trip per
// probe, so the wrapper stages up to 1024 rows. The running best and its
// byte mask stay in registers; only (best_score, best_cand) are written
// back. Neighbouring sorted rows mostly share a run, so a warp's threads
// walk similar lengths.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTile = 256;
constexpr int kMaxHalo = 1024;           // 30 KB of shared memory at W = 4
constexpr int kNeg = -(1 << 30);

template <int W> struct Words;   // a row's W probe words as one vector
template <> struct Words<4> {
  using T = uint4;
  __device__ static void unpack(const uint4& v, unsigned* c) {
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  }
};
template <> struct Words<2> {
  using T = uint2;
  __device__ static void unpack(const uint2& v, unsigned* c) {
    c[0] = v.x; c[1] = v.y;
  }
};

__device__ __forceinline__ int ctz_bytes(unsigned x) {
  // leading equal bytes from an xor word: ctz(x) / 8, 4 when x == 0
  return x == 0 ? 4 : ((__ffs(x) - 1) >> 3);
}

// mask of the bytes of word w that the first n bytes of a probe cover:
// the low min(max(8n - 32w, 0), 32) bits (the funnel shift clamps at 32)
__device__ __forceinline__ unsigned prefix_mask(int n, int w) {
  return __funnelshift_lc(0xFFFFFFFFu, 0u, max(8 * n - 32 * w, 0));
}

template <int W>
struct Best {
  unsigned q[W];
  unsigned m[W];   // bytes 0..bl of the probe (the filter's mask)
  int qpos, bs, bc, bl;

  // The filter: inside a run only a candidate whose first bl + 1 bytes
  // equal the row's can beat the best (with no best, every one can).
  __device__ __forceinline__ bool may_win(const unsigned* c) const {
    unsigned x = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) x |= (q[w] ^ c[w]) & m[w];
    return x == 0;
  }

  // The exact strict update by a valid candidate at cp; false once the
  // best saturates (l16 == 4 * W: nothing later can win).
  __device__ __forceinline__ bool update(const unsigned* c, int cp) {
    int l16 = ctz_bytes(q[W - 1] ^ c[W - 1]);
#pragma unroll
    for (int w = W - 2; w >= 0; --w) {
      const unsigned xw = q[w] ^ c[w];
      l16 = xw != 0 ? ctz_bytes(xw) : 4 + l16;
    }
    const int sc = (l16 << 20) - (qpos - cp);
    if (sc > bs) {
      bs = sc;
      bc = cp;
      bl = l16;
      if (bl == 4 * W) return false;
#pragma unroll
      for (int w = 0; w < W; ++w) m[w] = prefix_mask(bl + 1, w);
    }
    return true;
  }

  __device__ __forceinline__ int cur() const { return bl > 0 ? bl : 0; }
};

template <int W>
__global__ void __launch_bounds__(kTile)
probe_walk(const int* __restrict__ w2, const int* __restrict__ hs,
           const int* __restrict__ ps, const int* __restrict__ hv,
           const int* __restrict__ enc_end, int* __restrict__ score,
           int* __restrict__ cand, int N, int halo, int dense, int chain,
           int gate_depth, int good_l16, int max_dist, int enc_start) {
  using V = typename Words<W>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = kTile + halo;
  V* s_w = reinterpret_cast<V*>(smem_raw);                 // probe words
  int2* s_hp = reinterpret_cast<int2*>(s_w + rows);        // (hash, pos)

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const size_t lane = (size_t)b * N;
  const V* wv = reinterpret_cast<const V*>(w2);

  for (int i = threadIdx.x; i < rows; i += kTile) {
    const int r = r0 - halo + i;
    if (r >= 0 && r < N) {
      s_w[i] = __ldg(wv + lane + r);
      s_hp[i] = make_int2(__ldg(hs + lane + r), __ldg(ps + lane + r));
    } else {
      // rows outside the lane: hash -1 is below every hash, so the sorted
      // order and the walk's run-start exit hold across the lane's start
      s_w[i] = V{};
      s_hp[i] = make_int2(-1, 0);
    }
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int r = r0 + t;
  if (r >= N) return;
  const int me = t + halo;
  Best<W> best;
  Words<W>::unpack(s_w[me], best.q);
#pragma unroll
  for (int w = 0; w < W; ++w) best.m[w] = 0;  // no best: every one can win
  const int2 mine = s_hp[me];
  const int qh = mine.x;
  best.qpos = mine.y;
  best.bs = kNeg;
  best.bc = 0;
  best.bl = -1;
  // below lo a candidate is out of the window or before the usable history
  const int lo = max(__ldg(hv + b), best.qpos - max_dist);

  auto is_cand = [&](int k) {           // same hash, lo <= cpos < pos
    const int2 c = s_hp[me - k];
    return c.x == qh && c.y >= lo && c.y < best.qpos;
  };
  // K: the staged candidates, k = 1..K; the predicate holds up to K and
  // fails after. Gallop over k = 1, 3, 7, ... (<= S), then bisect.
  const int S = min(chain, me);
  int K = 0, hi = S + 1;
  for (int step = 1; K < S; step <<= 1) {
    const int k = min(K + step, S);
    if (!is_cand(k)) {
      hi = k;
      break;
    }
    K = k;
  }
  while (hi - K > 1) {
    const int mid = (K + hi) >> 1;
    if (is_cand(mid)) K = mid; else hi = mid;
  }
  // past the staged rows only when all of them were candidates
  const int kend = (K == S) ? chain : K;

  // probes k..kto; false once the walk stops (saturation or an exit)
  auto walk = [&](int& k, int kto) -> bool {
    const int ks = min(kto, K);
    for (; k <= ks; ++k) {
      unsigned c[W];
      Words<W>::unpack(s_w[me - k], c);
      if (best.may_win(c) && !best.update(c, s_hp[me - k].y)) {
        ++k;
        return false;
      }
    }
    for (; k <= kto; ++k) {                 // past the halo: global, in L2
      if (k > r) return false;
      const size_t g = lane + r - k;
      const V v = __ldg(wv + g);            // all three loads in flight
      const int ch = __ldg(hs + g);
      const int cp = __ldg(ps + g);
      if (ch != qh || cp < lo || cp >= best.qpos) return false;
      unsigned c[W];
      Words<W>::unpack(v, c);
      if (best.may_win(c) && !best.update(c, cp)) {
        ++k;
        return false;
      }
    }
    return true;
  };

  // the gates split the walk: the dense gate before probe gate_depth + 1
  // (when <= dense), the deep gate before probe dense + 1
  const bool gated = gate_depth + 1 <= dense;
  const int g1 = gated ? gate_depth + 1 : dense + 1;
  int k = 1;
  bool live = walk(k, min(kend, g1 - 1));
  if (live && gated && k <= kend) live = best.cur() < good_l16;
  live = live && walk(k, min(kend, dense));
  if (live && k <= kend) {
    // enc_end is read only where the deep probes run (it may be null else)
    live = best.cur() < good_l16 && best.qpos >= enc_start &&
           best.qpos < __ldg(enc_end + b);
  }
  if (live) walk(k, kend);
  score[lane + r] = best.bs;
  cand[lane + r] = best.bc;
}

template <int W>
cudaError_t launch(const int* w2, const int* hs, const int* ps, const int* hv,
                   const int* ee, int* score, int* cand, int B, int N,
                   int halo, int dense, int chain, int gate_depth,
                   int good_l16, int max_dist, int enc_start,
                   cudaStream_t stream) {
  using V = typename Words<W>::T;
  const dim3 grid((N + kTile - 1) / kTile, B);
  const size_t smem = (sizeof(V) + sizeof(int2)) * (size_t)(kTile + halo);
  probe_walk<W><<<grid, kTile, smem, stream>>>(
      w2, hs, ps, hv, ee, score, cand, N, halo, dense, chain, gate_depth,
      good_l16, max_dist, enc_start);
  return cudaGetLastError();
}

}  // namespace

// w2: (B, N, W) int32 probe words (u32 bits); hs, ps: (B, N) int32, sorted
// by (hash, pos); hv, enc_end: (B,) int32 (enc_end may be null when chain
// == dense). Outputs (B, N) int32. halo: the look-behind rows staged in
// shared memory (capped at chain and kMaxHalo).
// Returns cudaGetLastError() after the launch.
extern "C" int zng_probe_best(const void* w2, const void* hs, const void* ps,
                              const void* hv, const void* enc_end, void* score,
                              void* cand, int B, int N, int W, int halo,
                              int dense, int chain, int gate_depth,
                              int good_l16, int max_dist, int enc_start,
                              void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (dense < 0 || chain < dense || (dense == 0 && chain > 0) || halo < 1 ||
      gate_depth < 0 || B > 65535 || max_dist < 0)
    return cudaErrorInvalidValue;
  halo = std::max(1, std::min(std::min(halo, chain), kMaxHalo));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(w2);
  const int* h = static_cast<const int*>(hs);
  const int* p = static_cast<const int*>(ps);
  const int* v = static_cast<const int*>(hv);
  const int* e = static_cast<const int*>(enc_end);
  int* o1 = static_cast<int*>(score);
  int* o2 = static_cast<int*>(cand);
  if (W == 4)
    return launch<4>(a, h, p, v, e, o1, o2, B, N, halo, dense, chain,
                     gate_depth, good_l16, max_dist, enc_start, s);
  if (W == 2)
    return launch<2>(a, h, p, v, e, o1, o2, B, N, halo, dense, chain,
                     gate_depth, good_l16, max_dist, enc_start, s);
  return cudaErrorInvalidValue;
}
