// K2: greedy/lazy parse chain walk, for Hopper (sm_90a).
//
// Replaces the Pallas kernel zlibng_tpu/ops/parse_pallas.py:_parse_kernel
// (entry parse_select_pallas). For each lane b: i = bounds[b, 0]; while
// i < bounds[b, 1]: sel[b, i] = 1; i += max(step[b, i], 1). Every byte of
// sel is written (0 or 1); the caller allocates it uninitialised.
//
// What bounds it on this card: latency. Each stop is a load whose address
// depends on the previous one, and a 256 KiB text lane holds tens of
// thousands of stops (one per match or literal-run start on the encode
// path's fused steps, one per token on raw steps). The bytes (4 B read per
// stop plus the mask written once) would take about a microsecond at
// 3.35 TB/s; a serial walk on dependent global loads takes 0.2 us a stop.
//
// Design: speculate per segment, then stitch per lane (two launches).
//  1. parse_speculate: one warp per (lane, segment of kSeg positions).
//     The warp stages the next stop of every position in [lo - kLead, hi)
//     (from step, read with 16-byte loads) in shared memory, and lane 0
//     chases it from max(start, lo - kLead): the lead-in walk guesses the
//     lane's true entry into the segment (the segment holding `start`
//     starts exactly there). It records the guess g (first stop >= lo) and
//     the exit x (first stop >= hi, or `end`), builds the segment's mask in
//     shared memory and the warp writes all of it. Walks from different
//     points mostly merge within the lead-in: a fused literal step jumps to
//     the next match start, and a match is at most 258 long, so kLead >=
//     2 x 258 usually reaches a common stop. Every warp's walk is
//     ~(kSeg + kLead) / (mean step) shared-memory loads, and all segments
//     of all lanes run at once across the SMs.
//  2. parse_stitch: one block per lane carries the true entry e across
//     the lane's segments in order; warp 0 checks 32 segments at a time.
//     e == g: the speculative path was the true one, e = x. Otherwise the
//     block stages the segment's next stops and mask in shared memory and
//     one thread walks from e until it reaches a stop the speculation
//     marked (from there both paths agree and the exit is x) or leaves the
//     segment; the marks before that point are replaced by the true stops.
//     An entry at or past the segment's end (a long fused literal jump)
//     clears whatever the speculation marked there.
//
// Exact for any int32 step and any bounds: a step is max(st, 1), clamped so
// the walk never passes `end` (no overflow at INT32_MAX or at decode's
// 1 << 26 terminator). Speculation only decides how much the stitch
// repairs. Worst case: a periodic step (all 3, or all 258) whose lead-in
// walk never meets the true path, so every segment is repaired one after
// the other, each a serial walk across the whole segment in shared memory
// (~50 ns a stop) after a 10 KB stage.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// positions per phase-1 segment and the lead-in before it (ops/parse.py's
// SEG and LEAD); kSeg and kLead are multiples of 16
constexpr int kSeg = 2048;
constexpr int kLead = 512;
constexpr int kStitchThreads = 256;
constexpr int kChunk = 1024;       // (g, x) pairs a stitch block stages at once

// The stop after i: i + max(st, 1), or end if that reaches it (end if
// i >= end).
__device__ __forceinline__ int next_stop(int i, int st, int end) {
  const int s = st > 1 ? st : 1;
  return s >= end - i ? end : i + s;
}

// nx[j] = next_stop(base + j, src[j], end) - base for j in [0, n), by
// threads t of nt, 16-byte loads when aligned: the walk that follows is a
// bare chase of nx through shared memory.
__device__ __forceinline__ void load_next(int* nx, const int* __restrict__ src,
                                          int n, int base, int end, int t,
                                          int nt) {
  int j0 = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(nx))
       & 15) == 0) {
    const int n4 = n >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int j = t; j < n4; j += nt) {
      const int4 v = __ldg(s4 + j);
      const int p = base + 4 * j;
      reinterpret_cast<int4*>(nx)[j] = make_int4(
          next_stop(p, v.x, end) - base, next_stop(p + 1, v.y, end) - base,
          next_stop(p + 2, v.z, end) - base, next_stop(p + 3, v.w, end) - base);
    }
    j0 = n4 << 2;
  }
  for (int j = j0 + t; j < n; j += nt)
    nx[j] = next_stop(base + j, __ldg(src + j), end) - base;
}

// dst[0, n) = src[0, n) bytes by threads t of nt; 16-byte words when aligned.
__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src, int n,
                                           int t, int nt) {
  int j0 = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0) {
    const int n16 = n >> 4;
    for (int j = t; j < n16; j += nt)
      reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(src)[j];
    j0 = n16 << 4;
  }
  for (int j = j0 + t; j < n; j += nt) dst[j] = src[j];
}

// Phase 1. Grid (nseg, B), one warp each.
__global__ void __launch_bounds__(32)
parse_speculate(const int* __restrict__ step, const int* __restrict__ bounds,
                unsigned char* __restrict__ sel, int2* __restrict__ guess,
                int N, int nseg) {
  __shared__ __align__(16) int nx[kLead + kSeg];       // next stops
  __shared__ __align__(16) unsigned char sm[kSeg];     // the segment's mask
  const int k = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int lo = k * kSeg;
  const int n = min(kSeg, N - lo);
  const int start = bounds[2 * b];
  const int end = min(bounds[2 * b + 1], N);
  for (int j = t; j < kSeg / 16; j += 32)
    reinterpret_cast<int4*>(sm)[j] = make_int4(0, 0, 0, 0);
  const bool live = start >= 0 && start < end && lo < end && start < lo + n;
  const int a0 = max(lo - kLead, 0);
  if (live)
    load_next(nx, step + (size_t)b * N + a0, lo + n - a0, a0, end, t, 32);
  __syncwarp();
  if (t == 0) {
    int2 gx = make_int2(end, end);
    if (live) {
      // positions relative to a0: lead-in [.., rlo), body [rlo, rhe)
      const int rlo = lo - a0, rhe = min(lo + n, end) - a0;
      int r = max(start, a0) - a0;
      while (r < rlo) r = nx[r];
      gx.x = r + a0;
      while (r < rhe) {
        sm[r - rlo] = 1;
        r = nx[r];
      }
      gx.y = r + a0;
    }
    guess[(size_t)b * nseg + k] = gx;
  }
  __syncwarp();
  copy_bytes(sel + (size_t)b * N + lo, sm, n, t, 32);
}

// Phase 2. Grid (B), kStitchThreads each. stats[b] = (segments repaired,
// cleared).
__global__ void __launch_bounds__(kStitchThreads)
parse_stitch(const int* __restrict__ step, const int* __restrict__ bounds,
             unsigned char* __restrict__ sel, const int2* __restrict__ guess,
             int* __restrict__ stats, int N, int nseg) {
  __shared__ __align__(16) int nx[kSeg];               // next stops
  __shared__ __align__(16) unsigned char sm[kSeg];     // the segment's mask
  __shared__ int2 gx[kChunk];                          // (guess, exit) pairs
  __shared__ int s_e, s_kind, s_k, s_c;   // entry; job; merge point
  const int b = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int start = bounds[2 * b];
  const int end = min(bounds[2 * b + 1], N);
  const int* st = step + (size_t)b * N;
  unsigned char* out = sel + (size_t)b * N;
  int repairs = 0, clears = 0;                    // thread 0's counts
  if (t == 0) s_e = start;
  if (start >= 0 && start < end) {
    const int k_end = (end - 1) / kSeg + 1;       // segments with lo < end
    for (int c0 = start / kSeg; c0 < k_end; c0 += kChunk) {
      const int cn = min(kChunk, k_end - c0);
      __syncthreads();
      for (int j = t; j < cn; j += nt) gx[j] = guess[(size_t)b * nseg + c0 + j];
      __syncthreads();
      int k = c0;
      for (;;) {
        if (t < 32) {
          // warp 0 scans to the next segment whose speculation was wrong;
          // e, k and kind stay the same in all its lanes
          int e = s_e, kind = 0;                  // 0 none, 1 clear, 2 repair
          while (k < c0 + cn) {
            const int lo = k * kSeg;
            const int he = end - lo > kSeg ? lo + kSeg : end;
            const int2 p = gx[k - c0];
            if (e == p.x) {
              // the guess was the true entry; so is each later guess that
              // equals its predecessor's exit: skip those 32 at a time
              for (;;) {
                const int j = k + 1 + t;
                const bool ok =
                    j < c0 + cn && gx[j - c0].x == gx[j - 1 - c0].y;
                const unsigned run = __ballot_sync(0xffffffffu, ok);
                const int m = run == 0xffffffffu ? 32 : __ffs(~run) - 1;
                k += m;
                if (m < 32) break;
              }
              e = gx[k - c0].y;
              ++k;
              continue;
            }
            if (e >= he) {                        // no true stop in [lo, he)
              if (p.x < he) {
                kind = 1;
                break;
              }
              ++k;
              continue;
            }
            kind = 2;
            break;
          }
          __syncwarp();                           // every lane has read s_e
          if (t == 0) {
            s_e = e;
            s_kind = kind;
            s_k = k;
          }
        }
        __syncthreads();
        const int kind = s_kind;
        if (kind == 0) break;
        k = s_k;
        const int lo = k * kSeg;
        const int n = end - lo > kSeg ? kSeg : end - lo;  // [lo, he)
        if (kind == 1) {
          for (int j = t; j < n; j += nt) out[lo + j] = 0;
          if (t == 0) ++clears;
        } else {
          load_next(nx, st + lo, n, lo, end, t, nt);
          copy_bytes(sm, out + lo, n, t, nt);
          __syncthreads();
          if (t == 0) {
            // walk from the true entry until it meets a speculative stop
            // (c) or leaves the segment, marking its own stops 2
            int r = s_e - lo, c = n;
            while (r < n) {
              if (sm[r]) {
                c = r;
                break;
              }
              sm[r] = 2;
              r = nx[r];
            }
            s_e = c < n ? gx[k - c0].y : r + lo;
            s_c = c;
            ++repairs;
          }
          __syncthreads();
          const int c = s_c;
          for (int j = t; j < n; j += nt) {
            const unsigned char v = sm[j];
            sm[j] = v == 2 || (j >= c && v == 1);
          }
          __syncthreads();
          copy_bytes(out + lo, sm, n, t, nt);
        }
        ++k;
        __syncthreads();
      }
    }
  }
  if (t == 0) {
    stats[2 * b] = repairs;
    stats[2 * b + 1] = clears;
  }
}

}  // namespace

// step: (B, N) int32; bounds: (B, 2) int32 [start, end); sel: (B, N) uint8,
// every byte written; guess: (B, ceil(N / kSeg), 2) int32 scratch; stats:
// (B, 2) int32 out (segments repaired, cleared). Two launches on `stream`;
// returns the first non-zero cudaGetLastError() after a launch, or 0.
extern "C" int zng_parse_select(const void* step, const void* bounds,
                                void* sel, void* guess, void* stats, int B,
                                int N, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = (N - 1) / kSeg + 1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  parse_speculate<<<dim3(nseg, B), 32, 0, s>>>(
      static_cast<const int*>(step), static_cast<const int*>(bounds),
      static_cast<unsigned char*>(sel), static_cast<int2*>(guess), N, nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  parse_stitch<<<B, kStitchThreads, 0, s>>>(
      static_cast<const int*>(step), static_cast<const int*>(bounds),
      static_cast<unsigned char*>(sel), static_cast<const int2*>(guess),
      static_cast<int*>(stats), N, nseg);
  return static_cast<int>(cudaGetLastError());
}
