// Stage 2's token render, for Hopper (sm_90a): one launch per render call.
//
// Replaces no Pallas kernel. The reference renders with XLA array code
// (zlibng_tpu/ops/bitpack_jax.py and the demotion of its stage 2), which
// the port ran as eager PyTorch (ops/bitpack.py:render_tokens, its CPU
// route): ~160 launches a call without the demotion and ~200 with it (its
// int64 cumsum over (R, N, 2) and cummax among them), ~2 ms of launches
// for a call of a few rows. Row r of the (R, N) rows gives, at every
// selected position, the token's bits as two u32 halves (lo, hi) in int64
// and their count (nbits): a literal's code, or a match's length code,
// length extra bits, distance code and distance extra bits, LSB first
// (the three fields OR-placed at up to 55 bits as _or_field does), 0 where
// the position is not selected. With the demotion, a selected match whose
// bits exceed the literal bits of its span (the row's bytes
// [pos, min(pos + len, N))) turns into literals, unless a byte of its span
// has no literal code, and so does every position that a demoted span
// covers (pos < the furthest end of a demoted match at or before pos).
// Bit for bit what render_tokens gives for matches of length 3..258 at
// distance 1..32,768.
//
// What bounds it on this card: bytes. A position reads its byte, length,
// distance and selection (~10 B) and writes lo, hi and nbits (20 B): ~63
// MB for a lane group of 128 x 16,384 positions, ~19 us at 3.35 TB/s; a
// call of a few rows is under 1 us, so there the launch is the cost.
//
// Design: the code tables of a block's row (one set per row, or one set
// for every row: row step 0), 1,432 B, go to shared memory once. Inputs
// are read in place, as views: row r is unit r % upl of lane r / upl, at
// its own lane and unit strides per input (tok_len and tok_dist int32 or
// int64), so no copy or cast precedes the launch.
// - Without the demotion a position depends on nothing else: tiles of
//   kChunk positions, R x tiles blocks, consecutive threads on
//   consecutive positions, so a few long rows still fill the card.
// - With it, one block per row walks the row in chunks of kChunk
//   positions, kPer consecutive ones a thread. Per chunk: the literal bits
//   (and "no code") of a window of the chunk and the kHalo positions that
//   a chunk's match can reach go to shared memory and are scanned there
//   (a segment a thread, then the segments' sums on warp shuffles), so
//   a span's bits are a difference of two prefix sums with no carry
//   between chunks; then the demoted matches' ends take a block-wide
//   prefix max (warp shuffles, the warps' maxima in shared memory), with
//   the furthest end of the chunks before carried in a register. Two
//   prefix sums of at most kWin + 1 ints, ~18 KB, in place of the row's
//   whole (~128 KB). No atomics, no other block's data: the result does
//   not depend on timing. Every output element is written, 0 where not
//   selected, so the wrapper allocates them uninitialised.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                      // positions a thread per chunk
constexpr int kChunk = kThreads * kPer;      // 2,048 positions
constexpr int kHalo = 258;                   // the longest match's span
constexpr int kWin = kChunk + kHalo;
constexpr int kSeg = (kWin + kThreads - 1) / kThreads;
constexpr int kLit = 288;
constexpr int kDist = 30;
constexpr long long kM32 = 0xFFFFFFFFLL;

// An input's rows: element i of row r lies at
// p + (r / upl) * lane + (r % upl) * unit + i (in elements).
struct View {
  const void* p;
  long long lane, unit;
};

struct Args {
  View lits, tl, td, sel;                    // u8, TI, TI, bool
  const int *ll, *lc, *dl, *dc;              // code lengths and codes
  int lit_step, dist_step;                   // a row's table step: 0 or width
  long long *lo, *hi;                        // (R, N) outputs
  int* nbits;
  int N, upl, tiles;
};

struct Tables {
  int ll[kLit], lc[kLit], dl[kDist], dc[kDist];
};

// A match's symbols and extra bits, as lz77.py's length_code_arith,
// length_extra_arith, dist_code_arith and dist_extra_arith give them
// (lengths below 3 and distances below 1 clamped as there; symbols kept in
// the tables' range, which only a length over 258 or a distance over
// 32,768 would leave).
struct Match {
  int lsym, le, lv, dsym, de, dv;
};

__device__ __forceinline__ int floor_log2(int x) { return 31 - __clz(x); }

__device__ __forceinline__ Match match_of(int tl, int td) {
  Match m;
  const int l = tl < 3 ? 3 : tl;
  const int l3 = l - 3;
  if (l == 258 || l3 < 8) {
    m.lsym = l == 258 ? 285 : 257 + l3;
    m.le = 0;
    m.lv = 0;
  } else {
    const int e = floor_log2(l3) - 2;
    m.lsym = 257 + ((e + 1) << 2) + ((l3 >> e) & 3);
    m.le = e;
    m.lv = l3 & ((1 << e) - 1);
  }
  const int d1 = (td < 1 ? 1 : td) - 1;
  if (d1 < 4) {
    m.dsym = d1;
    m.de = 0;
    m.dv = 0;
  } else {
    const int e = floor_log2(d1) - 1;
    m.dsym = ((e + 1) << 1) + ((d1 >> e) & 1);
    m.de = e;
    m.dv = d1 & ((1 << e) - 1);
  }
  if (m.lsym > kLit - 1) m.lsym = kLit - 1;
  if (m.dsym > kDist - 1) m.dsym = kDist - 1;
  return m;
}

// A match's bits: its length code, extra bits, distance code and extra.
__device__ __forceinline__ int match_bits(const Tables& tb, const Match& m) {
  return tb.ll[m.lsym] + m.le + tb.dl[m.dsym] + m.de;
}

// (lo, hi) |= val << sh for a value held as two u32 halves in int64, with
// _or_field's arithmetic (sh >= 0: a sum of code lengths and extra bits).
__device__ __forceinline__ void or_field(long long& lo, long long& hi,
                                         long long val, int sh) {
  const unsigned long long v = static_cast<unsigned long long>(val);
  if (sh < 32) {
    lo |= static_cast<long long>(v << sh) & kM32;
    if (sh > 0) hi |= val >> (32 - sh);
  } else {
    hi |= static_cast<long long>(v << (sh - 32 < 31 ? sh - 32 : 31)) & kM32;
  }
}

// Writes position o's token: a match (match), a literal (sel alone) or
// nothing.
__device__ __forceinline__ void put(const Args& a, const Tables& tb,
                                    long long o, int lit, int tl, int td,
                                    bool sel, bool match) {
  long long lo = 0, hi = 0;
  int nb = 0;
  if (match) {
    const Match m = match_of(tl, td);
    lo = tb.lc[m.lsym];
    int sh = tb.ll[m.lsym];
    or_field(lo, hi, m.lv, sh);
    sh += m.le;
    or_field(lo, hi, tb.dc[m.dsym], sh);
    sh += tb.dl[m.dsym];
    or_field(lo, hi, m.dv, sh);
    nb = match_bits(tb, m);
  } else if (sel) {
    lo = tb.lc[lit];
    nb = tb.ll[lit];
  }
  a.lo[o] = lo;
  a.hi[o] = hi;
  a.nbits[o] = nb;
}

__device__ __forceinline__ void load_tables(Tables& tb, const Args& a,
                                            long long r) {
  const int* ll = a.ll + r * a.lit_step;
  const int* lc = a.lc + r * a.lit_step;
  const int* dl = a.dl + r * a.dist_step;
  const int* dc = a.dc + r * a.dist_step;
  for (int i = threadIdx.x; i < kLit; i += kThreads) {
    tb.ll[i] = ll[i];
    tb.lc[i] = lc[i];
  }
  for (int i = threadIdx.x; i < kDist; i += kThreads) {
    tb.dl[i] = dl[i];
    tb.dc[i] = dc[i];
  }
}

// Row r of an input of element type T.
template <class T>
__device__ __forceinline__ const T* row_of(const View& v, long long r,
                                           int upl) {
  return static_cast<const T*>(v.p) + (r / upl) * v.lane +
         (r % upl) * v.unit;
}

// Without the demotion: block (r, tile) renders positions
// [tile * kChunk, (tile + 1) * kChunk) of row r.
template <class TI>
__global__ void __launch_bounds__(kThreads) render_tiles(const Args a) {
  __shared__ Tables tb;
  const long long blk = blockIdx.x;
  const long long r = blk / a.tiles;
  const int c0 = static_cast<int>(blk % a.tiles) * kChunk;
  load_tables(tb, a, r);
  const unsigned char* lits = row_of<unsigned char>(a.lits, r, a.upl);
  const TI* tlp = row_of<TI>(a.tl, r, a.upl);
  const TI* tdp = row_of<TI>(a.td, r, a.upl);
  const bool* selp = row_of<bool>(a.sel, r, a.upl);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int pos = c0 + k * kThreads + static_cast<int>(threadIdx.x);
    if (pos >= a.N) break;
    const int tl = static_cast<int>(tlp[pos]);
    const bool sel = selp[pos];
    put(a, tb, r * a.N + pos, lits[pos], tl, static_cast<int>(tdp[pos]),
        sel, sel && tl > 0);
  }
}

// With the demotion: block r renders row r, chunk by chunk.
template <class TI>
__global__ void __launch_bounds__(kThreads) render_demote(const Args a) {
  __shared__ Tables tb;
  // prefix sums over the window [c0, c0 + w) of the literal bits (cb) and
  // of the bytes without a literal code (cz): element i sums the first i
  __shared__ int cb[kWin + 1];
  __shared__ int cz[kWin + 1];
  __shared__ int warp_b[kWarps], warp_z[kWarps], warp_max[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long r = blockIdx.x;
  const int N = a.N;
  load_tables(tb, a, r);
  const unsigned char* lits = row_of<unsigned char>(a.lits, r, a.upl);
  const TI* tlp = row_of<TI>(a.tl, r, a.upl);
  const TI* tdp = row_of<TI>(a.td, r, a.upl);
  const bool* selp = row_of<bool>(a.sel, r, a.upl);
  __syncthreads();

  int carry = 0;                 // the furthest demoted end so far
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    // ---- the window's literal bits, then their prefix sums ----------
    const int w = N - c0 < kWin ? N - c0 : kWin;
    for (int i = t; i < w; i += kThreads) {
      const int n = tb.ll[lits[c0 + i]];
      cb[i + 1] = n;
      cz[i + 1] = n == 0;
    }
    if (t == 0) cb[0] = cz[0] = 0;
    __syncthreads();
    const int s0 = 1 + t * kSeg;
    const int s1 = s0 + kSeg < w + 1 ? s0 + kSeg : w + 1;
    int sb = 0, sz = 0;
    for (int i = s0; i < s1; ++i) {
      sb += cb[i];
      cb[i] = sb;
      sz += cz[i];
      cz[i] = sz;
    }
    int ib = sb, iz = sz;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int yb = __shfl_up_sync(0xffffffffu, ib, d);
      const int yz = __shfl_up_sync(0xffffffffu, iz, d);
      if (lane >= d) {
        ib += yb;
        iz += yz;
      }
    }
    if (lane == 31) {
      warp_b[warp] = ib;
      warp_z[warp] = iz;
    }
    __syncthreads();
    int ob = ib - sb, oz = iz - sz;
    for (int k = 0; k < warp; ++k) {
      ob += warp_b[k];
      oz += warp_z[k];
    }
    for (int i = s0; i < s1; ++i) {
      cb[i] += ob;
      cz[i] += oz;
    }
    __syncthreads();

    // ---- this thread's positions: which matches are demoted ---------
    const int i0 = c0 + t * kPer;
    int lit[kPer], tl[kPer], td[kPer], upto[kPer];
    bool sel[kPer];
    int mx = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int pos = i0 + k;
      const bool in = pos < N;
      lit[k] = in ? lits[pos] : 0;
      tl[k] = in ? static_cast<int>(tlp[pos]) : 0;
      td[k] = in ? static_cast<int>(tdp[pos]) : 0;
      sel[k] = in && selp[pos];
      if (sel[k] && tl[k] > 0) {
        // the span's end, clamped at N: the window ends at N or past the
        // longest match
        const int p = pos - c0;
        const int e = tl[k] > w - p ? w : p + tl[k];
        const int span_bits = cb[e] - cb[p];
        const bool span_zero = cz[e] - cz[p] > 0;
        if (!span_zero && match_bits(tb, match_of(tl[k], td[k])) > span_bits)
          mx = mx > pos + tl[k] ? mx : pos + tl[k];
      }
      upto[k] = mx;
    }

    // ---- the block's prefix max of the demoted ends -----------------
    int im = mx;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, im, d);
      if (lane >= d) im = im > y ? im : y;
    }
    int before = __shfl_up_sync(0xffffffffu, im, 1);
    if (lane == 0) before = 0;
    if (lane == 31) warp_max[warp] = im;
    __syncthreads();
    before = before > carry ? before : carry;
    int chunk_max = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int m = warp_max[k];
      if (k < warp && m > before) before = m;
      if (m > chunk_max) chunk_max = m;
    }

    // ---- the tokens --------------------------------------------------
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int pos = i0 + k;
      if (pos >= N) break;
      const int end = upto[k] > before ? upto[k] : before;
      const bool covered = pos < end;
      put(a, tb, r * N + pos, lit[k], tl[k], td[k], sel[k] || covered,
          sel[k] && tl[k] > 0 && !covered);
    }
    carry = carry > chunk_max ? carry : chunk_max;
    __syncthreads();             // the next chunk rewrites the window
  }
}

inline View view_of(const void* p, long long lane, long long unit) {
  View v;
  v.p = p;
  v.lane = lane;
  v.unit = unit;
  return v;
}

// The kernel's arguments from zng_render's (see there).
inline Args args_of(const void* lits, long long lits_lane,
                    long long lits_unit, const void* tl, long long tl_lane,
                    long long tl_unit, const void* td, long long td_lane,
                    long long td_unit, const void* sel, long long sel_lane,
                    long long sel_unit, const void* ll, const void* lc,
                    const void* dl, const void* dc, int per_row, void* lo,
                    void* hi, void* nbits, int N, int upl) {
  Args a;
  a.lits = view_of(lits, lits_lane, lits_unit);
  a.tl = view_of(tl, tl_lane, tl_unit);
  a.td = view_of(td, td_lane, td_unit);
  a.sel = view_of(sel, sel_lane, sel_unit);
  a.ll = static_cast<const int*>(ll);
  a.lc = static_cast<const int*>(lc);
  a.dl = static_cast<const int*>(dl);
  a.dc = static_cast<const int*>(dc);
  a.lit_step = per_row ? kLit : 0;
  a.dist_step = per_row ? kDist : 0;
  a.lo = static_cast<long long*>(lo);
  a.hi = static_cast<long long*>(hi);
  a.nbits = static_cast<int*>(nbits);
  a.N = N;
  a.upl = upl;
  a.tiles = (N + kChunk - 1) / kChunk;
  return a;
}

}  // namespace

#ifdef __CUDACC__
// lits (u8), tok_len and tok_dist (int32, or int64 with wide), sel (bool):
// (R, N) rows, row r being unit r % upl of lane r / upl at each input's
// lane and unit strides (elements); code tables int32: lengths and codes
// of 288 literal/length and 30 distance symbols, one set per row with
// per_row (row r's at r * 288 and r * 30), else one set for every row;
// lo, hi (int64) and nbits (int32): (R, N) contiguous, every element
// written. R >= 0, N >= 0, upl >= 1 dividing R. One launch on `stream`
// when R * N > 0; returns cudaGetLastError() after it, or 0.
extern "C" int zng_render(const void* lits, long long lits_lane,
                          long long lits_unit, const void* tl,
                          long long tl_lane, long long tl_unit,
                          const void* td, long long td_lane,
                          long long td_unit, const void* sel,
                          long long sel_lane, long long sel_unit,
                          const void* ll, const void* lc, const void* dl,
                          const void* dc, int per_row, void* lo, void* hi,
                          void* nbits, int R, int N, int upl, int wide,
                          int demote, void* stream) {
  if (R < 0 || N < 0 || upl < 1 || R % upl != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || N == 0) return 0;
  const Args a = args_of(lits, lits_lane, lits_unit, tl, tl_lane, tl_unit,
                         td, td_lane, td_unit, sel, sel_lane, sel_unit, ll,
                         lc, dl, dc, per_row, lo, hi, nbits, N, upl);
  const long long blocks = demote ? R : static_cast<long long>(R) * a.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(blocks);
  if (demote && wide)
    render_demote<long long><<<g, kThreads, 0, s>>>(a);
  else if (demote)
    render_demote<int><<<g, kThreads, 0, s>>>(a);
  else if (wide)
    render_tiles<long long><<<g, kThreads, 0, s>>>(a);
  else
    render_tiles<int><<<g, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#endif
