// Stage 2 auto's Huffman tables and dynamic-block headers, for Hopper
// (sm_90a): one launch per lane group, one block per row.
//
// Replaces no Pallas kernel. The reference builds these tables with XLA
// loops (zlibng_tpu/ops/huffman_jax.py: huff_table's _phase1_scan and
// _phase2_scan, dyn_header's _rle_scan), which the port ran as eager
// PyTorch (ops/huffman.py: huff_table twice, then dyn_header): tens of
// launches and a host wait per serial step, ~30,000 launches per group.
// A row here is ops/huffman.py's huff_table of its 286 literal/length and
// of its 30 distance frequencies (15-bit limit), then dyn_header of the two
// length sets (scan_tree RLE of the concatenated lengths, the 19-symbol
// code-length tree with a 7-bit limit, the fixed-slot header tokens),
// bit-identical to them and so to huffman/encode.py and to
// native/zng_host.c:zng_huff_table/zng_dyn_header, whose serial C is a
// readable model of every step below.
//
// What bounds it on this card: latency. A tree is a chain of dependent
// shared-memory steps: Moffat-Katajainen phase 1 (m - 1 steps of two
// picks), phase 2 (m - 2), the leaf count per depth (m plus the depth),
// then the header's RLE (hlit + hdist <= 316 steps) and the code-length
// tree's own chain: ~(m - 1) + L dependent steps, ~1,000 of ~20-40 cycles
// for a full literal alphabet. The bytes are ~160 KB in and ~1.3 MB out
// per 128-row group, under 1 us at 3.35 TB/s. Expected: tens of us a
// launch, at G = 128 (one wave of 128 blocks on 132 SMs) and at G = 32
// alike. Measured on an H100 (700 W): 0.03 ms for rows of a few symbols,
// 0.05-0.12 ms for L6 groups of text (rows of up to ~280 symbols); the
// time follows the longest row's alphabet, not G.
//
// Design: one block of kThreads per row, its state in shared memory (~9
// KB). What is not a chain runs one thread per symbol: the sort by (freq
// asc, sym asc) as each nonzero symbol's rank among all (the key is
// unique, so the rank is its place), the reassignment after the Kraft
// restore as a second rank by (length asc, freq desc, sym asc), the
// canonical codes (the length's first code plus the number of smaller
// symbols of that length) and their bit reversal, the header's lengths
// array and its token slots. The chains run on one thread each: the
// literal tree on warp 0 and the distance tree on warp 9 at the same time,
// then the RLE and the code-length tree on warp 0. The Kraft restore works
// on the <= 16 length counts, with no host read. The header's bit total
// is 17 + 3 * hclen + the code-length frequencies times (code length +
// extra bits), 19 terms, with no reduction across the block. Frequencies
// must be below 2^22 (the plain version's sort keys; a block of the codec
// counts at most 2^18 symbols).
#include <cuda_runtime.h>

namespace {

constexpr int kLit = 286;             // literal/length alphabet
constexpr int kDist = 30;             // distance alphabet
constexpr int kCl = 19;               // code-length alphabet
constexpr int kMaxBits = 15;          // MAX_BITS
constexpr int kMaxBlBits = 7;         // MAX_BL_BITS
constexpr int kLTot = kLit + kDist;   // lengths the RLE reads, at most
constexpr int kTMax = 320;            // token slots (ops/huffman.py _TMAX)
constexpr int kSlots = 21 + 2 * kTMax;  // HDR_SLOTS
constexpr int kThreads = 320;         // >= kLTot and >= kDistT + kDist
constexpr int kDistT = 288;           // first thread of the distance tree

__constant__ int kBlOrder[kCl] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                  11, 4,  12, 3, 13, 2, 14, 1, 15};
// extra bits of each code-length symbol: 16 (repeat 3-6), 17 (zeros
// 3-10), 18 (zeros 11-138)
__constant__ int kClExtra[kCl] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                  0, 0, 0, 0, 0, 0, 2, 3, 7};

// One tree of N symbols, in shared memory.
template <int N>
struct Tree {
  int freq[N];
  int a[N];     // weights in sorted order, then phase 1's parent pointers
                // and internal weights, then phase 2's internal depths
  int ord[N];   // the nonzero symbols by (freq asc, sym asc)
  int len[N];   // code lengths
  int bl[kMaxBits + 1];    // symbols per length after the Kraft restore
  int next[kMaxBits + 1];  // first canonical code of each length
  int m;                   // nonzero symbols
};

// Thread of symbol s: its place in ord and a; zeroes its length.
template <int N>
__device__ __forceinline__ void rank_freq(Tree<N>& T, int s) {
  const int f = T.freq[s];
  T.len[s] = 0;
  if (f <= 0) return;
  int r = 0;
#pragma unroll 8
  for (int j = 0; j < N; ++j) {
    const int g = T.freq[j];
    r += (g > 0) & ((g < f) | ((g == f) & (j < s)));
  }
  T.ord[r] = s;
  T.a[r] = f;
  atomicAdd(&T.m, 1);
}

// One thread: phases 1-3 of the exact build, each length clamped to
// max_bits and counted, the Kraft restore on the counts, and each length's
// first canonical code (zng_host.c:zng_huff_table). len[] is left
// clamped; the reassignment follows.
template <int N>
__device__ void build_lengths(Tree<N>& T, int max_bits) {
  const int m = T.m;
  int* a = T.a;
  int* bl = T.bl;
  for (int b = 0; b <= kMaxBits; ++b) bl[b] = 0;
  if (m == 1) {
    T.len[T.ord[0]] = 1;        // DEFLATE needs a >= 1-bit code
    bl[1] = 1;
  } else if (m >= 2) {
    // phase 1: in-place merge; a[t] becomes internal node t's weight, and
    // a consumed internal node's slot its parent t
    int s = 0, r = 0;
    for (int t = 0; t < m - 1; ++t) {
      int w;
      if (s >= m || (r < t && a[r] < a[s])) {
        w = a[r];
        a[r] = t;
        ++r;
      } else {
        w = a[s];
        ++s;
      }
      if (s >= m || (r < t && a[r] < a[s])) {
        w += a[r];
        a[r] = t;
        ++r;
      } else {
        w += a[s];
        ++s;
      }
      a[t] = w;                 // s > t here, so no leaf is read after
    }
    // phase 2: internal node depths, root first
    a[m - 2] = 0;
    for (int t = m - 3; t >= 0; --t) a[t] = a[a[t]] + 1;
    // phase 3: leaves per depth, given to the symbols most frequent first
    int avail = 1, depth = 0, t = m - 2, k = m - 1;
    while (avail > 0) {
      int used = 0;
      while (t >= 0 && a[t] == depth) {
        ++used;
        --t;
      }
      const int d = depth < max_bits ? depth : max_bits;
      for (int leaves = avail - used; leaves > 0; --leaves)
        T.len[T.ord[k--]] = d;
      bl[d] += avail - used;
      avail = 2 * used;
      ++depth;
    }
    // Kraft restore: per unit of oversubscription, demote one leaf of the
    // deepest length below max_bits and promote one of max_bits
    int kraft = 0;
    for (int b = 1; b <= max_bits; ++b) kraft += bl[b] << (max_bits - b);
    for (; kraft > (1 << max_bits); --kraft) {
      int bits = max_bits - 1;
      while (bl[bits] == 0) --bits;
      --bl[bits];
      bl[bits + 1] += 2;
      --bl[max_bits];
    }
  }
  int code = 0;
  T.next[0] = 0;
  for (int b = 1; b <= kMaxBits; ++b) {
    code = (code + bl[b - 1]) << 1;
    T.next[b] = code;
  }
}

// Thread of symbol s: its length after the restore. The nonzero symbols
// by (clamped length asc, freq desc, sym asc) take bl's lengths in order;
// without a restore every symbol keeps its own.
template <int N>
__device__ __forceinline__ int reassigned(const Tree<N>& T, int s) {
  const int f = T.freq[s];
  if (f <= 0) return 0;
  const int l = T.len[s];
  int r = 0;
#pragma unroll 8
  for (int j = 0; j < N; ++j) {
    const int g = T.freq[j], lj = T.len[j];
    r += (g > 0) &
         ((lj < l) | ((lj == l) & ((g > f) | ((g == f) & (j < s)))));
  }
  int b = 0, cum = T.bl[0];
  while (cum <= r) cum += T.bl[++b];
  return b;
}

// Thread of symbol s: its canonical code, bit-reversed over its length
// (the LSB-first emission form); 0 for an unused symbol.
template <int N>
__device__ __forceinline__ int rev_code(const Tree<N>& T, int s) {
  const int l = T.len[s];
  if (l == 0) return 0;
  int c = T.next[l];
  for (int j = 0; j < s; ++j) c += T.len[j] == l;
  return static_cast<int>(__brev(static_cast<unsigned>(c)) >> (32 - l));
}

// One thread: scan_tree's RLE (trees.c:411-453) of v[0, L) into tokens
// (sym, extra; extra -1 for a plain length), counted in freq. Returns the
// token count (<= L: a token covers at least one length).
__device__ int rle(const int* v, int L, int* sym, int* extra, int* freq) {
  int n = 0;
  auto emit = [&](int s, int e) {
    sym[n] = s;
    extra[n] = e;
    ++freq[s];
    ++n;
  };
  int prevlen = -1, count = 0;
  int maxc = v[0] == 0 ? 138 : 7, minc = v[0] == 0 ? 3 : 4;
  for (int i = 0; i < L; ++i) {
    const int cur = v[i], nxt = i + 1 < L ? v[i + 1] : -2;
    const int cnt = count + 1;
    if (cnt < maxc && cur == nxt) {
      count = cnt;
      continue;
    }
    if (cnt < minc) {
      for (int k = 0; k < cnt; ++k) emit(cur, -1);
    } else if (cur != 0) {
      int c = cnt;
      if (cur != prevlen) {
        emit(cur, -1);
        --c;
      }
      emit(16, c - 3);
    } else if (cnt <= 10) {
      emit(17, cnt - 3);
    } else {
      emit(18, cnt - 11);
    }
    count = 0;
    prevlen = cur;
    if (nxt == 0) {
      maxc = 138;
      minc = 3;
    } else if (cur == nxt) {
      maxc = 6;
      minc = 3;
    } else {
      maxc = 7;
      minc = 4;
    }
  }
  return n;
}

// Grid (G), kThreads each: row g's tables and header.
__global__ void __launch_bounds__(kThreads)
huff_build(const int* __restrict__ lfreq, const int* __restrict__ dfreq,
           int* __restrict__ llen, int* __restrict__ lcode,
           int* __restrict__ dlen, int* __restrict__ dcode,
           long long* __restrict__ hdr_lo, int* __restrict__ hdr_nb,
           int* __restrict__ hdr_bits, int btype_bits) {
  __shared__ Tree<kLit> lit;
  __shared__ Tree<kDist> dist;
  __shared__ Tree<kCl> cl;
  __shared__ int v[kLTot];              // the concatenated lengths
  __shared__ int tsym[kTMax], textra[kTMax];
  __shared__ int clcode[kCl];
  __shared__ int s_hlit, s_hdist, s_hclen, s_ntok, s_bits;
  const int g = blockIdx.x, t = threadIdx.x;
  const int td = t - kDistT;            // distance symbol of this thread
  const bool is_l = t < kLit, is_d = td >= 0 && td < kDist;
  const size_t gl = static_cast<size_t>(g) * kLit;
  const size_t gd = static_cast<size_t>(g) * kDist;

  if (is_l) lit.freq[t] = lfreq[gl + t];
  if (is_d) dist.freq[td] = dfreq[gd + td];
  if (t < kCl) cl.freq[t] = 0;
  if (t == 0) {
    lit.m = dist.m = cl.m = 0;
    s_hlit = 257;
    s_hdist = 1;
  }
  __syncthreads();
  if (is_l) rank_freq(lit, t);
  if (is_d) rank_freq(dist, td);
  __syncthreads();
  if (t == 0) build_lengths(lit, kMaxBits);
  if (t == kDistT) build_lengths(dist, kMaxBits);
  __syncthreads();
  int nl = 0;
  if (is_l) nl = reassigned(lit, t);
  if (is_d) nl = reassigned(dist, td);
  __syncthreads();
  if (is_l) lit.len[t] = nl;
  if (is_d) dist.len[td] = nl;
  __syncthreads();
  if (is_l) {
    llen[gl + t] = nl;
    lcode[gl + t] = rev_code(lit, t);
    if (nl > 0) atomicMax(&s_hlit, t + 1);
  }
  if (is_d) {
    dlen[gd + td] = nl;
    dcode[gd + td] = rev_code(dist, td);
    if (nl > 0) atomicMax(&s_hdist, td + 1);
  }
  __syncthreads();

  // ---- header: RLE of the lengths, code-length tree, token slots -------
  const int hlit = s_hlit, hdist = s_hdist, L = hlit + hdist;
  if (t < kLTot)
    v[t] = t < hlit ? lit.len[t] : (t < L ? dist.len[t - hlit] : 0);
  __syncthreads();
  if (t == 0) s_ntok = rle(v, L, tsym, textra, cl.freq);
  __syncthreads();
  if (t < kCl) rank_freq(cl, t);
  __syncthreads();
  if (t == 0) build_lengths(cl, kMaxBlBits);
  __syncthreads();
  if (t < kCl) nl = reassigned(cl, t);
  __syncthreads();
  if (t < kCl) cl.len[t] = nl;
  __syncthreads();
  if (t < kCl) clcode[t] = rev_code(cl, t);
  if (t == 32) {
    int hclen = 4, bits = 17;
    for (int k = 0; k < kCl; ++k) {
      if (cl.len[kBlOrder[k]] > 0 && k + 1 > hclen) hclen = k + 1;
      bits += cl.freq[k] * (cl.len[k] + kClExtra[k]);
    }
    s_hclen = hclen;
    s_bits = bits + 3 * hclen;
  }
  __syncthreads();
  const int hclen = s_hclen, ntok = s_ntok;
  const size_t gs = static_cast<size_t>(g) * kSlots;
  for (int i = t; i < kSlots; i += kThreads) {
    long long lo = 0;
    int nb = 0;
    if (i == 0) {                       // the 3-bit block header
      lo = btype_bits;
      nb = 3;
    } else if (i == 1) {                // HLIT, HDIST, HCLEN
      lo = (hlit - 257) | ((hdist - 1) << 5) | ((hclen - 4) << 10);
      nb = 14;
    } else if (i < 21) {                // code lengths in BL_ORDER
      lo = cl.len[kBlOrder[i - 2]];
      nb = i - 2 < hclen ? 3 : 0;
    } else {                            // token j: its code, its extra
      const int j = (i - 21) >> 1;
      if (j < ntok) {
        const int s = tsym[j];
        if (((i - 21) & 1) == 0) {
          lo = clcode[s];
          nb = cl.len[s];
        } else if (textra[j] >= 0) {
          nb = kClExtra[s];
          lo = nb > 0 ? textra[j] : 0;
        }
      }
    }
    hdr_lo[gs + i] = lo;
    hdr_nb[gs + i] = nb;
  }
  if (t == 0) hdr_bits[g] = s_bits;
}

}  // namespace

#ifdef __CUDACC__
// lfreq: (G, 286) int32; dfreq: (G, 30) int32, frequencies in [0, 2^22);
// llen, lcode: (G, 286) int32 out; dlen, dcode: (G, 30) int32 out; hdr_lo:
// (G, 661) int64 out; hdr_nb: (G, 661) int32 out; hdr_bits: (G,) int32
// out; every element written. One launch on `stream`; returns
// cudaGetLastError() after it, or 0.
extern "C" int zng_huff_build(const void* lfreq, const void* dfreq,
                              void* llen, void* lcode, void* dlen,
                              void* dcode, void* hdr_lo, void* hdr_nb,
                              void* hdr_bits, int G, int btype_bits,
                              void* stream) {
  if (G <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  huff_build<<<G, kThreads, 0, s>>>(
      static_cast<const int*>(lfreq), static_cast<const int*>(dfreq),
      static_cast<int*>(llen), static_cast<int*>(lcode),
      static_cast<int*>(dlen), static_cast<int*>(dcode),
      static_cast<long long*>(hdr_lo), static_cast<int*>(hdr_nb),
      static_cast<int*>(hdr_bits), btype_bits);
  return static_cast<int>(cudaGetLastError());
}
#endif
