// Stage 2's bit pack, for Hopper (sm_90a): one launch per pack call, one
// block per row.
//
// Replaces no Pallas kernel. The reference packs with XLA array code
// (zlibng_tpu/ops/bitpack_merge.py:hierarchical_pack: pairwise limb merges
// within windows of 128 tokens, then the windows OR-placed into the
// stream), which the port ran as eager PyTorch (ops/bitpack_merge.py:
// hierarchical_pack, its CPU route): 7 merge rounds of int64 limb shifts
// and one gather, OR and scatter_ per window, ~880 launches for a lane
// group's 128 x 16,384 tokens and ~8,600 for a shard's lanes. Row r here
// is the LSB-first concatenation of its tokens, token t being the low
// nbits[r, t] bits of hi[r, t] : lo[r, t] (lo below bit 32; u32 values in
// int64, at most 31 bits of hi kept, as there), cut to out_bytes bytes and
// zero-filled after the stream; total[r] is the stream's whole length in
// bits even when it overflows out_bytes. Byte for byte what
// hierarchical_pack gives for nbits in [0, 63].
//
// What bounds it on this card: bytes. A token is read once (20 B: lo, hi,
// nbits) and each row's out_bytes written once: ~44 MB for an L6 lane
// group's body (128 x 16,384 tokens into 30,728-byte rows), ~13 us at
// 3.35 TB/s.
//
// Design: one block of kThreads per row, walking the row in chunks of
// kChunk tokens, kPer consecutive tokens a thread (16-byte loads when the
// row's layout allows, scalar loads otherwise). Each chunk: the block's
// exclusive scan of the threads' bit counts (warp shuffles, then the warps'
// sums from shared memory) gives every token its bit offset; each thread
// ORs its tokens (<= 3 words each) into a word buffer in shared memory
// (shared atomics: neighbours share boundary words); the block stores the
// chunk's finished words with consecutive threads on consecutive words and
// carries the one partial word into the next chunk's buffer. No global
// atomics, no other block's data: the result does not depend on timing.
// The last partial word and the zeros up to out_bytes close the row, so
// the wrapper allocates the outputs uninitialised.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                       // tokens a thread per chunk
constexpr int kChunk = kThreads * kPer;       // 2,048 tokens
// a chunk's bits (<= 64 a token) behind a carried phase of < 32 bits,
// and the word after the last one touched (the next carry)
constexpr int kWords = 2 * kChunk + 2;

// The low n bits (n in [0, 64]) of hi : lo as one value, with at most 32
// bits of lo and 31 of hi, as hierarchical_pack masks them.
__device__ __forceinline__ unsigned long long token_bits(long long lo,
                                                         long long hi,
                                                         int n) {
  const int nl = n < 32 ? n : 32;
  const int nh = n > 63 ? 31 : (n > 32 ? n - 32 : 0);
  unsigned l = static_cast<unsigned>(lo);
  if (nl < 32) l &= (1u << nl) - 1u;
  const unsigned h = static_cast<unsigned>(hi) & ((1u << nh) - 1u);
  return static_cast<unsigned long long>(h) << 32 | l;
}

// ORs value v (its bits set below 64) into buf at bit p.
__device__ __forceinline__ void or_bits(unsigned* buf, int p,
                                        unsigned long long v) {
  const int w = p >> 5;
  const int s = p & 31;
  const unsigned w0 = static_cast<unsigned>(v << s);
  const unsigned w1 = static_cast<unsigned>(s ? v >> (32 - s) : v >> 32);
  const unsigned w2 = s ? static_cast<unsigned>(v >> 32 >> (32 - s)) : 0u;
  if (w0) atomicOr(&buf[w], w0);
  if (w1) atomicOr(&buf[w + 1], w1);
  if (w2) atomicOr(&buf[w + 2], w2);
}

// Stores word gw of a row of out_bytes bytes: one 4-byte store when the
// rows are word-aligned, else its bytes below out_bytes.
__device__ __forceinline__ void store_word(unsigned char* row, long long gw,
                                           unsigned val, long long out_bytes,
                                           bool aligned) {
  const long long b = gw * 4;
  if (aligned) {
    if (b < out_bytes) reinterpret_cast<unsigned*>(row)[gw] = val;
    return;
  }
  for (int k = 0; k < 4; ++k)
    if (b + k < out_bytes)
      row[b + k] = static_cast<unsigned char>(val >> (8 * k));
}

__global__ void __launch_bounds__(kThreads)
bitpack(const long long* __restrict__ lo, const long long* __restrict__ hi,
        const int* __restrict__ nbits, unsigned char* __restrict__ out,
        int* __restrict__ total, int T, int out_bytes, bool vec,
        bool aligned) {
  __shared__ unsigned buf[kWords];
  __shared__ int warp_sum[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long r = blockIdx.x;
  const long long* lo_r = lo + r * T;
  const long long* hi_r = hi + r * T;
  const int* nb_r = nbits + r * T;
  unsigned char* row = out + r * out_bytes;
  for (int i = t; i < kWords; i += kThreads) buf[i] = 0u;

  long long bit = 0;                          // the chunk's first bit
  unsigned carry = 0u;                        // buf[0] at each chunk start
  for (int c0 = 0; c0 < T; c0 += kChunk) {
    // ---- this thread's kPer tokens ----------------------------------
    const int i0 = c0 + t * kPer;
    long long lv[kPer], hv[kPer];
    int nv[kPer];
    if (vec && i0 + kPer <= T) {
      // T % 4 == 0 and 16-byte-aligned bases (the launcher checks), so
      // i0, a multiple of kPer, starts 16-byte-aligned in every row
      const longlong2* l2 = reinterpret_cast<const longlong2*>(lo_r + i0);
      const longlong2* h2 = reinterpret_cast<const longlong2*>(hi_r + i0);
      const int4* n4 = reinterpret_cast<const int4*>(nb_r + i0);
#pragma unroll
      for (int k = 0; k < kPer / 2; ++k) {
        const longlong2 a = l2[k];
        const longlong2 b = h2[k];
        lv[2 * k] = a.x;
        lv[2 * k + 1] = a.y;
        hv[2 * k] = b.x;
        hv[2 * k + 1] = b.y;
      }
#pragma unroll
      for (int k = 0; k < kPer / 4; ++k) {
        const int4 a = n4[k];
        nv[4 * k] = a.x;
        nv[4 * k + 1] = a.y;
        nv[4 * k + 2] = a.z;
        nv[4 * k + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool in = i0 + k < T;
        lv[k] = in ? lo_r[i0 + k] : 0;
        hv[k] = in ? hi_r[i0 + k] : 0;
        nv[k] = in ? nb_r[i0 + k] : 0;
      }
    }
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      nv[k] = nv[k] < 0 ? 0 : (nv[k] > 64 ? 64 : nv[k]);
      mine += nv[k];
    }

    // ---- the block's exclusive scan of the bit counts ---------------
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();          // also: the last chunk's buffer reset is done
    int before = 0, chunk_bits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sum[w];
      before += w < warp ? s : 0;
      chunk_bits += s;
    }

    // ---- OR the tokens into the word buffer -------------------------
    const int phase = static_cast<int>(bit & 31);
    int p = phase + before + incl - mine;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (nv[k]) or_bits(buf, p, token_bits(lv[k], hv[k], nv[k]));
      p += nv[k];
    }
    __syncthreads();

    // ---- store the finished words, carry the partial one ------------
    const long long wbase = bit >> 5;
    const int nfull = (phase + chunk_bits) >> 5;
    for (int i = t; i < nfull; i += kThreads)
      store_word(row, wbase + i, buf[i], out_bytes, aligned);
    carry = buf[nfull];
    __syncthreads();
    for (int i = t; i <= nfull; i += kThreads) buf[i] = 0u;
    if (t == 0) buf[0] = carry;
    bit += chunk_bits;
  }

  // ---- the partial word, then zeros up to out_bytes ---------------------
  const long long out_words = (static_cast<long long>(out_bytes) + 3) >> 2;
  for (long long i = (bit >> 5) + t; i < out_words; i += kThreads)
    store_word(row, i, i == bit >> 5 ? carry : 0u, out_bytes, aligned);
  if (t == 0) total[r] = static_cast<int>(bit);
}

}  // namespace

#ifdef __CUDACC__
// lo, hi: (R, T) int64; nbits: (R, T) int32; out: (R, out_bytes) uint8 and
// total: (R,) int32, every element written. R in [1, 2^31 - 1], T >= 0,
// out_bytes >= 0. One launch on `stream`; returns cudaGetLastError() after
// it, or 0.
extern "C" int zng_bitpack(const void* lo, const void* hi, const void* nbits,
                           void* out, void* total, int R, int T,
                           int out_bytes, void* stream) {
  if (R <= 0) return 0;
  if (T < 0 || out_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto a16 = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
  };
  const bool vec = T % 4 == 0 && a16(lo) && a16(hi) && a16(nbits);
  const bool aligned = out_bytes % 4 == 0 &&
                       (reinterpret_cast<unsigned long long>(out) & 3u) == 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  bitpack<<<R, kThreads, 0, s>>>(
      static_cast<const long long*>(lo), static_cast<const long long*>(hi),
      static_cast<const int*>(nbits), static_cast<unsigned char*>(out),
      static_cast<int*>(total), T, out_bytes, vec, aligned);
  return static_cast<int>(cudaGetLastError());
}
#endif
