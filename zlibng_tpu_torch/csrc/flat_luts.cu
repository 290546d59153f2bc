// Decode phase A's flat Huffman LUTs, for Hopper (sm_90a): one launch per
// table, one thread per (lane, peek value).
//
// Replaces no Pallas kernel. The reference builds these tables with XLA
// array code (zlibng_tpu/ops/inflate_tpu.py:_build_flat_luts), which the
// port ran as eager PyTorch (ops/inflate.py:_build_flat_luts_plain): a
// bit reversal in four rounds, a popcount of 32 shifts, then 15 rounds of
// canonical-range compares, ~260 launches per table on (B, lut_cap) int32,
// each a few us of device work behind ~13 us of host enqueue. Entry p of
// lane b is what _build_flat_luts_plain computes, entry for entry: with
// w = popcount(mask[b]) and rev_w the top w bits of p's low 15 bits
// reversed, the first length ln in 1..w whose canonical offset
// off = (rev_w >> (w - ln)) - first[ln] lies in [0, counts[ln]) gives
// symtab[clamp(index[ln] + off, 0, nsyms - 1)] << 4 | ln; no such length
// gives -16.
//
// What bounds it on this card: bytes, barely. The work writes 4 * B *
// lut_cap bytes (2 MiB per table at B = 16, lut_cap = 32,768, ~0.6 us at
// 3.35 TB/s) and reads each lane's 48-int description and a few symtab
// entries (L1/L2 hits); the compares are at most 15 per entry. At these
// sizes the launch itself (a few us) is the cost.
//
// Design: grid (ceil(lut_cap / 256), B), 256 threads. A block stages its
// lane's counts, first and index (48 ints) in shared memory; each thread
// walks the <= 15 lengths in registers and writes its entry, so a warp's
// stores are 32 consecutive int32 (coalesced). No allocation, no host
// read: the wrapper allocates the output uninitialised and every entry is
// written.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDesc = 48;             // counts(16) | first(16) | index(16)

__global__ void __launch_bounds__(kThreads)
flat_luts(const int* __restrict__ tabs, const int* __restrict__ masks,
          int* __restrict__ out, int nsyms, int lut_cap) {
  __shared__ int desc[kDesc];
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int* row = tabs + static_cast<long long>(b) * (kDesc + nsyms);
  if (t < kDesc) desc[t] = row[t];
  __syncthreads();
  const int p = blockIdx.x * kThreads + t;
  if (p >= lut_cap) return;
  const int w = __popc(static_cast<unsigned>(masks[b]));   // <= 15
  const int rev15 = static_cast<int>(__brev(static_cast<unsigned>(p)
                                            & 0xFFFFu) >> 17);
  const int rev_w = rev15 >> (15 - w);
  int ent = -16;
  for (int ln = 1; ln <= w; ++ln) {
    const int off = (rev_w >> (w - ln)) - desc[16 + ln];
    if (off >= 0 && off < desc[ln]) {
      int i = desc[32 + ln] + off;
      i = i < 0 ? 0 : (i > nsyms - 1 ? nsyms - 1 : i);
      ent = (row[kDesc + i] << 4) | ln;
      break;
    }
  }
  out[static_cast<long long>(b) * lut_cap + p] = ent;
}

}  // namespace

#ifdef __CUDACC__
// tabs: (B, 48 + nsyms) int32, _canon_tables packings; masks: (B,) int32,
// popcount <= 15; out: (B, lut_cap) int32, every element written. B in
// [1, 65535], nsyms >= 1, lut_cap >= 1. One launch on `stream`; returns
// cudaGetLastError() after it, or 0.
extern "C" int zng_flat_luts(const void* tabs, const void* masks, void* out,
                             int B, int nsyms, int lut_cap, void* stream) {
  if (B <= 0 || lut_cap <= 0) return 0;
  if (B > 65535 || nsyms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  flat_luts<<<dim3((lut_cap + kThreads - 1) / kThreads, B), kThreads, 0, s>>>(
      static_cast<const int*>(tabs), static_cast<const int*>(masks),
      static_cast<int*>(out), nsyms, lut_cap);
  return static_cast<int>(cudaGetLastError());
}
#endif
