// K2: greedy/lazy parse chain walk, for Hopper (sm_90a).
//
// Replaces the Pallas kernel zlibng_tpu/ops/parse_pallas.py:_parse_kernel
// (entry parse_select_pallas). For each lane b: i = bounds[b, 0]; while
// i < bounds[b, 1]: sel[b, i] = 1; i += max(step[b, i], 1). The output mask
// is zero-filled by the caller.
//
// What bounds it on this card: latency, not bytes or operations. Each stop
// is one int32 load whose address depends on the previous load, so a lane
// walks at one global-memory round trip (~0.5-1 us from HBM, less once the
// step array sits in the 50 MB L2) per stop, and the encode path's fused
// step array still leaves thousands of stops (one per match or literal-run
// start) in a 256 KiB text lane. The bytes moved (4 B read and 1 B written
// per stop, plus the zero-filled mask) would take microseconds at 3.35 TB/s.
//
// Design: one thread per lane, walking dependent loads straight from
// global memory; B lanes run concurrently in one block. The walk is short
// and serial by nature; staging chunks of the step array in shared memory
// ahead of the walk is work for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void parse_kernel(const int* __restrict__ step,
                             const int* __restrict__ bounds,
                             unsigned char* __restrict__ sel, int B, int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* s = step + (size_t)b * N;
  unsigned char* o = sel + (size_t)b * N;
  int i = bounds[2 * b];
  const int e = min(bounds[2 * b + 1], N);
  while (i >= 0 && i < e) {
    o[i] = 1;
    const int st = s[i];
    i += st > 1 ? st : 1;
  }
}

}  // namespace

// step: (B, N) int32; bounds: (B, 2) int32 [start, end); sel: (B, N) uint8,
// zero-filled by the caller. Returns cudaGetLastError() after the launch.
extern "C" int zng_parse_select(const void* step, const void* bounds,
                                void* sel, int B, int N, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int threads = 32;
  parse_kernel<<<(B + threads - 1) / threads, threads, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(step), static_cast<const int*>(bounds),
      static_cast<unsigned char*>(sel), B, N);
  return static_cast<int>(cudaGetLastError());
}
