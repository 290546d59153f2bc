// A host model of the CUDA built-ins that zlibng_tpu_torch/csrc/huffman.cu,
// flat_luts.cu, bitpack.cu and render.cu use, so that a C++20 compiler can
// run their kernels on the CPU: a block is one std::thread per CUDA thread
// and __syncthreads a std::barrier (huffman_model.cpp), or a block is one
// fiber per CUDA thread on one OS thread and __syncthreads a switch back to
// the fibers' scheduler (flat_luts_model.cpp, bitpack_model.cpp,
// render_model.cpp: far fewer OS
// context switches for grids of thousands of blocks). __shared__ variables
// are static (one block runs at a time), atomics are GCC's. A warp shuffle
// is two block-wide barriers around a table of the lanes' values, so a
// kernel may shuffle only where every thread of its block does. A
// kernel's launcher is CUDA syntax and stays out (it is compiled only
// under __CUDACC__).
#pragma once
#include <barrier>
#include <cstring>

#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(n)

struct ModelDim3 {
  int x = 0, y = 0, z = 0;
};
inline thread_local ModelDim3 threadIdx, blockIdx;
inline std::barrier<>* model_barrier = nullptr;

// set by a model that runs a block's threads as fibers on one OS thread
inline void (*model_sync)() = nullptr;

inline void __syncthreads() {
  if (model_sync)
    model_sync();
  else
    model_barrier->arrive_and_wait();
}

inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

inline int atomicMax(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(
                        p, &old, v, false, __ATOMIC_SEQ_CST,
                        __ATOMIC_SEQ_CST)) {
  }
  return old;
}

inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

inline int __clz(int x) {
  return x ? __builtin_clz(static_cast<unsigned>(x)) : 32;
}

inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}

// every thread's posted value, by threadIdx.x (blocks of <= 1024 threads)
inline unsigned long long model_lanes[1024];

// Lane src of the caller's warp's value v (T of at most 8 bytes).
template <class T>
inline T model_shfl(T v, int src) {
  unsigned long long w = 0;
  std::memcpy(&w, &v, sizeof v);
  model_lanes[threadIdx.x] = w;
  __syncthreads();
  w = model_lanes[(threadIdx.x & ~31) + src];
  __syncthreads();
  std::memcpy(&v, &w, sizeof v);
  return v;
}

template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const int lane = threadIdx.x & 31;
  return model_shfl(v, lane >= static_cast<int>(delta) ? lane - delta : lane);
}

struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(16) longlong2 {
  long long x, y;
};
