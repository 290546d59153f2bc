// A host model of the CUDA built-ins that zlibng_tpu_torch/csrc/huffman.cu
// and flat_luts.cu use, so that a C++20 compiler can run their kernels on
// the CPU: a block is one std::thread per CUDA thread and __syncthreads a
// std::barrier (huffman_model.cpp), or a block is one fiber per CUDA
// thread on one OS thread and __syncthreads a switch back to the fibers'
// scheduler (flat_luts_model.cpp: far fewer OS context switches for
// grids of thousands of blocks). __shared__ variables are static (one
// block runs at a time), atomics are GCC's. A kernel's launcher is CUDA
// syntax and stays out (it is compiled only under __CUDACC__).
#pragma once
#include <barrier>

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
