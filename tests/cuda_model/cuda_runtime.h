// A host model of the CUDA built-ins that zlibng_tpu_torch/csrc/huffman.cu
// uses, so that a C++20 compiler can run its kernel on the CPU: a block is
// one std::thread per CUDA thread, __syncthreads a std::barrier,
// __shared__ variables are static (one block runs at a time), atomics are
// GCC's. The kernel's launcher is CUDA syntax and stays out (it is
// compiled only under __CUDACC__). huffman_model.cpp runs the kernel.
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

inline void __syncthreads() { model_barrier->arrive_and_wait(); }

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
