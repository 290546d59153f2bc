// Runs csrc/bitpack.cu's kernel on the CPU through the host model of
// cuda_runtime.h beside this file: one block per row, one after the other,
// each as kThreads fibers (fiber_grid.h). The launcher's two layout flags
// are arguments here, so that a test can run both load paths and both
// store paths on any input.
// Build (tests/test_torch_bitpack_kernel.py does):
//   g++ -std=c++20 -O1 -pthread -shared -fPIC -Itests/cuda_model
//       -Izlibng_tpu_torch/csrc tests/cuda_model/bitpack_model.cpp -o model.so
#include "fiber_grid.h"
#include "bitpack.cu"

// The arguments of zng_bitpack without the stream, then the flags that
// its launcher derives from T, out_bytes and the pointers' alignment.
extern "C" void zng_bitpack_model(const long long* lo, const long long* hi,
                                  const int* nbits, unsigned char* out,
                                  int* total, int R, int T, int out_bytes,
                                  int vec, int aligned) {
  fiber_grid::run(kThreads, R, [=](int b) {
    blockIdx.x = b;
    bitpack(lo, hi, nbits, out, total, T, out_bytes, vec != 0, aligned != 0);
  });
}
