// Runs csrc/flat_luts.cu's kernel on the CPU through the host model of
// cuda_runtime.h beside this file: the grid's blocks one after the other
// (blockIdx.x fastest, then blockIdx.y), each as kThreads fibers
// (fiber_grid.h).
// Build (tests/test_torch_flat_luts_kernel.py does):
//   g++ -std=c++20 -O1 -pthread -shared -fPIC -Itests/cuda_model
//       -Izlibng_tpu_torch/csrc tests/cuda_model/flat_luts_model.cpp -o model.so
#include "fiber_grid.h"
#include "flat_luts.cu"

// The arguments of zng_flat_luts, without the stream.
extern "C" void zng_flat_luts_model(const int* tabs, const int* masks,
                                    int* out, int B, int nsyms,
                                    int lut_cap) {
  const int gx = (lut_cap + kThreads - 1) / kThreads;
  fiber_grid::run(kThreads, B * gx, [=](int b) {
    blockIdx.x = b % gx;
    blockIdx.y = b / gx;
    flat_luts(tabs, masks, out, nsyms, lut_cap);
  });
}
