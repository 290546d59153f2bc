// Runs csrc/render.cu's kernels on the CPU through the host model of
// cuda_runtime.h beside this file: the blocks one after the other, each as
// kThreads fibers (fiber_grid.h), on the grid that zng_render launches.
// Build (tests/test_torch_render_kernel.py does):
//   g++ -std=c++20 -O1 -pthread -shared -fPIC -Itests/cuda_model
//       -Izlibng_tpu_torch/csrc tests/cuda_model/render_model.cpp -o model.so
#include "fiber_grid.h"
#include "render.cu"

// The arguments of zng_render without the stream.
extern "C" void zng_render_model(
    const void* lits, long long lits_lane, long long lits_unit,
    const void* tl, long long tl_lane, long long tl_unit, const void* td,
    long long td_lane, long long td_unit, const void* sel,
    long long sel_lane, long long sel_unit, const void* ll, const void* lc,
    const void* dl, const void* dc, int per_row, void* lo, void* hi,
    void* nbits, int R, int N, int upl, int wide, int demote) {
  if (R == 0 || N == 0) return;
  const Args a = args_of(lits, lits_lane, lits_unit, tl, tl_lane, tl_unit,
                         td, td_lane, td_unit, sel, sel_lane, sel_unit, ll,
                         lc, dl, dc, per_row, lo, hi, nbits, N, upl);
  const int blocks = demote ? R : R * a.tiles;
  fiber_grid::run(kThreads, blocks, [=](int b) {
    blockIdx.x = b;
    if (demote && wide)
      render_demote<long long>(a);
    else if (demote)
      render_demote<int>(a);
    else if (wide)
      render_tiles<long long>(a);
    else
      render_tiles<int>(a);
  });
}
