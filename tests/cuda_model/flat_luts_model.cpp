// Runs csrc/flat_luts.cu's kernel on the CPU through the host model of
// cuda_runtime.h beside this file: the grid's blocks one after the other
// (blockIdx.x fastest, then blockIdx.y), each as kThreads fibers
// (ucontext) on the calling thread. A round resumes every fiber once, in
// threadIdx order, and each runs to its next __syncthreads or to the end
// of its block, so a round is one barrier phase of the block.
// Build (tests/test_torch_flat_luts_kernel.py does):
//   g++ -std=c++20 -O1 -pthread -shared -fPIC -Itests/cuda_model
//       -Izlibng_tpu_torch/csrc tests/cuda_model/flat_luts_model.cpp -o model.so
#include <ucontext.h>

#include <vector>

#include "flat_luts.cu"

namespace {

constexpr size_t kStack = 1 << 16;

struct Launch {
  const int* tabs;
  const int* masks;
  int* out;
  int B, nsyms, lut_cap, gx;
};

Launch launch;
ucontext_t scheduler;
std::vector<ucontext_t> fibers;
std::vector<char> finished;
int current;

void yield_to_scheduler() { swapcontext(&fibers[current], &scheduler); }

void fiber_main(int t) {
  for (int y = 0; y < launch.B; ++y)
    for (int x = 0; x < launch.gx; ++x) {
      blockIdx.x = x;
      blockIdx.y = y;
      flat_luts(launch.tabs, launch.masks, launch.out, launch.nsyms,
                launch.lut_cap);
      yield_to_scheduler();             // the block ends before the next
    }
  finished[t] = 1;                      // back to the scheduler (uc_link)
}

}  // namespace

// The arguments of zng_flat_luts, without the stream.
extern "C" void zng_flat_luts_model(const int* tabs, const int* masks,
                                    int* out, int B, int nsyms,
                                    int lut_cap) {
  launch = {tabs, masks, out, B, nsyms, lut_cap,
            (lut_cap + kThreads - 1) / kThreads};
  fibers.assign(kThreads, ucontext_t{});
  finished.assign(kThreads, 0);
  std::vector<char> stacks(kThreads * kStack);
  for (int t = 0; t < kThreads; ++t) {
    getcontext(&fibers[t]);
    fibers[t].uc_stack.ss_sp = stacks.data() + t * kStack;
    fibers[t].uc_stack.ss_size = kStack;
    fibers[t].uc_link = &scheduler;
    makecontext(&fibers[t], reinterpret_cast<void (*)()>(fiber_main), 1, t);
  }
  model_sync = yield_to_scheduler;
  bool live = true;
  while (live) {
    live = false;
    for (int t = 0; t < kThreads; ++t) {
      if (finished[t]) continue;
      current = t;
      threadIdx.x = t;
      swapcontext(&scheduler, &fibers[t]);
      live = true;
    }
  }
  model_sync = nullptr;
}
