// Runs a kernel's grid on the CPU through the host model of cuda_runtime.h
// beside this file: the blocks one after the other, each as nthreads fibers
// (ucontext) on the calling thread, and __syncthreads a switch back to the
// scheduler. A round resumes every fiber once, in threadIdx order, and each
// runs to its next __syncthreads or to the end of its block, so a round is
// one barrier phase of the block (~0.45 ms a block of 256 threads).
#pragma once
#include <ucontext.h>

#include <functional>
#include <vector>

#include "cuda_runtime.h"

namespace fiber_grid {

constexpr size_t kStack = 1 << 16;

inline ucontext_t scheduler;
inline std::vector<ucontext_t> fibers;
inline std::vector<char> finished;
inline int current;
inline int grid_blocks;
inline std::function<void(int)> grid_block;

inline void yield_to_scheduler() {
  swapcontext(&fibers[current], &scheduler);
}

inline void fiber_main(int t) {
  for (int b = 0; b < grid_blocks; ++b) {
    grid_block(b);
    yield_to_scheduler();               // the block ends before the next
  }
  finished[t] = 1;                      // back to the scheduler (uc_link)
}

// Runs block(b) for every b in [0, nblocks) on nthreads fibers; block(b)
// sets blockIdx and calls the kernel.
inline void run(int nthreads, int nblocks, std::function<void(int)> block) {
  grid_blocks = nblocks;
  grid_block = std::move(block);
  fibers.assign(nthreads, ucontext_t{});
  finished.assign(nthreads, 0);
  std::vector<char> stacks(nthreads * kStack);
  for (int t = 0; t < nthreads; ++t) {
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
    for (int t = 0; t < nthreads; ++t) {
      if (finished[t]) continue;
      current = t;
      threadIdx.x = t;
      swapcontext(&scheduler, &fibers[t]);
      live = true;
    }
  }
  model_sync = nullptr;
}

}  // namespace fiber_grid
