// Runs csrc/huffman.cu's kernel on the CPU through the host model of
// cuda_runtime.h beside this file: G blocks one after the other, each on
// kThreads std::threads. Build (tests/test_torch_huffman_kernel.py does):
//   g++ -std=c++20 -O1 -pthread -shared -fPIC -Itests/cuda_model
//       -Izlibng_tpu_torch/csrc tests/cuda_model/huffman_model.cpp -o model.so
#include <thread>
#include <vector>

#include "huffman.cu"

// The arguments of zng_huff_build, without the stream.
extern "C" void zng_huff_build_model(const int* lfreq, const int* dfreq,
                                     int* llen, int* lcode, int* dlen,
                                     int* dcode, long long* hdr_lo,
                                     int* hdr_nb, int* hdr_bits, int G,
                                     int btype_bits) {
  std::barrier<> bar(kThreads);
  model_barrier = &bar;
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t)
    threads.emplace_back([=, &bar] {
      threadIdx.x = t;
      for (int g = 0; g < G; ++g) {
        blockIdx.x = g;
        huff_build(lfreq, dfreq, llen, lcode, dlen, dcode, hdr_lo, hdr_nb,
                   hdr_bits, btype_bits);
        bar.arrive_and_wait();          // the block ends before the next
      }
    });
  for (auto& th : threads) th.join();
  model_barrier = nullptr;
}
