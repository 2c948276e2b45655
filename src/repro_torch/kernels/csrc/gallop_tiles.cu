// K2's library: gallop_tiles (B = 1) and gallop_tiles_batched.  The kernel
// and its notes are in gallop.cuh.
#include "gallop.cuh"

using namespace repro;

extern "C" int repro_gallop_tiles(const void* r, int B, int M, const void* f,
                                  int N, void* out, void* stream) {
  return static_cast<int>(launch_gallop(
      static_cast<const int32_t*>(r), B, M, static_cast<const int32_t*>(f), N,
      static_cast<bool*>(out), static_cast<cudaStream_t>(stream)));
}
