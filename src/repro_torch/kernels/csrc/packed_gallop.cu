// K3: skip-aware packed gallop — decode only the candidate blocks of each
// row's compressed list, then gallop the candidates over them.
//
// Replaces src/repro/kernels/intersect_gallop.py::packed_gallop_batched
// (pl.pallas_call, body make_packed_gallop_kernel, with
// bitunpack.py::decode_candidates).  Two launches on one stream:
//   (i)  packed_decode_kernel (packed_decode.cuh), grid (C, B): one slot per
//        row, every slot active, into a (B, C * rows * 128) int32 window;
//   (ii) K2's gallop_kernel (gallop.cuh) over that window.
//
// Bound on the card: bytes — the candidate blocks' packed words, the window
// written once and read by the gallop, r and the mask.  Fusing the two
// launches where the window fits shared memory is later work.
#include "gallop.cuh"
#include "packed_decode.cuh"

using namespace repro;

extern "C" int repro_packed_gallop(const void* r, int M, const void* words,
                                   int Tp, const void* widths,
                                   const void* offsets, const void* maxes,
                                   int Kp, const void* blk, int C,
                                   const void* exc_pos, const void* exc_add,
                                   int E, int rows, int mode, int B,
                                   void* window, void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto win = static_cast<int32_t*>(window);
  const cudaError_t err = launch_packed_decode(
      words, Tp, widths, offsets, maxes, Kp, blk, C, exc_pos, exc_add, E, rows,
      mode, B, nullptr, win, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_gallop(static_cast<const int32_t*>(r), B, M,
                                        win, C * rows * kLanes,
                                        static_cast<bool*>(out), st));
}
