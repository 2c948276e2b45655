// K5: the packed SvS fold of a batch — decode each (j, b) slot's candidate
// blocks, then fold the gallop hits as K4 does.
//
// Replaces src/repro/kernels/megakernel.py::packed_fold_batched
// (pl.pallas_call, body make_packed_fold_kernel).  Two launches on one
// stream:
//   (i)  packed_decode_kernel (packed_decode.cuh), grid
//        (C, Jp * B): every active slot's candidate blocks into a
//        (Jp, B, C * rows * 128) int32 window; inactive slots are skipped;
//   (ii) fold_kernel (fold.cuh, shared with K4) over that window, with
//        N = C * rows * 128.
// The TPU decoded each slot into C * rows * 128 ints of VMEM scratch, freed
// when its grid step retired.  A Hopper block has at most 227 KB of shared
// memory, which holds only C <= 13 blocks of 32 rows, so the window goes
// through device memory; the scheduler's operand budget
// (index/batch.py::_chunk_size counts it) bounds it to 2**25 ints.  Fusing
// decode and fold in shared memory where the window fits is later work.
//
// Bound on the card: bytes — the candidate blocks' packed words and
// metadata, r, valid and the mask (the window is scratch and not counted).
#include "fold.cuh"
#include "packed_decode.cuh"

using namespace repro;

extern "C" int repro_packed_fold(const void* r, const void* valid, int B,
                                 int M, const void* words, int Tp,
                                 const void* widths, const void* offsets,
                                 const void* maxes, int Kp, const void* blk,
                                 int C, const void* exc_pos,
                                 const void* exc_add, int E, int rows,
                                 int mode, int Jp, const void* active,
                                 void* window, void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto act = static_cast<const bool*>(active);
  const auto win = static_cast<int32_t*>(window);
  const cudaError_t err = launch_packed_decode(
      words, Tp, widths, offsets, maxes, Kp, blk, C, exc_pos, exc_add, E, rows,
      mode, Jp * B, act, win, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_fold(
      static_cast<const int32_t*>(r), static_cast<const bool*>(valid), B, M,
      win, Jp, C * rows * kLanes, act, static_cast<bool*>(out), st));
}
