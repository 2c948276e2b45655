// K4: the decoded SvS fold of a batch in one launch — fold_kernel
// (fold.cuh) over a (J, B, N) stack of decoded, SENTINEL-padded lists.
//
// Replaces src/repro/kernels/megakernel.py::decoded_fold_batched
// (pl.pallas_call, body make_decoded_fold_kernel).  N need not be a power of
// two here, and no size of N leaves the kernel: the folds are read from
// device memory, not from a VMEM-resident block.
#include "fold.cuh"

using namespace repro;

extern "C" int repro_decoded_fold(const void* r, const void* valid, int B,
                                  int M, const void* folds, int J, int N,
                                  const void* active, void* out,
                                  void* stream) {
  return static_cast<int>(launch_fold(
      static_cast<const int32_t*>(r), static_cast<const bool*>(valid), B, M,
      static_cast<const int32_t*>(folds), J, N,
      static_cast<const bool*>(active), static_cast<bool*>(out),
      static_cast<cudaStream_t>(stream)));
}
