// Banded take: out[n] = sum of table[e] over output n's entries e, from the
// compact lists of a host-planned BandedTakePlan (ops/banded_gather.py). It
// serves the element gathers, the assembly recast as a gather, the SpMV of
// the FEM path and (csr, over a SumPlan) the fixed-order sums of the
// two-level coarse matrices.
//
// Replaces the TPU kernels in dolfinx_materials_tpu/ops/banded_gather.py:
// - banded_take_ell: make_banded_take_vmem (table resident in VMEM, occupied
//   window sub-blocks walked per (chunk, layer));
// - banded_take_csr: make_banded_take (one 8-row window block streamed
//   through VMEM per grid step).
// The TPU needed windows because its only fast data-dependent load was a
// 128-lane gather inside a row, and patched the out-of-window outliers in a
// second pass. This card has scalar gathers, and its 50 MB L2 holds the FEM
// tables (2-5 MB) whole, so the plan folds windows and patches at plan time
// into one list per output of absolute int32 table indices, and each kernel
// is one gather launch with the patches inside: no shared-memory staging, no
// patch pass, no atomics.
//
// Bound on this card: memory. Per take the least traffic is the table read
// once, the output written once and 4 bytes of index per entry; a few adds
// per 12-16 bytes. One thread per output walks its entries in list order
// (the adds of the windowed take: kept layers by ascending k, then patches
// in list order), so both kernels are bitwise equal to each other and to
// compact_take_reference.
// - ell: slices of 32 outputs (one warp), each as wide as its longest
//   output; entry j of lane t at ptr[s] + 32 j + t, so a warp reads 128
//   contiguous bytes of index per step; each row's tail is padded with -1.
// - csr: entries of output o at ptr[o] .. ptr[o + 1], no padding, for plans
//   whose per-output counts are uneven.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;

template <typename T, bool ELL>
__global__ void __launch_bounds__(THREADS)
compact_take_kernel(const T* __restrict__ table, const int* __restrict__ ptr,
                    const int* __restrict__ idx, T* __restrict__ out, int n_out) {
  const int o = blockIdx.x * THREADS + threadIdx.x;
  if (o >= n_out) return;
  const int row = ELL ? o / WARP : o;
  const int begin = __ldg(ptr + row) + (ELL ? o % WARP : 0);
  const int end = __ldg(ptr + row + 1);
  T acc = T(0);
  for (int p = begin; p < end; p += ELL ? WARP : 1) {
    const int e = __ldg(idx + p);
    if (ELL && e < 0) break;  // the rest of this output's row is padding
    acc += __ldg(table + e);
  }
  out[o] = acc;
}

template <typename T, bool ELL>
int launch(const T* table, const int* ptr, const int* idx, T* out, int n_out, void* stream) {
  if (n_out <= 0) return 0;
  const unsigned blocks = (unsigned)((n_out + THREADS - 1) / THREADS);
  compact_take_kernel<T, ELL><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      table, ptr, idx, out, n_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int banded_take_ell_f32(const float* table, const int* ptr, const int* idx,
                                   float* out, int n_out, void* stream) {
  return launch<float, true>(table, ptr, idx, out, n_out, stream);
}

extern "C" int banded_take_ell_f64(const double* table, const int* ptr, const int* idx,
                                   double* out, int n_out, void* stream) {
  return launch<double, true>(table, ptr, idx, out, n_out, stream);
}

extern "C" int banded_take_csr_f32(const float* table, const int* ptr, const int* idx,
                                   float* out, int n_out, void* stream) {
  return launch<float, false>(table, ptr, idx, out, n_out, stream);
}

extern "C" int banded_take_csr_f64(const double* table, const int* ptr, const int* idx,
                                   double* out, int n_out, void* stream) {
  return launch<double, false>(table, ptr, idx, out, n_out, stream);
}

extern "C" const char* dxm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
