// Banded take: out[n] = sum_k table[idx[n, k]] (idx -1 = skip) from a
// host-planned BandedTakePlan (ops/banded_gather.py). It serves the element
// gathers, the assembly recast as a gather, and the SpMV of the FEM path.
//
// Replaces the TPU kernels in dolfinx_materials_tpu/ops/banded_gather.py:
// - banded_take_stream:  make_banded_take (streams one 8-row window block per
//   grid step through VMEM);
// - banded_take_window:  make_banded_take_vmem (whole table resident in VMEM,
//   walks only the occupied sub-blocks plan.nq of each (chunk, layer)).
// The TPU needed windows because its only fast data-dependent load was a
// 128-lane gather inside a row; the card has real scalar gathers, so the
// plan's (row, lane) pairs are simply turned back into addresses.
//
// Bound on this card: memory. Per take the kernel reads the int32 rloc/cloc
// plans (8 bytes per (slot, layer), the largest stream), the table once, and
// writes the output once; a few flops per 8 bytes.
// - stream: one thread per output slot walks its K layers in order and reads
//   table[(base8*sub + rloc)*128 + cloc] straight from global memory; the
//   FEM tables (a few MB) stay resident in the 50 MB L2, and the plan arrays
//   are read coalesced (neighbouring threads, neighbouring slots).
// - window: one block per chunk; per layer the block copies the occupied
//   window (nq*sub rows x 128) into shared memory with coalesced loads, then
//   every thread gathers from shared memory. Global table traffic becomes
//   contiguous window copies instead of scattered 8-byte loads.
// Both add the layers in the same order (k = 0..K-1, skipping masked slots),
// so the two kernels are bitwise equal. Out-of-window outliers are patched
// afterwards by the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int LANE = 128;
constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;  // window kernel: chunk C <= THREADS * PER_THREAD

template <typename T>
__global__ void __launch_bounds__(THREADS)
banded_take_stream_kernel(const T* __restrict__ table, const int* __restrict__ base8,
                          const int* __restrict__ rloc, const int* __restrict__ cloc,
                          T* __restrict__ out, long long n_out, int K, int C, int sub) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const long long s = o / C;
  const int t = (int)(o % C);
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const long long sk = s * K + k;
    const int r = rloc[sk * C + t];
    if (r >= 0) {
      const long long row = (long long)base8[sk] * sub + r;
      acc += table[row * LANE + cloc[sk * C + t]];
    }
  }
  out[o] = acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
banded_take_window_kernel(const T* __restrict__ table, long long n_src,
                          const int* __restrict__ base8, const int* __restrict__ nq,
                          const int* __restrict__ rloc, const int* __restrict__ cloc,
                          T* __restrict__ out, long long n_out, int K, int C, int sub) {
  extern __shared__ unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const long long s = blockIdx.x;
  T acc[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) acc[j] = T(0);

  for (int k = 0; k < K; ++k) {
    const long long sk = s * K + k;
    const int W = nq[sk] * sub * LANE;
    const long long start = (long long)base8[sk] * sub * LANE;
    __syncthreads();  // the previous layer's reads of win are done
    for (int i = threadIdx.x; i < W; i += THREADS) {
      const long long g = start + i;
      win[i] = g < n_src ? table[g] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int t = threadIdx.x + j * THREADS;
      if (t < C) {
        const int r = rloc[sk * C + t];
        if (r >= 0) acc[j] += win[r * LANE + cloc[sk * C + t]];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int t = threadIdx.x + j * THREADS;
    const long long o = s * C + t;
    if (t < C && o < n_out) out[o] = acc[j];
  }
}

template <typename T>
int launch_stream(const T* table, const int* base8, const int* rloc, const int* cloc,
                  T* out, long long n_out, int K, int C, int sub, void* stream) {
  if (n_out <= 0) return 0;
  const long long blocks = (n_out + THREADS - 1) / THREADS;
  banded_take_stream_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      table, base8, rloc, cloc, out, n_out, K, C, sub);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_window(const T* table, long long n_src, const int* base8, const int* nq,
                  const int* rloc, const int* cloc, T* out, long long n_out, int ns,
                  int K, int C, int sub, int max_window_rows, void* stream) {
  if (C > THREADS * PER_THREAD) return (int)cudaErrorInvalidValue;
  if (n_out <= 0) return 0;
  const size_t smem = (size_t)max_window_rows * LANE * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(banded_take_window_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  banded_take_window_kernel<T><<<ns, THREADS, smem, (cudaStream_t)stream>>>(
      table, n_src, base8, nq, rloc, cloc, out, n_out, K, C, sub);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int banded_take_stream_f32(const float* table, const int* base8, const int* rloc,
                                      const int* cloc, float* out, long long n_out, int K,
                                      int C, int sub, void* stream) {
  return launch_stream<float>(table, base8, rloc, cloc, out, n_out, K, C, sub, stream);
}

extern "C" int banded_take_stream_f64(const double* table, const int* base8, const int* rloc,
                                      const int* cloc, double* out, long long n_out, int K,
                                      int C, int sub, void* stream) {
  return launch_stream<double>(table, base8, rloc, cloc, out, n_out, K, C, sub, stream);
}

extern "C" int banded_take_window_f32(const float* table, long long n_src, const int* base8,
                                      const int* nq, const int* rloc, const int* cloc,
                                      float* out, long long n_out, int ns, int K, int C,
                                      int sub, int max_window_rows, void* stream) {
  return launch_window<float>(table, n_src, base8, nq, rloc, cloc, out, n_out, ns, K, C,
                              sub, max_window_rows, stream);
}

extern "C" int banded_take_window_f64(const double* table, long long n_src, const int* base8,
                                      const int* nq, const int* rloc, const int* cloc,
                                      double* out, long long n_out, int ns, int K, int C,
                                      int sub, int max_window_rows, void* stream) {
  return launch_window<double>(table, n_src, base8, nq, rloc, cloc, out, n_out, ns, K, C,
                               sub, max_window_rows, stream);
}

extern "C" const char* dxm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
