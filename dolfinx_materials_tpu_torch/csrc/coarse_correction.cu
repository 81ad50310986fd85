// The aggregate coarse correction of the fused step's two-level
// preconditioner (parallel/sharding.py, M(ops, r)):
//     z_out = z + [mask ? 0 : s_inv * P (Ac^-1 (P^T (s_inv * [mask ? 0 : r])))]
// where P maps the NM coarse values of an aggregate onto its dofs through
// the mode weights W (ndofs x NM, row-major), as two kernels over one
// per-aggregate CSR list of dofs (ops/coarse_correction.py
// plan_aggregates):
// - coarse_restrict: rc[a NM + m] = sum over the dofs d of aggregate a of
//   r0[d] W[d, m], with r0 the masked and scaled residual;
// - coarse_prolong: each block first forms its aggregate's NM coarse values
//   wc = (Ac^-1 rc)[a NM .. a NM + NM - 1] from its NM rows of Ac^-1, then
//   adds sum_m W[d, m] wc[m], masked and scaled, to z at each of its dofs.
// Between the two, a caller whose ranks hold slices of the dofs sums rc
// across them (NCCL, outside the kernels).
//
// Replaces no TPU kernel: the JAX package leaves this part of M to XLA (a
// gather, a row sum, a dense product and a gather). On the card the same
// plain PyTorch steps ran as about ten launches, paced by index count and
// latency rather than bytes: PyTorch's vectorized gather moves 8-16 bytes an
// index, and the 968-row dense product (cuBLAS gemv) keeps too few rows in
// flight to hide DRAM latency (PERF.md).
//
// Bound on this card: bytes, a multiply and an add per value read. restrict
// reads r, the mask, s_inv, W and the dof list once; prolong reads Ac^-1
// once across the grid (each row by the one block that owns it), and z, the
// mask, s_inv, W and the dof list once, and writes z_out once. rc is a few KB
// and stays in L2.
// Design: one block per aggregate (a few hundred dofs each), so the sums over
// an aggregate and over a row of Ac^-1 stay inside a block: no atomics, no
// second pass, and the order of every sum is fixed by the block size and the
// list, so a launch gives the same bits in every run. Each thread strides
// over the list with the NM partial sums in registers; the block sums them
// by warp shuffles in a fixed tree, then across warps in warp order. The
// rows of Ac^-1 are contiguous and read 16 bytes a thread where the row
// length and the pointers allow it. The mask, the scaling and the add to z
// that followed the PyTorch steps are folded into the kernels' loads and
// stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T> struct Vec16;
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };

__device__ __forceinline__ double dot16(double2 a, double2 b) { return a.x * b.x + a.y * b.y; }
__device__ __forceinline__ float dot16(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// The block's sum of each thread's acc[m], in a fixed order: a shuffle tree
// in each warp, then warp 0 over the warps' partials. out[m] (shared memory)
// is visible to every thread on return.
template <typename T, int NM>
__device__ __forceinline__ void block_sum(const T (&acc)[NM], T* scratch, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    T v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) scratch[warp * NM + m] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      T v = lane < WARPS ? scratch[lane * NM + m] : T(0);
#pragma unroll
      for (int off = WARPS / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) out[m] = v;
    }
  }
  __syncthreads();
}

template <typename T, int NM>
__global__ void __launch_bounds__(THREADS)
coarse_restrict_kernel(const T* __restrict__ r, const unsigned char* __restrict__ mask,
                       const T* __restrict__ s_inv, const T* __restrict__ W,
                       const int* __restrict__ agg_ptr, const int* __restrict__ agg_dofs,
                       T* __restrict__ rc) {
  __shared__ T scratch[WARPS * NM];
  __shared__ T sums[NM];
  const int a = blockIdx.x;
  const int end = __ldg(agg_ptr + a + 1);
  T acc[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) acc[m] = T(0);
  for (int j = __ldg(agg_ptr + a) + threadIdx.x; j < end; j += THREADS) {
    const int d = __ldg(agg_dofs + j);
    T v = __ldg(r + d);
    if (mask != nullptr && __ldg(mask + d)) v = T(0);
    if (s_inv != nullptr) v *= __ldg(s_inv + d);
    const T* w = W + (size_t)d * NM;
#pragma unroll
    for (int m = 0; m < NM; ++m) acc[m] += v * __ldg(w + m);
  }
  block_sum<T, NM>(acc, scratch, sums);
  if (threadIdx.x < NM) rc[(size_t)a * NM + threadIdx.x] = sums[threadIdx.x];
}

template <typename T, int NM>
__global__ void __launch_bounds__(THREADS)
coarse_prolong_kernel(const T* __restrict__ rc, const T* __restrict__ Ac_inv, int ncoarse, bool vec,
                      const T* __restrict__ W, const int* __restrict__ agg_ptr,
                      const int* __restrict__ agg_dofs, const T* __restrict__ z,
                      const unsigned char* __restrict__ mask, const T* __restrict__ s_inv,
                      T* __restrict__ out) {
  __shared__ T scratch[WARPS * NM];
  __shared__ T wc[NM];
  const int a = blockIdx.x;
  const T* rows = Ac_inv + (size_t)a * NM * ncoarse;  // this aggregate's NM rows
  T acc[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) acc[m] = T(0);
  if (vec) {  // 16-byte loads: rows of a multiple of 16 bytes on aligned pointers
    using V = typename Vec16<T>::type;
    constexpr int PER = 16 / sizeof(T);
    const int nv = ncoarse / PER;
    const V* x = reinterpret_cast<const V*>(rc);
    for (int j = threadIdx.x; j < nv; j += THREADS) {
      const V xv = __ldg(x + j);
#pragma unroll
      for (int m = 0; m < NM; ++m)
        acc[m] += dot16(__ldg(reinterpret_cast<const V*>(rows + (size_t)m * ncoarse) + j), xv);
    }
  } else {
    for (int j = threadIdx.x; j < ncoarse; j += THREADS) {
      const T xj = __ldg(rc + j);
#pragma unroll
      for (int m = 0; m < NM; ++m) acc[m] += __ldg(rows + (size_t)m * ncoarse + j) * xj;
    }
  }
  block_sum<T, NM>(acc, scratch, wc);
  const int end = __ldg(agg_ptr + a + 1);
  for (int j = __ldg(agg_ptr + a) + threadIdx.x; j < end; j += THREADS) {
    const int d = __ldg(agg_dofs + j);
    const T* w = W + (size_t)d * NM;
    T c = __ldg(w) * wc[0];
#pragma unroll
    for (int m = 1; m < NM; ++m) c += __ldg(w + m) * wc[m];
    if (s_inv != nullptr) c *= __ldg(s_inv + d);
    if (mask != nullptr && __ldg(mask + d)) c = T(0);
    out[d] = z != nullptr ? __ldg(z + d) + c : c;
  }
}

template <typename T, int NM>
int restrict_nm(const T* r, const unsigned char* mask, const T* s_inv, const T* W, const int* agg_ptr,
                const int* agg_dofs, T* rc, int nagg, cudaStream_t stream) {
  coarse_restrict_kernel<T, NM><<<nagg, THREADS, 0, stream>>>(r, mask, s_inv, W, agg_ptr, agg_dofs, rc);
  return (int)cudaGetLastError();
}

template <typename T, int NM>
int prolong_nm(const T* rc, const T* Ac_inv, int ncoarse, const T* W, const int* agg_ptr,
               const int* agg_dofs, const T* z, const unsigned char* mask, const T* s_inv, T* out,
               int nagg, cudaStream_t stream) {
  const bool vec = ncoarse % (16 / sizeof(T)) == 0 && (uintptr_t)Ac_inv % 16 == 0 && (uintptr_t)rc % 16 == 0;
  coarse_prolong_kernel<T, NM><<<nagg, THREADS, 0, stream>>>(rc, Ac_inv, ncoarse, vec, W, agg_ptr, agg_dofs,
                                                             z, mask, s_inv, out);
  return (int)cudaGetLastError();
}

template <typename T>
int restrict_any(const T* r, const unsigned char* mask, const T* s_inv, const T* W, const int* agg_ptr,
                 const int* agg_dofs, T* rc, int nagg, int nmodes, void* stream) {
  if (nagg <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nmodes) {
    case 1: return restrict_nm<T, 1>(r, mask, s_inv, W, agg_ptr, agg_dofs, rc, nagg, s);
    case 2: return restrict_nm<T, 2>(r, mask, s_inv, W, agg_ptr, agg_dofs, rc, nagg, s);
    case 3: return restrict_nm<T, 3>(r, mask, s_inv, W, agg_ptr, agg_dofs, rc, nagg, s);
    case 4: return restrict_nm<T, 4>(r, mask, s_inv, W, agg_ptr, agg_dofs, rc, nagg, s);
    case 5: return restrict_nm<T, 5>(r, mask, s_inv, W, agg_ptr, agg_dofs, rc, nagg, s);
    case 6: return restrict_nm<T, 6>(r, mask, s_inv, W, agg_ptr, agg_dofs, rc, nagg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int prolong_any(const T* rc, const T* Ac_inv, const T* W, const int* agg_ptr, const int* agg_dofs,
                const T* z, const unsigned char* mask, const T* s_inv, T* out, int nagg, int nmodes,
                void* stream) {
  if (nagg <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = nagg * nmodes;
  switch (nmodes) {
    case 1: return prolong_nm<T, 1>(rc, Ac_inv, nc, W, agg_ptr, agg_dofs, z, mask, s_inv, out, nagg, s);
    case 2: return prolong_nm<T, 2>(rc, Ac_inv, nc, W, agg_ptr, agg_dofs, z, mask, s_inv, out, nagg, s);
    case 3: return prolong_nm<T, 3>(rc, Ac_inv, nc, W, agg_ptr, agg_dofs, z, mask, s_inv, out, nagg, s);
    case 4: return prolong_nm<T, 4>(rc, Ac_inv, nc, W, agg_ptr, agg_dofs, z, mask, s_inv, out, nagg, s);
    case 5: return prolong_nm<T, 5>(rc, Ac_inv, nc, W, agg_ptr, agg_dofs, z, mask, s_inv, out, nagg, s);
    case 6: return prolong_nm<T, 6>(rc, Ac_inv, nc, W, agg_ptr, agg_dofs, z, mask, s_inv, out, nagg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mask, s_inv and z may be null: no mask, no scaling, no add.
extern "C" int coarse_restrict_f32(const float* r, const unsigned char* mask, const float* s_inv,
                                   const float* W, const int* agg_ptr, const int* agg_dofs, float* rc,
                                   int nagg, int nmodes, void* stream) {
  return restrict_any<float>(r, mask, s_inv, W, agg_ptr, agg_dofs, rc, nagg, nmodes, stream);
}

extern "C" int coarse_restrict_f64(const double* r, const unsigned char* mask, const double* s_inv,
                                   const double* W, const int* agg_ptr, const int* agg_dofs, double* rc,
                                   int nagg, int nmodes, void* stream) {
  return restrict_any<double>(r, mask, s_inv, W, agg_ptr, agg_dofs, rc, nagg, nmodes, stream);
}

extern "C" int coarse_prolong_f32(const float* rc, const float* Ac_inv, const float* W, const int* agg_ptr,
                                  const int* agg_dofs, const float* z, const unsigned char* mask,
                                  const float* s_inv, float* out, int nagg, int nmodes, void* stream) {
  return prolong_any<float>(rc, Ac_inv, W, agg_ptr, agg_dofs, z, mask, s_inv, out, nagg, nmodes, stream);
}

extern "C" int coarse_prolong_f64(const double* rc, const double* Ac_inv, const double* W, const int* agg_ptr,
                                  const int* agg_dofs, const double* z, const unsigned char* mask,
                                  const double* s_inv, double* out, int nagg, int nmodes, void* stream) {
  return prolong_any<double>(rc, Ac_inv, W, agg_ptr, agg_dofs, z, mask, s_inv, out, nagg, nmodes, stream);
}

extern "C" const char* dxm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
