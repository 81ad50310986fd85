// J2 radial return with its consistent tangent, one thread per Gauss point.
//
// Replaces the two TPU kernels of dolfinx_materials_tpu/ops/pallas_j2.py
// (shared body _radial_return_rows): elastic trial, hardening Newton on dp
// (warm-started or cold, n_iter steps), stress, new plastic strain and p, and
// the Simo-Hughes tangent
//     Ct = C - 2 mu beta K4 - gamma nbar (x) nbar.
// - make_j2_pallas_update   -> j2_radial_return_f32/_f64: Ct as 36 entries;
// - make_j2_pallas_factored -> j2_radial_return_factored_f32/_f64: Ct as the
//   two scalars fac = [2 mu beta, gamma]; nbar = dev(sig)/q(sig) is recovered
//   from the returned stress (the return keeps the deviatoric direction).
// The tangent form is a compile-time parameter of one kernel template, so the
// factored instantiation carries neither the 36-entry store loop nor the
// stiffness constants. The same kernels serve the j2_fast contract
// (ops/j2_fast.py: cold start, 12 iterations, regularizer 1e-14) and the
// Pallas one (warm start, 4 iterations, regularizer 1e-7): both are
// parameters.
//
// Bound on this card: memory. A point reads 13 values and writes 49 with the
// full tangent (the 36 entries dominate) or 15 with the factored one, about
// 2 flops per byte in f64 and 4 in f32 for the full form and under 20 for the
// factored, far under the H100's compute/bandwidth ratio. Design: every point is
// independent, so one thread owns one point, keeps the whole Newton loop in
// registers, and touches device memory exactly once per input and output.
// With feature-major (components, n) arrays neighbouring threads read and
// write neighbouring addresses, so every access coalesces without any
// shared-memory tiling. The point-major (n, components) layout that the FEM
// path holds is also accepted: each warp then writes 32 strided 36-value
// tangent rows, which L2 has to merge (measured far slower per point than
// feature-major; staging the tangent through shared memory is the next
// step). The ragged tail is masked: no n % tile constraint.
//
// The TPU kernel evaluates the hardening curve with jax.jvp on any callable;
// here the value and slope are closed forms for the laws with a law id
// (models/hardening.py: Linear, Voce, Swift, Ramberg-Osgood); a user callable
// with no closed form runs the plain PyTorch return map.

#include <cuda_runtime.h>

namespace {

constexpr int LAW_LINEAR = 0;
constexpr int LAW_VOCE = 1;
constexpr int LAW_SWIFT = 2;
constexpr int LAW_RAMBERG_OSGOOD = 3;
constexpr int THREADS = 256;

template <typename T>
struct J2Params {
  T mu, lmbda;
  T h0, h1, h2, h3;  // hardening parameters, meaning set by law
  T reg;             // regularizer: tiny = (reg * (1 + sigY(p)))^2
  int law, n_iter, warm_start, feature_major;
};

// Mandel elastic stiffness, row-major: an argument of the full-tangent
// instantiation only
template <typename T>
struct Stiffness {
  T C[36];
};
struct NoStiffness {};

template <typename T>
__device__ __forceinline__ T relu(T x) { return x > T(0) ? x : T(0); }

// explicit precision per type: no silent promotion of f32 math to f64
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return ::exp(x); }
__device__ __forceinline__ float dpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double dpow(double x, double y) { return ::pow(x, y); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return ::sqrt(x); }

template <typename T>
__device__ __forceinline__ void hardening(const J2Params<T>& P, T p, T& Y, T& dY) {
  if (P.law == LAW_LINEAR) {  // sig0 + H p
    Y = P.h0 + P.h1 * p;
    dY = P.h1;
  } else if (P.law == LAW_VOCE) {  // sig0 + (sigu - sig0)(1 - exp(-b p))
    T e = dexp(-P.h2 * p);
    Y = P.h0 + (P.h1 - P.h0) * (T(1) - e);
    dY = (P.h1 - P.h0) * (P.h2 * e);
  } else if (P.law == LAW_SWIFT) {  // sig0 (1 + p/eps0)^n
    T base = T(1) + p / P.h1;
    Y = P.h0 * dpow(base, P.h2);
    dY = P.h0 * P.h2 * dpow(base, P.h2 - T(1)) / P.h1;
  } else {  // Ramberg-Osgood: sig0 (k max(p, p_eps))^(1/n), k = E/(alpha sig0);
            // h1 = k, h2 = 1/n, h3 = p_eps; the clamp has slope 0 below p_eps
    const bool above = p >= P.h3;
    T x = (above ? p : P.h3) * P.h1;
    Y = P.h0 * dpow(x, P.h2);
    dY = above ? P.h0 * P.h2 * P.h1 * dpow(x, P.h2 - T(1)) : T(0);
  }
}

// FACTORED = false: tg is Ct (36 wide), Cm a Stiffness<T>;
// FACTORED = true:  tg is fac (2 wide), Cm a NoStiffness.
template <typename T, bool FACTORED, typename CM>
__global__ void __launch_bounds__(THREADS)
j2_radial_return_kernel(const T* __restrict__ eps, const T* __restrict__ epsp,
                        const T* __restrict__ p_in, T* __restrict__ sig,
                        T* __restrict__ tg, T* __restrict__ epspn,
                        T* __restrict__ pn, long long n, const J2Params<T> P,
                        const CM Cm) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // element (f, i) of a width-w array: f*n + i feature-major, i*w + f otherwise
  const bool fm = P.feature_major != 0;
#define AT(f, w) (fm ? (long long)(f) * n + i : i * (w) + (f))

  const T mu = P.mu;
  T ep[6], e[6];
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    ep[f] = epsp[AT(f, 6)];
    e[f] = eps[AT(f, 6)] - ep[f];
  }
  const T p = p_in[AT(0, 1)];

  // elastic trial: normal rows carry the pressure, shear rows are deviatoric
  const T lt = P.lmbda * (e[0] + e[1] + e[2]);
  T s[6], sn[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) sn[f] = T(2) * mu * e[f] + lt;
  const T m = (sn[0] + sn[1] + sn[2]) * (T(1) / T(3));
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    s[f] = sn[f] - m;
    s[3 + f] = T(2) * mu * e[3 + f];
  }

  T Y0, dY0;
  hardening(P, p, Y0, dY0);
  const T tiny = (P.reg * (T(1) + Y0)) * (P.reg * (T(1) + Y0));
  T ss = T(0);
#pragma unroll
  for (int f = 0; f < 6; ++f) ss += s[f] * s[f];
  const T q = dsqrt(T(1.5) * ss + tiny);
  const T iq = T(1) / q;
  const T f_tr = q - Y0;
  const T f_act = relu(f_tr);

  // hardening Newton on dp; the clamp keeps softening seeds finite
  T dp = T(0);
  if (P.warm_start) {
    T den = T(3) * mu + dY0;
    den = den > T(1e-3) * mu ? den : T(1e-3) * mu;
    dp = f_act / den;
  }
  for (int it = 0; it < P.n_iter; ++it) {
    T Y, dY;
    hardening(P, p + dp, Y, dY);
    const T r = f_act - T(3) * mu * dp - (Y - Y0);
    dp = relu(dp - r / (-T(3) * mu - dY));
  }
  T Yn, Hp;
  hardening(P, p + dp, Yn, Hp);

  T nb[6];
#pragma unroll
  for (int f = 0; f < 6; ++f) nb[f] = s[f] * iq;
  const T c3 = T(3) * mu * dp;
  const T c15 = T(1.5) * dp;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    sig[AT(f, 6)] = sn[f] - c3 * nb[f];
    sig[AT(3 + f, 6)] = s[3 + f] - c3 * nb[3 + f];
  }
#pragma unroll
  for (int f = 0; f < 6; ++f) epspn[AT(f, 6)] = ep[f] + c15 * nb[f];
  pn[AT(0, 1)] = p + dp;

  const T plastic = f_tr > T(0) ? T(1) : T(0);
  const T b2m = T(6) * mu * mu * dp * iq * plastic;  // 2 mu beta
  const T gamma = T(9) * mu * mu * (T(1) / (T(3) * mu + Hp) - dp * iq) * plastic;
  if constexpr (FACTORED) {
    tg[AT(0, 2)] = b2m;
    tg[AT(1, 2)] = gamma;
  } else {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        // K4 = I - (1/3) I2 (x) I2
        const T k4 = (a == b ? T(1) : T(0)) - (a < 3 && b < 3 ? T(1) / T(3) : T(0));
        tg[AT(6 * a + b, 36)] = Cm.C[6 * a + b] - k4 * b2m - gamma * nb[a] * nb[b];
      }
    }
  }
#undef AT
}

template <typename T, bool FACTORED>
int launch(const T* eps, const T* epsp, const T* p, T* sig, T* tg, T* epspn, T* pn,
           long long n, const double* params, int law, int n_iter, int warm_start,
           int feature_major, void* stream) {
  J2Params<T> P;
  P.mu = T(params[0]);
  P.lmbda = T(params[1]);
  P.h0 = T(params[2]);
  P.h1 = T(params[3]);
  P.h2 = T(params[4]);
  P.h3 = T(params[5]);
  P.reg = T(params[6]);
  P.law = law;
  P.n_iter = n_iter;
  P.warm_start = warm_start;
  P.feature_major = feature_major;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (FACTORED) {
    j2_radial_return_kernel<T, true, NoStiffness><<<blocks, THREADS, 0, st>>>(
        eps, epsp, p, sig, tg, epspn, pn, n, P, NoStiffness{});
  } else {
    Stiffness<T> Cm;
    for (int k = 0; k < 36; ++k) Cm.C[k] = T(params[7 + k]);
    j2_radial_return_kernel<T, false, Stiffness<T>><<<blocks, THREADS, 0, st>>>(
        eps, epsp, p, sig, tg, epspn, pn, n, P, Cm);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// params (host): mu, lmbda, h0, h1, h2, h3, reg, then C[36] (full tangent only)
#define J2_ENTRY(NAME, T, FACTORED)                                                    \
  extern "C" int NAME(const T* eps, const T* epsp, const T* p, T* sig, T* tg,         \
                      T* epspn, T* pn, long long n, const double* params, int law,     \
                      int n_iter, int warm_start, int feature_major, void* stream) {   \
    return launch<T, FACTORED>(eps, epsp, p, sig, tg, epspn, pn, n, params, law,      \
                               n_iter, warm_start, feature_major, stream);             \
  }

J2_ENTRY(j2_radial_return_f32, float, false)
J2_ENTRY(j2_radial_return_f64, double, false)
J2_ENTRY(j2_radial_return_factored_f32, float, true)
J2_ENTRY(j2_radial_return_factored_f64, double, true)
#undef J2_ENTRY

extern "C" const char* dxm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
