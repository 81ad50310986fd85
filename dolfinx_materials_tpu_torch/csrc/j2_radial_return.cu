// J2 radial return with its consistent tangent, one thread per Gauss point.
//
// Replaces the two TPU kernels of dolfinx_materials_tpu/ops/pallas_j2.py
// (shared body _radial_return_rows): elastic trial, hardening Newton on dp
// (warm-started or cold, n_iter steps), stress, new plastic strain and p, and
// the Simo-Hughes tangent
//     Ct = C - 2 mu beta K4 - gamma nbar (x) nbar.
// - make_j2_pallas_update (pallas_j2.py:103) -> j2_radial_return_f32/_f64:
//   Ct as 36 entries;
// - make_j2_pallas_factored (pallas_j2.py:196) ->
//   j2_radial_return_factored_f32/_f64: Ct as the two scalars
//   fac = [2 mu beta, gamma]; nbar = dev(sig)/q(sig) is recovered from the
//   returned stress (the return keeps the deviatoric direction).
// One kernel template, instantiated per dtype, tangent form (FACTORED), law
// form (PROGRAM, below) and layout (FEATURE_MAJOR): feature-major
// (components, n) arrays as the TPU kernels took them, or point-major (n,
// components) as the FEM path holds them. The same kernels serve the
// j2_fast contract (ops/j2_fast.py: cold start, 12 iterations, regularizer
// 1e-14) and the Pallas one (warm start, 4 iterations, regularizer 1e-7):
// both are parameters.
//
// Bound on this card: bytes. A point reads 13 values and writes 49 with the
// full tangent (62 in all) or 15 with the factored one (28): about 2 flops a
// byte in f64 and 4 in f32 for the full form, far under the H100's
// compute/bandwidth ratio, so the design is about moving each of those bytes
// once, in whole sectors. (Swift and Ramberg-Osgood evaluate pow 14 times a
// point in the j2_fast contract; in f64 that transcendental, not the bytes,
// can set the pace.) Tensor cores do not apply: every point is an independent
// scalar map with no matrix product, so wgmma and the DMMA units have nothing
// to do.
//
// Feature-major: neighbouring threads touch neighbouring addresses in every
// row, so each thread reads and writes its point directly; every access
// coalesces.
//
// Point-major: a point's values are contiguous, so a warp that writes one
// component of 32 points touches 32 sectors (288-byte stride for the
// tangent). A block therefore works on tiles of TILE consecutive points, and
// each of a tile's arrays is one contiguous slab of global memory:
// - copy in: eps (TILE x 6), eps_p (TILE x 6) and p (TILE) go to shared
//   memory unpadded, in address order, by cp.async, 16 bytes a thread (a
//   warp covers 512 contiguous bytes an instruction);
// - compute: thread j runs point j's return map from shared memory, in the
//   arithmetic of the feature-major route (one inlined function), writes
//   sig, eps_p_new and p_new over its own inputs and its tangent factors
//   b2m = 2 mu beta, gamma and nbar[6] into a factor tile (row stride 9, or
//   3 for the factored form: odd, so a warp's rows fall on distinct banks;
//   the unpadded input rows of 6 cost a 2-way conflict on 13 reads a point);
// - store: sig, eps_p_new, p_new and fac (or Ct) leave in address order, 16
//   bytes a thread. The 36 tangent entries are not staged: the thread that
//   stores entry (a, b) of point j computes it there from the factor tile,
//   with the feature-major route's function (tangent_entry), and shared
//   memory holds 9 values a point for the tangent instead of 36.
// Both layouts give the same bits: one function computes each value, and the
// build fuses no multiply and add into an FMA (ops/cuda_build.py), which the
// compiler would otherwise do differently in each instantiation.
// The grid is persistent (the blocks the card holds at once, at most one per
// tile), and each block keeps two input buffers: the next tile's copies are
// in flight while the current tile computes and stores. A first version
// without them (one tile a block, eight blocks an SM) ran the main path's
// 294,912 points in lockstep waves of load, compute and store, at 1.75x (K1)
// and 2.4x (K2) the bound (PERF.md).
// Shared memory, TILE = 128: 2 x 13 input values a point, the factor tile
// and C[36]: 36,128 bytes in f64 and 18,064 in f32 for the full tangent,
// 29,704 and 14,852 for the factored one; static (under 48 KB), with the
// carveout set to all shared memory. __launch_bounds__(TILE, 5) holds a
// thread to 96 registers, five blocks (20 warps) an SM: the caps of 64 (eight
// blocks) and 80 (six) spilled 40-112 bytes in f64; at 96 only the f64
// full-tangent point-major instantiation spills, 16 bytes. A TMA bulk copy
// would need a barrier object per buffer and 16-byte sizes; cp.async takes
// the ragged tail and misaligned views in the same loop.
// Tail and alignment: the last tile holds n % TILE points, and its slabs end
// anywhere; a contiguous view may start at any element. The launch checks
// once whether all seven arrays start on 16 bytes: then each slab moves as
// 16-byte vectors and its last len % (16 / sizeof(T)) values one by one;
// otherwise every slab moves value by value. Tile starts are multiples of
// TILE points, so an aligned array gives aligned slabs.
//
// The TPU kernel evaluates the hardening curve with jax.jvp on any callable.
// Here the four laws of models/hardening.py (Linear, Voce, Swift,
// Ramberg-Osgood) keep closed forms for value and slope; any other traceable
// law arrives as a program (ops/law_program.py, law id LAW_PROGRAM): an SSA
// list of at most MAX_INS instructions that hardening() interprets, carrying
// value and slope as a dual pair in T. The program is a kernel argument by
// value (__grid_constant__: read in place, never copied per thread), so it
// sits in the constant bank: every thread of a warp reads the same
// instruction (a broadcast) and takes the same branch of the switch, so the
// interpreter adds no divergence. Its two slot arrays are indexed at
// run time and live in local memory (L1), 16 bytes a slot used in f64.
// Programs run in a kernel of their own (j2_law_program_kernel, the same
// body with PROGRAM set), so the closed-form kernel keeps its parameters and
// code.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int LAW_LINEAR = 0;
constexpr int LAW_VOCE = 1;
constexpr int LAW_SWIFT = 2;
constexpr int LAW_RAMBERG_OSGOOD = 3;
constexpr int LAW_PROGRAM = 4;
constexpr int MAX_INS = 64;    // instructions of a law program (ops/law_program.py)
constexpr int TILE = 128;      // points of a block, one thread each
constexpr int MIN_BLOCKS = 5;  // resident blocks asked of ptxas: <= 96 registers
constexpr int SF = 9;          // shared row stride of the factors b2m, gamma, nbar[6]
                               // (3 for the factored form's b2m, gamma)

template <typename T>
struct J2Params {
  T mu, lmbda;
  T h0, h1, h2, h3;  // hardening parameters, meaning set by law
  T reg;             // regularizer: tiny = (reg * (1 + sigY(p)))^2
  int law, n_iter, warm_start;
};

// Mandel elastic stiffness, row-major: an argument of the full-tangent
// instantiations only
template <typename T>
struct Stiffness {
  T C[36];
};
struct NoStiffness {};
template <typename T, bool FACTORED>
using Tangent = std::conditional_t<FACTORED, NoStiffness, Stiffness<T>>;

// A traced hardening law: instruction k reads slots a[k], b[k] (slot 0 is p)
// and the constant c[k], and writes slot k + 1; sigma_Y is slot out. The
// opcodes are ops/law_program.py's OPS, in order.
enum Op : unsigned char {
  OP_CONST, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_ADD_C, OP_MUL_C, OP_DIV_C, OP_RSUB_C,
  OP_RDIV_C, OP_POW_C, OP_C_POW, OP_NEG, OP_EXP, OP_LOG, OP_LOG1P, OP_EXPM1, OP_SQRT,
  OP_TANH, OP_ABS, OP_CLAMP_LO, OP_CLAMP_HI, OP_MAX_C, OP_MIN_C
};
template <typename T>
struct LawProgram {
  int n, out;
  unsigned char op[MAX_INS], a[MAX_INS], b[MAX_INS];
  T c[MAX_INS];
};
// the closed-form instantiations take no program
struct NoProgram {};
template <typename T, bool PROGRAM>
using Program = std::conditional_t<PROGRAM, LawProgram<T>, NoProgram>;

template <typename T>
__device__ __forceinline__ T relu(T x) { return x > T(0) ? x : T(0); }

// explicit precision per type: no silent promotion of f32 math to f64
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return ::exp(x); }
__device__ __forceinline__ float dpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double dpow(double x, double y) { return ::pow(x, y); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return ::sqrt(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return ::log(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return ::log1p(x); }
__device__ __forceinline__ float dexpm1(float x) { return expm1f(x); }
__device__ __forceinline__ double dexpm1(double x) { return ::expm1(x); }
__device__ __forceinline__ float dtanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dtanh(double x) { return ::tanh(x); }

// Value and slope of a law program at p, in the order of
// ops/law_program.py's evaluate(); slopes at a tie as torch.func.jvp gives
// them (clamp passes the slope, maximum/minimum half of it)
template <typename T>
struct Dual {
  T v, d;
};
// not inlined, and the value and slope come back by value (no address
// taken of the caller's)
template <typename T>
__device__ __noinline__ Dual<T> run_program(const LawProgram<T>& L, T p) {
  T v[MAX_INS + 1], d[MAX_INS + 1];
  v[0] = p;
  d[0] = T(1);
  for (int k = 0; k < L.n; ++k) {
    const T va = v[L.a[k]], da = d[L.a[k]];
    const T vb = v[L.b[k]], db = d[L.b[k]];
    const T c = L.c[k];
    T r, dr;
    switch (L.op[k]) {
      case OP_CONST: r = c; dr = T(0); break;
      case OP_ADD: r = va + vb; dr = da + db; break;
      case OP_SUB: r = va - vb; dr = da - db; break;
      case OP_MUL: r = va * vb; dr = da * vb + va * db; break;
      case OP_DIV: r = va / vb; dr = (da - r * db) / vb; break;
      case OP_ADD_C: r = va + c; dr = da; break;
      case OP_MUL_C: r = va * c; dr = da * c; break;
      case OP_DIV_C: r = va / c; dr = da / c; break;
      case OP_RSUB_C: r = c - va; dr = -da; break;
      case OP_RDIV_C: r = c / va; dr = -(r / va) * da; break;
      case OP_POW_C: r = dpow(va, c); dr = c == T(0) ? T(0) : c * dpow(va, c - T(1)) * da; break;
      case OP_C_POW: r = dpow(c, va); dr = c == T(0) ? T(0) : r * dlog(c) * da; break;
      case OP_NEG: r = -va; dr = -da; break;
      case OP_EXP: r = dexp(va); dr = r * da; break;
      case OP_LOG: r = dlog(va); dr = da / va; break;
      case OP_LOG1P: r = dlog1p(va); dr = da / (T(1) + va); break;
      case OP_EXPM1: r = dexpm1(va); dr = (r + T(1)) * da; break;
      case OP_SQRT: r = dsqrt(va); dr = da / (T(2) * r); break;
      case OP_TANH: r = dtanh(va); dr = (T(1) - r * r) * da; break;
      case OP_ABS:
        r = va < T(0) ? -va : va;
        dr = va > T(0) ? da : (va < T(0) ? -da : T(0));
        break;
      case OP_CLAMP_LO: r = va < c ? c : va; dr = va >= c ? da : T(0); break;
      case OP_CLAMP_HI: r = va > c ? c : va; dr = va <= c ? da : T(0); break;
      case OP_MAX_C:
        r = va < c ? c : va;
        dr = va > c ? da : (va == c ? T(0.5) * da : T(0));
        break;
      default:  // OP_MIN_C
        r = va > c ? c : va;
        dr = va < c ? da : (va == c ? T(0.5) * da : T(0));
        break;
    }
    v[k + 1] = r;
    d[k + 1] = dr;
  }
  return {v[L.out], d[L.out]};
}

// PROGRAM: a law program (j2_law_program_kernel); else the closed forms
template <typename T, bool PROGRAM>
__device__ __forceinline__ void hardening(const J2Params<T>& P, const Program<T, PROGRAM>& L, T p,
                                          T& Y, T& dY) {
  if constexpr (PROGRAM) {
    const Dual<T> y = run_program(L, p);
    Y = y.v;
    dY = y.d;
  } else if (P.law == LAW_LINEAR) {  // sig0 + H p
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

template <typename T>
struct PointOut {
  T sig[6], epsp[6], p;
  T b2m, gamma, nb[6];  // tangent factors: 2 mu beta, gamma, nbar
};

// One point's return map; both layouts run it, so their sig, eps_p_new,
// p_new and factors are the same arithmetic
template <typename T, bool PROGRAM>
__device__ __forceinline__ PointOut<T> return_map(const J2Params<T>& P, const Program<T, PROGRAM>& L,
                                                  const T (&eps)[6], const T (&ep)[6], const T p) {
  const T mu = P.mu;
  T e[6];
#pragma unroll
  for (int f = 0; f < 6; ++f) e[f] = eps[f] - ep[f];

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
  hardening<T, PROGRAM>(P, L, p, Y0, dY0);
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
    hardening<T, PROGRAM>(P, L, p + dp, Y, dY);
    const T r = f_act - T(3) * mu * dp - (Y - Y0);
    dp = relu(dp - r / (-T(3) * mu - dY));
  }
  T Yn, Hp;
  hardening<T, PROGRAM>(P, L, p + dp, Yn, Hp);

  PointOut<T> o;
#pragma unroll
  for (int f = 0; f < 6; ++f) o.nb[f] = s[f] * iq;
  const T c3 = T(3) * mu * dp;
  const T c15 = T(1.5) * dp;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    o.sig[f] = sn[f] - c3 * o.nb[f];
    o.sig[3 + f] = s[3 + f] - c3 * o.nb[3 + f];
  }
#pragma unroll
  for (int f = 0; f < 6; ++f) o.epsp[f] = ep[f] + c15 * o.nb[f];
  o.p = p + dp;

  const T plastic = f_tr > T(0) ? T(1) : T(0);
  o.b2m = T(6) * mu * mu * dp * iq * plastic;  // 2 mu beta
  o.gamma = T(9) * mu * mu * (T(1) / (T(3) * mu + Hp) - dp * iq) * plastic;
  return o;
}

// entry (a, b) of Ct = C - 2 mu beta K4 - gamma nbar (x) nbar, with
// K4 = I - (1/3) I2 (x) I2, in the plain version's order of operations
template <typename T>
__device__ __forceinline__ T tangent_entry(T c, int a, int b, T b2m, T gamma, T na, T nb) {
  const T k4 = (a == b ? T(1) : T(0)) - (a < 3 && b < 3 ? T(1) / T(3) : T(0));
  return c - k4 * b2m - gamma * na * nb;
}

// 16-byte vectors and their lanes
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};
__device__ __forceinline__ void set_lane(float4& v, int c, float x) {
  if (c == 0) v.x = x;
  else if (c == 1) v.y = x;
  else if (c == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ void set_lane(double2& v, int c, double x) {
  if (c == 0) v.x = x;
  else v.y = x;
}

// Asynchronous global -> shared copies (cp.async): 16 bytes (both addresses
// on the 16-byte grid) or one value of 4 or 8 bytes
template <int BYTES>
__device__ __forceinline__ void copy_async(void* s, const void* g) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(s));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(g) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(g), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying the len values of a global slab to s in address order:
// 16-byte vectors when vec, then the rest one value at a time
template <typename T>
__device__ __forceinline__ void load_slab(T* s, const T* g, int len, bool vec) {
  constexpr int NV = 16 / sizeof(T);
  int k0 = 0;
  if (vec) {
    for (int v = threadIdx.x; v < len / NV; v += TILE) copy_async<16>(s + NV * v, g + NV * v);
    k0 = len / NV * NV;
  }
  for (int k = k0 + threadIdx.x; k < len; k += TILE) copy_async<sizeof(T)>(s + k, g + k);
}

// Start copying tile t's inputs into buf: eps at 0, eps_p at 6 TILE, p at
// 12 TILE, each unpadded
template <typename T>
__device__ __forceinline__ void load_tile(T* buf, const T* eps, const T* epsp, const T* p,
                                          long long t, long long n, bool vec) {
  const long long t0 = t * TILE;
  const int count = (int)(n - t0 < TILE ? n - t0 : TILE);
  load_slab(buf, eps + 6 * t0, 6 * count, vec);
  load_slab(buf + 6 * TILE, epsp + 6 * t0, 6 * count, vec);
  load_slab(buf + 12 * TILE, p + t0, count, vec);
}

// Store value(k) for the len values of a global slab in address order:
// 16-byte vectors when vec, then the rest one by one
template <typename T, typename F>
__device__ __forceinline__ void stage_out(T* __restrict__ g, int len, bool vec, F value) {
  constexpr int NV = 16 / sizeof(T);
  using V = typename Vec<T>::type;
  int k0 = 0;
  if (vec) {
    V* gv = reinterpret_cast<V*>(g);
    for (int v = threadIdx.x; v < len / NV; v += TILE) {
      V x;
#pragma unroll
      for (int c = 0; c < NV; ++c) set_lane(x, c, value(v * NV + c));
      gv[v] = x;
    }
    k0 = len / NV * NV;
  }
  for (int k = k0 + threadIdx.x; k < len; k += TILE) g[k] = value(k);
}

// The kernels' body, inlined into the two kernels below.
// FACTORED = false: tg is Ct (36 wide), Cm a Stiffness<T>;
// FACTORED = true:  tg is fac (2 wide), Cm a NoStiffness.
// vec: every array starts on 16 bytes (point-major only).
template <typename T, bool FACTORED, bool FEATURE_MAJOR, bool PROGRAM>
__device__ __forceinline__ void j2_body(const T* __restrict__ eps, const T* __restrict__ epsp,
                                        const T* __restrict__ p_in, T* __restrict__ sig,
                                        T* __restrict__ tg, T* __restrict__ epspn,
                                        T* __restrict__ pn, long long n, const J2Params<T>& P,
                                        const Program<T, PROGRAM>& L, const Tangent<T, FACTORED>& Cm,
                                        bool vec) {
  if constexpr (FEATURE_MAJOR) {
    // element (f, i) of a (w, n) array at f * n + i
    const long long i = (long long)blockIdx.x * TILE + threadIdx.x;
    if (i >= n) return;
    T e[6], ep[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      e[f] = eps[f * n + i];
      ep[f] = epsp[f * n + i];
    }
    const PointOut<T> o = return_map<T, PROGRAM>(P, L, e, ep, p_in[i]);
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      sig[f * n + i] = o.sig[f];
      epspn[f * n + i] = o.epsp[f];
    }
    pn[i] = o.p;
    if constexpr (FACTORED) {
      tg[i] = o.b2m;
      tg[n + i] = o.gamma;
    } else {
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b < 6; ++b)
          tg[(6 * a + b) * n + i] =
              tangent_entry(Cm.C[6 * a + b], a, b, o.b2m, o.gamma, o.nb[a], o.nb[b]);
      }
    }
  } else {
    // point-major: a persistent block walks the tiles blockIdx.x + k gridDim.x;
    // the next tile's inputs are copied into one half of s_in while this one
    // is computed from the other, and its outputs overwrite its inputs
    constexpr int SFW = FACTORED ? 3 : SF;
    __shared__ __align__(16) T s_in[2][13 * TILE];
    __shared__ T s_f[TILE * SFW];  // b2m, gamma (, nbar[6])
    __shared__ T s_C[FACTORED ? 1 : 36];
    if constexpr (!FACTORED) {
      // C read at run-time indices from shared memory: from the parameter
      // bank, lanes with different indices would be served one by one
      if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < 36; ++k) s_C[k] = Cm.C[k];
      }
    }
    const long long tiles = (n + TILE - 1) / TILE;
    long long t = blockIdx.x;
    load_tile(s_in[0], eps, epsp, p_in, t, n, vec);
    copy_async_commit();
    for (int half = 0; t < tiles; t += gridDim.x, half ^= 1) {
      if (t + gridDim.x < tiles) load_tile(s_in[half ^ 1], eps, epsp, p_in, t + gridDim.x, n, vec);
      copy_async_commit();
      copy_async_wait<1>();  // this tile's copies have landed, the next one's may not
      __syncthreads();

      T* const s_e = s_in[half];        // eps, then sig
      T* const s_ep = s_e + 6 * TILE;   // eps_p, then eps_p_new
      T* const s_p = s_e + 12 * TILE;   // p, then p_new
      const long long t0 = t * TILE;
      const int count = (int)(n - t0 < TILE ? n - t0 : TILE);
      const int j = threadIdx.x;
      if (j < count) {
        T e[6], ep[6];
#pragma unroll
        for (int f = 0; f < 6; ++f) {
          e[f] = s_e[6 * j + f];
          ep[f] = s_ep[6 * j + f];
        }
        const PointOut<T> o = return_map<T, PROGRAM>(P, L, e, ep, s_p[j]);
#pragma unroll
        for (int f = 0; f < 6; ++f) {
          s_e[6 * j + f] = o.sig[f];
          s_ep[6 * j + f] = o.epsp[f];
        }
        s_p[j] = o.p;
        s_f[j * SFW] = o.b2m;
        s_f[j * SFW + 1] = o.gamma;
        if constexpr (!FACTORED) {
#pragma unroll
          for (int f = 0; f < 6; ++f) s_f[j * SFW + 2 + f] = o.nb[f];
        }
      }
      __syncthreads();

      stage_out(sig + 6 * t0, 6 * count, vec, [&](int k) { return s_e[k]; });
      stage_out(epspn + 6 * t0, 6 * count, vec, [&](int k) { return s_ep[k]; });
      stage_out(pn + t0, count, vec, [&](int k) { return s_p[k]; });
      if constexpr (FACTORED) {
        stage_out(tg + 2 * t0, 2 * count, vec, [&](int k) { return s_f[(k / 2) * SFW + k % 2]; });
      } else {
        stage_out(tg + 36 * t0, 36 * count, vec, [&](int k) {
          const int r = k % 36, a = r / 6, b = r % 6;
          const T* f = s_f + (k / 36) * SFW;
          return tangent_entry(s_C[r], a, b, f[0], f[1], f[2 + a], f[2 + b]);
        });
      }
      __syncthreads();  // s_in[half] takes the copies started next time round, s_f is rewritten
    }
  }
}

// The closed-form laws (law id 0-3)
template <typename T, bool FACTORED, bool FEATURE_MAJOR>
__global__ void __launch_bounds__(TILE, MIN_BLOCKS)
j2_radial_return_kernel(const T* __restrict__ eps, const T* __restrict__ epsp,
                        const T* __restrict__ p_in, T* __restrict__ sig,
                        T* __restrict__ tg, T* __restrict__ epspn,
                        T* __restrict__ pn, long long n, const J2Params<T> P,
                        const Tangent<T, FACTORED> Cm, bool vec) {
  j2_body<T, FACTORED, FEATURE_MAJOR, false>(eps, epsp, p_in, sig, tg, epspn, pn, n, P, NoProgram{},
                                             Cm, vec);
}

// A law program (LAW_PROGRAM): a kernel of its own, so the closed-form
// kernel keeps the parameter list and the code it had without programs
template <typename T, bool FACTORED, bool FEATURE_MAJOR>
__global__ void __launch_bounds__(TILE, MIN_BLOCKS)
j2_law_program_kernel(const T* __restrict__ eps, const T* __restrict__ epsp,
                      const T* __restrict__ p_in, T* __restrict__ sig,
                      T* __restrict__ tg, T* __restrict__ epspn,
                      T* __restrict__ pn, long long n, const J2Params<T> P,
                      const __grid_constant__ LawProgram<T> L, const Tangent<T, FACTORED> Cm,
                      bool vec) {
  j2_body<T, FACTORED, FEATURE_MAJOR, true>(eps, epsp, p_in, sig, tg, epspn, pn, n, P, L, Cm, vec);
}

template <typename T, bool FACTORED, bool FEATURE_MAJOR, bool PROGRAM>
constexpr auto kernel_of() {
  if constexpr (PROGRAM)
    return j2_law_program_kernel<T, FACTORED, FEATURE_MAJOR>;
  else
    return j2_radial_return_kernel<T, FACTORED, FEATURE_MAJOR>;
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

// Blocks of the point-major kernel that the card holds at once: the
// persistent grid. Asked once per instantiation, of the device current then
// (a grid of any size gives the same results).
template <typename T, bool FACTORED, bool PROGRAM>
long long resident_blocks() {
  static const long long blocks = [] {
    auto kernel = kernel_of<T, FACTORED, false, PROGRAM>();
    // all of the SM's shared memory, for as many resident blocks as it holds
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    int per_sm = 0, dev = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TILE, 0);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }();
  return blocks;
}

template <typename T, bool FACTORED, bool PROGRAM>
void launch_kernel(const T* eps, const T* epsp, const T* p, T* sig, T* tg, T* epspn, T* pn,
                   long long n, const J2Params<T>& P, const Program<T, PROGRAM>& L,
                   const Tangent<T, FACTORED>& Cm, int feature_major, cudaStream_t st) {
  const long long tiles = (n + TILE - 1) / TILE;
  bool vec = false;
  unsigned grid = (unsigned)tiles;
  if (!feature_major) {
    vec = aligned16(eps) && aligned16(epsp) && aligned16(p) && aligned16(sig) && aligned16(tg) &&
          aligned16(epspn) && aligned16(pn);
    const long long resident = resident_blocks<T, FACTORED, PROGRAM>();
    grid = (unsigned)(tiles < resident ? tiles : resident);
  }
  const auto kernel = feature_major ? kernel_of<T, FACTORED, true, PROGRAM>()
                                    : kernel_of<T, FACTORED, false, PROGRAM>();
  if constexpr (PROGRAM)
    kernel<<<grid, TILE, 0, st>>>(eps, epsp, p, sig, tg, epspn, pn, n, P, L, Cm, vec);
  else
    kernel<<<grid, TILE, 0, st>>>(eps, epsp, p, sig, tg, epspn, pn, n, P, Cm, vec);
}

template <typename T, bool FACTORED>
int launch(const T* eps, const T* epsp, const T* p, T* sig, T* tg, T* epspn, T* pn,
           long long n, const double* params, int law, int n_iter, int warm_start,
           int feature_major, void* stream) {
  if (n <= 0) return 0;
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
  Tangent<T, FACTORED> Cm;
  if constexpr (!FACTORED) {
    for (int k = 0; k < 36; ++k) Cm.C[k] = T(params[7 + k]);
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (law == LAW_PROGRAM) {  // n, out, then op, a, b, c per instruction after C[36]
    LawProgram<T> L;
    const double* prog = params + 43;
    L.n = (int)prog[0];
    L.out = (int)prog[1];
    if (L.n < 0 || L.n > MAX_INS || L.out < 0 || L.out > L.n) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < L.n; ++k) {
      const double* ins = prog + 2 + 4 * k;
      if (ins[0] < 0 || ins[0] > OP_MIN_C || ins[1] < 0 || ins[1] > k || ins[2] < 0 || ins[2] > k)
        return (int)cudaErrorInvalidValue;
      L.op[k] = (unsigned char)ins[0];
      L.a[k] = (unsigned char)ins[1];
      L.b[k] = (unsigned char)ins[2];
      L.c[k] = T(ins[3]);
    }
    launch_kernel<T, FACTORED, true>(eps, epsp, p, sig, tg, epspn, pn, n, P, L, Cm, feature_major, st);
  } else {
    launch_kernel<T, FACTORED, false>(eps, epsp, p, sig, tg, epspn, pn, n, P, NoProgram{}, Cm,
                                      feature_major, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// params (host): mu, lmbda, h0, h1, h2, h3, reg, then C[36] (read by the
// full-tangent entry points only), then for law == LAW_PROGRAM the program:
// n, out, and op, a, b, c per instruction
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
