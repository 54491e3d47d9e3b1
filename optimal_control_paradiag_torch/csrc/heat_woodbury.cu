// Fused half-spectrum Woodbury direct solve for the heat family, for Hopper.
//
// Replaces the Pallas TPU kernel optimal_control_paradiag_tpu/paradiag/
// pallas_heat.py:_make_kernel (launched by build_pallas_heat_solver). It
// computes the same function: for every wavenumber column j, over all
// K = N_t/2 + 1 half-spectrum bins k,
//
//   x = W(b),  then `refine` times  x += W(b - A_hat x),
//   W(r) = D^-1 r - D^-1 Psi (G_j Phi* D^-1 r),
//   A_hat x = D x + psi_u1 (m1 uN) + psi_pN (m1 p1),
//
// with D the per-(k, j) 2x2 circulant block (a11, conj(a11), tm, 1/det),
// Phi* the 2 pairing-weighted phase-sum extractions (u slice N_t-1 -> uN,
// p slice 0 -> p1), G_j the real 2x2 capacity matrix of column j and Psi the
// 2 rank-1 injections (u row 0, p row N_t-1). Complex arithmetic is split
// real, in the order of the Pallas kernel body and of its PyTorch twin
// (cuda_heat.py: fused_heat_reference).
//
// Bound: bytes. Per (k, j) element the function reads b (4 reals) and three
// constants and writes x (4 reals), and does ~172 flops (refine = 1): at
// K = 513, n = 2047, float32 that is 46.2 MB against 0.18 GFLOP, two orders
// of magnitude under the ridge of the card.
//
// Schedule: that of the wave kernel (woodbury.cu), at rank 2. The Pallas
// kernel holds a whole (K, 128) column slab of 11 arrays in VMEM (2.9 MB at
// K = 513); a Hopper SM has 228 KB of shared memory. Each column's work is a
// chain of reductions over K, each feeding two per-column scalars into the
// next: z = Phi* D^-1 b, then the extraction (uN, p1) of x inside A_hat, then
// z of D^-1 (b - A_hat x). So the kernel streams over K in 2 + 2 * refine
// passes and carries only those scalars between passes; x lives in the
// output buffer between passes. Every reduction is formed from the
// working-dtype intermediates, as in the twin, so the defect correction sees
// the real rounding.
//
// Layout. A block owns TJ = 16 adjacent columns (threadIdx.x, coalesced along
// the row-major (K, n) arrays) and splits K across KS = 32 lanes
// (threadIdx.y, bins k = ty, ty + KS, ...); the 2 partial sums of each
// reduction meet in shared memory. The complex state is torch.view_as_real of
// a contiguous (2, K, n) complex tensor: [u|p][k][j][re|im], read and written
// as float2 / double2. At the 2D lumped shape (K = 33) most lanes hold one
// bin: a known cost of this simple layout.

#include <cuda_runtime.h>

namespace {

constexpr int TJ = 16;  // columns per block
constexpr int KS = 32;  // lanes splitting the K bins of a column

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

template <typename T> struct C4 { T ur, ui, pr, pi; };

// yu = (conj(a11) u + tm p) / det ; yp = (a11 p - tm u) / det
template <typename T>
__device__ __forceinline__ C4<T> d_inv(const C4<T>& r, T a11r, T a11i, T tm1, T invdet) {
  C4<T> y;
  y.ur = (a11r * r.ur + a11i * r.ui + tm1 * r.pr) * invdet;
  y.ui = (a11r * r.ui - a11i * r.ur + tm1 * r.pi) * invdet;
  y.pr = (a11r * r.pr - a11i * r.pi - tm1 * r.ur) * invdet;
  y.pi = (a11r * r.pi + a11i * r.pr - tm1 * r.ui) * invdet;
  return y;
}

// D x  (a22 = conj(a11); tm real)
template <typename T>
__device__ __forceinline__ C4<T> d_apply(const C4<T>& x, T a11r, T a11i, T tm1) {
  C4<T> d;
  d.ur = a11r * x.ur - a11i * x.ui - tm1 * x.pr;
  d.ui = a11r * x.ui + a11i * x.ur - tm1 * x.pi;
  d.pr = tm1 * x.ur + a11r * x.pr + a11i * x.pi;
  d.pi = tm1 * x.ui + a11r * x.pi - a11i * x.pr;
  return d;
}

// psi (x) w at bin k: rank-1 injections into u row 0 and p row N_t - 1.
template <typename T>
__device__ __forceinline__ C4<T> psi_outer(const T* ph, T wu, T wp) {
  return C4<T>{ph[4] * wu, ph[5] * wu, ph[6] * wp, ph[7] * wp};
}

// Real part of the pairing-weighted phase sums, bin k's term.
template <typename T>
__device__ __forceinline__ void extract_add(T acc[2], const C4<T>& y, const T* ph) {
  acc[0] += ph[0] * y.ur - ph[1] * y.ui;
  acc[1] += ph[2] * y.pr - ph[3] * y.pi;
}

// Sum the 2 per-lane partials of each column over the KS lanes of the block;
// every thread of the column gets the totals back in acc.
template <typename T>
__device__ __forceinline__ void column_sum2(T acc[2], T (&part)[2][KS][TJ], T (&tot)[2][TJ]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  part[0][ty][tx] = acc[0];
  part[1][ty][tx] = acc[1];
  __syncthreads();
  if (ty < 2) {
    T s = T(0);
    for (int i = 0; i < KS; ++i) s += part[ty][i][tx];
    tot[ty][tx] = s;
  }
  __syncthreads();
  acc[0] = tot[0][tx];
  acc[1] = tot[1][tx];
}

template <typename T>
__global__ void __launch_bounds__(TJ * KS)
heat_fused_kernel(const T* __restrict__ b, T* __restrict__ x,
                  const T* __restrict__ a11r_g, const T* __restrict__ a11i_g,
                  const T* __restrict__ invdet_g, const T* __restrict__ colc,
                  const T* __restrict__ phases, int K, int n, int refine) {
  using V = typename Vec2<T>::type;
  __shared__ T part[2][KS][TJ];
  __shared__ T tot[2][TJ];

  const int ty = threadIdx.y;
  const int j = blockIdx.x * TJ + threadIdx.x;
  // Dead columns (j >= n) run no bins but join every block reduction.
  const int k_end = j < n ? K : 0;
  const size_t plane = (size_t)K * n;  // complex elements of the u (or p) plane
  const V* bv = reinterpret_cast<const V*>(b);
  V* xv = reinterpret_cast<V*>(x);

  T m1 = T(0), tm1 = T(0), g00 = T(0), g01 = T(0), g10 = T(0), g11 = T(0);
  if (j < n) {
    m1 = colc[j];
    tm1 = colc[n + j];
    g00 = colc[2 * n + j];
    g01 = colc[3 * n + j];
    g10 = colc[4 * n + j];
    g11 = colc[5 * n + j];
  }

  auto load = [&](const V* s, int k) {
    const size_t o = (size_t)k * n + j;
    const V u = s[o], p = s[plane + o];
    return C4<T>{u.x, u.y, p.x, p.y};
  };
  auto store = [&](int k, const C4<T>& v) {
    const size_t o = (size_t)k * n + j;
    V u, p;
    u.x = v.ur; u.y = v.ui; p.x = v.pr; p.y = v.pi;
    xv[o] = u;
    xv[plane + o] = p;
  };

  T acc[2], wu, wp, ru, rp;

  // Pass 1: z = Phi* D^-1 b ; w = G z
  acc[0] = acc[1] = T(0);
  for (int k = ty; k < k_end; k += KS) {
    const size_t o = (size_t)k * n + j;
    const C4<T> y = d_inv(load(bv, k), a11r_g[o], a11i_g[o], tm1, invdet_g[o]);
    extract_add(acc, y, phases + 8 * k);
  }
  column_sum2(acc, part, tot);
  wu = g00 * acc[0] + g01 * acc[1];
  wp = g10 * acc[0] + g11 * acc[1];

  // Pass 2: x = D^-1 b - D^-1 (psi w); accumulate Phi* x for A_hat.
  acc[0] = acc[1] = T(0);
  for (int k = ty; k < k_end; k += KS) {
    const size_t o = (size_t)k * n + j;
    const T a11r = a11r_g[o], a11i = a11i_g[o], invdet = invdet_g[o];
    const T* ph = phases + 8 * k;
    const C4<T> y = d_inv(load(bv, k), a11r, a11i, tm1, invdet);
    const C4<T> d = d_inv(psi_outer(ph, wu, wp), a11r, a11i, tm1, invdet);
    const C4<T> xk{y.ur - d.ur, y.ui - d.ui, y.pr - d.pr, y.pi - d.pi};
    store(k, xk);
    if (refine > 0) extract_add(acc, xk, ph);
  }

  for (int s = 0; s < refine; ++s) {
    // The rank-2 rows of A_hat from the extracted slices (uN, p1).
    column_sum2(acc, part, tot);
    ru = m1 * acc[0];
    rp = m1 * acc[1];

    // Pass 3: z = Phi* D^-1 (b - A_hat x) ; w = G z
    acc[0] = acc[1] = T(0);
    for (int k = ty; k < k_end; k += KS) {
      const size_t o = (size_t)k * n + j;
      const T a11r = a11r_g[o], a11i = a11i_g[o], invdet = invdet_g[o];
      const T* ph = phases + 8 * k;
      const C4<T> bk = load(bv, k);
      const C4<T> dx = d_apply(load(xv, k), a11r, a11i, tm1);
      const C4<T> in = psi_outer(ph, ru, rp);
      const C4<T> res{bk.ur - (dx.ur + in.ur), bk.ui - (dx.ui + in.ui),
                      bk.pr - (dx.pr + in.pr), bk.pi - (dx.pi + in.pi)};
      extract_add(acc, d_inv(res, a11r, a11i, tm1, invdet), ph);
    }
    column_sum2(acc, part, tot);
    wu = g00 * acc[0] + g01 * acc[1];
    wp = g10 * acc[0] + g11 * acc[1];

    // Pass 4: x += D^-1 (b - A_hat x) - D^-1 (psi w); accumulate Phi* x
    // when another refine step follows.
    const bool more = s + 1 < refine;
    acc[0] = acc[1] = T(0);
    for (int k = ty; k < k_end; k += KS) {
      const size_t o = (size_t)k * n + j;
      const T a11r = a11r_g[o], a11i = a11i_g[o], invdet = invdet_g[o];
      const T* ph = phases + 8 * k;
      const C4<T> bk = load(bv, k);
      const C4<T> xk = load(xv, k);
      const C4<T> dx = d_apply(xk, a11r, a11i, tm1);
      const C4<T> in = psi_outer(ph, ru, rp);
      const C4<T> res{bk.ur - (dx.ur + in.ur), bk.ui - (dx.ui + in.ui),
                      bk.pr - (dx.pr + in.pr), bk.pi - (dx.pi + in.pi)};
      const C4<T> y = d_inv(res, a11r, a11i, tm1, invdet);
      const C4<T> d = d_inv(psi_outer(ph, wu, wp), a11r, a11i, tm1, invdet);
      const C4<T> xn{xk.ur + (y.ur - d.ur), xk.ui + (y.ui - d.ui),
                     xk.pr + (y.pr - d.pr), xk.pi + (y.pi - d.pi)};
      store(k, xn);
      if (more) extract_add(acc, xn, ph);
    }
  }
}

template <typename T>
int launch(const T* b, T* x, const T* a11r, const T* a11i, const T* invdet, const T* colc,
           const T* phases, int K, int n, int refine, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TJ, KS);
  const dim3 grid((n + TJ - 1) / TJ);
  heat_fused_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      b, x, a11r, a11i, invdet, colc, phases, K, n, refine);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the state b
// and the output x are view_as_real of contiguous (2, K, n) complex tensors,
// a11r / a11i / invdet are (K, n), colc is (6, n) [m1, tm1, G00, G01, G10,
// G11], phases is (K, 8) [phi_uN, phi_p1, psi_u1, psi_pN as re/im]. Returns
// the cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" {

int heat_woodbury_fused_f32(const float* b, float* x, const float* a11r, const float* a11i,
                            const float* invdet, const float* colc, const float* phases, int K,
                            int n, int refine, int device, void* stream) {
  return launch<float>(b, x, a11r, a11i, invdet, colc, phases, K, n, refine, device, stream);
}

int heat_woodbury_fused_f64(const double* b, double* x, const double* a11r, const double* a11i,
                            const double* invdet, const double* colc, const double* phases, int K,
                            int n, int refine, int device, void* stream) {
  return launch<double>(b, x, a11r, a11i, invdet, colc, phases, K, n, refine, device, stream);
}

const char* heat_woodbury_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
