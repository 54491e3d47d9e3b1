// Fused half-spectrum Woodbury direct solve for the wave family, for Hopper.
//
// Replaces the Pallas TPU kernel optimal_control_paradiag_tpu/paradiag/
// pallas_woodbury.py:_make_kernel (launched by build_pallas_woodbury_solver).
// It computes the same function: for every wavenumber column j, over all
// K = N_t/2 + 1 half-spectrum bins k,
//
//   x = W(b),  then `refine` times  x += W(b - A_hat x),
//   W(r) = D^-1 r - D^-1 Psi (G_j Phi* D^-1 r),
//
// with D the per-(k, j) 2x2 circulant block (a11, conj(a11), tm, 1/det),
// Phi* the 4 pairing-weighted phase-sum extractions (u slices N-1, N-2; p
// slices 0, 1), G_j the real 4x4 capacity matrix of column j, Psi the 4
// rank-1 injections, and A_hat = D plus the rank-4 boundary rows built from
// m1, kap1, tm1, mk1. Complex arithmetic is split real, in the order of the
// Pallas kernel body and of its PyTorch twin (cuda_woodbury.py:
// fused_woodbury_reference).
//
// Bound: bytes. Per (k, j) element the function reads b (4 reals) and three
// constants and writes x (4 reals), and does ~220 flops (refine = 1): at
// K = 513, n = 2047, float32 that is 46.2 MB against 0.23 GFLOP, two orders
// of magnitude under the ridge of the card.
//
// Schedule. The Pallas kernel holds a whole (K, 128) column slab of 11 arrays
// in VMEM (2.9 MB at K = 513); a Hopper SM has 228 KB of shared memory. Each
// column's work is a chain of reductions over K, each feeding a handful of
// per-column scalars into the next: z = Phi* D^-1 b (4 values), then the
// extraction of x inside A_hat (4), then z of D^-1 (b - A_hat x) (4). So the
// kernel streams over K in 2 + 2 * refine passes and carries only those
// scalars between passes; x lives in the output buffer between passes (16.8 MB
// at the headline shape, L2-resident on the card). Every reduction is formed
// from the working-dtype intermediates, as in the twin, so the defect
// correction sees the real rounding.
//
// Layout. A block owns TJ = 16 adjacent columns (threadIdx.x, coalesced along
// the row-major (K, n) arrays) and splits K across KS = 32 lanes
// (threadIdx.y, bins k = ty, ty + KS, ...); the 4 partial sums of each
// reduction meet in shared memory. At n = 2047 that is 128 blocks of 512
// threads. The complex state is torch.view_as_real of a contiguous (2, K, n)
// complex tensor: [u|p][k][j][re|im], read and written as float2 / double2.

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

// psi (x) w at bin k: rank-1 injections into u rows 0, 1 and p rows N-1, N-2.
template <typename T>
__device__ __forceinline__ C4<T> psi_outer(const T* ph, const T w[4]) {
  C4<T> c;
  c.ur = ph[8] * w[0] + ph[10] * w[1];
  c.ui = ph[9] * w[0] + ph[11] * w[1];
  c.pr = ph[12] * w[2] + ph[14] * w[3];
  c.pi = ph[13] * w[2] + ph[15] * w[3];
  return c;
}

// Real part of the pairing-weighted phase sums, bin k's term.
template <typename T>
__device__ __forceinline__ void extract_add(T acc[4], const C4<T>& y, const T* ph) {
  acc[0] += ph[0] * y.ur - ph[1] * y.ui;
  acc[1] += ph[2] * y.ur - ph[3] * y.ui;
  acc[2] += ph[4] * y.pr - ph[5] * y.pi;
  acc[3] += ph[6] * y.pr - ph[7] * y.pi;
}

// Sum the 4 per-lane partials of each column over the KS lanes of the block;
// every thread of the column gets the totals back in acc.
template <typename T>
__device__ __forceinline__ void column_sum4(T acc[4], T (&part)[4][KS][TJ], T (&tot)[4][TJ]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int c = 0; c < 4; ++c) part[c][ty][tx] = acc[c];
  __syncthreads();
  if (ty < 4) {
    T s = T(0);
    for (int i = 0; i < KS; ++i) s += part[ty][i][tx];
    tot[ty][tx] = s;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = tot[c][tx];
}

// w = G_j z
template <typename T>
__device__ __forceinline__ void capacity_mix(T w[4], const T z[4], const T* __restrict__ gc, int j, int n) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    w[a] = gc[(4 * a + 0) * n + j] * z[0] + gc[(4 * a + 1) * n + j] * z[1] +
           gc[(4 * a + 2) * n + j] * z[2] + gc[(4 * a + 3) * n + j] * z[3];
  }
}

template <typename T>
__global__ void __launch_bounds__(TJ * KS)
woodbury_fused_kernel(const T* __restrict__ b, T* __restrict__ x,
                      const T* __restrict__ a11r_g, const T* __restrict__ a11i_g,
                      const T* __restrict__ invdet_g, const T* __restrict__ colc,
                      const T* __restrict__ gc, const T* __restrict__ phases,
                      int K, int n, int refine) {
  using V = typename Vec2<T>::type;
  __shared__ T part[4][KS][TJ];
  __shared__ T tot[4][TJ];

  const int ty = threadIdx.y;
  const int j = blockIdx.x * TJ + threadIdx.x;
  // Dead columns (j >= n) run no bins but join every block reduction.
  const int k_end = j < n ? K : 0;
  const size_t plane = (size_t)K * n;  // complex elements of the u (or p) plane
  const V* bv = reinterpret_cast<const V*>(b);
  V* xv = reinterpret_cast<V*>(x);

  T m1 = T(0), kap1 = T(0), tm1 = T(0), mk1 = T(0);
  if (j < n) {
    m1 = colc[j];
    kap1 = colc[n + j];
    tm1 = colc[2 * n + j];
    mk1 = colc[3 * n + j];
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

  T acc[4], w[4] = {T(0), T(0), T(0), T(0)}, r[4];

  // Pass 1: z = Phi* D^-1 b ; w = G z
  acc[0] = acc[1] = acc[2] = acc[3] = T(0);
  for (int k = ty; k < k_end; k += KS) {
    const size_t o = (size_t)k * n + j;
    const C4<T> y = d_inv(load(bv, k), a11r_g[o], a11i_g[o], tm1, invdet_g[o]);
    extract_add(acc, y, phases + 16 * k);
  }
  column_sum4(acc, part, tot);
  if (j < n) capacity_mix(w, acc, gc, j, n);

  // Pass 2: x = D^-1 b - D^-1 (psi w); accumulate Phi* x for A_hat.
  acc[0] = acc[1] = acc[2] = acc[3] = T(0);
  for (int k = ty; k < k_end; k += KS) {
    const size_t o = (size_t)k * n + j;
    const T a11r = a11r_g[o], a11i = a11i_g[o], invdet = invdet_g[o];
    const T* ph = phases + 16 * k;
    const C4<T> y = d_inv(load(bv, k), a11r, a11i, tm1, invdet);
    const C4<T> d = d_inv(psi_outer(ph, w), a11r, a11i, tm1, invdet);
    const C4<T> xk{y.ur - d.ur, y.ui - d.ui, y.pr - d.pr, y.pi - d.pi};
    store(k, xk);
    if (refine > 0) extract_add(acc, xk, ph);
  }

  for (int s = 0; s < refine; ++s) {
    // Boundary rows of A_hat from the extracted slices (uN1, uN2, p0, p1).
    column_sum4(acc, part, tot);
    r[0] = m1 * (T(2) * acc[0] - acc[1]) - kap1 * acc[1] + T(0.5) * tm1 * acc[2];
    r[1] = -mk1 * acc[0];
    r[2] = m1 * (T(2) * acc[2] - acc[3]) - kap1 * acc[3] - T(0.5) * tm1 * acc[0];
    r[3] = -mk1 * acc[2];

    // Pass 3: z = Phi* D^-1 (b - A_hat x) ; w = G z
    acc[0] = acc[1] = acc[2] = acc[3] = T(0);
    for (int k = ty; k < k_end; k += KS) {
      const size_t o = (size_t)k * n + j;
      const T a11r = a11r_g[o], a11i = a11i_g[o], invdet = invdet_g[o];
      const T* ph = phases + 16 * k;
      const C4<T> bk = load(bv, k);
      const C4<T> dx = d_apply(load(xv, k), a11r, a11i, tm1);
      const C4<T> in = psi_outer(ph, r);
      const C4<T> res{bk.ur - (dx.ur + in.ur), bk.ui - (dx.ui + in.ui),
                      bk.pr - (dx.pr + in.pr), bk.pi - (dx.pi + in.pi)};
      extract_add(acc, d_inv(res, a11r, a11i, tm1, invdet), ph);
    }
    column_sum4(acc, part, tot);
    if (j < n) capacity_mix(w, acc, gc, j, n);

    // Pass 4: x += D^-1 (b - A_hat x) - D^-1 (psi w); accumulate Phi* x
    // when another refine step follows.
    const bool more = s + 1 < refine;
    acc[0] = acc[1] = acc[2] = acc[3] = T(0);
    for (int k = ty; k < k_end; k += KS) {
      const size_t o = (size_t)k * n + j;
      const T a11r = a11r_g[o], a11i = a11i_g[o], invdet = invdet_g[o];
      const T* ph = phases + 16 * k;
      const C4<T> bk = load(bv, k);
      const C4<T> xk = load(xv, k);
      const C4<T> dx = d_apply(xk, a11r, a11i, tm1);
      const C4<T> in = psi_outer(ph, r);
      const C4<T> res{bk.ur - (dx.ur + in.ur), bk.ui - (dx.ui + in.ui),
                      bk.pr - (dx.pr + in.pr), bk.pi - (dx.pi + in.pi)};
      const C4<T> y = d_inv(res, a11r, a11i, tm1, invdet);
      const C4<T> d = d_inv(psi_outer(ph, w), a11r, a11i, tm1, invdet);
      const C4<T> xn{xk.ur + (y.ur - d.ur), xk.ui + (y.ui - d.ui),
                     xk.pr + (y.pr - d.pr), xk.pi + (y.pi - d.pi)};
      store(k, xn);
      if (more) extract_add(acc, xn, ph);
    }
  }
}

template <typename T>
int launch(const T* b, T* x, const T* a11r, const T* a11i, const T* invdet, const T* colc,
           const T* gc, const T* phases, int K, int n, int refine, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(TJ, KS);
  const dim3 grid((n + TJ - 1) / TJ);
  woodbury_fused_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      b, x, a11r, a11i, invdet, colc, gc, phases, K, n, refine);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the state b
// and the output x are view_as_real of contiguous (2, K, n) complex tensors,
// a11r / a11i / invdet are (K, n), colc is (4, n) [m1, kap1, tm1, mk1], gc is
// (16, n) [G row-major], phases is (K, 16). Returns the cudaError_t of the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" {

int woodbury_fused_f32(const float* b, float* x, const float* a11r, const float* a11i,
                       const float* invdet, const float* colc, const float* gc,
                       const float* phases, int K, int n, int refine, int device, void* stream) {
  return launch<float>(b, x, a11r, a11i, invdet, colc, gc, phases, K, n, refine, device, stream);
}

int woodbury_fused_f64(const double* b, double* x, const double* a11r, const double* a11i,
                       const double* invdet, const double* colc, const double* gc,
                       const double* phases, int K, int n, int refine, int device,
                       void* stream) {
  return launch<double>(b, x, a11r, a11i, invdet, colc, gc, phases, K, n, refine, device, stream);
}

const char* woodbury_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
