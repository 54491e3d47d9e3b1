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
// (cuda_heat.py: fused_heat_reference); only the order of the sums over K
// differs. Every reduction is formed from the working-dtype intermediates
// (no closed form), so the defect correction sees the real rounding.
//
// Bound: bytes. Per (k, j) element the function reads b (4 reals) and three
// constants and writes x (4 reals), and does ~172 flops (refine = 1): at
// K = 513, n = 2047, float32 that is 46.2 MB against 0.18 GFLOP, two orders
// of magnitude under the ridge of the card.
//
// Two kernels; cuda_heat.py:heat_schedule picks one from the shape when the
// constants are packed.
//
// heat_slab_kernel (the rule). The schedule of the wave family's slab kernel
// (woodbury.cu) at rank 2. A block owns C adjacent columns and all K bins of
// each; shared memory holds, per bin and column, b and x (two complex arrays
// each) and a11r, a11i, invdet: 11 reals, 44 B in float32. The passes of the
// chain (z -> w, the extraction (uN, p1) -> ru, rp, z -> w) run from shared
// memory, carrying only per-column scalars between them; each pass
// overwrites x in the slab. One store sweep, column index fastest, writes x
// to device memory. So b and the constants are read from device memory once
// and x written once, for any refine.
//   The load sweep differs from the wave kernel's in the constants. They come
// packed in the slab's own image (cuda_heat.py:_slab_image): one contiguous,
// 16-byte-aligned chunk per block, [a11r, a11i pairs][invdet] at the slab's
// column stride, dead columns and padding bins zero. One thread brings the
// whole chunk in with a single cp.async.bulk (the TMA's bulk copy,
// completion on an mbarrier), where the wave kernel issues three 4- or
// 8-byte cp.async per bin and column from the (K, n) planes. The phase
// table, the same for every block, comes the same way from a copy padded
// to the slab's [bin][8 phases + 16 bytes] rows, read 16 bytes at a time (8
// lanes reading pieces of 8 rows hit distinct banks). b keeps the (2, K, n)
// layout of the packed FFT; its rows are only 8-byte aligned at odd n, so
// it goes in 8-byte (float2) or 16-byte (double2) cp.async copies, column
// index fastest. Its short row pieces are what the sweep waits for: the bulk
// copies move the contiguous image and table several times as fast per byte
// (PERF.md, the heat slab profile with and without b). The per-column
// scalars (m1, tm1, G) are loaded before the copies are issued, so that
// their latency hides behind them.
//   Each column gets L K-lanes (bins k = lane, lane + L, ...). With L <= 32
// they lie in one warp and the sums over K are xor-shuffle butterflies with
// no block barrier; with L = 64, 128 (C = 2, 1) the warps of a column then
// meet once in shared memory. The butterfly gives every lane the same sum
// bitwise, so all lanes of a column agree on z, w and r. A block has 128
// threads for C <= 4 and 256 above. C is the largest power of two <= 32
// whose slab fits the 232,448 B a block may use: 1D float32 C = 8 (L = 32),
// float64 C = 4, 2D lumped (K = 33) C = 32 (L = 8). The column stride is
// K padded as in the wave kernel, so that the columns one warp touches fall
// in distinct banks. Blocks above 48 KB opt in with cudaFuncSetAttribute,
// whose error is returned like the launch's.
//   Built with -DHEAT_WOODBURY_PROFILE, the kernel records clock64 at its
// phase boundaries for the first 8192 blocks; adding -DHEAT_WOODBURY_SKIP_B
// leaves b out of the load sweep, to time the sweep without it (x is then
// wrong: a measurement build only). Built with
// -DHEAT_WOODBURY_PLANES, it loads the constants the wave kernel's way
// instead, three short cp.async per bin and column from the (K, n) planes:
// chip_smoke.py times that build beside this one.
//
// heat_streaming_kernel (long K). Where even C = 1 does not fit a block
// (K > 2525 in float32, K > 1382 in float64), this kernel, the first port of
// B2, runs. It streams over K in 2 + 2 * refine passes, re-reading b and the
// constants in each and keeping x in the output buffer between passes. A
// block owns TJ = 16 adjacent columns (threadIdx.x, coalesced along the
// row-major (K, n) arrays) and splits K across KS = 32 lanes (threadIdx.y);
// the 2 partial sums of each reduction meet in shared memory. It stays
// unchanged for those shapes and as the yardstick the slab kernel is timed
// against. A refused or failed launch of either kernel is returned as an
// error.
//
// Layout. The complex state is torch.view_as_real of a contiguous (2, K, n)
// complex tensor: [u|p][k][j][re|im], read and written as float2 / double2.
//
// Batch. A (B, 2, K, n) state is B independent solves (lanes) sharing the
// constants, in one launch: the lanes ride the grid's y axis (blockIdx.y,
// so B <= 65535), and a block offsets b and x by its lane's 2 K n complex
// elements and does nothing else differently. The slab kernel's constant
// image is indexed by column block (blockIdx.x) alone, so every lane of a
// column block bulk-copies the same chunk. Schedule, shared memory and
// arithmetic are those of the single solve, so lane i of a batched launch
// is bitwise what a launch on lane i alone gives.

#include <cuda_runtime.h>

#ifdef HEAT_WOODBURY_PROFILE
__device__ long long heat_woodbury_profile[8192][8];
#define PROFILE_MARK(i)                                                              \
  do {                                                                               \
    if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < 8192) heat_woodbury_profile[blockIdx.x][i] = clock64(); \
  } while (0)
#else
#define PROFILE_MARK(i) \
  do {                  \
  } while (0)
#endif

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
heat_streaming_kernel(const T* __restrict__ b, T* __restrict__ x,
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
  const size_t lane_off = (size_t)blockIdx.y * 2 * plane;  // this block's lane of the batch
  const V* bv = reinterpret_cast<const V*>(b) + lane_off;
  V* xv = reinterpret_cast<V*>(x) + lane_off;

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

// ---------------------------------------------------------------------------
// Slab schedule.

// Async copy of BYTES (4, 8 or 16) from device to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block's mbarrier: phase 0 completes when all `count` threads have
// arrived and every byte they announced has landed.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Announce `bytes` on the barrier and copy them from device memory to
// shared memory with one bulk copy (both addresses 16-byte aligned, bytes a
// multiple of 16) that completes them on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, unsigned bar) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait until phase 0 of the barrier has completed.
__device__ __forceinline__ void mbar_wait0(unsigned bar) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar)
      : "memory");
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ void unpack(float* p, const float4& v) {
  p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
}
__device__ __forceinline__ void unpack(double* p, const double2& v) { p[0] = v.x; p[1] = v.y; }

// Row pitch of the staged phase table, in reals: the 8 phases of a bin and
// 16 bytes of padding (48 B rows in float32), so that the 8 lanes reading
// 16-byte pieces of 8 rows at once hit distinct banks.
template <typename T>
__host__ __device__ constexpr int phase_pitch() { return 8 + 16 / (int)sizeof(T); }

// Phases LO..HI-1 of bin k from the staged table, 16 bytes at a time.
template <int LO, int HI, typename T>
__device__ __forceinline__ void load_phases(T ph[8], const T* sph, int k) {
  using Q = typename Vec16<T>::type;
  constexpr int E = 16 / sizeof(T);  // reals per piece
  const Q* row = reinterpret_cast<const Q*>(sph + k * phase_pitch<T>());
#pragma unroll
  for (int q = LO / E; q < HI / E; ++q) unpack(ph + q * E, row[q]);
}

// Sum the 2 per-lane partials of each column over its L lanes; every lane of
// the column gets the same totals back in acc. The butterfly adds each pair
// in both orders, which IEEE addition makes bitwise equal. With L > 32 the
// column's warps then meet in `red` (two alternating buffers, so one barrier
// per reduction suffices).
template <typename T, int L>
__device__ __forceinline__ void lane_sum2(T acc[2], T* red, int cols, int& parity) {
  constexpr int W = L < 32 ? L : 32;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
    acc[1] += __shfl_xor_sync(0xffffffffu, acc[1], o);
  }
  if constexpr (L > 32) {
    constexpr int NW = L / 32;  // warps per column
    const int c = threadIdx.x / L, wi = (threadIdx.x % L) >> 5;
    T* part = red + (size_t)(parity * cols + c) * NW * 2;
    if ((threadIdx.x & 31) == 0) {
      part[wi * 2] = acc[0];
      part[wi * 2 + 1] = acc[1];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      T s = part[q];
#pragma unroll
      for (int v = 1; v < NW; ++v) s += part[v * 2 + q];
      acc[q] = s;
    }
    parity ^= 1;
  }
}

// Reals of one block's constant image: the a11 pairs and invdet of its
// `slab` = cols * ks bins, padded to a whole number of 16-byte pieces.
template <typename T>
__host__ __device__ int image_reals(int slab) {
  constexpr int E = 16 / (int)sizeof(T);
  return (3 * slab + E - 1) / E * E;
}

// Shared memory of a slab block: 16 bytes for the mbarrier, the phase table
// (phase_pitch reals per bin), the constant image (cuda_heat.py:_slab_image),
// b and x of its `cols` columns at column stride ks (two complex arrays
// each), and two buffers of cross-warp partials when L > 32.
template <typename T>
size_t slab_bytes(int K, int cols, int lanes, int ks) {
  const int slab = cols * ks;
  size_t bytes = 16 + ((size_t)phase_pitch<T>() * K + image_reals<T>(slab) + (size_t)8 * slab) * sizeof(T);
  if (lanes > 32) bytes += (size_t)2 * cols * (lanes / 32) * 2 * sizeof(T);
  return bytes;
}

// One block: cols = blockDim.x / L columns, all K bins. Slab arrays are
// [column][bin] at stride ks; the phases [bin][phase_pitch], bulk-copied
// from `table`. `image` holds one chunk of image_reals(cols * ks) reals per
// block; the (K, n) planes a11r, a11i, invdet are read only by the
// -DHEAT_WOODBURY_PLANES build.
template <typename T, int L>
__global__ void __launch_bounds__(256)
heat_slab_kernel(const T* __restrict__ b, T* __restrict__ x,
                 const T* __restrict__ a11r_g, const T* __restrict__ a11i_g,
                 const T* __restrict__ invdet_g, const T* __restrict__ colc,
                 const T* __restrict__ table, const T* __restrict__ image,
                 int K, int n, int refine, int ks) {
  using V = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char slab[];
  constexpr int PH = phase_pitch<T>();
  const int cols = blockDim.x / L;
  const int S = cols * ks;
  const int chunk = image_reals<T>(S);
  T* const sph = reinterpret_cast<T*>(slab + 16);
  V* const sa11 = reinterpret_cast<V*>(sph + PH * K);  // (a11r, a11i)
  T* const sinvdet = reinterpret_cast<T*>(sa11 + S);
  V* const bu = reinterpret_cast<V*>(reinterpret_cast<T*>(sa11) + chunk);
  V* const bp = bu + S;
  V* const xu = bp + S;
  V* const xp = xu + S;
  T* const red = reinterpret_cast<T*>(xp + S);

  PROFILE_MARK(0);
  const int j0 = blockIdx.x * cols;
  const int cshift = __ffs(cols) - 1;
  const size_t plane = (size_t)K * n;  // complex elements of the u (or p) plane
  const size_t lane_off = (size_t)blockIdx.y * 2 * plane;  // this block's lane of the batch
  const V* bv = reinterpret_cast<const V*>(b) + lane_off;
  V* xv = reinterpret_cast<V*>(x) + lane_off;

  // The column's scalars, loaded first so that they arrive during the copies.
  const int c = threadIdx.x / L, lane = threadIdx.x % L;
  const int j = j0 + c;
  // Dead columns (j >= n) run no bins but join every reduction.
  const int k_end = j < n ? K : 0;
  const int base = c * ks;
  T m1 = T(0), tm1 = T(0), g00 = T(0), g01 = T(0), g10 = T(0), g11 = T(0);
  if (j < n) {
    m1 = colc[j];
    tm1 = colc[n + j];
    g00 = colc[2 * n + j];
    g01 = colc[3 * n + j];
    g10 = colc[4 * n + j];
    g11 = colc[5 * n + j];
  }

  // Load sweep: one thread bulk-copies the phase table and the block's
  // constant image; all threads copy b of the block's columns, column index
  // fastest, with cp.async; every copy is in flight before the waits.
  const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(slab));
  if (threadIdx.x == 0) mbar_init(bar, blockDim.x);
  __syncthreads();
  if (threadIdx.x == 0) {
    bulk_load(sph, table, (unsigned)(PH * K * sizeof(T)), bar);
#ifndef HEAT_WOODBURY_PLANES
    bulk_load(sa11, image + (size_t)blockIdx.x * chunk, (unsigned)(chunk * sizeof(T)), bar);
#endif
  }
  for (int i = threadIdx.x; i < K * cols; i += blockDim.x) {
    const int k = i >> cshift, cc = i & (cols - 1);
    if (j0 + cc < n) {
      const size_t o = (size_t)k * n + j0 + cc;
      const int s = cc * ks + k;
#if !(defined(HEAT_WOODBURY_PROFILE) && defined(HEAT_WOODBURY_SKIP_B))
      cp_async<sizeof(V)>(bu + s, bv + o);
      cp_async<sizeof(V)>(bp + s, bv + plane + o);
#endif
#ifdef HEAT_WOODBURY_PLANES
      cp_async<sizeof(T)>(&sa11[s].x, a11r_g + o);
      cp_async<sizeof(T)>(&sa11[s].y, a11i_g + o);
      cp_async<sizeof(T)>(sinvdet + s, invdet_g + o);
#endif
    }
  }
  mbar_arrive(bar);
  PROFILE_MARK(1);
  cp_async_wait_all();
  mbar_wait0(bar);
  __syncthreads();
  PROFILE_MARK(2);

  auto load = [&](const V* u, const V* p, int s) {
    const V a = u[s], q = p[s];
    return C4<T>{a.x, a.y, q.x, q.y};
  };
  auto store = [&](int s, const C4<T>& v) {
    V a, q;
    a.x = v.ur; a.y = v.ui; q.x = v.pr; q.y = v.pi;
    xu[s] = a;
    xp[s] = q;
  };

  int parity = 0;
  T acc[2], wu, wp, ru, rp, ph[8];

  // Pass 1: z = Phi* D^-1 b ; w = G z
  acc[0] = acc[1] = T(0);
#pragma unroll 2
  for (int k = lane; k < k_end; k += L) {
    const int s = base + k;
    load_phases<0, 4>(ph, sph, k);
    const V a = sa11[s];
    const C4<T> y = d_inv(load(bu, bp, s), a.x, a.y, tm1, sinvdet[s]);
    extract_add(acc, y, ph);
  }
  lane_sum2<T, L>(acc, red, cols, parity);
  wu = g00 * acc[0] + g01 * acc[1];
  wp = g10 * acc[0] + g11 * acc[1];
  PROFILE_MARK(3);

  // Pass 2: x = D^-1 b - D^-1 (psi w) into the slab; accumulate Phi* x for A_hat.
  acc[0] = acc[1] = T(0);
#pragma unroll 2
  for (int k = lane; k < k_end; k += L) {
    const int s = base + k;
    const V a = sa11[s];
    const T a11r = a.x, a11i = a.y, invdet = sinvdet[s];
    load_phases<4, 8>(ph, sph, k);
    if (refine > 0) load_phases<0, 4>(ph, sph, k);
    const C4<T> y = d_inv(load(bu, bp, s), a11r, a11i, tm1, invdet);
    const C4<T> d = d_inv(psi_outer(ph, wu, wp), a11r, a11i, tm1, invdet);
    const C4<T> xk{y.ur - d.ur, y.ui - d.ui, y.pr - d.pr, y.pi - d.pi};
    store(s, xk);
    if (refine > 0) extract_add(acc, xk, ph);
  }

  for (int st = 0; st < refine; ++st) {
    // The rank-2 rows of A_hat from the extracted slices (uN, p1).
    lane_sum2<T, L>(acc, red, cols, parity);
    PROFILE_MARK(4);
    ru = m1 * acc[0];
    rp = m1 * acc[1];

    // Pass 3: z = Phi* D^-1 (b - A_hat x) ; w = G z
    acc[0] = acc[1] = T(0);
#pragma unroll 2
    for (int k = lane; k < k_end; k += L) {
      const int s = base + k;
      const V a = sa11[s];
      const T a11r = a.x, a11i = a.y, invdet = sinvdet[s];
      load_phases<0, 8>(ph, sph, k);
      const C4<T> bk = load(bu, bp, s);
      const C4<T> dx = d_apply(load(xu, xp, s), a11r, a11i, tm1);
      const C4<T> in = psi_outer(ph, ru, rp);
      const C4<T> res{bk.ur - (dx.ur + in.ur), bk.ui - (dx.ui + in.ui),
                      bk.pr - (dx.pr + in.pr), bk.pi - (dx.pi + in.pi)};
      extract_add(acc, d_inv(res, a11r, a11i, tm1, invdet), ph);
    }
    lane_sum2<T, L>(acc, red, cols, parity);
    wu = g00 * acc[0] + g01 * acc[1];
    wp = g10 * acc[0] + g11 * acc[1];
    PROFILE_MARK(5);

    // Pass 4: x += D^-1 (b - A_hat x) - D^-1 (psi w) in the slab; accumulate
    // Phi* x when another refine step follows.
    const bool more = st + 1 < refine;
    acc[0] = acc[1] = T(0);
#pragma unroll 2
    for (int k = lane; k < k_end; k += L) {
      const int s = base + k;
      const V a = sa11[s];
      const T a11r = a.x, a11i = a.y, invdet = sinvdet[s];
      load_phases<4, 8>(ph, sph, k);
      if (more) load_phases<0, 4>(ph, sph, k);
      const C4<T> bk = load(bu, bp, s);
      const C4<T> xk = load(xu, xp, s);
      const C4<T> dx = d_apply(xk, a11r, a11i, tm1);
      const C4<T> in = psi_outer(ph, ru, rp);
      const C4<T> res{bk.ur - (dx.ur + in.ur), bk.ui - (dx.ui + in.ui),
                      bk.pr - (dx.pr + in.pr), bk.pi - (dx.pi + in.pi)};
      const C4<T> y = d_inv(res, a11r, a11i, tm1, invdet);
      const C4<T> d = d_inv(psi_outer(ph, wu, wp), a11r, a11i, tm1, invdet);
      const C4<T> xn{xk.ur + (y.ur - d.ur), xk.ui + (y.ui - d.ui),
                     xk.pr + (y.pr - d.pr), xk.pi + (y.pi - d.pi)};
      store(s, xn);
      if (more) extract_add(acc, xn, ph);
    }
  }

  // Store sweep: x to device memory once, column index fastest.
  __syncthreads();
  PROFILE_MARK(6);
  for (int i = threadIdx.x; i < K * cols; i += blockDim.x) {
    const int k = i >> cshift, cc = i & (cols - 1);
    if (j0 + cc < n) {
      const size_t o = (size_t)k * n + j0 + cc;
      const int s = cc * ks + k;
      xv[o] = xu[s];
      xv[plane + o] = xp[s];
    }
  }
  PROFILE_MARK(7);
}

// ---------------------------------------------------------------------------
// Launchers.

// A batch the grid's y axis can hold.
inline bool batch_ok(int batch) { return batch >= 1 && batch <= 65535; }

template <typename T>
int launch_streaming(const T* b, T* x, const T* a11r, const T* a11i, const T* invdet,
                     const T* colc, const T* phases, int K, int n, int batch, int refine,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!batch_ok(batch)) return (int)cudaErrorInvalidValue;
  const dim3 block(TJ, KS);
  const dim3 grid((n + TJ - 1) / TJ, batch);
  heat_streaming_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      b, x, a11r, a11i, invdet, colc, phases, K, n, refine);
  return (int)cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_slab_lanes(const T* b, T* x, const T* a11r, const T* a11i, const T* invdet,
                              const T* colc, const T* table, const T* image, int K, int n,
                              int batch, int refine, int cols, int ks, int smem,
                              cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        heat_slab_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch's check would report it again
      return err;
    }
  }
  heat_slab_kernel<T, L><<<dim3((n + cols - 1) / cols, batch), cols * L, smem, stream>>>(
      b, x, a11r, a11i, invdet, colc, table, image, K, n, refine, ks);
  return cudaGetLastError();
}

template <typename T>
int launch_slab(const T* b, T* x, const T* a11r, const T* a11i, const T* invdet, const T* colc,
                const T* table, const T* image, int K, int n, int batch, int refine, int cols,
                int lanes, int ks, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool pow2 = cols >= 1 && cols <= 32 && (cols & (cols - 1)) == 0;
  const int threads = cols * lanes;
  if (!batch_ok(batch) || !pow2 || threads % 32 != 0 || threads > 256 || ks < K || smem < 0 ||
      (size_t)smem < slab_bytes<T>(K, cols, lanes, ks))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 8:
      err = launch_slab_lanes<T, 8>(b, x, a11r, a11i, invdet, colc, table, image, K, n, batch, refine, cols, ks, smem, s);
      break;
    case 16:
      err = launch_slab_lanes<T, 16>(b, x, a11r, a11i, invdet, colc, table, image, K, n, batch, refine, cols, ks, smem, s);
      break;
    case 32:
      err = launch_slab_lanes<T, 32>(b, x, a11r, a11i, invdet, colc, table, image, K, n, batch, refine, cols, ks, smem, s);
      break;
    case 64:
      err = launch_slab_lanes<T, 64>(b, x, a11r, a11i, invdet, colc, table, image, K, n, batch, refine, cols, ks, smem, s);
      break;
    case 128:
      err = launch_slab_lanes<T, 128>(b, x, a11r, a11i, invdet, colc, table, image, K, n, batch, refine, cols, ks, smem, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; the state b
// and the output x are view_as_real of contiguous (batch, 2, K, n) complex
// tensors (1 <= batch <= 65535; the constants are shared by the lanes),
// a11r / a11i / invdet are (K, n), colc is (6, n) [m1, tm1, G00, G01, G10,
// G11], phases is (K, 8) [phi_uN, phi_p1, psi_u1, psi_pN as re/im]. The slab
// launchers take in its place the same table padded to phase_pitch reals
// per bin, then the constant image (ceil(n / cols) chunks of
// image_reals(cols * ks) reals), both 16-byte aligned, and the schedule:
// `cols` columns per block (a power of two <= 32), `lanes` K-lanes per
// column (cols * lanes threads, a multiple of 32 and at most 256), slab
// column stride `ks` >= K and `smem_bytes` of dynamic shared memory (at
// least what the slab needs). Returns the cudaError_t of the launch (0 on
// success; a schedule the launcher or the card refuses is an error too);
// the launch is asynchronous on `stream`.
extern "C" {

int heat_streaming_f32(const float* b, float* x, const float* a11r, const float* a11i,
                       const float* invdet, const float* colc, const float* phases, int K, int n,
                       int batch, int refine, int device, void* stream) {
  return launch_streaming<float>(b, x, a11r, a11i, invdet, colc, phases, K, n, batch, refine,
                                 device, stream);
}

int heat_streaming_f64(const double* b, double* x, const double* a11r, const double* a11i,
                       const double* invdet, const double* colc, const double* phases, int K,
                       int n, int batch, int refine, int device, void* stream) {
  return launch_streaming<double>(b, x, a11r, a11i, invdet, colc, phases, K, n, batch, refine,
                                  device, stream);
}

int heat_slab_f32(const float* b, float* x, const float* a11r, const float* a11i,
                  const float* invdet, const float* colc, const float* table, const float* image,
                  int K, int n, int batch, int refine, int cols, int lanes, int ks, int smem_bytes,
                  int device, void* stream) {
  return launch_slab<float>(b, x, a11r, a11i, invdet, colc, table, image, K, n, batch, refine,
                            cols, lanes, ks, smem_bytes, device, stream);
}

int heat_slab_f64(const double* b, double* x, const double* a11r, const double* a11i,
                  const double* invdet, const double* colc, const double* table,
                  const double* image, int K, int n, int batch, int refine, int cols, int lanes,
                  int ks, int smem_bytes, int device, void* stream) {
  return launch_slab<double>(b, x, a11r, a11i, invdet, colc, table, image, K, n, batch, refine,
                             cols, lanes, ks, smem_bytes, device, stream);
}

const char* heat_woodbury_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

#ifdef HEAT_WOODBURY_PROFILE
// Copy the profile build's (8192, 8) clock64 marks to host memory.
int heat_woodbury_profile_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, heat_woodbury_profile, sizeof(heat_woodbury_profile));
}
#endif

}  // extern "C"
