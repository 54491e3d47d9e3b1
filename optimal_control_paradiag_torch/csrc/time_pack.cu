// The packed complex time FFT's own passes, for Hopper: everything of
// ops/transforms.py:time_rfft_conj_packed and time_irfft_conj_packed
// (time_transform='fft2') but cuFFT itself, in four kernels.
//
// Replaces no Pallas kernel: the JAX package leaves this glue to XLA, which
// fuses it. In the port it was eager PyTorch: torch.complex, the two-for-one
// split and merge (about ten passes each way), the transposing copies torch
// makes around a batched FFT over the time axis, the inverse's
// normalisation pass and the final stack. These kernels do it in one pass
// each side of cuFFT.
//
// What they compute, bit for bit the plain twin (ops/time_pack.py:
// pack_reference, split_reference, merge_reference, unpack_reference). N
// time steps, K = N / 2 + 1 bins, n columns, any number B of leading lanes;
// Z = fft(s0 + i s1) over time.
//
//   pack:   out = s0 + i s1                                  (B, N, n)
//   split:  Zm[k] = conj(Z[(N - k) % N]),
//           R0 = 0.5 (Z + Zm),  R1 = -0.5i (Z - Zm),
//           b_hat = [conj(R0[:K]), conj(R1[:K])] * (1/N)     (B, 2, K, n)
//   merge:  a = conj(xi0), b = conj(xi1),
//           W = (a + i b) N,  W2 = (a - i b) N,
//           out[k] = W[k] (k < K),  out[N - k] = conj(W2[k]) (1 <= k <= N - K)
//                                                           (B, N, n)
//   unpack: w = z * (1/N),  out = [re w, im w]              (B, 2, N, n) real
//
// Each complex operation of the twin is done here as PyTorch's CUDA
// kernels do it, on c10::complex: a + alpha b with alpha = 1 or -1 (add,
// sub), (ac - bd, ad + bc) for a product, with the twin's scalars as the
// complex constants torch makes of them (0.5, -0.5i = (-0, -0.5), 1i, N,
// 1/N rounded to the working type), in the same order. Every real
// operation is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn, and
// the double ones), so nvcc contracts none into an FMA. Each product but
// the scalings by N and 1/N has an exact factor (0, +-1, 0.5), so a
// contracted FMA in PyTorch's own kernels gives the same bits; even the
// signs of zeros (the imaginary parts of the DC and Nyquist bins) agree.
// pack only moves values. unpack's 1/N is the inverse FFT's normalisation
// as torch applies it on the card: after cuFFT's unnormalised transform,
// the complex product by the real scalar 1/N (mul_, MulFunctor).
//
// Layouts. cuFFT's output over the time axis is time-fastest: each (N, n)
// matrix column-major, the matrices one after another (torch's fft over
// dim -2 returns strides (1, N)). What its plan reads depends on the lanes,
// as torch chooses the plan: one (N, n) matrix it reads row-major in place
// (a strided plan); more than one torch first copies to time-fastest.
// pack and merge write the layout of that plan (`time_fastest`), so each
// caller keeps its cuFFT plan and its bits; split and unpack read
// cuFFT's time-fastest output. b_hat, xi and unpack's output are
// row-major.
//
// Bound: bytes. Each kernel reads its input once and writes its output
// once: 2 x 16.8 MB at the wave headline in float32 (N = 1024, n = 2047),
// 10.0 us at 3.35 TB/s.
//
// Design.
// - The transposing kernels (split; pack, merge in the time-fastest
//   layout; unpack) take a 32 x 32 tile of (time or bin) x column (the
//   float32 merge 64 bins x 32 columns, merge_bins) in a block of 32 x 8
//   threads: the threads read the tile along the side
//   that is contiguous in the input, stage it in shared memory (padded
//   against bank conflicts), and write it along the side that is
//   contiguous in the output, so every access of a warp is one contiguous
//   run. split's threads read bin k and its mirror N - k of a column (both
//   runs contiguous) and form both outputs of a bin at once; merge's form
//   bin k and its mirror at once and write both runs.
// - merge in the row-major layout: a thread owns a column and a bin
//   k < K, reads xi0[k] and xi1[k] once and writes out[k] and, where it
//   exists, the mirrored out[N - k]. pack in the row-major layout is
//   elementwise, 16 bytes a thread from each plane where the plane's
//   length and the pointers allow it.
// - Lanes ride the grid's y axis together with the row tiles, in a
//   grid-stride loop, so any B, N and n launch.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int TILE = 32;  // rows and columns of a transposing block's tile
constexpr int ROWS = 8;   // thread rows of a transposing block (32 x 8 threads)
constexpr int BIN_ROWS = 64;  // the float32 merge's bins a tile, a multiple of TILE
constexpr int MERGE_THREADS = 256;
constexpr int PACK_THREADS = 256;
constexpr long long MAX_GRID_Y = 65535;
constexpr long long PACK_MAX_BLOCKS = 132 * 16;  // a grid-stride loop past this

template <typename T>
struct Complex;
template <>
struct Complex<float> {
  using type = float2;
};
template <>
struct Complex<double> {
  using type = double2;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// c10::complex's product: (ac - bd, ad + bc).
template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  return {add_rn(mul_rn(a.x, b.x), -mul_rn(a.y, b.y)), add_rn(mul_rn(a.x, b.y), mul_rn(a.y, b.x))};
}

template <typename C>
__device__ __forceinline__ C cadd(C a, C b) {
  return {add_rn(a.x, b.x), add_rn(a.y, b.y)};
}

template <typename C>
__device__ __forceinline__ C cconj(C a) {
  return {a.x, -a.y};
}

// torch's add and sub, a + alpha * b with alpha = (+-1, 0).
template <typename C, typename T>
__device__ __forceinline__ C add_alpha(C a, C b, T alpha) {
  return cadd(a, cmul(C{alpha, 0}, b));
}

// The bins a merge tile takes: BIN_ROWS in float32, so that the 2D cell's
// K = 33 bins (N = 64) are one tile and not a full one and one of a single
// bin (17 % faster there, 3 % slower at K = 513); TILE in float64, whose
// tiles of more would pass the 48 KB of static shared memory.
template <typename T>
__host__ __device__ constexpr int merge_bins() {
  return sizeof(T) == 4 ? BIN_ROWS : TILE;
}

// b_hat's bin k of both planes from Z[k] = z and Z[(N - k) % N] = w.
template <typename T, typename C = typename Complex<T>::type>
__device__ __forceinline__ void split_bin(C z, C w, T inv_n, C& b0, C& b1) {
  const C zm = cconj(w);
  const C r0 = cmul(add_alpha(z, zm, T(1)), C{T(0.5), 0});
  const C r1 = cmul(add_alpha(z, zm, T(-1)), C{-T(0), T(-0.5)});
  b0 = cmul(cconj(r0), C{inv_n, 0});
  b1 = cmul(cconj(r1), C{inv_n, 0});
}

// The merge's bin k from xi0[k] and xi1[k]: w = W[k] and m = conj(W2[k]),
// the value of bin N - k.
template <typename T, typename C = typename Complex<T>::type>
__device__ __forceinline__ void merge_bin(C x0, C x1, T scale, C& w, C& m) {
  const C a = cconj(x0);
  const C ib = cmul(cconj(x1), C{T(0), T(1)});
  w = cmul(add_alpha(a, ib, T(1)), C{scale, 0});
  m = cconj(cmul(add_alpha(a, ib, T(-1)), C{scale, 0}));
}

template <typename T, typename C = typename Complex<T>::type>
__global__ void __launch_bounds__(TILE * ROWS)
    time_pack_split_kernel(const C* __restrict__ Z, C* __restrict__ out, int B, int N, int n, T inv_n) {
  __shared__ C tile[2][TILE][TILE + 1];  // [plane][column][bin], padded against bank conflicts
  const int K = N / 2 + 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * TILE;
  const long long ktiles = (K + TILE - 1) / TILE;
  for (long long t = blockIdx.y; t < (long long)B * ktiles; t += gridDim.y) {
    const long long b = t / ktiles;
    const int k0 = (int)(t - b * ktiles) * TILE;
    const C* zb = Z + b * N * n;
    for (int r = ty; r < TILE; r += ROWS) {  // thread x: bin, r: column
      const int k = k0 + tx, j = j0 + r;
      if (k < K && j < n) {
        const C* col = zb + (long long)j * N;
        split_bin<T>(col[k], col[k == 0 ? 0 : N - k], inv_n, tile[0][r][tx], tile[1][r][tx]);
      }
    }
    __syncthreads();
    const int j = j0 + tx;
    for (int r = ty; r < TILE; r += ROWS) {  // thread x: column, r: bin
      const int k = k0 + r;
      if (k < K && j < n) {
        out[((2 * b) * K + k) * n + j] = tile[0][tx][r];
        out[((2 * b + 1) * K + k) * n + j] = tile[1][tx][r];
      }
    }
    __syncthreads();
  }
}

template <typename T, typename C = typename Complex<T>::type>
__global__ void __launch_bounds__(MERGE_THREADS)
    time_pack_merge_rows_kernel(const C* __restrict__ xi, C* __restrict__ out, int B, int N, int n) {
  const int K = N / 2 + 1;
  const int j = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (j >= n) return;
  for (long long row = blockIdx.y; row < (long long)B * K; row += gridDim.y) {
    const long long b = row / K;
    const int k = (int)(row - b * K);
    C w, m;
    merge_bin<T>(xi[((2 * b) * K + k) * n + j], xi[((2 * b + 1) * K + k) * n + j], (T)N, w, m);
    out[(b * N + k) * n + j] = w;
    if (k >= 1 && k <= N - K) out[(b * N + N - k) * n + j] = m;
  }
}

// merge into cuFFT's time-fastest layout: out is (B, n, N). A tile is
// merge_bins<T>() bins by TILE columns.
template <typename T, typename C = typename Complex<T>::type>
__global__ void __launch_bounds__(TILE * ROWS)
    time_pack_merge_tiles_kernel(const C* __restrict__ xi, C* __restrict__ out, int B, int N, int n) {
  constexpr int KB = merge_bins<T>();
  __shared__ C tile[2][TILE][KB + 1];  // [bin k, mirror N - k][column][bin], padded
  const int K = N / 2 + 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * TILE;
  const long long ktiles = (K + KB - 1) / KB;
  for (long long t = blockIdx.y; t < (long long)B * ktiles; t += gridDim.y) {
    const long long b = t / ktiles;
    const int k0 = (int)(t - b * ktiles) * KB;
    const int j = j0 + tx;
    for (int r = ty; r < KB; r += ROWS) {  // thread x: column, r: bin
      const int k = k0 + r;
      if (k < K && j < n)
        merge_bin<T>(xi[((2 * b) * K + k) * n + j], xi[((2 * b + 1) * K + k) * n + j], (T)N, tile[0][tx][r],
                     tile[1][tx][r]);
    }
    __syncthreads();
    for (int r = ty; r < TILE; r += ROWS) {  // thread x: bin, r: column
      const int jr = j0 + r;
      if (jr < n) {
        C* col = out + (b * n + jr) * N;
        for (int q = 0; q < KB; q += TILE) {
          const int k = k0 + q + tx;
          if (k < K) col[k] = tile[0][r][q + tx];
          if (k >= 1 && k <= N - K) col[N - k] = tile[1][r][q + tx];
        }
      }
    }
    __syncthreads();
  }
}

// Complex values of 16 bytes a thread: four float32 or two float64 of each
// plane.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int size = 4;
  static __device__ void store(float2* o, float4 a, float4 c) {
    reinterpret_cast<float4*>(o)[0] = float4{a.x, c.x, a.y, c.y};
    reinterpret_cast<float4*>(o)[1] = float4{a.z, c.z, a.w, c.w};
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int size = 2;
  static __device__ void store(double2* o, double2 a, double2 c) {
    o[0] = double2{a.x, c.x};
    o[1] = double2{a.y, c.y};
  }
};

// pack in the row-major layout: out[b, i] = (s[b, 0, i], s[b, 1, i]) over
// the M = N n elements of a lane; 16 bytes a thread from each plane where
// VEC (M a multiple of the vector, the pointers 16-byte aligned).
template <typename T, bool VEC, typename C = typename Complex<T>::type>
__global__ void __launch_bounds__(PACK_THREADS)
    time_pack_pack_rows_kernel(const T* __restrict__ s, C* __restrict__ out, int B, long long M) {
  using V = Vec<T>;
  const long long stride = (long long)gridDim.x * PACK_THREADS;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* s0 = s + 2 * b * M;
    const T* s1 = s0 + M;
    C* o = out + b * M;
    if (VEC) {
      const auto* v0 = reinterpret_cast<const typename V::type*>(s0);
      const auto* v1 = reinterpret_cast<const typename V::type*>(s1);
      for (long long i = blockIdx.x * (long long)PACK_THREADS + threadIdx.x; i < M / V::size; i += stride)
        V::store(o + i * V::size, v0[i], v1[i]);
    } else {
      for (long long i = blockIdx.x * (long long)PACK_THREADS + threadIdx.x; i < M; i += stride)
        o[i] = C{s0[i], s1[i]};
    }
  }
}

// pack into cuFFT's time-fastest layout: out is (B, n, N).
template <typename T, typename C = typename Complex<T>::type>
__global__ void __launch_bounds__(TILE * ROWS)
    time_pack_pack_tiles_kernel(const T* __restrict__ s, C* __restrict__ out, int B, int N, int n) {
  __shared__ C tile[TILE][TILE + 1];  // [column][time], padded
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * TILE;
  const long long ttiles = (N + TILE - 1) / TILE;
  for (long long t = blockIdx.y; t < (long long)B * ttiles; t += gridDim.y) {
    const long long b = t / ttiles;
    const int t0 = (int)(t - b * ttiles) * TILE;
    const T* s0 = s + 2 * b * N * n;
    const T* s1 = s0 + (long long)N * n;
    const int j = j0 + tx;
    for (int r = ty; r < TILE; r += ROWS) {  // thread x: column, r: time
      const int tt = t0 + r;
      if (tt < N && j < n) tile[tx][r] = C{s0[(long long)tt * n + j], s1[(long long)tt * n + j]};
    }
    __syncthreads();
    const int tt = t0 + tx;
    for (int r = ty; r < TILE; r += ROWS) {  // thread x: time, r: column
      const int jr = j0 + r;
      if (tt < N && jr < n) out[(b * n + jr) * N + tt] = tile[r][tx];
    }
    __syncthreads();
  }
}

// unpack from cuFFT's time-fastest output z (B, n, N): out (B, 2, N, n) real.
template <typename T, typename C = typename Complex<T>::type>
__global__ void __launch_bounds__(TILE * ROWS)
    time_pack_unpack_kernel(const C* __restrict__ z, T* __restrict__ out, int B, int N, int n, T inv_n) {
  __shared__ T tile[2][TILE][TILE + 1];  // [re, im][column][time], padded
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * TILE;
  const long long ttiles = (N + TILE - 1) / TILE;
  for (long long t = blockIdx.y; t < (long long)B * ttiles; t += gridDim.y) {
    const long long b = t / ttiles;
    const int t0 = (int)(t - b * ttiles) * TILE;
    const int tt = t0 + tx;
    for (int r = ty; r < TILE; r += ROWS) {  // thread x: time, r: column
      const int jr = j0 + r;
      if (tt < N && jr < n) {
        const C w = cmul(z[(b * n + jr) * N + tt], C{inv_n, 0});
        tile[0][r][tx] = w.x;
        tile[1][r][tx] = w.y;
      }
    }
    __syncthreads();
    const int j = j0 + tx;
    T* o0 = out + 2 * b * N * n;
    T* o1 = o0 + (long long)N * n;
    for (int r = ty; r < TILE; r += ROWS) {  // thread x: column, r: time
      const int tr = t0 + r;
      if (tr < N && j < n) {
        o0[(long long)tr * n + j] = tile[0][tx][r];
        o1[(long long)tr * n + j] = tile[1][tx][r];
      }
    }
    __syncthreads();
  }
}

// The calling thread's device set to `device` (the runtime call only when
// it differs).
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

// `err`, with the runtime's error state cleared.
int failed(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

// The grid of a transposing kernel: column tiles on x, lanes times row
// tiles of `per` rows on y (a grid-stride loop past 65535).
dim3 tile_grid(int B, int rows, int n, int per = TILE) {
  const long long rtiles = (rows + per - 1) / per;
  return dim3((n + TILE - 1) / TILE, (unsigned)std::min((long long)B * rtiles, MAX_GRID_Y));
}

// 0 where the device is set and the sizes valid, else the error code.
int prepare(int B, int N, int n, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return failed(err);
  if (B < 1 || N < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch_pack(const void* s, void* out, int B, int N, int n, int time_fastest, int device, void* stream) {
  using C = typename Complex<T>::type;
  if (int err = prepare(B, N, n, device)) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const T* src = static_cast<const T*>(s);
  C* dst = static_cast<C*>(out);
  if (time_fastest) {
    time_pack_pack_tiles_kernel<T><<<tile_grid(B, N, n), dim3(TILE, ROWS), 0, st>>>(src, dst, B, N, n);
  } else {
    const long long M = (long long)N * n;
    const bool vec = M % Vec<T>::size == 0 && aligned16(s) && aligned16(out);
    const long long items = vec ? M / Vec<T>::size : M;
    const dim3 grid((unsigned)std::min((items + PACK_THREADS - 1) / PACK_THREADS, PACK_MAX_BLOCKS),
                    (unsigned)std::min((long long)B, MAX_GRID_Y));
    if (vec)
      time_pack_pack_rows_kernel<T, true><<<grid, PACK_THREADS, 0, st>>>(src, dst, B, M);
    else
      time_pack_pack_rows_kernel<T, false><<<grid, PACK_THREADS, 0, st>>>(src, dst, B, M);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split(const void* Z, void* out, int B, int N, int n, int device, void* stream) {
  using C = typename Complex<T>::type;
  if (int err = prepare(B, N, n, device)) return err;
  // 1/N as torch's `* (1.0 / N)` makes it: the double quotient, rounded to T.
  const T inv_n = (T)(1.0 / N);
  time_pack_split_kernel<T><<<tile_grid(B, N / 2 + 1, n), dim3(TILE, ROWS), 0, (cudaStream_t)stream>>>(
      static_cast<const C*>(Z), static_cast<C*>(out), B, N, n, inv_n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_merge(const void* xi, void* out, int B, int N, int n, int time_fastest, int device, void* stream) {
  using C = typename Complex<T>::type;
  if (int err = prepare(B, N, n, device)) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const C* src = static_cast<const C*>(xi);
  C* dst = static_cast<C*>(out);
  if (time_fastest) {
    const dim3 grid = tile_grid(B, N / 2 + 1, n, merge_bins<T>());
    time_pack_merge_tiles_kernel<T><<<grid, dim3(TILE, ROWS), 0, st>>>(src, dst, B, N, n);
  } else {
    const dim3 grid((n + MERGE_THREADS - 1) / MERGE_THREADS,
                    (unsigned)std::min((long long)B * (N / 2 + 1), MAX_GRID_Y));
    time_pack_merge_rows_kernel<T><<<grid, MERGE_THREADS, 0, st>>>(src, dst, B, N, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_unpack(const void* z, void* out, int B, int N, int n, int device, void* stream) {
  using C = typename Complex<T>::type;
  if (int err = prepare(B, N, n, device)) return err;
  // 1/N as torch's normalisation makes it: the double 1.0 / N, rounded to T.
  const T inv_n = (T)(1.0 / N);
  time_pack_unpack_kernel<T><<<tile_grid(B, N, n), dim3(TILE, ROWS), 0, (cudaStream_t)stream>>>(
      static_cast<const C*>(z), static_cast<T*>(out), B, N, n, inv_n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers to data of the
// named real type (s, unpack's output) or complex data of it (the others),
// 8-byte (f32) or 16-byte (f64) aligned. Z and unpack's z: B column-major
// (N, n) matrices one after another (time-fastest); s and unpack's output
// (B, 2, N, n), b_hat and xi (B, 2, K, n) row-major, K = N / 2 + 1; pack's
// and merge's output (B, N, n), row-major or, where `time_fastest` is not 0,
// time-fastest. Each returns the launch's cudaError_t (0 on success; a size
// below 1 is cudaErrorInvalidValue) with the runtime's error state cleared;
// the launch is asynchronous on `stream`.
extern "C" {

int time_pack_pack_f32(const void* s, void* out, int B, int N, int n, int time_fastest, int device, void* stream) {
  return launch_pack<float>(s, out, B, N, n, time_fastest, device, stream);
}

int time_pack_pack_f64(const void* s, void* out, int B, int N, int n, int time_fastest, int device, void* stream) {
  return launch_pack<double>(s, out, B, N, n, time_fastest, device, stream);
}

int time_pack_split_f32(const void* Z, void* b_hat, int B, int N, int n, int device, void* stream) {
  return launch_split<float>(Z, b_hat, B, N, n, device, stream);
}

int time_pack_split_f64(const void* Z, void* b_hat, int B, int N, int n, int device, void* stream) {
  return launch_split<double>(Z, b_hat, B, N, n, device, stream);
}

int time_pack_merge_f32(const void* xi, void* out, int B, int N, int n, int time_fastest, int device, void* stream) {
  return launch_merge<float>(xi, out, B, N, n, time_fastest, device, stream);
}

int time_pack_merge_f64(const void* xi, void* out, int B, int N, int n, int time_fastest, int device, void* stream) {
  return launch_merge<double>(xi, out, B, N, n, time_fastest, device, stream);
}

int time_pack_unpack_f32(const void* z, void* out, int B, int N, int n, int device, void* stream) {
  return launch_unpack<float>(z, out, B, N, n, device, stream);
}

int time_pack_unpack_f64(const void* z, void* out, int B, int N, int n, int device, void* stream) {
  return launch_unpack<double>(z, out, B, N, n, device, stream);
}

const char* time_pack_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
