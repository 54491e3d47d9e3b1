// The two-for-one split and merge around the packed complex time FFT, for
// Hopper: the glue of ops/transforms.py:time_rfft_conj_packed and
// time_irfft_conj_packed (time_transform='fft2'), one kernel each way.
//
// Replaces no Pallas kernel: the JAX package leaves this glue to XLA, which
// fuses it. In the port it was eager PyTorch, about ten full passes over
// the spectral state each way; these kernels do it in one.
//
// What they compute, bit for bit the plain twin (ops/time_pack.py:
// split_reference, merge_reference). N time steps, K = N / 2 + 1 bins, n
// columns, any number B of leading lanes; Z = fft(s0 + i s1) over time.
//
//   split:  Zm[k] = conj(Z[(N - k) % N]),
//           R0 = 0.5 (Z + Zm),  R1 = -0.5i (Z - Zm),
//           b_hat = [conj(R0[:K]), conj(R1[:K])] * (1/N)     (B, 2, K, n)
//   merge:  a = conj(xi0), b = conj(xi1),
//           W = (a + i b) N,  W2 = (a - i b) N,
//           out[k] = W[k] (k < K),  out[N - k] = conj(W2[k]) (1 <= k <= N - K)
//                                                           (B, N, n)
//
// Each complex operation of the twin is done here as PyTorch's CUDA
// kernels do it, on c10::complex: a + alpha b with alpha = 1 or -1 (add,
// sub), (ac - bd, ad + bc) for a product, with the twin's scalars as the
// complex constants torch makes of them (0.5, -0.5i = (-0, -0.5), 1i, N,
// 1/N rounded to the working type), in the same order. Every real
// operation is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn, and
// the double ones), so nvcc contracts none into an FMA. Each product but
// the last scaling has an exact factor (0, +-1, 0.5), so a contracted FMA
// in PyTorch's own kernels gives the same bits; even the signs of zeros
// (the imaginary parts of the DC and Nyquist bins) agree.
//
// Bound: bytes. Each way reads one (B, N, n) or (B, 2, K, n) complex
// tensor once and writes the other once: 2 x 16.8 MB at the wave headline
// in float32 (N = 1024, n = 2047), 10.0 us at 3.35 TB/s.
//
// Design.
// - split: cuFFT leaves Z column-major, time fastest (torch's fft over
//   dim -2 returns strides (1, N) for each (N, n) matrix), while b_hat is
//   row-major. A block takes a 32-bin x 32-column tile: its threads read
//   the 32 bins k and their mirrors N - k of each column (both runs
//   contiguous in memory), form both outputs of a bin at once, stage them
//   in shared memory, and write 32-column rows of each plane. Each element
//   of Z is read once: bin k and its mirror belong to the same thread.
// - merge: xi and the output are both row-major. A thread owns a column
//   and a bin k < K: it reads xi0[k] and xi1[k] once and writes out[k] and,
//   where it exists, the mirrored out[N - k].
// - Lanes ride the grid's y axis together with the bin tiles (merge: the
//   bins), in a grid-stride loop, so any B and K launch.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int TILE = 32;  // split: bins and columns of a block's tile
constexpr int ROWS = 8;   // split: thread rows of a block (32 x 8 threads)
constexpr int MERGE_THREADS = 256;
constexpr long long MAX_GRID_Y = 65535;

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

// b_hat's bin k of both planes from Z[k] = z and Z[(N - k) % N] = w.
template <typename T, typename C = typename Complex<T>::type>
__device__ __forceinline__ void split_bin(C z, C w, T inv_n, C& b0, C& b1) {
  const C zm = cconj(w);
  const C r0 = cmul(add_alpha(z, zm, T(1)), C{T(0.5), 0});
  const C r1 = cmul(add_alpha(z, zm, T(-1)), C{-T(0), T(-0.5)});
  b0 = cmul(cconj(r0), C{inv_n, 0});
  b1 = cmul(cconj(r1), C{inv_n, 0});
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
    time_pack_merge_kernel(const C* __restrict__ xi, C* __restrict__ out, int B, int N, int n) {
  const int K = N / 2 + 1;
  const int j = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (j >= n) return;
  const T scale = (T)N;
  for (long long row = blockIdx.y; row < (long long)B * K; row += gridDim.y) {
    const long long b = row / K;
    const int k = (int)(row - b * K);
    const C a = cconj(xi[((2 * b) * K + k) * n + j]);
    const C ib = cmul(cconj(xi[((2 * b + 1) * K + k) * n + j]), C{T(0), T(1)});
    out[(b * N + k) * n + j] = cmul(add_alpha(a, ib, T(1)), C{scale, 0});
    if (k >= 1 && k <= N - K) out[(b * N + N - k) * n + j] = cconj(cmul(add_alpha(a, ib, T(-1)), C{scale, 0}));
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

bool valid(int B, int N, int n) { return B >= 1 && N >= 1 && n >= 1; }

template <typename T>
int launch_split(const void* Z, void* out, int B, int N, int n, int device, void* stream) {
  using C = typename Complex<T>::type;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return failed(err);
  if (!valid(B, N, n)) return (int)cudaErrorInvalidValue;
  const long long ktiles = (N / 2 + 1 + TILE - 1) / TILE;
  const dim3 grid((n + TILE - 1) / TILE, (unsigned)std::min((long long)B * ktiles, MAX_GRID_Y));
  const dim3 block(TILE, ROWS);
  // 1/N as torch's `* (1.0 / N)` makes it: the double quotient, rounded to T.
  const T inv_n = (T)(1.0 / N);
  time_pack_split_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(static_cast<const C*>(Z),
                                                                       static_cast<C*>(out), B, N, n, inv_n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_merge(const void* xi, void* out, int B, int N, int n, int device, void* stream) {
  using C = typename Complex<T>::type;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return failed(err);
  if (!valid(B, N, n)) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + MERGE_THREADS - 1) / MERGE_THREADS,
                  (unsigned)std::min((long long)B * (N / 2 + 1), MAX_GRID_Y));
  time_pack_merge_kernel<T><<<grid, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const C*>(xi), static_cast<C*>(out), B, N, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers to complex
// data of the named real type, 8-byte (f32) or 16-byte (f64) aligned. Z:
// B column-major (N, n) matrices one after another; b_hat and xi (B, 2,
// K, n) and the merge's output (B, N, n) row-major, K = N / 2 + 1. Each
// returns the launch's cudaError_t (0 on success; a size below 1 is
// cudaErrorInvalidValue) with the runtime's error state cleared; the launch
// is asynchronous on `stream`.
extern "C" {

int time_pack_split_f32(const void* Z, void* b_hat, int B, int N, int n, int device, void* stream) {
  return launch_split<float>(Z, b_hat, B, N, n, device, stream);
}

int time_pack_split_f64(const void* Z, void* b_hat, int B, int N, int n, int device, void* stream) {
  return launch_split<double>(Z, b_hat, B, N, n, device, stream);
}

int time_pack_merge_f32(const void* xi, void* out, int B, int N, int n, int device, void* stream) {
  return launch_merge<float>(xi, out, B, N, n, device, stream);
}

int time_pack_merge_f64(const void* xi, void* out, int B, int N, int n, int device, void* stream) {
  return launch_merge<double>(xi, out, B, N, n, device, stream);
}

const char* time_pack_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
