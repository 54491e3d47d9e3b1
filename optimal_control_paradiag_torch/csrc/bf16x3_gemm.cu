// The bf16x3 matrix product C = A @ B for Hopper: the three-pass bf16
// product that XLA runs for a float32 dot at jax.lax.Precision.HIGH.
//
// Replaces no Pallas kernel. It is the port's counterpart of XLA's
// Precision.HIGH dot in the JAX package's matmul sine transform
// (optimal_control_paradiag_tpu/fem/space.py:P1Space.dst, dst_precision=
// 'high') and in the radix products of its four-step plans
// (ops/transforms.py:FourStepPlan, DstFourStepPlan, precision=HIGH). torch
// has no such product: its 'high' float32 matmul is TF32, and cuBLAS offers
// single-pass bf16 only.
//
// What it computes. Each float32 operand x is split into two bf16 values,
// hi = RNE(x) and lo = RNE(x - hi) (the subtraction is exact in float32),
// and
//
//   C = (A_hi B_lo + A_lo B_hi) + A_hi B_hi,
//
// summed in float32 (lo * lo is dropped: about 2^-16 of the product). The
// product of two bf16 values is exact in float32, so this kernel and its
// plain PyTorch twin (ops/bf16x3.py:bf16x3_matmul_reference) differ only in
// the order of float32 sums.
//
// Operands. A is (M, K) float32, row-major, as the caller's state lies;
// it is split in the kernel. B is a constant of the caller (the DST-I
// matrix, a plan's radix matrix), split once on the host side of the
// wrapper: its hi and lo planes are (K, ldb) bf16, row-major, ldb = N
// rounded up to a multiple of 8 and the padding columns zero, so that
// every row of a plane starts on 16 bytes and loads in 16-byte pieces.
// C is (M, N) float32, row-major.
//
// Bound: operations. At the headline DST (M = 2 N_t = 2048, K = N = 2047)
// the three passes are 3 x 2 M N K = 51.5 GFLOP of bf16 tensor-core work,
// 0.052 ms at 989 TFLOP/s, against 50.3 MB of traffic (A and C in float32,
// both B planes), 0.015 ms at 3.35 TB/s.
//
// Design (right first; wgmma, TMA and warp specialisation are later work):
// - a 128 x 128 output tile per block of 256 threads (8 warps, 2 along M
//   by 4 along N, 64 x 32 outputs each), K in steps of 32;
// - each K step, A's float32 tile is read from device memory (scalar
//   loads, neighbouring threads on neighbouring k: A's rows are K floats
//   apart, which need not be 16-byte aligned), split to hi and lo with
//   __float2bfloat16_rn, the same split as the twin, and stored to shared
//   memory beside B's hi and lo tiles (16-byte loads). The loads of the
//   next step are issued into registers before the current step's
//   products, so their latency overlaps the tensor-core work;
// - rows of the shared tiles are padded (A 40, B 136 bf16) so that the
//   eight 16-byte rows an ldmatrix reads fall in distinct banks;
// - fragments come by ldmatrix (B with .trans, from its [k][n] tile), and
//   each fragment pair takes three mma.sync.m16n8k16 bf16 products with
//   float32 accumulators, the two small terms first;
// - the tensor cores do not round a float32 accumulation to nearest (they
//   align the products to the largest exponent and drop the low bits), so
//   an accumulator carried over all of K would lose up to an ulp towards
//   zero at each product step, a bias that grows with K. Each K step is
//   therefore summed from zero in its own accumulator and added to the
//   running sum by an ordinary float32 add;
// - loads outside A, B or the padding are predicated and zero-filled, and
//   the store is predicated, so any M, N, K >= 0 works (K = N = 2047 and
//   255 at the main path's shapes, 1 x 1 x 1 in the tests).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;  // 80-byte rows: an ldmatrix's 8 rows hit 8 distinct bank groups
constexpr int B_LD = BN + 8;  // 272-byte rows, likewise

struct __align__(16) Tiles {
  __nv_bfloat16 a[2][BM][A_LD];  // A's hi and lo planes, [m][k]
  __nv_bfloat16 b[2][BK][B_LD];  // B's hi and lo planes, [k][n]
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2,
                                              unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A's tile at (m0, k0) into registers: thread t holds the k pair 2 (t % 16)
// of rows t / 16 + 16 i, i < 8; zero outside A.
__device__ __forceinline__ void load_a(const float* __restrict__ A, int M, int K, int m0, int k0, int t,
                                       float (&ra)[16]) {
  const int k = k0 + 2 * (t % 16);
  const int r = t / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + r + 16 * i;
    const bool in = m < M;
    const float* row = A + (size_t)(in ? m : 0) * K;
    ra[2 * i] = (in && k < K) ? __ldg(row + k) : 0.f;
    ra[2 * i + 1] = (in && k + 1 < K) ? __ldg(row + k + 1) : 0.f;
  }
}

// Split A's registers into hi and lo bf16 and store them to the tile.
__device__ __forceinline__ void store_a(Tiles& s, int t, const float (&ra)[16]) {
  const int c = 2 * (t % 16);
  const int r = t / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x0 = ra[2 * i], x1 = ra[2 * i + 1];
    const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
    const __nv_bfloat16 l0 = __float2bfloat16_rn(x0 - __bfloat162float(h0));
    const __nv_bfloat16 l1 = __float2bfloat16_rn(x1 - __bfloat162float(h1));
    *reinterpret_cast<__nv_bfloat162*>(&s.a[0][r + 16 * i][c]) = __halves2bfloat162(h0, h1);
    *reinterpret_cast<__nv_bfloat162*>(&s.a[1][r + 16 * i][c]) = __halves2bfloat162(l0, l1);
  }
}

// B's tile at (k0, n0), both planes, into registers: thread t holds the
// 16-byte piece at column 8 (t % 16) of rows t / 16 and t / 16 + 16; zero
// past K or past ldb (ldb is a multiple of 8, so a piece is all in or all out).
__device__ __forceinline__ void load_b(const __nv_bfloat16* __restrict__ Bhi, const __nv_bfloat16* __restrict__ Blo,
                                       int K, int ldb, int k0, int n0, int t, uint4 (&rb)[4]) {
  const int n = n0 + 8 * (t % 16);
  const int r = t / 16;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = k0 + r + 16 * j;
    const bool in = k < K && n < ldb;
    const size_t off = in ? (size_t)k * ldb + n : 0;
    rb[2 * j] = in ? __ldg(reinterpret_cast<const uint4*>(Bhi + off)) : make_uint4(0, 0, 0, 0);
    rb[2 * j + 1] = in ? __ldg(reinterpret_cast<const uint4*>(Blo + off)) : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_b(Tiles& s, int t, const uint4 (&rb)[4]) {
  const int c = 8 * (t % 16);
  const int r = t / 16;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    *reinterpret_cast<uint4*>(&s.b[0][r + 16 * j][c]) = rb[2 * j];
    *reinterpret_cast<uint4*>(&s.b[1][r + 16 * j][c]) = rb[2 * j + 1];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    bf16x3_gemm_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bhi,
                       const __nv_bfloat16* __restrict__ Blo, float* __restrict__ C, int M, int N, int K,
                       int ldb) {
  __shared__ Tiles s;
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  float ra[16];
  uint4 rb[4];
  const int steps = (K + BK - 1) / BK;
  if (steps > 0) {
    load_a(A, M, K, m0, 0, t, ra);
    load_b(Bhi, Blo, K, ldb, 0, n0, t, rb);
  }
  for (int step = 0; step < steps; ++step) {
    store_a(s, t, ra);
    store_b(s, t, rb);
    __syncthreads();
    if (step + 1 < steps) {  // the next step's loads, in flight during the products below
      load_a(A, M, K, m0, (step + 1) * BK, t, ra);
      load_b(Bhi, Blo, K, ldb, (step + 1) * BK, n0, t, rb);
    }

    float part[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: k 0-7 / 8-15 of n-tile 2 nj, then of n-tile 2 nj + 1
        const int kr = kk + (lane % 8) + ((lane / 8) % 2) * 8;
        const int nc = wn + nj * 16 + (lane / 16) * 8;
        ldsm_x4_trans(smem_u32(&s.b[0][kr][nc]), bh[2 * nj][0], bh[2 * nj][1], bh[2 * nj + 1][0],
                      bh[2 * nj + 1][1]);
        ldsm_x4_trans(smem_u32(&s.b[1][kr][nc]), bl[2 * nj][0], bl[2 * nj][1], bl[2 * nj + 1][0],
                      bl[2 * nj + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // matrices: rows 0-7 / 8-15 at k 0-7, then at k 8-15
        unsigned ah[4], al[4];
        const int mr = wm + mi * 16 + (lane % 16);
        const int kc = kk + (lane / 16) * 8;
        ldsm_x4(smem_u32(&s.a[0][mr][kc]), ah);
        ldsm_x4(smem_u32(&s.a[1][mr][kc]), al);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(part[mi][ni], ah, bl[ni]);
          mma_bf16(part[mi][ni], al, bh[ni]);
          mma_bf16(part[mi][ni], ah, bh[ni]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
    __syncthreads();  // the tiles are rewritten at the top of the next step
  }

  // accumulator (mi, ni): rows g and g + 8, columns 2 tig and 2 tig + 1
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        float* out = C + (size_t)row * N;
        if (col < N) out[col] = acc[mi][ni][2 * h];
        if (col + 1 < N) out[col + 1] = acc[mi][ni][2 * h + 1];
      }
    }
  }
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers: A (M, K)
// float32 row-major; Bhi and Blo (K, ldb) bf16 row-major, 16-byte aligned,
// ldb a multiple of 8 and >= N, columns N..ldb-1 zero; C (M, N) float32
// row-major. Returns the cudaError_t of the launch (0 on success; shapes
// the launcher refuses are cudaErrorInvalidValue); the launch is
// asynchronous on `stream`.
extern "C" {

int bf16x3_gemm_f32(const float* A, const void* Bhi, const void* Blo, float* C, int M, int N, int K, int ldb,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = ((long long)N + BN - 1) / BN;
  if (M < 0 || N < 0 || K < 0 || ldb < N || ldb % 8 != 0 || n_tiles > 65535 ||
      (reinterpret_cast<uintptr_t>(Bhi) | reinterpret_cast<uintptr_t>(Blo)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((M + BM - 1) / BM, (unsigned)n_tiles);
  bf16x3_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      A, static_cast<const __nv_bfloat16*>(Bhi), static_cast<const __nv_bfloat16*>(Blo), C, M, N, K, ldb);
  return (int)cudaGetLastError();
}

const char* bf16x3_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
