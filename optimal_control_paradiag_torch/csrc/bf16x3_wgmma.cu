// The bf16x3 matrix product C = A @ B for Hopper, as a TMA-fed,
// warp-specialised wgmma GEMM: the route of B3 for all but the smallest
// shapes (the headline sine transform, M = 2 N_t = 2048, K = N = 2047, its
// batches, the heat 2D axes, K = N = 255). bf16x3_gemm.cu keeps the
// mma.sync kernel for the small ones (the four-step plans' radix products,
// K = 32); ops/bf16x3.py:bf16x3_route picks from the shape alone.
//
// Replaces no Pallas kernel: like bf16x3_gemm.cu it is the port's
// counterpart of XLA's Precision.HIGH dot in the JAX package's matmul sine
// transform (optimal_control_paradiag_tpu/fem/space.py:P1Space.dst,
// dst_precision='high') and in its four-step plans (ops/transforms.py).
//
// What it computes, exactly as bf16x3_gemm.cu and the plain twin
// (ops/bf16x3.py:bf16x3_matmul_reference): each float32 operand x is split
// into hi = RNE_bf16(x) and lo = RNE_bf16(x - hi), and
//
//   C = (A_hi B_lo + A_lo B_hi) + A_hi B_hi,
//
// the bf16 products exact, the sums in float32.
//
// Bound: operations. At the headline, 3 x 2 M N K = 51.5 GFLOP of bf16
// tensor-core work, 0.052 ms at 989 TFLOP/s, against 50.3 MB of traffic
// (A and C in float32 once, both B planes once), 0.015 ms at 3.35 TB/s.
//
// Design.
// - A split pass (bf16x3_split_kernel) reads A (M, K) float32 once and
//   writes its hi and lo planes (2, M, ld) bf16, ld = K rounded up to 64,
//   zero past K: the rows then start on 128 bytes, which TMA needs (A's own
//   rows, 2047 floats apart, cannot be described to it), and each element
//   is split once instead of once per output tile in its row.
// - B is the caller's constant, split once into the same K-major layout,
//   (2, N, ld) bf16 (ops/bf16x3.py:split_matrix).
// - The GEMM (bf16x3_wgmma_kernel): one 128 x 128 output tile per block of
//   three warpgroups, N's tiles first. Warpgroup 0 is the producer: one
//   thread keeps a ring of three shared-memory stages full, each stage the
//   64-deep K slice of A_hi, A_lo, B_hi and B_lo (4 x 16 KB), loaded by TMA
//   with the 128-byte swizzle and completed on the stage's `full` mbarrier.
//   Warpgroups 1 and 2 are the consumers, 64 output rows each: per k16
//   slice three wgmma.m64n128k16 bf16 products (hi lo, lo hi, hi hi) with
//   both operands read from shared memory by descriptor, then the stage is
//   released on its `empty` mbarrier. setmaxnreg moves registers from the
//   producer (40) to the consumers (232).
// - The tensor cores do not round a float32 accumulation to nearest (they
//   truncate after aligning to the largest exponent), so a chain carried
//   over all of K would drift towards zero. Each 64-deep stage is summed
//   from zero in a partial accumulator, and the partial is added into the
//   running float32 sum by an ordinary add: 64 registers for the sum and 64
//   for the partial per consumer thread (an add every second stage, and
//   32-deep stages, measured slower: PERF.md, PR 13).
// - Rows past M or N come from TMA's zero fill. C's rows (N floats) need
//   not be 16-byte aligned, so neither TMA nor vector stores can write
//   them: each warp stages its 16 rows in the ring, idle by then, and
//   writes them a row at a time, 32 neighbouring floats per store.
// - The host builds both tensor maps with cuTensorMapEncodeTiled, fetched
//   through cudaGetDriverEntryPoint (no -lcuda), and passes them as
//   __grid_constant__ parameters.
//
// Measurement build only (chip_smoke.py): -DBF16X3_PROFILE (clock64 and
// %globaltimer marks per block, read by bf16x3_profile_read).

#include <cuda.h>  // CUtensorMap and its enums; the driver function comes by entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#ifdef BF16X3_PROFILE  // measurement only: clock64 sums and %globaltimer marks of a block
__device__ long long bf16x3_profile[1024][8];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#endif

namespace {

constexpr int BM = 128;  // output rows per block: two consumer warpgroups of 64
constexpr int BN = 128;  // output columns per block: one m64n128 wgmma
constexpr int BK = 64;  // K per stage: a row of a tile is 128 bytes, the swizzle's span
constexpr int ROW_BYTES = 2 * BK;
constexpr int STAGES = 3;  // a ring of 192 KB
constexpr int THREADS = 3 * 128;
constexpr int PLANE_BYTES = BM * ROW_BYTES;   // one plane of one stage (BN == BM)
constexpr int STAGE_BYTES = 4 * PLANE_BYTES;  // A hi, A lo, B hi, B lo
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + room to align the ring to 1024 bytes
constexpr int C_LD = BN + 8;  // floats per staged row of C: a warp's float2 stores fill the banks twice
static_assert(8 * 16 * C_LD * 4 <= STAGES * STAGE_BYTES, "the eight consumer warps stage their rows in the ring");
constexpr int SPLIT_X = 64, SPLIT_Y = 4;  // the split pass's block: 256 columns of 4 rows

static_assert(BM == BN, "the planes of A and B share one tile shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- split pass

// A (M, K) float32 -> planes (2, M, ld) bf16: [0] hi, [1] lo, zero past K.
// A block of SPLIT_X x SPLIT_Y threads covers 4 SPLIT_X columns of SPLIT_Y
// rows at a time, striding over the rows: each thread splits 4 neighbouring
// elements and stores 8 bytes to each plane; a warp reads 512 contiguous
// bytes of a row.
__global__ void __launch_bounds__(SPLIT_X * SPLIT_Y)
    bf16x3_split_kernel(const float* __restrict__ A, __nv_bfloat16* __restrict__ planes, int M, int K, int ld) {
  const int c = 4 * (blockIdx.x * SPLIT_X + threadIdx.x);
  if (c >= ld) return;
  const size_t plane = (size_t)M * ld;
  for (long long m = (long long)blockIdx.y * SPLIT_Y + threadIdx.y; m < M; m += (long long)gridDim.y * SPLIT_Y) {
    const float* row = A + m * K;
    __align__(8) __nv_bfloat16 hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = c + j < K ? __ldg(row + c + j) : 0.f;
      hi[j] = __float2bfloat16_rn(x);
      lo[j] = __float2bfloat16_rn(x - __bfloat162float(hi[j]));
    }
    const size_t off = (size_t)m * ld + c;
    *reinterpret_cast<uint2*>(planes + off) = *reinterpret_cast<const uint2*>(hi);
    *reinterpret_cast<uint2*>(planes + plane + off) = *reinterpret_cast<const uint2*>(lo);
  }
}

// ---------------------------------------------------------------- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// phase that never completes (a fault of the kernel) traps after about two
// seconds, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

// One box {BK, 128, 1} of a (2, rows, ld) plane tensor at (k0, r0, plane).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k0, int r0,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(r0), "r"(plane)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: 8-row groups 8 ROW_BYTES apart (SBO), the leading offset unused
// by this layout; the tile starts on a multiple of 8 ROW_BYTES, and a k16
// step within a row adds 32 bytes (2 in the >> 4 field).
__device__ __forceinline__ uint64_t tile_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(8 * ROW_BYTES >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads of the accumulator above the wait.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, float32) = A (64 x 16) B (16 x 128) + (accumulate ? d : 0),
// bf16 operands by descriptor, both K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---------------------------------------------------------------- the GEMM

// a_map: A's planes (2, M, ld); b_map: B's planes (2, N, ld); nk = ld / BK.
// Block b computes output tile b, N's tiles first: the blocks resident at
// once share a few row panels of A and all of B, so that a batch whose A
// outgrows L2 reads it from device memory once.
__global__ void __launch_bounds__(THREADS, 1)
    bf16x3_wgmma_kernel(__grid_constant__ const CUtensorMap a_map, __grid_constant__ const CUtensorMap b_map,
                        float* __restrict__ C, int M, int N, int nk) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the ring: stage s, plane p (0 A hi, 1 A lo, 2 B hi, 3 B lo) at ring + s STAGE_BYTES + p PLANE_BYTES
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128;
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrive, plus the stage's TMA bytes
      mbar_init(&empty[s], 8);  // lane 0 of each of the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % STAGES;
        if (ks >= STAGES) mbar_wait(&empty[s], (ks / STAGES - 1) & 1);
        uint8_t* st = ring + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load(st, &a_map, &full[s], ks * BK, m0, 0);
        tma_load(st + PLANE_BYTES, &a_map, &full[s], ks * BK, m0, 1);
        tma_load(st + 2 * PLANE_BYTES, &b_map, &full[s], ks * BK, n0, 0);
        tma_load(st + 3 * PLANE_BYTES, &b_map, &full[s], ks * BK, n0, 1);
      }
    }
  } else {
    // ------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;  // rows 64 c .. 64 c + 63 of the tile
    const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
#ifdef BF16X3_PROFILE
    long long t_full = 0, t_mma = 0;
    const long long t_start = clock64(), ns_start = global_ns();
#endif
    for (int ks = 0; ks < nk; ++ks) {
      const int s = ks % STAGES;
#ifdef BF16X3_PROFILE
      const long long t0 = clock64();
#endif
      mbar_wait(&full[s], (ks / STAGES) & 1);
#ifdef BF16X3_PROFILE
      const long long t1 = clock64();
      t_full += t1 - t0;
#endif
      const uint32_t st = smem_u32(ring + s * STAGE_BYTES);
      const uint64_t a_hi = tile_desc(st + c * 64 * ROW_BYTES), a_lo = tile_desc(st + PLANE_BYTES + c * 64 * ROW_BYTES);
      const uint64_t b_hi = tile_desc(st + 2 * PLANE_BYTES), b_lo = tile_desc(st + 3 * PLANE_BYTES);
      fence_operands(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t step = 2 * kk;  // 32 bytes, in the descriptor's 16-byte units
        wgmma_m64n128k16(part, a_hi + step, b_lo + step, kk != 0);  // the stage's partial starts from zero
        wgmma_m64n128k16(part, a_lo + step, b_hi + step, 1);
        wgmma_m64n128k16(part, a_hi + step, b_hi + step, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(part);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
#ifdef BF16X3_PROFILE
      t_mma += clock64() - t1;
#endif
    }
#ifdef BF16X3_PROFILE
    const bool mark = t == 0 && c == 0 && blockIdx.x < 1024;
    if (mark) {
      bf16x3_profile[blockIdx.x][0] = clock64() - t_start;  // the main loop
      bf16x3_profile[blockIdx.x][1] = t_full;                // waiting for a stage to land
      bf16x3_profile[blockIdx.x][2] = t_mma;                 // products, their wait, the release and the add
      bf16x3_profile[blockIdx.x][4] = ns_start;
      bf16x3_profile[blockIdx.x][5] = global_ns();           // the main loop's end
      unsigned sm;
      asm volatile("mov.u32 %0, %smid;" : "=r"(sm));
      bf16x3_profile[blockIdx.x][7] = sm;
    }
#endif

    // The store. Each warp holds 16 rows of the tile: accumulator i at row
    // lane / 4 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
    // Once both consumer warpgroups are past their last stage the ring is
    // free: each warp stages its rows there, then writes them out a row at a
    // time, 32 neighbouring floats per store (C's rows need not be 16-byte
    // aligned, so the stores are scalar and predicated).
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* rows = reinterpret_cast<float*>(ring) + (c * 4 + warp) * 16 * C_LD;
    const int r = lane / 4, q = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(rows + r * C_LD + 8 * j + q) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(rows + (r + 8) * C_LD + 8 * j + q) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncwarp();
    const int row0 = m0 + c * 64 + warp * 16;
    for (int i = 0; i < 16 && row0 + i < M; ++i) {
      float* out = C + (size_t)(row0 + i) * N + n0;
#pragma unroll
      for (int p = 0; p < BN / 32; ++p) {
        const int col = 32 * p + lane;
        if (n0 + col < N) out[col] = rows[i * C_LD + col];
      }
    }
#ifdef BF16X3_PROFILE
    if (mark) bf16x3_profile[blockIdx.x][6] = global_ns();  // the stores issued
#endif
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (2, rows, ld) bf16 plane tensor, boxes {BK, 128, 1}
// with the 128-byte swizzle; rows past `rows` read as zero.
bool plane_map(CUtensorMap* map, const void* planes, int rows, int ld) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)rows, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)rows * ld * 2};
  const cuuint32_t box[3] = {BK, BM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(planes), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The calling thread's device set to `device` (the runtime call only when
// it differs).
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

// The pending launch error, cleared (0 on success).
int launch_status() { return (int)cudaGetLastError(); }

// `err`, with the runtime's error state cleared.
int failed(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

cudaError_t split_launch(const float* A, void* planes, int M, int K, int ld, cudaStream_t stream) {
  if (M == 0 || ld == 0) return cudaSuccess;
  const dim3 grid((ld + 4 * SPLIT_X - 1) / (4 * SPLIT_X), (unsigned)std::min((M + SPLIT_Y - 1) / SPLIT_Y, 65535));
  bf16x3_split_kernel<<<grid, dim3(SPLIT_X, SPLIT_Y), 0, stream>>>(A, static_cast<__nv_bfloat16*>(planes), M, K, ld);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers: A (M, K)
// float32 row-major; planes (2, M, ld) bf16; B's planes (2, N, ld) bf16,
// K-major, columns K..ld-1 zero; C (M, N) float32 row-major; ld a multiple
// of 64 and >= K. Each returns the cudaError_t of its launches (0 on
// success; what the launcher refuses is cudaErrorInvalidValue) with the
// runtime's error state cleared; the launches are asynchronous on `stream`.
extern "C" {

// The split pass alone: A -> its hi and lo planes.
int bf16x3_split_f32(const float* A, void* planes, int M, int K, int ld, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return failed(err);
  if (M < 0 || K < 0 || ld < K || ld % 64 != 0 || !aligned16(planes)) return (int)cudaErrorInvalidValue;
  err = split_launch(A, planes, M, K, ld, (cudaStream_t)stream);
  return err != cudaSuccess ? failed(err) : launch_status();
}

// C = A @ B in bf16x3: the split of A into `a_planes` (scratch of the
// caller, (2, M, ld) bf16), then the GEMM.
int bf16x3_wgmma_f32(const float* A, void* a_planes, const void* b_planes, float* C, int M, int N, int K, int ld,
                     int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return failed(err);
  const long long tiles = (((long long)M + BM - 1) / BM) * (((long long)N + BN - 1) / BN);
  if (M < 0 || N < 0 || K < 0 || ld < K || ld % 64 != 0 || tiles > 0x7FFFFFFF || !aligned16(a_planes) ||
      !aligned16(b_planes))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K == 0) {
    err = cudaMemsetAsync(C, 0, (size_t)M * N * sizeof(float), s);
    return err != cudaSuccess ? failed(err) : launch_status();
  }
  CUtensorMap a_map, b_map;
  if (!plane_map(&a_map, a_planes, M, ld) || !plane_map(&b_map, b_planes, N, ld)) return (int)cudaErrorInvalidValue;
  static bool attribute_set[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!attribute_set[device]) {
    err = cudaFuncSetAttribute(bf16x3_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return failed(err);
    attribute_set[device] = true;
  }
  err = split_launch(A, a_planes, M, K, ld, s);
  if (err != cudaSuccess) return failed(err);
  bf16x3_wgmma_kernel<<<(unsigned)tiles, THREADS, SMEM_BYTES, s>>>(a_map, b_map, C, M, N, ld / BK);
  return launch_status();
}

const char* bf16x3_wgmma_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

#ifdef BF16X3_PROFILE
// Copy the profile build's (1024, 8) marks to host memory.
int bf16x3_profile_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, bf16x3_profile, sizeof(bf16x3_profile));
}
#endif

}  // extern "C"
