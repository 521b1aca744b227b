// The ConvLSTM gate conv as an implicit GEMM, shared by the fused cell
// forward (convlstm_cell.cu) and the fused cell backward (cell_bwd.cu).
//
//   gates = conv_same(xh, w) + b      xh (B,H,W,Cin), w (k,k,Cin,4*hid) HWIO
//
// It replaces the gate conv of three TPU kernels: B1
// nasa_niswan_tpu/ops/convlstm_pallas2.py::_cell_kernel_v2 (all modes), the
// gate recompute of B2 nasa_niswan_tpu/ops/convgrad_pallas.py::
// _cell_bwd_kernel, and B4 nasa_niswan_tpu/ops/convlstm_pallas.py::
// _cell_kernel (the same cell as B1's plain mode).  Two mainloops hand the
// four pre-activation gates (i, f, g, o) of a (pixel, hidden channel) to an
// epilogue functor, which decides what to do with them:
//
//   struct Epi {
//     static constexpr bool kReduce;     // also reduce 4*hid sums over the block
//     float* db_part;                    // [block][4*hid], when kReduce
//     // FP32 pipes: channel j of pixel pix
//     __device__ void apply(size_t pix, int j, float i, float f, float g,
//                           float o, float (&sum)[4]) const;
//     // wgmma: channels j, j + 1 (j even) of pixel pix, p[e][gate]
//     __device__ void apply2(size_t pix, int j, const float (&p)[2][4],
//                            float (&sum)[2][4]) const;
//   };
//
// `pix` is the flat NHWC pixel index (b*H + row)*W + col.  With kReduce the
// kernel sums `sum` over the block's pixels in a fixed order and writes one
// row of 4*hid partial sums per block, so a second pass finishes the sum
// without atomics and reruns stay bit-identical.
//
//  * cell_fp32_kernel (any operand type T, hid <= 128, FP32 pipes): one block
//    per (batch, row tile, 16-column tile); each thread owns one hidden
//    channel j and kPix = 4 consecutive columns; the haloed input is staged
//    (as f32) in chunks of kChunk channels.  f32 operands, and bf16 at a hid
//    that is not 8, 16, 32 or 64 (no main path has one), run here.
//  * cell_wgmma_kernel (bf16 operands, hid in {8, 16, 32, 64}): M = pixels,
//    N = 4*hid gate columns in block order, K = k*k*Cin, f32 accumulate.
//
// What bounds the gate conv on an H100 (989 TFLOP/s dense bf16, 3.35 TB/s,
// 50 MB L2), at the main-path shapes (100x154 padded grid; FLOPs of the
// conv, bytes of every operand once):
//   training B = 8: layer 1 (Cin 72, hid 64, k 5) 113.5 GFLOP, 0.115 ms;
//     layer 2 (Cin 96, hid 32, k 3) 0.028 ms; layer 3 (Cin 48, hid 16,
//     k 3) 0.008 ms, all bound by operations (xh, c, h', c' ~25-60 MB);
//   serving B = 1: layer 1 (Cin 126) 0.025 ms, layers 2-3 0.004 ms.
// So the operands must reach the tensor cores at their full rate, fed from
// shared memory with every copy overlapped.  The old mma.sync kernel
// restaged a 32 x N weight slice per (chunk, tap) with two barriers and no
// copy in flight, and reached 7-10% of the bound.  This one:
//  1. Weights through a ring of kRing shared-memory stages fed by
//     cp.async.bulk and mbarriers (full: bytes landed; empty: every consumer
//     warp is done), kept full by one producer warp; no block-wide barrier
//     in the K loop.  The caller packs w once per weight tensor
//     (pack_cell_weights_kernel, ~1 MB at layer 1; ops/convlstm_cell.py
//     keeps it while the tensor is unchanged) into the byte image each
//     stage must hold: per k16 step a K-major, unswizzled wgmma B tile, so a
//     stage is one 1-D bulk copy and needs no tensor map.  Columns stay in
//     gate-block order: a warpgroup's accumulator spans all N columns, so a
//     thread holds all four gates of its channels and no interleave is
//     needed (the old kernel split N over warps, hence its n = 4j + g).
//  2. Weight bytes from L2 per launch = blocks x packed bytes.  Training:
//     layer 1 1040 blocks x 1.02 MB = 1065 MB (old kernel 958 MB: 72 of
//     the 80 padded channels), layer 2 1040 x 221 KB = 230 MB (442), layer
//     3 1040 x 55 KB = 58 MB (111); serving: layer 1 130 x 1.64 MB = 213 MB
//     (210), layers 2-3 29 and 7 MB (55 and 14).  Sharing each stage
//     between two blocks of a cluster by multicast halved the hid-64 bytes
//     but cost 8% of layer 1's time (remote barrier arrivals, the pair in
//     lockstep; measured on an H100, PERF.md): at ~30% of the bound the
//     mainloop is not bound by L2 bytes, so blocks stay alone.
//  3. The haloed input tile ((8+k-1) x (16+k-1) pixels x up to 128
//     channels) is staged once per block (per 128-channel group beyond
//     that) by asynchronous copies, zero-filled outside the frame (the SAME
//     padding) and past Cin.  The copy is as wide as Cin and xh allow: 16
//     bytes when Cin % 8 == 0, else 8 or 4 bytes (Cin 70, 126), else 2.
//     Copying a ragged row's contiguous run in aligned 16-byte pieces and
//     placing its channel pairs was tried: Cin 126 cost as much over Cin
//     128 (15-17%), and the extra code slowed every layer (PERF.md).  Pixels
//     are cp + 8 bf16 apart (cp = channels rounded up to 16), an odd number
//     of 16-byte units, so ldmatrix reads are conflict-free.
//     B1's plain mode may instead read its input as the two tensors x and
//     h where they lie (HaloParts: each bf16 or f32, with its own batch,
//     row, column and channel strides), so no concatenated, cast xh is
//     written before the launch.  stage_parts puts every channel where
//     stage_halo would have put xh's (x at [0, Cx), h at [Cx, Cin), zeros
//     past Cin): a bf16 part with unit channel stride by cp.async as above;
//     an f32 part (the carry h, layers 2-3's x) by cp.async into a scratch
//     past the halo, then rounded with __float2bfloat16 (to nearest even,
//     as .to(torch.bfloat16) rounds); a channels-first bf16 frame by
//     cp.async of column pairs into a scratch of planes, then moved; a
//     part of any other layout is refused and the caller concatenates.  The
//     staged halo is xh's byte for byte, so h' and c' are bit-equal to the
//     concatenated launch; nothing after the staging differs.  This is its
//     own instantiation (kParts), it takes one channel group (Cin <= 128:
//     every main path) and stages it before the accumulators are live, so
//     its registers stay the mainloop's; its scratch is held to what keeps
//     the blocks per SM of the launch on xh (parts_smem_budget: the hid-16
//     layer's h then loads through registers).  Loading f32 through
//     registers with 64 floats in flight took the kernel to 164-168
//     registers, and staging inside the group loop (acc live) spilled at
//     hid 64, each slower than the glue it replaced (PERF.md).
//  4. K in steps of 16 channels: a ragged Cin wastes at most 15 (Cin 72 ->
//     80, 126 -> 128, 70 -> 80).  The packed B rows past Cin are zero and
//     so are the halo's channels past Cin.
//  5. wgmma.m64nNk16 (sm_90a): two consumer warpgroups, each 4 rows x 16
//     columns of the 8 x 16 pixel tile (one image row of 16 pixels per
//     warp, the m16n8k16 A fragment), N = 4*hid (256/128/64/32).  A comes
//     from registers, ldmatrix'ed from the halo at the tap-shifted address
//     (every tap from one staged halo); B from the ring.  A is double
//     buffered: step s+1's ldmatrix overlaps step s's wgmma
//     (wgmma.wait_group 1).  ptxas still reports the wgmma pipeline
//     serialized (C7513, "non wgmma instructions defining input registers");
//     neither fencing the operands nor grouping the steps removed it, and
//     grouping with wait_group 0 measured slower (PERF.md).
//  6. Epilogue: each thread holds channel pairs (j, j + 1) of two pixels,
//     so c, h', c', dh, dc, dc_prev move as 8-byte pairs and gates and
//     dgates as bf16 pairs, each quad of lanes covering 32 contiguous bytes.
//     The db partials are reduced by a fixed butterfly over the lanes, then
//     over the 8 consumer warps in order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace niswan {

constexpr int kTileW = 16;             // output columns per block
constexpr int kPix = 4;                // consecutive columns per thread
constexpr int kGroupsW = kTileW / kPix;
constexpr int kChunk = 32;             // input channels staged per pass
constexpr int kStride = kChunk + 1;    // padded pixel stride in shared memory
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix of four 8x8 bf16 matrices; lane l gives the 16-byte row address
// of row l % 8 of matrix l / 8.  .trans hands each thread the transposed
// fragment (pixel-major smem -> row-major A or column-major B of mma).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(a));
}

// 16-byte asynchronous copy global -> shared; with ok false nothing is read
// and the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ size_t block_index() {
  return ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}

template <typename T, int K, class Epi>
__global__ void __launch_bounds__(kMaxThreads)
cell_fp32_kernel(const T* __restrict__ xh, const T* __restrict__ w,
                 const float* __restrict__ bias, const Epi epi, int H, int W,
                 int Cin, int hid, int tile_h) {
  // [halo row][halo col][channel of the chunk], pixel stride kStride; with
  // Epi::kReduce it is reused afterwards as [thread group][4*hid]
  extern __shared__ float tile[];
  constexpr int P = K / 2;
  constexpr int kHaloW = kTileW + K - 1;
  const int halo_pixels = (tile_h + K - 1) * kHaloW;
  const int n4 = 4 * hid;

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * tile_h;
  const int col0 = blockIdx.x * kTileW;

  const int j = threadIdx.x % hid;
  const int group = threadIdx.x / hid;
  const int ty = group / kGroupsW;
  const int tx0 = (group % kGroupsW) * kPix;

  float acc[kPix][4];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[p][g] = 0.0f;

  const T* xh_b = xh + (size_t)b * H * W * Cin;

  for (int ci0 = 0; ci0 < Cin; ci0 += kChunk) {
    const int cn = min(kChunk, Cin - ci0);
    __syncthreads();  // the previous chunk has been consumed
    for (int e = threadIdx.x; e < halo_pixels * kChunk; e += blockDim.x) {
      const int cc = e % kChunk;
      const int pix = e / kChunk;
      const int r = row0 - P + pix / kHaloW;
      const int col = col0 - P + pix % kHaloW;
      float v = 0.0f;
      if (cc < cn && r >= 0 && r < H && col >= 0 && col < W)
        v = to_f32(xh_b[((size_t)r * W + col) * Cin + ci0 + cc]);
      tile[pix * kStride + cc] = v;
    }
    __syncthreads();

#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float* xs = tile + ((ty + dy) * kHaloW + tx0 + dx) * kStride;
        const T* wp = w + ((size_t)(dy * K + dx) * Cin + ci0) * n4 + j;
#pragma unroll 4
        for (int cc = 0; cc < cn; ++cc) {
          const T* wr = wp + (size_t)cc * n4;
          const float w0 = to_f32(wr[0]);
          const float w1 = to_f32(wr[hid]);
          const float w2 = to_f32(wr[2 * hid]);
          const float w3 = to_f32(wr[3 * hid]);
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            const float x = xs[p * kStride + cc];
            acc[p][0] = fmaf(x, w0, acc[p][0]);
            acc[p][1] = fmaf(x, w1, acc[p][1]);
            acc[p][2] = fmaf(x, w2, acc[p][2]);
            acc[p][3] = fmaf(x, w3, acc[p][3]);
          }
        }
      }
    }
  }

  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int r = row0 + ty;
  if (r < H) {
    const float bi = bias[j], bf = bias[hid + j];
    const float bg = bias[2 * hid + j], bo = bias[3 * hid + j];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int col = col0 + tx0 + p;
      if (col >= W) break;
      const size_t pix = ((size_t)b * H + r) * W + col;
      epi.apply(pix, j, acc[p][0] + bi, acc[p][1] + bf, acc[p][2] + bg,
                acc[p][3] + bo, sum);
    }
  }
  if constexpr (Epi::kReduce) {
    __syncthreads();  // every thread is done with the staged tile
    const int groups = blockDim.x / hid;
#pragma unroll
    for (int g = 0; g < 4; ++g) tile[group * n4 + g * hid + j] = sum[g];
    __syncthreads();
    float* out = epi.db_part + block_index() * n4;
    for (int t = threadIdx.x; t < n4; t += blockDim.x) {
      float s = 0.0f;
      for (int q = 0; q < groups; ++q) s += tile[q * n4 + t];
      out[t] = s;
    }
  }
}


// ---- the bf16 mainloop on wgmma ----------------------------------------------

constexpr int kCellRows = 8;           // output rows per block: 4 per warpgroup
constexpr int kCellCols = 16;          // output columns per block: one m16 per warp
constexpr int kCellConsumers = 256;    // two consumer warpgroups
constexpr int kCellThreads = kCellConsumers + 32;  // + one producer warp
constexpr int kRing = 4;               // weight stages in the ring
constexpr int kStageBytes = 16384;     // bytes per stage: 1024 / N k16 steps
constexpr int kGroupCh = 128;          // input channels per staged halo
constexpr int kRingOffset = 128;       // the ring follows 2 * kRing mbarriers
constexpr int kMaxSmem = 232448;       // dynamic shared memory a block may use
// wgmma B descriptor, K-major without swizzle: core matrices of 8 gate
// columns x 8 channels (128 contiguous bytes); the two along K (channels
// 0-7, 8-15) are kLbo apart, the next 8 columns kSbo apart
constexpr int kLbo = 128;
constexpr int kSbo = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// `bytes` from global to shared, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// named barrier over the consumer warps only (the producer warp may be gone)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kCellConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (m64 x N, f32) += a (m64 x k16 bf16, registers, the m16n8k16 A fragment
// of each warp's 16 rows) x B (k16 x N bf16 in shared memory, descriptor);
// TB 0: B K-major (the packed weights), 1: B MN-major (B2's dW, dgates)
template <int N, int TB = 0>
struct WgmmaRS;

template <int TB>
struct WgmmaRS<32, TB> {
  __device__ static __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
};

template <int TB>
struct WgmmaRS<64, TB> {
  __device__ static __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
};

template <int TB>
struct WgmmaRS<128, TB> {
  __device__ static __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
};

template <int TB>
struct WgmmaRS<256, TB> {
  __device__ static __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
};


// Steps of the K loop: for each group of kGroupCh input channels, for each
// tap, for each 16-channel chunk of the group.  The packed weights hold one
// k16 x N tile per step, in that order.
__host__ __device__ inline int cell_chunks(int Cin, int g) {
  const int left = Cin - g * kGroupCh;
  return ((left < kGroupCh ? left : kGroupCh) + 15) / 16;
}

__host__ __device__ inline int cell_steps(int Cin, int k) {
  int s = 0;
  for (int g = 0; g * kGroupCh < Cin; ++g) s += k * k * cell_chunks(Cin, g);
  return s;
}

// w (k,k,Cin,N) HWIO -> the wgmma B image: per step s a k16 x N tile of
// 16-byte units [N/8][2][8] (columns 8nb..8nb+7, channels 8kh..8kh+7 of
// the chunk), channels past Cin zero.  One thread per 16-byte unit.
static __global__ void pack_cell_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                         __nv_bfloat16* __restrict__ out, int K,
                                         int Cin, int N, long long units) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  const int r = (int)(u & 7), kh = (int)((u >> 3) & 1);
  const long long t = u >> 4;
  const int nb = (int)(t % (N / 8));
  const int s = (int)(t / (N / 8));
  const int g = s / (K * K * (kGroupCh / 16));
  const int rem = s - g * K * K * (kGroupCh / 16);
  const int nch = cell_chunks(Cin, g);
  const int tap = rem / nch, c = rem % nch;
  const int ch0 = g * kGroupCh + c * 16 + 8 * kh;
  const int n = 8 * nb + r;
  const __nv_bfloat16* src = w + ((size_t)tap * Cin) * N + n;
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ch = ch0 + 2 * q;
    const uint32_t lo = ch < Cin ? __bfloat16_as_ushort(src[(size_t)ch * N]) : 0u;
    const uint32_t hi = ch + 1 < Cin ? __bfloat16_as_ushort(src[(size_t)(ch + 1) * N]) : 0u;
    v[q] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(out + u * 8) = make_uint4(v[0], v[1], v[2], v[3]);
}

// The haloed tile ((kCellRows + K - 1) x (kCellCols + K - 1) pixels, pixel
// stride cp + 8) of channels [c0, c0 + cp) of image b (xh_b), by copies of
// vec channels: 16-byte cp.async for vec 8, 8- and 4-byte for 4 and 2, one
// element at a time for 1; zero outside the frame and past Cin.
template <int K>
__device__ __forceinline__ void stage_halo(
    const __nv_bfloat16* __restrict__ xh_b, __nv_bfloat16* halo, int H, int W, int Cin,
    int cp, int vec, int c0, int row0, int col0, int tid) {
  constexpr int P = K / 2;
  constexpr int kHaloW = kCellCols + K - 1;
  constexpr int kHaloPix = (kCellRows + K - 1) * kHaloW;
  const int ps = cp + 8;
  const int cend = min(Cin, c0 + kGroupCh);
  const int units = cp / vec;
  for (int e = tid; e < kHaloPix * units; e += kCellConsumers) {
    const int pix = e / units, u = e - pix * units;
    const int y = row0 - P + pix / kHaloW;
    const int x = col0 - P + pix % kHaloW;
    const int ch = c0 + u * vec;
    const bool ok = y >= 0 && y < H && x >= 0 && x < W && ch < cend;
    const __nv_bfloat16* src = ok ? xh_b + ((size_t)y * W + x) * Cin + ch : xh_b;
    __nv_bfloat16* dst = halo + pix * ps + u * vec;
    if (vec == 8) cp_async16(dst, src, ok);
    else if (vec == 4) cp_async8(dst, src, ok);
    else if (vec == 2) cp_async4(dst, src, ok);
    else *dst = ok ? *src : __float2bfloat16(0.0f);
  }
}

// ---- the input as two parts ---------------------------------------------------

// How one of the two tensors that B1's plain mode may read in place of xh
// reaches the halo (plan_parts).  The two-part kernel takes one channel
// group (Cin <= kGroupCh) and stages it before the accumulators are live.
//   kDirect  bf16 with unit channel stride: cp.async of vec channels, as
//            stage_halo copies xh;
//   kF32     f32 with unit channel stride: cp.async of vec floats into the
//            part's scratch [halo pixel][ch], rounded into the halo once
//            landed;
//   kPlanes  bf16 with unit column stride and another channel stride (a
//            channels-first frame): cp.async of column pairs into the part's
//            scratch [channel][halo row][kHaloW + 2 columns from an even
//            one], moved into the halo once landed;
//   kRegs    f32 with unit channel stride whose scratch would cost the
//            launch a block per SM: loads of 4 floats through registers,
//            16 floats in flight per thread, rounded as they are stored.
// A part that takes none of them (a bf16 part with an odd channel count
// or offset, an f32 or odd-strided channels-first one) is refused, and
// the caller concatenates the pair.  Every f32 value is rounded with
// __float2bfloat16 (to nearest even, as .to(torch.bfloat16) rounds).
enum PartMode { kDirect = 0, kF32 = 1, kPlanes = 2, kRegs = 3 };

struct HaloPart {
  const void* p;             // element (b, y, x, c) at p + b*sb + y*sy + x*sx + c*sc
  long long sb, sy, sx, sc;  // element strides
  int ch;                    // channels
  int f32;                   // 1: f32, 0: bf16
  int mode, vec;             // PartMode; channels one copy or load moves
  int soff;                  // its scratch's byte offset past the halo
};

// The two-part kernel's input: channels [0, part[0].ch) come from part[0]
// (x), the next part[1].ch from part[1] (h)
struct HaloParts {
  HaloPart part[2];
};

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// two f32 rounded to a bf16 pair, lo in the low half (cvt.rn.bf16x2.f32:
// each as __float2bfloat16 rounds it)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4-byte asynchronous copy of which the first `bytes` (0, 2 or 4) are read
// and the rest zero-filled
__device__ __forceinline__ void cp_async4_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// A consumer thread's items e = tid, tid + kCellConsumers, ... of `units`
// a halo pixel, walked as (pixel, unit) with e = pix * units + u: one
// division at the start, none per item.
struct Walk {
  int pix, u, units, dp, du;
  __device__ __forceinline__ Walk(int tid, int n) : units(n) {
    pix = tid / n;
    u = tid - pix * n;
    dp = kCellConsumers / n;
    du = kCellConsumers - dp * n;
  }
  __device__ __forceinline__ void next() {
    pix += dp;
    u += du;
    if (u >= units) {
      u -= units;
      ++pix;
    }
  }
};

// A kRegs part into the halo from dst0 on, 4 floats an item: the loads of
// 4 items are issued before the first is stored; pairs: dst0 is on an
// even channel.
template <int K>
__device__ __forceinline__ void regs_part(const HaloPart& q, __nv_bfloat16* dst0, bool pairs,
                                          int b, int H, int W, int ps, int row0, int col0,
                                          int tid) {
  constexpr int P = K / 2;
  constexpr int kHaloW = kCellCols + K - 1;
  constexpr int kHaloPix = (kCellRows + K - 1) * kHaloW;
  constexpr int R = 4;
  const float* base = static_cast<const float*>(q.p) + b * q.sb;
  Walk w(tid, q.ch / 4);
  while (w.pix < kHaloPix) {
    float4 v[R];
    Walk at = w;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = row0 - P + at.pix / kHaloW;
      const int x = col0 - P + at.pix % kHaloW;
      const bool ok = at.pix < kHaloPix && y >= 0 && y < H && x >= 0 && x < W;
      const float* s = base + y * q.sy + x * q.sx + at.u * 4;
      v[r] = ok ? __ldg(reinterpret_cast<const float4*>(s)) : make_float4(0, 0, 0, 0);
      at.next();
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (w.pix < kHaloPix) {
        __nv_bfloat16* d = dst0 + w.pix * ps + w.u * 4;
        if (pairs) {
          *reinterpret_cast<uint32_t*>(d) = bf16_pair(v[r].x, v[r].y);
          *reinterpret_cast<uint32_t*>(d + 2) = bf16_pair(v[r].z, v[r].w);
        } else {
          const float f[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<unsigned short*>(d + j) = (unsigned short)bf16_bits(f[j]);
        }
      }
      w.next();
    }
  }
}

// The halo of the input [x; h] (Cin <= kGroupCh) from its two parts, each
// channel where stage_halo would have put xh's, zero outside the frame
// and past Cin, landed and every consumer warp past it: the asynchronous
// copies first (kDirect into the halo, kF32 and kPlanes into their
// scratch), the loads through registers while they fly, then, once they
// have landed, each scratch into the halo (kF32 a pixel's channels per
// warp, kPlanes a row's pixels per warp, each reading its scratch along
// its rows), as bf16 pairs where the part starts on an even channel and
// has an even count.
template <int K>
__device__ __forceinline__ void stage_parts(const HaloParts& src, __nv_bfloat16* halo,
                                            unsigned char* scratch, int b, int H, int W,
                                            int Cin, int cp, int row0, int col0, int tid) {
  constexpr int P = K / 2;
  constexpr int kHaloW = kCellCols + K - 1;
  constexpr int kHaloH = kCellRows + K - 1;
  constexpr int kHaloPix = kHaloH * kHaloW;
  constexpr int kPairs = kHaloW / 2 + 1;  // column pairs from an even column
  constexpr int kPlaneW = 2 * kPairs;
  const int ps = cp + 8;
  const int x0 = (col0 - P) & ~1;  // the planes' first column
  bool convert = false;
#pragma unroll
  for (int i = 0, off = 0; i < 2; off += src.part[i].ch, ++i) {
    const HaloPart& q = src.part[i];
    if (q.mode == kDirect || q.mode == kF32) {
      const int v = q.vec, esz = q.f32 ? 4 : 2, bytes = v * esz;
      const char* base = static_cast<const char*>(q.p) + b * q.sb * esz;
      for (Walk w(tid, q.ch / v); w.pix < kHaloPix; w.next()) {
        const int y = row0 - P + w.pix / kHaloW;
        const int x = col0 - P + w.pix % kHaloW;
        const bool ok = y >= 0 && y < H && x >= 0 && x < W;
        const char* s = ok ? base + (y * q.sy + x * q.sx + w.u * v) * esz : base;
        void* d = q.mode == kDirect
                      ? static_cast<void*>(halo + off + w.pix * ps + w.u * v)
                      : static_cast<void*>(reinterpret_cast<float*>(scratch + q.soff) +
                                           w.pix * q.ch + w.u * v);
        if (bytes == 16) cp_async16(d, s, ok);
        else if (bytes == 8) cp_async8(d, s, ok);
        else cp_async4(d, s, ok);
      }
      convert |= q.mode == kF32;
    } else if (q.mode == kPlanes) {
      const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(q.p) + b * q.sb;
      __nv_bfloat16* plane = reinterpret_cast<__nv_bfloat16*>(scratch + q.soff);
      for (int e = tid; e < q.ch * kHaloH * kPairs; e += kCellConsumers) {
        const int pr = e % kPairs, t = e / kPairs;
        const int r = t % kHaloH, c = t / kHaloH;
        const int y = row0 - P + r, x = x0 + 2 * pr;
        const int bytes = y >= 0 && y < H && x >= 0 ? 2 * min(2, max(0, W - x)) : 0;
        const __nv_bfloat16* s = bytes ? base + y * q.sy + x + c * q.sc : base;
        cp_async4_n(plane + (c * kHaloH + r) * kPlaneW + 2 * pr, s, bytes);
      }
      convert = true;
    }
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0, off = 0; i < 2; off += src.part[i].ch, ++i)
    if (src.part[i].mode == kRegs)
      regs_part<K>(src.part[i], halo + off, off % 2 == 0, b, H, W, ps, row0, col0, tid);
  const int nz = cp - Cin;  // the channels past Cin
  for (int e = tid; e < kHaloPix * nz; e += kCellConsumers) {
    const int pix = e / nz;
    *reinterpret_cast<unsigned short*>(halo + pix * ps + Cin + (e - pix * nz)) = 0;
  }
  cp_async_wait<0>();
  consumers_sync();
  if (!convert) return;
  const int xs = (col0 - P) - x0;  // the halo's first column in the planes
#pragma unroll
  for (int i = 0, off = 0; i < 2; off += src.part[i].ch, ++i) {
    const HaloPart& q = src.part[i];
    __nv_bfloat16* dst0 = halo + off;
    const int w = (off | q.ch) % 2 == 0 ? 2 : 1;
    if (q.mode == kF32) {
      const float* f = reinterpret_cast<const float*>(scratch + q.soff);
      for (Walk it(tid, q.ch / w); it.pix < kHaloPix; it.next()) {
        const int c = it.u * w;
        const float* s = f + it.pix * q.ch + c;
        if (w == 2)
          *reinterpret_cast<uint32_t*>(dst0 + it.pix * ps + c) = bf16_pair(s[0], s[1]);
        else
          *reinterpret_cast<unsigned short*>(dst0 + it.pix * ps + c) =
              (unsigned short)bf16_bits(s[0]);
      }
    } else if (q.mode == kPlanes) {
      const unsigned short* plane = reinterpret_cast<const unsigned short*>(scratch + q.soff);
      for (int e = tid; e < kHaloPix * (q.ch / w); e += kCellConsumers) {
        const int pix = e % kHaloPix, c = (e / kHaloPix) * w;
        const unsigned short* s =
            plane + (c * kHaloH + pix / kHaloW) * kPlaneW + xs + pix % kHaloW;
        if (w == 2)
          *reinterpret_cast<uint32_t*>(dst0 + pix * ps + c) =
              (uint32_t)s[0] | (uint32_t)s[kHaloH * kPlaneW] << 16;
        else
          *reinterpret_cast<unsigned short*>(dst0 + pix * ps + c) = s[0];
      }
    }
  }
  consumers_sync();
}

// NT = hid / 8.  kParts: the input (one channel group) is read from
// `parts` (B1's two-part launch), else from xh; an instantiation of its
// own, so the staging of the one adds nothing to the registers of the
// other.
template <int K, int NT, class Epi, bool kParts>
__global__ void __launch_bounds__(kCellThreads, 1)
cell_wgmma_kernel(const __nv_bfloat16* __restrict__ xh,
                  const __nv_bfloat16* __restrict__ wpack,
                  const float* __restrict__ bias, const Epi epi, int H, int W,
                  int Cin, int vec, int cp, int steps, int ks, int ring,
                  const HaloParts parts) {
  constexpr int hid = NT * 8;
  constexpr int N = 4 * hid;
  constexpr int P = K / 2;
  constexpr int kHaloW = kCellCols + K - 1;
  constexpr int kHaloPix = (kCellRows + K - 1) * kHaloW;
  constexpr int kStepBytes = N * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);  // full[kRing], then empty[kRing]
  const uint32_t ring_u32 = bars + kRingOffset;
  const int stage_bytes = ks * kStepBytes;
  __nv_bfloat16* halo =
      reinterpret_cast<__nv_bfloat16*>(smem + kRingOffset + ring * stage_bytes);
  const int ps = cp + 8;  // bf16 per halo pixel: 16 * odd bytes, no ldmatrix conflicts
  const int n_stages = (steps + ks - 1) / ks;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(bars + 8 * i, 1);                       // the local producer
      mbar_init(bars + 8 * (kRing + i), 8);             // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kCellRows;
  const int col0 = blockIdx.x * kCellCols;

  if (tid >= kCellConsumers) {
    // producer: one thread keeps the ring full
    if (tid == kCellConsumers) {
      const char* src = reinterpret_cast<const char*>(wpack);
      for (int st = 0; st < n_stages; ++st) {
        const int slot = st % ring;
        if (st >= ring) mbar_wait(bars + 8 * (kRing + slot), ((st / ring) - 1) & 1);
        const uint32_t bytes = (uint32_t)(min(ks, steps - st * ks) * kStepBytes);
        mbar_expect_tx(bars + 8 * slot, bytes);
        bulk_copy(ring_u32 + slot * stage_bytes, src + (size_t)st * stage_bytes, bytes,
                  bars + 8 * slot);
      }
    }
    __syncwarp();
  } else {
    const int lane = tid & 31;
    const int cw = tid >> 5;          // consumer warp 0..7
    const int rl = cw;                // its tile row: warpgroup cw / 4 owns rows 4(cw/4)..
    const int grp = lane >> 2, q = lane & 3;
    const __nv_bfloat16* xh_b = kParts ? nullptr : xh + (size_t)b * H * W * Cin;
    // ldmatrix.x4 rows: matrix lane / 8 = (pixels 0-7 | 8-15) x (channels 0-7 | 8-15)
    const int a_off = (rl * kHaloW + (lane & 7) + 8 * ((lane >> 3) & 1)) * ps + 8 * (lane >> 4);
    // the two parts' one group, staged before the accumulators are live;
    // the parts' scratch follows the halo (plan_parts)
    if constexpr (kParts)
      stage_parts<K>(parts, halo, reinterpret_cast<unsigned char*>(halo + kHaloPix * ps), b, H,
                     W, Cin, cp, row0, col0, tid);

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;

    int slot = 0, in = 0, rel_slot = 0, tap = 0, c = 0, nch = 0;
    uint32_t phase = 0;
    bool release = false;
    const uint64_t desc0 = (uint64_t)((kLbo >> 4) & 0x3FFF) << 16 |
                           (uint64_t)((kSbo >> 4) & 0x3FFF) << 32 |
                           (uint64_t)((ring_u32 >> 4) & 0x3FFF);
    uint32_t a0[4], a1[4];
    // one k16 step: A of (tap, chunk c) from the halo, B from the ring
    auto step = [&](uint32_t (&a)[4]) {
      if (in == 0) mbar_wait(bars + 8 * slot, phase);
      const int dy = tap / K, dx = tap % K;
      ldmatrix_x4(a, halo + a_off + (dy * kHaloW + dx) * ps + 16 * c);
      wgmma_fence();
      WgmmaRS<N>::mma(acc, a, desc0 + (uint64_t)((slot * stage_bytes + in * kStepBytes) >> 4));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step is done: its A registers and stage are free
      if (release) {
        if (lane == 0) mbar_arrive(bars + 8 * (kRing + rel_slot));
        release = false;
      }
      if (++in == ks) {
        in = 0;
        release = true;
        rel_slot = slot;
        if (++slot == ring) { slot = 0; phase ^= 1; }
      }
      if (++c == nch) { c = 0; ++tap; }
    };

    for (int g = 0; g * kGroupCh < Cin; ++g) {
      // stage the haloed tile of this channel group: zero outside the frame
      // and past Cin, by the widest copy Cin and xh's alignment allow (the
      // two parts' one group is staged above)
      if constexpr (!kParts) {
        if (g > 0) consumers_sync();  // every warp is done with the last group's halo
        const int c0 = g * kGroupCh;
        stage_halo<K>(xh_b, halo, H, W, Cin, cp, vec, c0, row0, col0, tid);
        cp_async_commit();
        cp_async_wait<0>();
        consumers_sync();
      }

      nch = cell_chunks(Cin, g);
      tap = 0;
      c = 0;
      const int n = K * K * nch;
      for (int t = 0; t < n; t += 2) {
        step(a0);
        if (t + 1 < n) step(a1);
      }
      wgmma_wait<0>();  // the next group starts again from a0
    }

    // epilogue: warp cw holds pixels (row0 + rl, col0 + grp + 8h) and, in
    // n8 tile i of N, columns 8i + 2q + {0, 1}; the gates of channels
    // j, j + 1 = 8i' + 2q + {0, 1} sit in tiles i' + g*NT, g = i, f, g, o
    float* red = reinterpret_cast<float*>(smem + kRingOffset);  // [8][N], reusing the ring
    if constexpr (Epi::kReduce) consumers_sync();  // every wgmma has read the ring
    const int r = row0 + rl;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int j = 8 * i + 2 * q;
      float sum[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + grp + 8 * h;
        float p[2][4];
#pragma unroll
        for (int gt = 0; gt < 4; ++gt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            p[e][gt] = acc[4 * (i + gt * NT) + 2 * h + e] + bias[gt * hid + j + e];
        if (r < H && col < W) epi.apply2(((size_t)b * H + r) * W + col, j, p, sum);
      }
      if constexpr (Epi::kReduce) {
        // lanes of one q differ in grp (bits 2-4 of the lane): fixed butterfly
#pragma unroll
        for (int gt = 0; gt < 4; ++gt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = sum[e][gt];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (grp == 0) red[cw * N + gt * hid + j + e] = v;
          }
      }
    }
    if constexpr (Epi::kReduce) {
      consumers_sync();
      float* out = epi.db_part + block_index() * N;
      for (int t = tid; t < N; t += kCellConsumers) {
        float v = red[t];
#pragma unroll
        for (int w8 = 1; w8 < 8; ++w8) v += red[w8 * N + t];
        out[t] = v;
      }
    }
  }
}

// ---- planning and launching --------------------------------------------------

struct CellLaunch {
  dim3 grid;
  int threads = 0;
  size_t smem = 0;
  int tile_h = 0;      // FP32 pipes: output rows per block
  bool wgmma = false;  // the bf16 mainloop above
  int vec = 0, cp = 0, steps = 0, ks = 0, ring = 0;
  long long pack_elems = 0;  // bf16 of the packed weights (caller's workspace)
  long long pack_floats() const { return (pack_elems / 2 + 3) / 4 * 4; }
};

// bf16 with hid in {8, 16, 32, 64} takes the wgmma mainloop (any Cin, any
// alignment: xh's alignment only picks the halo copy width); everything
// else the FP32 pipes.  Returns false for shapes no kernel takes.  A null
// xh plans as if it were 16-byte aligned.
inline bool plan_cell(bool bf16, const void* xh, int B, int H, int W, int Cin,
                      int hid, int k, bool reduce, CellLaunch* out) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || Cin < 1 || hid < 1 ||
      hid * kGroupsW > kMaxThreads || (k != 1 && k != 3 && k != 5 && k != 7))
    return false;
  CellLaunch L;
  L.wgmma = bf16 && (hid == 8 || hid == 16 || hid == 32 || hid == 64);
  if (L.wgmma) {
    const int N = 4 * hid;
    L.grid = dim3((W + kCellCols - 1) / kCellCols, (H + kCellRows - 1) / kCellRows, B);
    L.threads = kCellThreads;
    const uintptr_t a = reinterpret_cast<uintptr_t>(xh);
    L.vec = 1;
    for (int v = 8; v > 1; v /= 2)
      if (Cin % v == 0 && a % (2 * v) == 0) { L.vec = v; break; }
    L.cp = (std::min(Cin, kGroupCh) + 15) / 16 * 16;
    L.steps = cell_steps(Cin, k);
    L.ks = kStageBytes / (N * 32);
    const int n_stages = (L.steps + L.ks - 1) / L.ks;
    L.ring = std::min(kRing, n_stages);
    const size_t halo = (size_t)(kCellRows + k - 1) * (kCellCols + k - 1) * (L.cp + 8) * 2;
    L.smem = kRingOffset + (size_t)L.ring * L.ks * N * 32 + halo;
    L.pack_elems = (long long)L.steps * N * 16;
  } else {
    L.tile_h = std::max(1, std::min(8, kMaxThreads / (hid * kGroupsW)));
    L.threads = hid * kGroupsW * L.tile_h;
    L.grid = dim3((W + kTileW - 1) / kTileW, (H + L.tile_h - 1) / L.tile_h, B);
    L.smem = (size_t)(L.tile_h + k - 1) * (kTileW + k - 1) * kStride *
             sizeof(float);
    if (reduce) L.smem = std::max(L.smem, (size_t)L.threads * 4 * sizeof(float));
  }
  if (L.grid.y > 65535) return false;
  *out = L;
  return true;
}

// A part's route and copy width when its first channel is channel `off`
// of the input; false where it takes none.  A copy of vec channels needs
// vec to divide the part's channels, address and strides; a kDirect copy
// lands at channel off + c of the halo, so vec divides off too.
inline bool plan_part(HaloPart& q, int off) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(q.p);
  q.vec = 1;
  q.soff = 0;
  if (q.sc == 1) {
    const int esz = q.f32 ? 4 : 2;
    for (int v = q.f32 ? 4 : 8; v > 1; v /= 2) {
      if (q.ch % v == 0 && a % (esz * v) == 0 && q.sb % v == 0 && q.sy % v == 0 &&
          q.sx % v == 0 && (q.f32 || off % v == 0)) {
        q.vec = v;
        break;
      }
    }
    q.mode = q.f32 ? kF32 : kDirect;
    return q.f32 || q.vec > 1;  // no 2-byte cp.async
  }
  q.mode = kPlanes;
  q.vec = 2;
  return !q.f32 && q.sx == 1 && q.sb % 2 == 0 && q.sy % 2 == 0 && q.sc % 2 == 0 && a % 4 == 0;
}

inline size_t part_scratch_bytes(const HaloPart& q, int k) {
  const size_t hr = kCellRows + k - 1, hc = kCellCols + k - 1;
  const size_t bytes = q.mode == kF32      ? (size_t)q.ch * hr * hc * 4
                       : q.mode == kPlanes ? (size_t)q.ch * hr * (hc + 2) * 2
                                           : 0;
  return (bytes + 15) / 16 * 16;
}

// Both parts' routes (Cin <= kGroupCh); their scratch follows the halo in
// L's shared memory, which may grow to `budget` (parts_smem_budget).  Past
// it the kF32 part of 4-float copies with the smaller scratch, then the
// other, loads through registers (kRegs).  False where a part takes no
// route, or the scratch that remains does not fit.
inline bool plan_parts(HaloParts& s, CellLaunch& L, int k, size_t budget) {
  if (!plan_part(s.part[0], 0) || !plan_part(s.part[1], s.part[0].ch)) return false;
  size_t b0, b1;
  for (;;) {
    b0 = part_scratch_bytes(s.part[0], k);
    b1 = part_scratch_bytes(s.part[1], k);
    if (b0 + b1 == 0 || L.smem + b0 + b1 <= std::min(budget, (size_t)kMaxSmem)) break;
    const bool r0 = s.part[0].mode == kF32 && s.part[0].vec == 4;
    const bool r1 = s.part[1].mode == kF32 && s.part[1].vec == 4;
    if (!r0 && !r1) return false;
    s.part[r0 && (!r1 || b0 <= b1) ? 0 : 1].mode = kRegs;
  }
  s.part[1].soff = (int)b0;
  L.smem += b0 + b1;
  return true;
}

// The most shared memory the two-part launch of these shapes may take and
// still run as many blocks per SM as the launch on xh, which takes
// xh_smem: from the card's occupancy calculator and its shared memory per
// SM.  kMaxSmem where the two-part kernel's registers allow fewer blocks
// anyway, or the card cannot tell.  Worked out once per xh_smem.
template <int K, int NT, class Epi>
size_t parts_smem_budget(size_t xh_smem) {
  static size_t key = 0, memo = 0;
  if (key == xh_smem) return memo;
  const auto xk = cell_wgmma_kernel<K, NT, Epi, false>;
  const auto pk = cell_wgmma_kernel<K, NT, Epi, true>;
  int dev = 0, per_sm = 0, reserved = 0, n_xh = 0, n_regs = 0;
  size_t out = kMaxSmem;
  if (cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) ==
          cudaSuccess &&
      cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) ==
          cudaSuccess &&
      cudaFuncSetAttribute(xk, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) ==
          cudaSuccess &&
      cudaFuncSetAttribute(pk, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_xh, xk, kCellThreads, xh_smem) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_regs, pk, kCellThreads, 0) ==
          cudaSuccess &&
      n_xh > 0 && n_regs >= n_xh)
    out = std::min((size_t)kMaxSmem, (size_t)(per_sm / n_xh - reserved));
  cudaGetLastError();  // a failed query leaves no error for the next launch
  key = xh_smem;
  memo = out;
  return out;
}

template <int K, int NT, class Epi, bool kParts>
int launch_cell_wgmma_k(const CellLaunch& L, const __nv_bfloat16* x,
                        const __nv_bfloat16* wpack, const float* bb,
                        const Epi& epi, int H, int W, int Cin, cudaStream_t s,
                        const HaloParts& parts) {
  auto kernel = cell_wgmma_kernel<K, NT, Epi, kParts>;
  // once per kernel, to the card's most, so a CUDA graph capture makes no
  // attribute call
  static int ready = 0;
  if (!ready) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err) return err;
    ready = 1;
  }
  if (L.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  kernel<<<L.grid, kCellThreads, L.smem, s>>>(x, wpack, bb, epi, H, W, Cin, L.vec, L.cp,
                                              L.steps, L.ks, L.ring, parts);
  return (int)cudaGetLastError();
}

template <int K, class Epi, bool kParts>
int launch_cell_wgmma(const CellLaunch& L, const __nv_bfloat16* x,
                      const __nv_bfloat16* wpack, const float* bb, const Epi& epi,
                      int H, int W, int Cin, int hid, cudaStream_t s,
                      const HaloParts& parts) {
  switch (hid) {
    case 8: return launch_cell_wgmma_k<K, 1, Epi, kParts>(L, x, wpack, bb, epi, H, W, Cin, s, parts);
    case 16: return launch_cell_wgmma_k<K, 2, Epi, kParts>(L, x, wpack, bb, epi, H, W, Cin, s, parts);
    case 32: return launch_cell_wgmma_k<K, 4, Epi, kParts>(L, x, wpack, bb, epi, H, W, Cin, s, parts);
    case 64: return launch_cell_wgmma_k<K, 8, Epi, kParts>(L, x, wpack, bb, epi, H, W, Cin, s, parts);
    default: return (int)cudaErrorInvalidValue;
  }
}

// w's packed image for the wgmma mainloop into `out` (pack_elems bf16,
// 16-byte aligned), for any B, H and W.
inline int pack_cell_weights(const void* w, void* out, int Cin, int hid, int k,
                             cudaStream_t s) {
  CellLaunch L;
  if (!plan_cell(true, nullptr, 1, 1, 1, Cin, hid, k, false, &L) || !L.wgmma ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const long long units = L.pack_elems / 8;
  pack_cell_weights_kernel<<<(unsigned)((units + 255) / 256), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), k, Cin,
      4 * hid, units);
  return (int)cudaGetLastError();
}

template <typename T, int K, class Epi>
int launch_cell_fp32_k(const CellLaunch& L, const T* x, const T* wt,
                       const float* bb, const Epi& epi, int H, int W, int Cin,
                       int hid, cudaStream_t s) {
  cell_fp32_kernel<T, K, Epi><<<L.grid, L.threads, L.smem, s>>>(
      x, wt, bb, epi, H, W, Cin, hid, L.tile_h);
  return (int)cudaGetLastError();
}

// One launch of the gate conv with epilogue `epi`, on the kernel `L` names:
// the wgmma mainloop reads the packed weights `wpack` (pack_cell_weights,
// 16-byte aligned), the FP32 pipes `w`.  kParts (the wgmma mainloop only,
// one channel group): the input is read from `parts` and xh is unused.
template <typename T, class Epi, bool kParts = false>
int launch_cell(const CellLaunch& L, const void* xh, const void* w,
                const void* wpack, const void* b, const Epi& epi, int H, int W,
                int Cin, int hid, int k, void* stream,
                const HaloParts& parts = HaloParts{}) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bb = static_cast<const float*>(b);
  if (kParts && Cin > kGroupCh) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (L.wgmma) {
      const auto* x = static_cast<const __nv_bfloat16*>(xh);
      const auto* wp = static_cast<const __nv_bfloat16*>(wpack);
      if (wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16) return (int)cudaErrorInvalidValue;
      switch (k) {
        case 1: return launch_cell_wgmma<1, Epi, kParts>(L, x, wp, bb, epi, H, W, Cin, hid, s, parts);
        case 3: return launch_cell_wgmma<3, Epi, kParts>(L, x, wp, bb, epi, H, W, Cin, hid, s, parts);
        case 5: return launch_cell_wgmma<5, Epi, kParts>(L, x, wp, bb, epi, H, W, Cin, hid, s, parts);
        case 7: return launch_cell_wgmma<7, Epi, kParts>(L, x, wp, bb, epi, H, W, Cin, hid, s, parts);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
  if (L.wgmma || kParts) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xh);
  const T* wt = static_cast<const T*>(w);
  switch (k) {
    case 1: return launch_cell_fp32_k<T, 1>(L, x, wt, bb, epi, H, W, Cin, hid, s);
    case 3: return launch_cell_fp32_k<T, 3>(L, x, wt, bb, epi, H, W, Cin, hid, s);
    case 5: return launch_cell_fp32_k<T, 5>(L, x, wt, bb, epi, H, W, Cin, hid, s);
    case 7: return launch_cell_fp32_k<T, 7>(L, x, wt, bb, epi, H, W, Cin, hid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace niswan
