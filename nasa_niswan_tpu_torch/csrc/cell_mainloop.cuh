// The ConvLSTM gate conv as an implicit GEMM, shared by the fused cell
// forward (convlstm_cell.cu) and the fused cell backward (cell_bwd.cu).
//
//   gates = conv_same(xh, w) + b      xh (B,H,W,Cin), w (k,k,Cin,4*hid) HWIO
//
// Two mainloops compute the gates and hand each (pixel, hidden channel j)
// its four pre-activation gates (i, f, g, o) in registers; an epilogue
// functor decides what to do with them:
//
//   struct Epi {
//     static constexpr bool kReduce;     // also reduce 4 sums over the block
//     float* db_part;                    // [block][4*hid], when kReduce
//     __device__ void apply(size_t pix, int j, float i, float f, float g,
//                           float o, float (&sum)[4]) const;
//   };
//
// `pix` is the flat NHWC pixel index (b*H + row)*W + col.  With kReduce the
// kernel sums each thread's `sum` over the block's pixels in a fixed order
// and writes one row of 4*hid partial sums per block, so a second pass can
// finish the sum without atomics and reruns stay bit-identical.
//
//  * cell_fp32_kernel (any operand type T, hid <= 128, FP32 pipes): one block
//    per (batch, row tile, 16-column tile); each thread owns one hidden
//    channel j and kPix = 4 consecutive columns and keeps the four gate
//    accumulators (j, hid+j, 2hid+j, 3hid+j) of each pixel in registers; the
//    haloed input tile is staged in shared memory (as f32) in chunks of
//    kChunk input channels, so shared memory stays under 48 KB for any Cin
//    (41 KB at most, k = 7) and the ragged channel tail is the last chunk.
//  * cell_mma_kernel (bf16 operands, hid in {8, 16, 32, 64}, tensor cores,
//    mma.sync m16n8k16 with f32 accumulate): M = pixels, N = 4*hid gate
//    columns, K = k*k*Cin.  A block computes an 8-row (hid 64) or 4-row x
//    16-column pixel tile and all N columns with 16 or 8 warps: 4 or 2 along
//    M (two 16-pixel rows each) x 4 along N (hid columns each).  Per chunk of 32 input channels the haloed
//    input tile is staged once; per (chunk, tap) the 32 x N weight slice is
//    staged with its columns interleaved as n = 4*j + g, so that an m16n8
//    accumulator holds gates (i, f) of channel j in even lanes and (g, o) in
//    odd lanes: one shuffle with the neighbouring lane gives each thread all
//    four gates of one (pixel, j).  A fragments are read straight from the
//    staged halo tile (the implicit GEMM's im2col).  Shared-memory rows are
//    padded to 40 bf16 so fragment loads are free of bank conflicts.
//
// The SAME zero padding is applied at every frame edge by the tile loaders.

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

constexpr int kMmaCols = 16;              // output columns per block (m16)
constexpr int kMmaChunk = 32;             // input channels per stage
constexpr int kMmaStride = kMmaChunk + 8; // bf16 per staged row

// Output rows per block of the tensor-core kernel, by NT = hid / 8: the
// 32 x 256 weight slice of hid 64 is amortized over 8 rows (measured faster
// at B = 1 and 8); the narrower layers keep 4 rows, and enough blocks.
__host__ __device__ constexpr int mma_rows(int nt) { return nt == 8 ? 8 : 4; }
// two rows per warp along M, 4 warps along N
__host__ __device__ constexpr int mma_threads(int nt) { return 32 * (mma_rows(nt) / 2) * 4; }

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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// NT = hid / 8: the n8 tiles of one warp's hid columns.
template <int K, int NT, class Epi>
__global__ void __launch_bounds__(mma_threads(NT))
cell_mma_kernel(const __nv_bfloat16* __restrict__ xh,
                const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ bias, const Epi epi, int H, int W,
                int Cin) {
  constexpr int hid = NT * 8;
  constexpr int N = 4 * hid;
  constexpr int P = K / 2;
  constexpr int kRows = mma_rows(NT);
  constexpr int kWarpsM = kRows / 2;
  constexpr int kThreads = mma_threads(NT);
  constexpr int kHaloW = kMmaCols + K - 1;
  constexpr int kHaloPixels = (kRows + K - 1) * kHaloW;
  __shared__ __align__(16) __nv_bfloat16 a_tile[kHaloPixels * kMmaStride];
  __shared__ __align__(16) __nv_bfloat16 b_tile[N * kMmaStride];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;  // tile rows 2*wm, 2*wm + 1
  const int wn = warp & 3;   // interleaved columns [wn*hid, (wn+1)*hid)
  const int grp = lane >> 2, quad = lane & 3;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kMmaCols;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const __nv_bfloat16* xh_b = xh + (size_t)b * H * W * Cin;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kMmaChunk) {
    const int cn = min(kMmaChunk, Cin - ci0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int e = threadIdx.x; e < kHaloPixels * kMmaChunk; e += kThreads) {
      const int cc = e % kMmaChunk;
      const int pix = e / kMmaChunk;
      const int r = row0 - P + pix / kHaloW;
      const int col = col0 - P + pix % kHaloW;
      __nv_bfloat16 v = zero;
      if (cc < cn && r >= 0 && r < H && col >= 0 && col < W)
        v = xh_b[((size_t)r * W + col) * Cin + ci0 + cc];
      a_tile[pix * kMmaStride + cc] = v;
    }
    for (int tap = 0; tap < K * K; ++tap) {
      const int dy = tap / K, dx = tap % K;
      __syncthreads();  // the previous tap's weights are consumed
      // weight slice w[dy, dx, ci0 + cc, g*hid + j] -> b_tile[4*j + g][cc],
      // moved as 8 consecutive columns x 2 consecutive channels per item
      const __nv_bfloat16* wt = w + ((size_t)tap * Cin + ci0) * N;
      for (int e = threadIdx.x; e < (kMmaChunk / 2) * (N / 8);
           e += kThreads) {
        const int pair = e % (kMmaChunk / 2);
        const int col = (e / (kMmaChunk / 2)) * 8;
        const int cc = 2 * pair;
        uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
        if (cc < cn)
          lo = *reinterpret_cast<const uint4*>(wt + (size_t)cc * N + col);
        if (cc + 1 < cn)
          hi = *reinterpret_cast<const uint4*>(wt + (size_t)(cc + 1) * N + col);
        const __nv_bfloat16* l = reinterpret_cast<const __nv_bfloat16*>(&lo);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&hi);
        const int g = col / hid, j0 = col % hid;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          __nv_bfloat162 v;
          v.x = l[q];
          v.y = h[q];
          *reinterpret_cast<__nv_bfloat162*>(
              b_tile + (4 * (j0 + q) + g) * kMmaStride + cc) = v;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kMmaChunk; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* base =
              a_tile + ((wm * 2 + mt + dy) * kHaloW + dx) * kMmaStride + kk +
              quad * 2;
          a[mt][0] = ld_pair(base + grp * kMmaStride);
          a[mt][1] = ld_pair(base + (grp + 8) * kMmaStride);
          a[mt][2] = ld_pair(base + grp * kMmaStride + 8);
          a[mt][3] = ld_pair(base + (grp + 8) * kMmaStride + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* bb =
              b_tile + (wn * hid + nt * 8 + grp) * kMmaStride + kk + quad * 2;
          const uint32_t b0 = ld_pair(bb), b1 = ld_pair(bb + 8);
          mma_bf16(acc[0][nt], a[0], b0, b1);
          mma_bf16(acc[1][nt], a[1], b0, b1);
        }
      }
    }
  }

  // accumulator (row, n): d0,d1 -> (grp, 2*quad + {0,1}); d2,d3 -> (grp + 8,
  // same).  n = 4*j + g, so even lanes hold gates (i, f), odd lanes (g, o).
  const bool odd = lane & 1;
  float sum[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int g = 0; g < 4; ++g) sum[nt][g] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = row0 + wm * 2 + mt;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* d = acc[mt][nt];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
      const int col = col0 + grp + (odd ? 8 : 0);
      const int j = (wn * hid + nt * 8) / 4 + quad / 2;
      if (r >= H || col >= W) continue;
      const size_t pix = ((size_t)b * H + r) * W + col;
      epi.apply(pix, j, (odd ? r0 : d[0]) + bias[j],
                (odd ? r1 : d[1]) + bias[hid + j],
                (odd ? d[2] : r0) + bias[2 * hid + j],
                (odd ? d[3] : r1) + bias[3 * hid + j], sum[nt]);
    }
  }
  if constexpr (Epi::kReduce) {
    // lanes holding channel j differ in bits 0, 2, 3, 4 of the lane index
    // (bit 1 picks j or j + 1): a butterfly over those bits, then the warps
    // along M in order, through shared memory that held the weight slices
    __syncthreads();  // every warp is done with b_tile
    float* red = reinterpret_cast<float*>(b_tile);  // [kWarpsM][N]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float v = sum[nt][g];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if ((lane & ~2) == 0)
          red[wm * N + g * hid + (wn * hid + nt * 8) / 4 + quad / 2] = v;
      }
    __syncthreads();
    float* out = epi.db_part + block_index() * N;
    for (int t = threadIdx.x; t < N; t += kThreads) {
      float v = red[t];
#pragma unroll
      for (int q = 1; q < kWarpsM; ++q) v += red[q * N + t];
      out[t] = v;
    }
  }
}

// ---- launch helpers ---------------------------------------------------------

struct CellLaunch {
  dim3 grid;
  int threads = 0;
  int tile_h = 0;
  size_t smem = 0;
  bool mma = false;
};

// The tensor-core kernel takes bf16 operands, hid in {8, 16, 32, 64} and a
// 16-byte aligned weight tensor; everything else runs on the FP32 pipes.
// Returns false for shapes no kernel takes.
inline bool plan_cell(bool bf16, const void* w, int B, int H, int W, int Cin,
                      int hid, int k, bool reduce, CellLaunch* out) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || Cin < 1 || hid < 1 ||
      hid * kGroupsW > kMaxThreads || (k != 1 && k != 3 && k != 5 && k != 7))
    return false;
  CellLaunch L;
  L.mma = bf16 && (hid == 8 || hid == 16 || hid == 32 || hid == 64) &&
          reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (L.mma) {
    const int rows = mma_rows(hid / 8);
    L.grid = dim3((W + kMmaCols - 1) / kMmaCols, (H + rows - 1) / rows, B);
    L.threads = mma_threads(hid / 8);
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

template <int K, class Epi>
int launch_cell_mma_k(const CellLaunch& L, const __nv_bfloat16* x,
                      const __nv_bfloat16* wt, const float* bb, const Epi& epi,
                      int H, int W, int Cin, int hid, cudaStream_t s) {
  switch (hid) {
    case 8:
      cell_mma_kernel<K, 1, Epi><<<L.grid, L.threads, 0, s>>>(x, wt, bb, epi, H, W, Cin);
      break;
    case 16:
      cell_mma_kernel<K, 2, Epi><<<L.grid, L.threads, 0, s>>>(x, wt, bb, epi, H, W, Cin);
      break;
    case 32:
      cell_mma_kernel<K, 4, Epi><<<L.grid, L.threads, 0, s>>>(x, wt, bb, epi, H, W, Cin);
      break;
    case 64:
      cell_mma_kernel<K, 8, Epi><<<L.grid, L.threads, 0, s>>>(x, wt, bb, epi, H, W, Cin);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// One launch of the gate conv with epilogue `epi`, on the kernel `L` names.
template <typename T, class Epi>
int launch_cell(const CellLaunch& L, const void* xh, const void* w,
                const void* b, const Epi& epi, int H, int W, int Cin, int hid,
                int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bb = static_cast<const float*>(b);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (L.mma) {
      const auto* x = static_cast<const __nv_bfloat16*>(xh);
      const auto* wt = static_cast<const __nv_bfloat16*>(w);
      switch (k) {
        case 1: return launch_cell_mma_k<1>(L, x, wt, bb, epi, H, W, Cin, hid, s);
        case 3: return launch_cell_mma_k<3>(L, x, wt, bb, epi, H, W, Cin, hid, s);
        case 5: return launch_cell_mma_k<5>(L, x, wt, bb, epi, H, W, Cin, hid, s);
        case 7: return launch_cell_mma_k<7>(L, x, wt, bb, epi, H, W, Cin, hid, s);
        default: return (int)cudaErrorInvalidValue;
      }
    }
  }
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
