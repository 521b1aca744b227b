// Fused ConvLSTM cell forward for Hopper (sm_90a), with a plain C interface
// (loaded with ctypes by nasa_niswan_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernel nasa_niswan_tpu/ops/convlstm_pallas2.py
// ::_cell_kernel_v2 in its plain mode (no hoisted input gates, no gate
// output).  One launch computes one cell step:
//
//   gates = conv_same(xh, w) + b        xh (B,H,W,Cin), w (k,k,Cin,4*hid) HWIO
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the gate blocks
//   c' = c * f + i * g,  h' = o * tanh(c')
//
// xh and w are bf16 or f32 (template T); c, b, h' and c' are f32 and every
// sum is taken in f32.  All tensors are dense NHWC / HWIO; the conv's SAME
// zero padding is applied at every frame edge by the tile loader.
//
// Two kernels compute it, both without atomics, so reruns are bit-identical:
//
//  * bf16 operands with hid in {8, 16, 32, 64} (the serving stack's 64/32/16)
//    run on the tensor cores (mma.sync m16n8k16, f32 accumulate) as an
//    implicit GEMM: M = pixels, N = 4*hid, K = k*k*Cin.  See the comment at
//    convlstm_cell_mma_kernel.
//  * everything else (f32 operands, other hidden sizes) runs on the FP32
//    pipes, convlstm_cell_kernel below: one block per (batch, row tile,
//    16-column tile); each thread owns one hidden channel j and kPix = 4
//    consecutive columns and keeps the four gate accumulators (j, hid+j,
//    2hid+j, 3hid+j) of each pixel in registers; the haloed input tile is
//    staged in shared memory (as f32) in chunks of kChunk input channels,
//    so shared memory stays under 48 KB for any Cin (41 KB at most, k = 7)
//    and the ragged channel tail is the last chunk; weights are read in
//    HWIO, where neighbouring j are neighbouring addresses.
//
// In both, the four gates of a (pixel, j) meet in one thread, so the state
// update is thread-local and the 4*hid gate tensor never reaches device
// memory.
//
// What bounds it: at the serving shapes (B=1, 100x154, layer 1 Cin=126,
// hid=64, k=5) the gate conv is an M=15,400 x N=256 x K=3,150 product, about
// 25 GFLOP of the step's 29, against ~17 MB of traffic: compute-bound on
// paper.  The FP32 kernel issues 4 weight loads and 4 shared loads per 16
// FMAs, so its load/store unit is the limit.  The tensor-core kernel
// restages a 32 x N weight slice from L2 for every (channel chunk, tap),
// ~400 MB of L2 reads per layer-1 step over 250 blocks, with two barriers
// per stage; that staging, not the mma rate, is its limit.  wgmma with
// TMA-fed, multi-stage tiles is the later, fast version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
convlstm_cell_kernel(const T* __restrict__ xh, const T* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ c, float* __restrict__ h_out,
                     float* __restrict__ c_out, int H, int W, int Cin,
                     int hid, int tile_h) {
  // [halo row][halo col][channel of the chunk], pixel stride kStride
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

  const int r = row0 + ty;
  if (r >= H) return;
  const float bi = bias[j], bf = bias[hid + j];
  const float bg = bias[2 * hid + j], bo = bias[3 * hid + j];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int col = col0 + tx0 + p;
    if (col >= W) break;
    const size_t o = (((size_t)b * H + r) * W + col) * hid + j;
    const float ig = sigmoid(acc[p][0] + bi);
    const float fg = sigmoid(acc[p][1] + bf);
    const float gg = tanhf(acc[p][2] + bg);
    const float og = sigmoid(acc[p][3] + bo);
    const float c_new = c[o] * fg + ig * gg;
    c_out[o] = c_new;
    h_out[o] = og * tanhf(c_new);
  }
}

// ---- bf16 tensor-core variant ----------------------------------------------
//
// The same cell as an implicit GEMM on the tensor cores: M = pixels, N =
// 4*hid gate columns, K = k*k*Cin, as mma.sync m16n8k16 (bf16 in, f32
// accumulate).  A block computes a 4-row x 16-column pixel tile and all N
// columns with 8 warps: 2 along M (two 16-pixel rows each) x 4 along N (hid
// columns each).  Per chunk of 32 input channels the haloed input tile is
// staged once; per (chunk, tap) the 32 x N weight slice is staged with its
// columns interleaved as n = 4*j + g, so that an m16n8 accumulator holds
// gates (i, f) of channel j in even lanes and (g, o) in odd lanes: one
// shuffle with the neighbouring lane gives each thread all four gates of
// one (pixel, j), and the state update stays in registers.  A fragments are
// read straight from the staged halo tile (the implicit GEMM's im2col).
// Shared-memory rows are padded to 40 bf16 so fragment loads are free of
// bank conflicts.

constexpr int kMmaRows = 4;               // output rows per block
constexpr int kMmaCols = 16;              // output columns per block (m16)
constexpr int kMmaChunk = 32;             // input channels per stage
constexpr int kMmaStride = kMmaChunk + 8; // bf16 per staged row
constexpr int kMmaThreads = 256;

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

// NT = hid / 8: the n8 tiles of one warp's hid columns.
template <int K, int NT>
__global__ void __launch_bounds__(kMmaThreads)
convlstm_cell_mma_kernel(const __nv_bfloat16* __restrict__ xh,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ c, float* __restrict__ h_out,
                         float* __restrict__ c_out, int H, int W, int Cin) {
  constexpr int hid = NT * 8;
  constexpr int N = 4 * hid;
  constexpr int P = K / 2;
  constexpr int kHaloW = kMmaCols + K - 1;
  constexpr int kHaloPixels = (kMmaRows + K - 1) * kHaloW;
  __shared__ __align__(16) __nv_bfloat16 a_tile[kHaloPixels * kMmaStride];
  __shared__ __align__(16) __nv_bfloat16 b_tile[N * kMmaStride];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;  // tile rows 2*wm, 2*wm + 1
  const int wn = warp & 3;   // interleaved columns [wn*hid, (wn+1)*hid)
  const int grp = lane >> 2, quad = lane & 3;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kMmaRows;
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
    for (int e = threadIdx.x; e < kHaloPixels * kMmaChunk; e += kMmaThreads) {
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
           e += kMmaThreads) {
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
      const size_t o = (((size_t)b * H + r) * W + col) * hid + j;
      const float ig = sigmoid((odd ? r0 : d[0]) + bias[j]);
      const float fg = sigmoid((odd ? r1 : d[1]) + bias[hid + j]);
      const float gg = tanhf((odd ? d[2] : r0) + bias[2 * hid + j]);
      const float og = sigmoid((odd ? d[3] : r1) + bias[3 * hid + j]);
      const float c_new = c[o] * fg + ig * gg;
      c_out[o] = c_new;
      h_out[o] = og * tanhf(c_new);
    }
  }
}

template <int K>
int launch_mma_k(const __nv_bfloat16* x, const __nv_bfloat16* wt,
                 const float* bb, const float* cc, float* ho, float* co,
                 int H, int W, int Cin, int hid, dim3 grid, cudaStream_t s) {
  switch (hid) {
    case 8:
      convlstm_cell_mma_kernel<K, 1><<<grid, kMmaThreads, 0, s>>>(
          x, wt, bb, cc, ho, co, H, W, Cin);
      break;
    case 16:
      convlstm_cell_mma_kernel<K, 2><<<grid, kMmaThreads, 0, s>>>(
          x, wt, bb, cc, ho, co, H, W, Cin);
      break;
    case 32:
      convlstm_cell_mma_kernel<K, 4><<<grid, kMmaThreads, 0, s>>>(
          x, wt, bb, cc, ho, co, H, W, Cin);
      break;
    case 64:
      convlstm_cell_mma_kernel<K, 8><<<grid, kMmaThreads, 0, s>>>(
          x, wt, bb, cc, ho, co, H, W, Cin);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The tensor-core kernel takes bf16 operands, hid in {8, 16, 32, 64} and a
// 16-byte aligned weight tensor; returns -1 where it does not apply.
int launch_mma(const void* xh, const void* w, const void* b, const void* c,
               void* h_out, void* c_out, int B, int H, int W, int Cin,
               int hid, int k, void* stream) {
  if ((hid != 8 && hid != 16 && hid != 32 && hid != 64) ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return -1;
  const dim3 grid((W + kMmaCols - 1) / kMmaCols, (H + kMmaRows - 1) / kMmaRows,
                  B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const __nv_bfloat16*>(xh);
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const float*>(b);
  const auto* cc = static_cast<const float*>(c);
  auto* ho = static_cast<float*>(h_out);
  auto* co = static_cast<float*>(c_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_mma_k<1>(x, wt, bb, cc, ho, co, H, W, Cin, hid, grid, s);
    case 3: return launch_mma_k<3>(x, wt, bb, cc, ho, co, H, W, Cin, hid, grid, s);
    case 5: return launch_mma_k<5>(x, wt, bb, cc, ho, co, H, W, Cin, hid, grid, s);
    case 7: return launch_mma_k<7>(x, wt, bb, cc, ho, co, H, W, Cin, hid, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* xh, const void* w, const void* b, const void* c,
           void* h_out, void* c_out, int B, int H, int W, int Cin, int hid,
           int k, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || hid < 1 ||
      hid * kGroupsW > kMaxThreads || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int tile_h = std::max(1, std::min(8, kMaxThreads / (hid * kGroupsW)));
  const int threads = hid * kGroupsW * tile_h;
  const int row_tiles = (H + tile_h - 1) / tile_h;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, row_tiles, B);
  const size_t smem =
      (size_t)(tile_h + k - 1) * (kTileW + k - 1) * kStride * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(xh);
  const T* wt = static_cast<const T*>(w);
  const float* bb = static_cast<const float*>(b);
  const float* cc = static_cast<const float*>(c);
  float* ho = static_cast<float*>(h_out);
  float* co = static_cast<float*>(c_out);
  switch (k) {
    case 1:
      convlstm_cell_kernel<T, 1><<<grid, threads, smem, s>>>(
          x, wt, bb, cc, ho, co, H, W, Cin, hid, tile_h);
      break;
    case 3:
      convlstm_cell_kernel<T, 3><<<grid, threads, smem, s>>>(
          x, wt, bb, cc, ho, co, H, W, Cin, hid, tile_h);
      break;
    case 5:
      convlstm_cell_kernel<T, 5><<<grid, threads, smem, s>>>(
          x, wt, bb, cc, ho, co, H, W, Cin, hid, tile_h);
      break;
    case 7:
      convlstm_cell_kernel<T, 7><<<grid, threads, smem, s>>>(
          x, wt, bb, cc, ho, co, H, W, Cin, hid, tile_h);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = success).  The launch is
// asynchronous on `stream`; nothing is synchronised or allocated here.
int niswan_convlstm_cell_f32(const void* xh, const void* w, const void* b,
                             const void* c, void* h_out, void* c_out, int B,
                             int H, int W, int Cin, int hid, int k,
                             void* stream) {
  return launch<float>(xh, w, b, c, h_out, c_out, B, H, W, Cin, hid, k,
                       stream);
}

int niswan_convlstm_cell_bf16(const void* xh, const void* w, const void* b,
                              const void* c, void* h_out, void* c_out, int B,
                              int H, int W, int Cin, int hid, int k,
                              void* stream) {
  if (B >= 1 && B <= 65535 && H >= 1 && W >= 1 && Cin >= 1) {
    const int err = launch_mma(xh, w, b, c, h_out, c_out, B, H, W, Cin, hid,
                               k, stream);
    if (err >= 0) return err;
  }
  return launch<__nv_bfloat16>(xh, w, b, c, h_out, c_out, B, H, W, Cin, hid,
                               k, stream);
}

const char* niswan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
