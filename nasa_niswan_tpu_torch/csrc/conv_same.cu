// SAME k x k convolution with an f32 output, for Hopper (sm_90a), with a
// plain C interface (loaded with ctypes by nasa_niswan_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernel nasa_niswan_tpu/ops/convgrad_pallas.py
// ::_conv_same_kernel (called through conv_same_v2).  It computes
//
//   out[b, y, x, n] = sum over dy, dx, c of x[b, y+dy-P, x+dx-P, c] * w[dy, dx, c, n]
//
// with x (B,H,W,Cin) and w (k,k,Cin,Cout) HWIO in the compute dtype (bf16 or
// f32), zero padding at the frame edges and f32 sums.  With the flipped,
// transposed cell kernel w' = flip(w, (0, 1)).swapaxes(2, 3) and x = dgates
// it is the cell's data gradient dxh: M = pixels, N = Cin of the cell (72, 96
// and 48 at the training shapes, 126 at the 20-level fusion), K = k*k*4*hid.
//
//  * conv_same_mma_kernel (bf16): an implicit GEMM on the tensor cores,
//    mma.sync m16n8k16 with f32 accumulate, the forward cell's mainloop
//    without its gate epilogue.  A block computes an 8-row x 16-column pixel
//    tile and a slice of the output channels 32, 48, 64 or 80 wide (the one
//    that wastes least of Cout: 80 for 72, 48 for 96 and 48, 64 for 126)
//    with 8 warps, 4 along M (two 16-pixel rows each) x 2 along N.  Per chunk
//    of 32 input channels the haloed input tile is staged once; per (chunk,
//    tap) the 32-channel weight slice, by 16-byte copies as it is stored
//    (channel rows, output channels contiguous), and ldmatrix.trans reads the
//    column-major B fragments from it.  The ragged N tail is staged as zeros
//    and not stored.
//  * conv_same_fp32_kernel (f32 operands): the same tiles on the FP32 pipes;
//    each thread owns 4 consecutive columns x 4 output channels (j, j+16,
//    j+32, j+48) and reads its weights from global memory, neighbouring
//    threads on neighbouring channels.
//
// Each output is written once, with no atomics: reruns are bit-identical.
// What bounds it: at the training layer-1 shape the product is M = 123,200 x
// N = 72 x K = 6,400, about 114 GFLOP (127 computed in the 80-wide slice).
// The mma kernel's per-tap weight staging, two barriers per 32-channel tap
// stage, is its limit, as in the forward.

#include "cell_mainloop.cuh"

namespace {

using namespace niswan;

constexpr int kConvRows = 8;  // output rows per block of the mma kernel
constexpr int kConvThreads = 256;

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(a));
}

// NT: the n8 tiles of each of the 2 warps along N; the block's slice of the
// output channels is 16 * NT wide (32, 48, 64 or 80, picked to fit Cout).
template <int K, int NT>
__global__ void __launch_bounds__(kConvThreads)
conv_same_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     float* __restrict__ out, int H, int W, int Cin, int Cout) {
  constexpr int P = K / 2;
  constexpr int kHaloW = kMmaCols + K - 1;
  constexpr int kHaloPixels = (kConvRows + K - 1) * kHaloW;
  constexpr int kTileN = 16 * NT;
  constexpr int kStrideB = kTileN + 8;  // bf16 per staged channel row
  __shared__ __align__(16) __nv_bfloat16 a_tile[kHaloPixels * kMmaStride];
  __shared__ __align__(16) __nv_bfloat16 b_tile[kMmaChunk * kStrideB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;  // tile rows 2*wm, 2*wm + 1
  const int wn = warp & 1;   // n8 tiles [NT*wn, NT*wn + NT) of the slice
  const int grp = lane >> 2, quad = lane & 3;
  const int n_slices = (Cout + kTileN - 1) / kTileN;
  const int b = blockIdx.z / n_slices;
  const int n0 = (blockIdx.z % n_slices) * kTileN;
  const int row0 = blockIdx.y * kConvRows;
  const int col0 = blockIdx.x * kMmaCols;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const __nv_bfloat16* x_b = x + (size_t)b * H * W * Cin;
  // whole 16-byte groups of 8 output channels when Cout allows them
  const bool vec = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;

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
    for (int e = threadIdx.x; e < kHaloPixels * kMmaChunk; e += kConvThreads) {
      const int cc = e % kMmaChunk;
      const int pix = e / kMmaChunk;
      const int r = row0 - P + pix / kHaloW;
      const int col = col0 - P + pix % kHaloW;
      __nv_bfloat16 v = zero;
      if (cc < cn && r >= 0 && r < H && col >= 0 && col < W)
        v = x_b[((size_t)r * W + col) * Cin + ci0 + cc];
      a_tile[pix * kMmaStride + cc] = v;
    }
    for (int tap = 0; tap < K * K; ++tap) {
      const int dy = tap / K, dx = tap % K;
      __syncthreads();  // the previous tap's weights are consumed
      // w[dy, dx, ci0 + cc, n0 + n] -> b_tile[cc][n], as stored: the
      // column-major B fragments come from ldmatrix.trans
      const __nv_bfloat16* wt = w + ((size_t)tap * Cin + ci0) * Cout + n0;
      if (vec) {
        for (int e = threadIdx.x; e < kMmaChunk * (kTileN / 8); e += kConvThreads) {
          const int cc = e / (kTileN / 8), n = 8 * (e % (kTileN / 8));
          uint4 v = make_uint4(0, 0, 0, 0);
          if (cc < cn && n0 + n < Cout)
            v = *reinterpret_cast<const uint4*>(wt + (size_t)cc * Cout + n);
          *reinterpret_cast<uint4*>(b_tile + cc * kStrideB + n) = v;
        }
      } else {
        for (int e = threadIdx.x; e < kMmaChunk * kTileN; e += kConvThreads) {
          const int cc = e / kTileN, n = e % kTileN;
          __nv_bfloat16 v = zero;
          if (cc < cn && n0 + n < Cout) v = wt[(size_t)cc * Cout + n];
          b_tile[cc * kStrideB + n] = v;
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
          // lanes 0-7 address k rows kk..kk+7, lanes 8-15 rows kk+8..kk+15
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, b_tile + (kk + (lane & 15)) * kStrideB +
                                        (wn * NT + nt) * 8);
          mma_bf16(acc[0][nt], a[0], b0, b1);
          mma_bf16(acc[1][nt], a[1], b0, b1);
        }
      }
    }
  }

  // accumulator (row, n): d0,d1 -> (grp, 2*quad + {0,1}); d2,d3 -> (grp + 8,
  // same); a row is a pixel column of the tile row
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = row0 + wm * 2 + mt;
    if (r >= H) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + (wn * NT + nt) * 8 + quad * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = col0 + grp + 8 * half;
        if (col >= W) continue;
        float* o = out + (((size_t)b * H + r) * W + col) * Cout;
        if (n < Cout) o[n] = acc[mt][nt][2 * half];
        if (n + 1 < Cout) o[n + 1] = acc[mt][nt][2 * half + 1];
      }
    }
  }
}

// The n8 tiles per warp whose slice width wastes the least of Cout (the
// larger on a tie: fewer slices restage the input).
int pick_nt(int Cout) {
  int best = 2;
  long long best_width = -1;
  for (int nt = 2; nt <= 5; ++nt) {
    const long long tile = 16 * nt;
    const long long width = (Cout + tile - 1) / tile * tile;
    if (best_width < 0 || width <= best_width) {
      best = nt;
      best_width = width;
    }
  }
  return best;
}

template <int K>
void launch_conv_mma_k(int nt, dim3 grid, cudaStream_t s,
                       const __nv_bfloat16* x, const __nv_bfloat16* w,
                       float* o, int H, int W, int Cin, int Cout) {
  switch (nt) {
    case 2: conv_same_mma_kernel<K, 2><<<grid, kConvThreads, 0, s>>>(x, w, o, H, W, Cin, Cout); break;
    case 3: conv_same_mma_kernel<K, 3><<<grid, kConvThreads, 0, s>>>(x, w, o, H, W, Cin, Cout); break;
    case 4: conv_same_mma_kernel<K, 4><<<grid, kConvThreads, 0, s>>>(x, w, o, H, W, Cin, Cout); break;
    default: conv_same_mma_kernel<K, 5><<<grid, kConvThreads, 0, s>>>(x, w, o, H, W, Cin, Cout); break;
  }
}

constexpr int kFpRows = 4;       // output rows per block
constexpr int kFpTileN = 64;     // output channels per block
constexpr int kFpSpan = 16;      // channel stride between a thread's outputs
constexpr int kFpThreads = kFpSpan * kGroupsW * kFpRows;  // 256

template <typename T, int K>
__global__ void __launch_bounds__(kFpThreads)
conv_same_fp32_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      float* __restrict__ out, int H, int W, int Cin,
                      int Cout) {
  constexpr int P = K / 2;
  constexpr int kHaloW = kTileW + K - 1;
  constexpr int kHaloPixels = (kFpRows + K - 1) * kHaloW;
  // [halo row][halo col][channel of the chunk], as f32; 29 KB at k = 7
  __shared__ float tile[kHaloPixels * kStride];

  const int n_slices = (Cout + kFpTileN - 1) / kFpTileN;
  const int b = blockIdx.z / n_slices;
  const int n0 = (blockIdx.z % n_slices) * kFpTileN;
  const int row0 = blockIdx.y * kFpRows;
  const int col0 = blockIdx.x * kTileW;
  const int j = threadIdx.x % kFpSpan;
  const int group = threadIdx.x / kFpSpan;
  const int ty = group / kGroupsW;
  const int tx0 = (group % kGroupsW) * kPix;

  // output channel q of this thread; past Cout it reads a valid column and
  // is never stored
  int nq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) nq[q] = min(n0 + j + kFpSpan * q, Cout - 1);

  float acc[kPix][4];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;

  const T* x_b = x + (size_t)b * H * W * Cin;
  for (int ci0 = 0; ci0 < Cin; ci0 += kChunk) {
    const int cn = min(kChunk, Cin - ci0);
    __syncthreads();  // the previous chunk has been consumed
    for (int e = threadIdx.x; e < kHaloPixels * kChunk; e += kFpThreads) {
      const int cc = e % kChunk;
      const int pix = e / kChunk;
      const int r = row0 - P + pix / kHaloW;
      const int col = col0 - P + pix % kHaloW;
      float v = 0.0f;
      if (cc < cn && r >= 0 && r < H && col >= 0 && col < W)
        v = to_f32(x_b[((size_t)r * W + col) * Cin + ci0 + cc]);
      tile[pix * kStride + cc] = v;
    }
    __syncthreads();

#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float* xs = tile + ((ty + dy) * kHaloW + tx0 + dx) * kStride;
        const T* wp = w + ((size_t)(dy * K + dx) * Cin + ci0) * Cout;
#pragma unroll 4
        for (int cc = 0; cc < cn; ++cc) {
          const T* wr = wp + (size_t)cc * Cout;
          const float w0 = to_f32(wr[nq[0]]);
          const float w1 = to_f32(wr[nq[1]]);
          const float w2 = to_f32(wr[nq[2]]);
          const float w3 = to_f32(wr[nq[3]]);
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            const float xv = xs[p * kStride + cc];
            acc[p][0] = fmaf(xv, w0, acc[p][0]);
            acc[p][1] = fmaf(xv, w1, acc[p][1]);
            acc[p][2] = fmaf(xv, w2, acc[p][2]);
            acc[p][3] = fmaf(xv, w3, acc[p][3]);
          }
        }
      }
    }
  }

  const int r = row0 + ty;
  if (r >= H) return;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int col = col0 + tx0 + p;
    if (col >= W) break;
    float* o = out + (((size_t)b * H + r) * W + col) * Cout;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + j + kFpSpan * q;
      if (n < Cout) o[n] = acc[p][q];
    }
  }
}

template <typename T>
int conv_same(const void* x, const void* w, void* out, int B, int H, int W,
              int Cin, int Cout, int k, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int nt = pick_nt(Cout);
    const long long gz = (long long)B * ((Cout + 16 * nt - 1) / (16 * nt));
    const dim3 grid((W + kMmaCols - 1) / kMmaCols,
                    (H + kConvRows - 1) / kConvRows, (unsigned)gz);
    if (gz > 65535 || grid.y > 65535) return (int)cudaErrorInvalidValue;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    switch (k) {
      case 1: launch_conv_mma_k<1>(nt, grid, s, xb, wb, o, H, W, Cin, Cout); break;
      case 3: launch_conv_mma_k<3>(nt, grid, s, xb, wb, o, H, W, Cin, Cout); break;
      case 5: launch_conv_mma_k<5>(nt, grid, s, xb, wb, o, H, W, Cin, Cout); break;
      case 7: launch_conv_mma_k<7>(nt, grid, s, xb, wb, o, H, W, Cin, Cout); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    const long long gz = (long long)B * ((Cout + kFpTileN - 1) / kFpTileN);
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kFpRows - 1) / kFpRows,
                    (unsigned)gz);
    if (gz > 65535 || grid.y > 65535) return (int)cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    const T* wt = static_cast<const T*>(w);
    switch (k) {
      case 1: conv_same_fp32_kernel<T, 1><<<grid, kFpThreads, 0, s>>>(xt, wt, o, H, W, Cin, Cout); break;
      case 3: conv_same_fp32_kernel<T, 3><<<grid, kFpThreads, 0, s>>>(xt, wt, o, H, W, Cin, Cout); break;
      case 5: conv_same_fp32_kernel<T, 5><<<grid, kFpThreads, 0, s>>>(xt, wt, o, H, W, Cin, Cout); break;
      case 7: conv_same_fp32_kernel<T, 7><<<grid, kFpThreads, 0, s>>>(xt, wt, o, H, W, Cin, Cout); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = success).  The launch is
// asynchronous on `stream`; nothing is synchronised or allocated here.
int niswan_conv_same_f32(const void* x, const void* w, void* out, int B, int H,
                         int W, int Cin, int Cout, int k, void* stream) {
  return conv_same<float>(x, w, out, B, H, W, Cin, Cout, k, stream);
}

int niswan_conv_same_bf16(const void* x, const void* w, void* out, int B,
                          int H, int W, int Cin, int Cout, int k,
                          void* stream) {
  return conv_same<__nv_bfloat16>(x, w, out, B, H, W, Cin, Cout, k, stream);
}

}  // extern "C"
