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
// and 48 at the training shapes, 70 at config #3, 126 at the 20-level
// fusion), K = k*k*4*hid.
//
//  * conv_same_mma_kernel (bf16): an implicit GEMM on the tensor cores,
//    mma.sync m16n8k16 with f32 accumulate.  A block computes an 8-row x
//    32-column pixel tile and a slice of the output channels 32, 48, 64 or
//    80 wide (the one that wastes least of Cout) with 8 warps, 4 along M
//    (two rows of two m16 column halves each) x 2 along N.  Per chunk of 16
//    input channels one stage holds the haloed input tile and the weights
//    of ALL k*k taps for the chunk and the slice (70 KB at k 5 and an
//    80-wide slice), both staged by 16-byte cp.async; two stages, so the
//    next chunk's copies fly while this chunk's k*k*(4 x NT) mmas run, with
//    one barrier per chunk.  A fragments come from the halo by ldmatrix
//    (the implicit GEMM's im2col, shifted per tap), B fragments from the
//    staged weights by ldmatrix.trans.
//    Contract of the bf16 entry: Cin % 8 == 0, w's rows (tap, channel)
//    padded to Cw = round_up(Cout, 8) columns, the columns past Cout zero,
//    x and w 16-byte aligned.  ops/convgrad.py pads w' (and, for a ragged
//    Cin, x) once per call, so every copy is 16 bytes and Cout 70 costs
//    what 72 does.
//  * conv_same_fp32_kernel (f32 operands): the same tiles on the FP32 pipes;
//    each thread owns 4 consecutive columns x 4 output channels (j, j+16,
//    j+32, j+48) and reads its weights from global memory, neighbouring
//    threads on neighbouring channels.
//
// Each output is written once, with no atomics: reruns are bit-identical.
// What bounds it: at the training layer-1 shape the product is M = 123,200 x
// N = 72 x K = 6,400, about 114 GFLOP (0.115 ms at the dense bf16 peak),
// against ~98 MB of operands and output (0.029 ms at 3.35 TB/s):
// operations.  The first version restaged the 32-channel weight slice for
// every (chunk, tap) with two barriers each (200 stages per block at k 5,
// Cin 256), staged the halo one bf16 element at a time with a div/mod each,
// and fell to scalar weight loads for Cout % 8 != 0; this one stages each
// weight byte once per block and chunk, and every staged weight byte feeds
// the 256 pixels of the block's tile.

#include "cell_mainloop.cuh"

namespace {

using namespace niswan;

constexpr int kConvRows = 8;     // output rows per block of the mma kernel
constexpr int kConvCols = 32;    // output columns per block: two m16 tiles
constexpr int kConvCh = 16;      // input channels per stage: one k16 step per tap
constexpr int kConvChStride = kConvCh + 8;  // bf16 per staged pixel (48 B)
constexpr int kConvStages = 2;
constexpr int kConvThreads = 256;
constexpr int kConvMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

// bytes of one stage: the halo tile, then the k*k x 16 x (16*NT) weights
__host__ __device__ constexpr int conv_stage_bytes(int k, int nt) {
  return (kConvRows + k - 1) * (kConvCols + k - 1) * kConvChStride * 2 +
         k * k * kConvCh * (16 * nt + 8) * 2;
}

// NT: the n8 tiles of each of the 2 warps along N; the block's slice of the
// output channels is 16 * NT wide.
template <int K, int NT>
__global__ void __launch_bounds__(kConvThreads, 1)
conv_same_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     float* __restrict__ out, int H, int W, int Cin, int Cout) {
  constexpr int P = K / 2;
  constexpr int kHaloRows = kConvRows + K - 1;
  constexpr int kHaloCols = kConvCols + K - 1;
  constexpr int kTileN = 16 * NT;
  constexpr int kStrideN = kTileN + 8;  // bf16 per staged weight row
  constexpr int kHaloBytes = kHaloRows * kHaloCols * kConvChStride * 2;
  constexpr int kStageBytes = conv_stage_bytes(K, NT);
  extern __shared__ __align__(16) unsigned char conv_smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;  // tile rows 2*wm, 2*wm + 1
  const int wn = warp & 1;   // n8 tiles [NT*wn, NT*wn + NT) of the slice
  const int grp = lane >> 2, quad = lane & 3;
  const int Cw = (Cout + 7) / 8 * 8;  // w's row pitch
  const int n_slices = (Cout + kTileN - 1) / kTileN;
  const int b = blockIdx.z / n_slices;
  const int n0 = (blockIdx.z % n_slices) * kTileN;
  const int row0 = blockIdx.y * kConvRows;
  const int col0 = blockIdx.x * kConvCols;
  const __nv_bfloat16* x_b = x + (size_t)b * H * W * Cin;
  const int chunks = (Cin + kConvCh - 1) / kConvCh;

  // input channels [c0, c0 + 16) of the halo and of every tap's weights
  auto issue = [&](int chunk, int buf) {
    unsigned char* base = conv_smem + buf * kStageBytes;
    __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(base + kHaloBytes);
    const int c0 = chunk * kConvCh;
    for (int e = threadIdx.x; e < kHaloRows * kHaloCols * 2; e += kConvThreads) {
      const int pix = e >> 1, g = e & 1;
      const int r = row0 - P + pix / kHaloCols;
      const int col = col0 - P + pix % kHaloCols;
      const int ch = c0 + 8 * g;
      const bool ok = r >= 0 && r < H && col >= 0 && col < W && ch < Cin;
      cp_async16(halo + pix * kConvChStride + 8 * g,
                 ok ? x_b + ((size_t)r * W + col) * Cin + ch : x, ok);
    }
    // w[tap, c0 + cc, n0 + n] -> wt[tap*16 + cc][n], as stored: the
    // column-major B fragments come from ldmatrix.trans
    constexpr int kGroups = kTileN / 8;
    for (int e = threadIdx.x; e < K * K * kConvCh * kGroups; e += kConvThreads) {
      const int j = e % kGroups, row = e / kGroups;
      const int cc = row % kConvCh, tap = row / kConvCh;
      const int n = n0 + 8 * j;
      const bool ok = c0 + cc < Cin && n < Cw;
      cp_async16(wt + row * kStrideN + 8 * j,
                 ok ? w + ((size_t)tap * Cin + c0 + cc) * Cw + n : w, ok);
    }
  };

  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

  auto compute = [&](int buf) {
    const unsigned char* base = conv_smem + buf * kStageBytes;
    const __nv_bfloat16* halo = reinterpret_cast<const __nv_bfloat16*>(base);
    const __nv_bfloat16* wt = reinterpret_cast<const __nv_bfloat16*>(base + kHaloBytes);
    // A (m16 pixels x k16 channels), row-major: matrices (pixels 0-7 |
    // 8-15) x (channels 0-7 | 8-15), lane -> pixel lane % 16, channel half
    // lane / 16; m16 tile mt = 2 * (row of the warp) + column half
    const __nv_bfloat16* arow =
        halo + ((2 * wm) * kHaloCols + (lane & 15)) * kConvChStride + 8 * (lane >> 4);
    // B (k16 channels x n8), from rows k = lane % 16 of the tap's weights
    const __nv_bfloat16* brow = wt + (lane & 15) * kStrideN + wn * NT * 8;
#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int tap = dy * K + dx;
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(a[mt], arow + (((mt >> 1) + dy) * kHaloCols + 16 * (mt & 1) + dx) *
                                        kConvChStride);
        uint32_t bq[NT][2];
        const __nv_bfloat16* bt = brow + tap * kConvCh * kStrideN;
#pragma unroll
        for (int nt = 0; nt + 1 < NT; nt += 2) {
          // lanes 16-31 address the next n8 tile
          uint32_t r[4];
          ldmatrix_x4_trans(r, bt + (nt + (lane >> 4)) * 8);
          bq[nt][0] = r[0];
          bq[nt][1] = r[1];
          bq[nt + 1][0] = r[2];
          bq[nt + 1][1] = r[3];
        }
        if constexpr (NT % 2 == 1)
          ldmatrix_x2_trans(bq[NT - 1][0], bq[NT - 1][1], bt + (NT - 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a[mt], bq[nt][0], bq[nt][1]);
      }
    }
  };

  // chunk c + 1 is copied while chunk c is multiplied; one barrier per chunk
  // (it also frees the buffer the next copy overwrites)
#pragma unroll
  for (int s = 0; s < kConvStages - 1; ++s) {
    if (s < chunks) issue(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kConvStages - 2>();
    __syncthreads();
    const int nx = c + kConvStages - 1;
    if (nx < chunks) issue(nx, nx % kConvStages);
    cp_async_commit();
    compute(c % kConvStages);
  }

  // accumulator (row, n): d0,d1 -> (grp, 2*quad + {0,1}); d2,d3 -> (grp + 8,
  // same); a row is a pixel column of the m16 tile
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r = row0 + 2 * wm + (mt >> 1);
    if (r >= H) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + (wn * NT + nt) * 8 + quad * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = col0 + 16 * (mt & 1) + grp + 8 * half;
        if (col >= W) continue;
        float* o = out + (((size_t)b * H + r) * W + col) * Cout;
        if (n < Cout) o[n] = acc[mt][nt][2 * half];
        if (n + 1 < Cout) o[n + 1] = acc[mt][nt][2 * half + 1];
      }
    }
  }
}

// The n8 tiles per warp (2..max_nt) whose slice width wastes the least of
// Cout (the larger on a tie: fewer slices restage the input).
int pick_nt(int Cout, int max_nt) {
  int best = 2;
  long long best_width = -1;
  for (int nt = 2; nt <= max_nt; ++nt) {
    const long long tile = 16 * nt;
    const long long width = (Cout + tile - 1) / tile * tile;
    if (best_width < 0 || width <= best_width) {
      best = nt;
      best_width = width;
    }
  }
  return best;
}

template <int K, int NT>
int launch_conv_mma(dim3 grid, cudaStream_t s, const __nv_bfloat16* x,
                    const __nv_bfloat16* w, float* o, int H, int W, int Cin,
                    int Cout) {
  constexpr int kSmem = kConvStages * conv_stage_bytes(K, NT);
  static_assert(kSmem <= kConvMaxSmem, "stage too large for one block");
  int err = (int)cudaFuncSetAttribute(conv_same_mma_kernel<K, NT>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kSmem);
  if (err) return err;
  conv_same_mma_kernel<K, NT><<<grid, kConvThreads, kSmem, s>>>(x, w, o, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

// the widest slice whose two stages fit in a block's shared memory
constexpr int conv_max_nt(int k) {
  return kConvStages * conv_stage_bytes(k, 5) <= kConvMaxSmem ? 5
         : kConvStages * conv_stage_bytes(k, 4) <= kConvMaxSmem ? 4
         : kConvStages * conv_stage_bytes(k, 3) <= kConvMaxSmem ? 3 : 2;
}

template <int K>
int launch_conv_mma_k(dim3 grid, int nt, cudaStream_t s, const __nv_bfloat16* x,
                      const __nv_bfloat16* w, float* o, int H, int W, int Cin,
                      int Cout) {
  constexpr int kMax = conv_max_nt(K);
  switch (nt) {
    case 2: return launch_conv_mma<K, 2>(grid, s, x, w, o, H, W, Cin, Cout);
    case 3: return launch_conv_mma<K, (kMax < 3 ? 2 : 3)>(grid, s, x, w, o, H, W, Cin, Cout);
    case 4: return launch_conv_mma<K, (kMax < 4 ? 2 : 4)>(grid, s, x, w, o, H, W, Cin, Cout);
    default: return launch_conv_mma<K, (kMax < 5 ? 2 : 5)>(grid, s, x, w, o, H, W, Cin, Cout);
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
    if (Cin % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    int max_nt = 0;
    switch (k) {
      case 1: max_nt = conv_max_nt(1); break;
      case 3: max_nt = conv_max_nt(3); break;
      case 5: max_nt = conv_max_nt(5); break;
      case 7: max_nt = conv_max_nt(7); break;
      default: return (int)cudaErrorInvalidValue;
    }
    const int nt = pick_nt(Cout, max_nt);
    const long long gz = (long long)B * ((Cout + 16 * nt - 1) / (16 * nt));
    const dim3 grid((W + kConvCols - 1) / kConvCols,
                    (H + kConvRows - 1) / kConvRows, (unsigned)gz);
    if (gz > 65535 || grid.y > 65535) return (int)cudaErrorInvalidValue;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    switch (k) {
      case 1: return launch_conv_mma_k<1>(grid, nt, s, xb, wb, o, H, W, Cin, Cout);
      case 3: return launch_conv_mma_k<3>(grid, nt, s, xb, wb, o, H, W, Cin, Cout);
      case 5: return launch_conv_mma_k<5>(grid, nt, s, xb, wb, o, H, W, Cin, Cout);
      default: return launch_conv_mma_k<7>(grid, nt, s, xb, wb, o, H, W, Cin, Cout);
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
    return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = success).  The launch is
// asynchronous on `stream`; nothing is synchronised or allocated here.
// f32: x (B,H,W,Cin), w (k,k,Cin,Cout).  bf16: the contract above (Cin % 8
// == 0, w's rows padded to round_up(Cout, 8), 16-byte aligned operands).
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
