// Fused ConvLSTM cell backward for Hopper (sm_90a), with a plain C interface
// (loaded with ctypes by nasa_niswan_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernel nasa_niswan_tpu/ops/convgrad_pallas.py
// ::_cell_bwd_kernel (called through fused_cell_bwd_v2).  From the cell's
// input xh (B,H,W,Cin), state c, output cotangents dh, dc (B,H,W,hid) and
// weights w (k,k,Cin,4*hid), b (4*hid) it computes
//
//   dgates  (B,H,W,4*hid), compute dtype: the pre-activation gate cotangents
//   dc_prev (B,H,W,hid) f32:              dct * f
//   dw      (k,k,Cin,4*hid) f32:          sum over pixels of im2col(xh) x dgates
//   db      (4*hid) f32:                  sum over pixels of the f32 dgates
//
// in three launches, none with atomics, so reruns are bit-identical:
//
//  (a) cell_*_kernel with BackwardEpi: the gates are recomputed with the
//      forward's implicit-GEMM mainloop (cell_mainloop.cuh: wgmma for bf16
//      with hid in {8, 16, 32, 64}, reading the caller's packed weights
//      `wpack`; FP32 pipes otherwise), and the epilogue applies the
//      elementwise backward of the nonlinearities and the state update
//      (convgrad_pallas.py:147-163) in registers.  It writes dgates rounded
//      to the compute dtype, dc_prev, and per block the f32 sums of its
//      dgates (the db partials, one row per block of the plan's grid).
//  (b) dw as a GEMM of M = k*k*Cin rows (tap, channel) by N = 4*hid columns
//      over K = B*H*W pixels, split over the pixels into a fixed number of
//      slots; each block owns a tile of dw and one slot and writes its f32
//      partial tile.  The TPU kernel kept dw resident across its sequential
//      grid (the dW half, convgrad_pallas.py:165-183); CUDA blocks run in no
//      order, hence the slots.  bf16 runs dw_mma_kernel on the tensor cores
//      for every shape; f32 runs dw_partial_kernel on the FP32 pipes.
//  (c) sum_slots_kernel / sum_rows_kernel: dw and db summed over the slots
//      and block rows, each in a fixed order.
//
// (b) and (c) for dw also run on their own (niswan_conv_dw_*): the weight
// gradient of the per-cell training route, whose forward kept the gates.
//
// The workspace (slot partials, db partials, and the zero-padded copies of
// xh or dgates that ragged channel counts need) is allocated by the caller;
// niswan_*_workspace says how many floats it needs.
//
// What bounds dw on this card: at the training layer-1 shape (B=8, 100x154,
// Cin=72, N=256, k=5) it is 113.5 GFLOP, 0.115 ms at the dense bf16 peak,
// against ~80 MB of operands (0.024 ms at 3.35 TB/s): operations, so the
// operands must reach the tensor cores from shared memory, each fetched from
// L2 as few times as possible, with the copies overlapping the mmas, at any
// channel count (config #3's layer 1 takes Cin = 70, the 20-level fusion
// 126).  dw_mma_kernel (bf16):
//  * owns 16 channels x all k*k taps (up to 32 with 128 columns at k 7,
//    the rest in a second block) x 32-128 gate columns per block, and
//    walks 8-row x 16-column pixel tiles indexed by (b, tile row, tile
//    column), so no per-load pixel div/mod;
//  * stages each tile's haloed xh rows (16 channels, zero-filled past Cin
//    and outside the frame) and its dgates rows once per block, by 16-byte
//    cp.async, three stages in flight with one barrier per stage: an xh
//    byte is fetched once per tile halo, not once per tap (k*k = 25 times);
//  * forms every tap of the block from that one staged halo: the A fragment
//    of tap (dy, dx) is ldmatrix.trans at the halo pixel shifted by (dy, dx)
//    (the TPU kernel's roll of dgates per dx, done on the other operand),
//    while each warp's dgates fragments are loaded once per k16 step and
//    reused for all of its taps;
//  * takes any Cin and N: a ragged channel count (Cin or N not a multiple
//    of 8, or an unaligned operand, which no 16-byte copy can read) is
//    first copied once into a zero-padded buffer of the workspace by
//    pad_channels_kernel (17.7 MB written at config #3's layer 1, ~11 us at
//    3.35 TB/s).  The padded rows of dw are never written.

#include "cell_mainloop.cuh"

namespace {

using namespace niswan;

// The elementwise backward of one (pixel, channel): pre-activation gates p,
// state c, cotangents dh, dc -> gate cotangents d (i, f, g, o), dc_prev.
__device__ __forceinline__ float cell_backward(const float (&p)[4], float c32,
                                               float dhv, float dcv,
                                               float (&d)[4]) {
  const float i = sigmoid(p[0]);
  const float f = sigmoid(p[1]);
  const float g = tanhf(p[2]);
  const float og = sigmoid(p[3]);
  const float tc = tanhf(c32 * f + i * g);
  const float dct = dcv + dhv * og * (1.0f - tc * tc);
  d[0] = dct * g * i * (1.0f - i);
  d[1] = dct * c32 * f * (1.0f - f);
  d[2] = dct * i * (1.0f - g * g);
  d[3] = dhv * tc * og * (1.0f - og);
  return dct * f;
}

template <typename T>
struct BackwardEpi {
  const float* c;
  const float* dh;
  const float* dc;
  T* dgates;
  float* dc_prev;
  int hid;
  float* db_part;
  static constexpr bool kReduce = true;

  __device__ __forceinline__ void apply(size_t pix, int j, float pi, float pf,
                                        float pg, float po,
                                        float (&sum)[4]) const {
    const size_t o = pix * hid + j;
    const float p[4] = {pi, pf, pg, po};
    float d[4];
    dc_prev[o] = cell_backward(p, c[o], dh[o], dc[o], d);
    T* dg = dgates + pix * 4 * hid + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      dg[g * hid] = from_f32<T>(d[g]);
      sum[g] += d[g];
    }
  }

  // channels j, j + 1 (j even; bf16 only): f32 and bf16 pairs
  __device__ __forceinline__ void apply2(size_t pix, int j, const float (&p)[2][4],
                                         float (&sum)[2][4]) const {
    const size_t o = pix * hid + j;
    const float2 cv = *reinterpret_cast<const float2*>(c + o);
    const float2 dhv = *reinterpret_cast<const float2*>(dh + o);
    const float2 dcv = *reinterpret_cast<const float2*>(dc + o);
    float d0[4], d1[4];
    float2 prev;
    prev.x = cell_backward(p[0], cv.x, dhv.x, dcv.x, d0);
    prev.y = cell_backward(p[1], cv.y, dhv.y, dcv.y, d1);
    *reinterpret_cast<float2*>(dc_prev + o) = prev;
    T* dg = dgates + pix * 4 * hid + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      *reinterpret_cast<__nv_bfloat162*>(dg + g * hid) = __floats2bfloat162_rn(d0[g], d1[g]);
      sum[0][g] += d0[g];
      sum[1][g] += d1[g];
    }
  }
};

// ---- (b) on the FP32 pipes: f32 operands -------------------------------------

constexpr int kDwTile = 128;    // dw rows and columns per block
constexpr int kDwPix = 16;      // pixels staged per pass
constexpr int kDwThreads = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int kDwTargetBlocks = 512;
constexpr int kDwMaxSlots = 64;

__global__ void __launch_bounds__(kDwThreads)
dw_partial_kernel(const float* __restrict__ xh, const float* __restrict__ dg,
                  float* __restrict__ part, int H, int W, int C, int N, int k,
                  int M, long long npix, int pix_per_slot) {
  __shared__ __align__(16) float a_s[kDwPix][kDwTile];
  __shared__ __align__(16) float b_s[kDwPix][kDwTile];
  const int m0 = blockIdx.x * kDwTile;
  const int n0 = blockIdx.y * kDwTile;
  const int slot = blockIdx.z;
  const long long p_begin = (long long)slot * pix_per_slot;
  const long long p_end = min(npix, p_begin + pix_per_slot);
  const int P = k / 2;
  const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;

  // each thread stages one fixed dw row (tap, channel) and one column
  const int mi = threadIdx.x % kDwTile;
  const int m = m0 + mi;
  const int tap = m / C, ch = m % C;
  const int oy = tap / k - P, ox = tap % k - P;
  const int n = n0 + mi;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;

  for (long long p0 = p_begin; p0 < p_end; p0 += kDwPix) {
    __syncthreads();  // the previous pixels are consumed
    for (int pi = threadIdx.x / kDwTile; pi < kDwPix;
         pi += kDwThreads / kDwTile) {
      const long long p = p0 + pi;
      float a = 0.0f, bv = 0.0f;
      if (p < p_end) {
        if (m < M) {
          const int x = (int)(p % W);
          const long long t = p / W;
          const int y = (int)(t % H);
          const long long bi = t / H;
          const int yy = y + oy, xx = x + ox;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W)
            a = xh[((bi * H + yy) * W + xx) * C + ch];
        }
        if (n < N) bv = dg[p * N + n];
      }
      a_s[pi][mi] = a;
      b_s[pi][mi] = bv;
    }
    __syncthreads();
#pragma unroll 4
    for (int pi = 0; pi < kDwPix; ++pi) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[pi][tm * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[pi][64 + tm * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[pi][tn * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[pi][64 + tn * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(av[i], bw[q], acc[i][q]);
    }
  }

  float* out = part + (size_t)slot * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mm = m0 + (i < 4 ? tm * 4 + i : 64 + tm * 4 + i - 4);
    if (mm >= M) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int nn = n0 + (q < 4 ? tn * 4 + q : 64 + tn * 4 + q - 4);
      if (nn < N) out[(size_t)mm * N + nn] = acc[i][q];
    }
  }
}

// ---- (b) on the tensor cores: bf16 operands, any shape -----------------------
//
// mma.sync m16n8k16 (f32 accumulate) with M = dw rows (tap, channel), N =
// gate columns and K = pixels.  Block: 16 channels [c0, c0+16) x the taps
// [t0, t0 + taps) x kTileN = 32*NJ gate columns, over the pixel tiles of one
// slot.  16 warps, 16/NJ along the taps x NJ along the columns (32 each):
// warp (wm, wn) owns the taps t0 + wm + (16/NJ)*i, i < kTapsPerWarp, and
// keeps one m16 x n32 accumulator per tap.  Per stage one 8 x 16 pixel
// tile: the halo of xh, (8+k-1) x (16+k-1) pixels x 16 channels (48-byte
// pixel rows, so the eight rows of an ldmatrix fall in distinct banks), and
// dgates, 128 pixels x kTileN columns.  Each of the tile's rows is one k16
// step.  (8 rows and 16 warps measured 14% faster at layer 1 than 4 rows
// and 8 warps: fewer barriers per pixel, more warps to hide latency.)

constexpr int kDwmRows = 8;                 // frame rows per pixel tile
constexpr int kDwmCols = 16;                // columns per tile row: one k16 step
constexpr int kDwmPix = kDwmRows * kDwmCols;
constexpr int kDwmCh = 16;                  // channels per block: m16 per tap
constexpr int kDwmChStride = kDwmCh + 8;    // bf16 per staged halo pixel
constexpr int kDwmStages = 3;
constexpr int kDwmWarps = 16;
constexpr int kDwmThreads = 32 * kDwmWarps;
constexpr int kDwmTapsPerWarp = 4;          // accumulators: 4 x 16 of <= 128 registers
constexpr long long kDwmTargetBlocks = 264; // two waves of 132 SMs, 1 block/SM
constexpr long long kDwmMaxSlots = 128;

// taps per block for kernel size k and NJ warps along the columns
__host__ __device__ constexpr int dwm_taps(int k, int nj) {
  return k * k < (kDwmWarps / nj) * kDwmTapsPerWarp ? k * k
                                                    : (kDwmWarps / nj) * kDwmTapsPerWarp;
}

template <int K, int NJ>
struct DwmShape {
  static constexpr int kWarpsM = kDwmWarps / NJ;
  static constexpr int kTileN = 32 * NJ;
  static constexpr int kStrideN = kTileN + 8;  // bf16 per staged dgates row
  static constexpr int kTaps = dwm_taps(K, NJ);
  static constexpr int kTapsPerWarp = (kTaps + kWarpsM - 1) / kWarpsM;
  static constexpr int kHaloRows = kDwmRows + K - 1;
  static constexpr int kHaloCols = kDwmCols + K - 1;
  static constexpr int kHaloBytes = kHaloRows * kHaloCols * kDwmChStride * 2;
  static constexpr int kStageBytes = kHaloBytes + kDwmPix * kStrideN * 2;
  static constexpr int kSmem = kDwmStages * kStageBytes;
};

template <int K, int NJ>
__global__ void __launch_bounds__(kDwmThreads, 1)
dw_mma_kernel(const __nv_bfloat16* __restrict__ xh,
              const __nv_bfloat16* __restrict__ dg, float* __restrict__ part,
              int H, int W, int Cin, int Cp, int N, int Np, int cblocks,
              int tiles_w, int tiles_h, long long tiles,
              long long tiles_per_slot) {
  using S = DwmShape<K, NJ>;
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / NJ, wn = warp % NJ;
  const int grp = lane >> 2, quad = lane & 3;
  const int lr = lane & 7, li = lane >> 3;  // ldmatrix: row lr of matrix li
  const int c0 = (blockIdx.x % cblocks) * kDwmCh;
  const int t0 = (blockIdx.x / cblocks) * S::kTaps;
  const int taps = min(S::kTaps, K * K - t0);
  const int n0 = blockIdx.y * S::kTileN;
  const long long tile0 = (long long)blockIdx.z * tiles_per_slot;
  const int n_tiles = (int)max(0LL, min(tiles, tile0 + tiles_per_slot) - tile0);

  // halo offset (bf16) of each of this warp's taps
  int tap_off[S::kTapsPerWarp];
#pragma unroll
  for (int i = 0; i < S::kTapsPerWarp; ++i) {
    const int tap = t0 + min(wm + S::kWarpsM * i, taps - 1);
    tap_off[i] = ((tap / K) * S::kHaloCols + tap % K) * kDwmChStride;
  }

  // one pixel tile (b, rows y0.., columns x0..) into stage buffer `buf`
  auto issue = [&](long long t, int buf) {
    unsigned char* base = dw_smem + buf * S::kStageBytes;
    __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* gt = reinterpret_cast<__nv_bfloat16*>(base + S::kHaloBytes);
    const int tx = (int)(t % tiles_w);
    const long long t2 = t / tiles_w;
    const int ty = (int)(t2 % tiles_h);
    const size_t b = (size_t)(t2 / tiles_h);
    const int y0 = ty * kDwmRows, x0 = tx * kDwmCols;
    const __nv_bfloat16* xb = xh + b * H * W * Cp;
    for (int e = threadIdx.x; e < S::kHaloRows * S::kHaloCols * 2;
         e += kDwmThreads) {
      const int pix = e >> 1, g = e & 1;
      const int y = y0 - P + pix / S::kHaloCols;
      const int x = x0 - P + pix % S::kHaloCols;
      const int ch = c0 + 8 * g;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W && ch < Cp;
      cp_async16(halo + pix * kDwmChStride + 8 * g,
                 ok ? xb + ((size_t)y * W + x) * Cp + ch : xh, ok);
    }
    const __nv_bfloat16* gb = dg + b * H * W * Np;
    constexpr int kGroups = S::kTileN / 8;
    for (int e = threadIdx.x; e < kDwmPix * kGroups; e += kDwmThreads) {
      const int p = e / kGroups, j = e % kGroups;
      const int y = y0 + p / kDwmCols, x = x0 + p % kDwmCols;
      const int n = n0 + 8 * j;
      // pixels past the frame stage zero cotangents: they add nothing
      const bool ok = y < H && x < W && n < Np;
      cp_async16(gt + p * S::kStrideN + 8 * j,
                 ok ? gb + ((size_t)y * W + x) * Np + n : dg, ok);
    }
  };

  float acc[S::kTapsPerWarp][4][4];
#pragma unroll
  for (int i = 0; i < S::kTapsPerWarp; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][nt][q] = 0.0f;

  auto compute = [&](int buf) {
    const unsigned char* base = dw_smem + buf * S::kStageBytes;
    const __nv_bfloat16* halo = reinterpret_cast<const __nv_bfloat16*>(base);
    const __nv_bfloat16* gt =
        reinterpret_cast<const __nv_bfloat16*>(base + S::kHaloBytes);
#pragma unroll
    for (int r = 0; r < kDwmRows; ++r) {
      // B (k16 pixels x n32 of this warp), column-major: matrices (pixels
      // 0-7 | 8-15) x (n8 tile 2np | 2np+1)
      uint32_t bf[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bf[np], gt + (r * kDwmCols + lr + 8 * (li & 1)) * S::kStrideN +
                                      wn * 32 + (2 * np + (li >> 1)) * 8);
      // A (m16 channels x k16 pixels) of each tap: the halo row r + dy,
      // shifted by dx; matrices (pixels 0-7 | 8-15) x (channels 0-7 | 8-15)
      const __nv_bfloat16* arow =
          halo + (r * S::kHaloCols + lr + 8 * (li >> 1)) * kDwmChStride + 8 * (li & 1);
#pragma unroll
      for (int i = 0; i < S::kTapsPerWarp; ++i) {
        if (wm + S::kWarpsM * i < taps) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, arow + tap_off[i]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[i][nt], a, bf[nt >> 1][2 * (nt & 1)],
                     bf[nt >> 1][2 * (nt & 1) + 1]);
        }
      }
    }
  };

  // kDwmStages - 1 tiles in flight ahead of the one being multiplied; one
  // barrier per tile (it also frees the buffer the next copy overwrites)
#pragma unroll
  for (int s = 0; s < kDwmStages - 1; ++s) {
    if (s < n_tiles) issue(tile0 + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kDwmStages - 2>();
    __syncthreads();
    const int nx = i + kDwmStages - 1;
    if (nx < n_tiles) issue(tile0 + nx, nx % kDwmStages);
    cp_async_commit();
    compute(i % kDwmStages);
  }

  // accumulator (row, col): d0,d1 -> (grp, 2*quad + {0,1}); d2,d3 -> (grp+8,
  // same); a row is channel c0 + row of the tap, a column a gate column.
  // Channels past Cin (the zero-filled group) are not written.
  float* out = part + (size_t)blockIdx.z * K * K * Cin * N;
#pragma unroll
  for (int i = 0; i < S::kTapsPerWarp; ++i) {
    const int t = wm + S::kWarpsM * i;
    if (t >= taps) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * quad;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + grp + 8 * h;
        if (c >= Cin) continue;
        float* o = out + ((size_t)(t0 + t) * Cin + c) * N + n;
        if (n < N) o[0] = acc[i][nt][2 * h];
        if (n + 1 < N) o[1] = acc[i][nt][2 * h + 1];
      }
    }
  }
}

// dst (rows, Cp) = src (rows, C) with the channels [C, Cp) zero; Cp % 8 == 0
// and dst 16-byte aligned.  One thread per 8 channels of a row.
__global__ void pad_channels_kernel(const __nv_bfloat16* __restrict__ src,
                                    __nv_bfloat16* __restrict__ dst,
                                    long long rows, int C, int Cp) {
  const int groups = Cp / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * groups) return;
  const long long r = i / groups;
  const int c0 = (int)(i % groups) * 8;
  const __nv_bfloat16* s = src + r * C;
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + 2 * q;
    const uint32_t lo = c < C ? __bfloat16_as_ushort(s[c]) : 0u;
    const uint32_t hi = c + 1 < C ? __bfloat16_as_ushort(s[c + 1]) : 0u;
    v[q] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst + r * Cp + c0) = make_uint4(v[0], v[1], v[2], v[3]);
}

// out[i] = sum over s of part[s][i], s in order
__global__ void sum_slots_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int slots,
                                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int q = 0; q < slots; ++q) s += part[(size_t)q * n + i];
  out[i] = s;
}

// out[col] = sum over rows of part[row][col]: one block per column, each
// thread a strided run of rows, then a fixed-shape tree
constexpr int kRowThreads = 256;
__global__ void __launch_bounds__(kRowThreads)
sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                long long rows, int n) {
  __shared__ float s[kRowThreads];
  const int col = blockIdx.x;
  float v = 0.0f;
  for (long long r = threadIdx.x; r < rows; r += kRowThreads)
    v += part[(size_t)r * n + col];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int stride = kRowThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[col] = s[0];
}

// ---- planning and launching (b) and (c) --------------------------------------

inline long long round4(long long n) { return (n + 3) / 4 * 4; }

struct DwPlan {
  bool mma = false;
  int n_tiles = 0, slots = 0;
  // FP32 pipes: m_tiles x n_tiles x slots blocks of pix_per_slot pixels
  int m_tiles = 0, pix_per_slot = 0;
  // tensor cores: (cblocks * tblocks) x n_tiles x slots blocks, each walking
  // tiles_per_slot of the `tiles` pixel tiles; cp, np the padded channel
  // pitches of xh and dgates
  int nj = 0, cblocks = 0, tblocks = 0, tiles_w = 0, tiles_h = 0, cp = 0, np = 0;
  long long tiles = 0, tiles_per_slot = 0;
  bool pad_x = false, pad_g = false;
  // workspace floats: slot partials, then the padded xh and dgates copies
  long long part_floats = 0, xpad_floats = 0, gpad_floats = 0;
  long long floats() const { return part_floats + xpad_floats + gpad_floats; }
};

// The plan follows the shape, the dtype and the operands' alignment only
// (never the device or the run), so the summation order, and with it every
// bit of dw, is fixed.  bf16 always takes the tensor cores; f32 the FP32
// pipes.  A null dg means an aligned dgates (B2's own output).
bool plan_dw(bool bf16, const void* xh, const void* dg, int B, int H, int W,
             int Cin, int N, int k, DwPlan* out) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || N < 1 ||
      (k != 1 && k != 3 && k != 5 && k != 7))
    return false;
  DwPlan p;
  const long long npix = (long long)B * H * W;
  const long long M = (long long)k * k * Cin;
  if (bf16) {
    p.mma = true;
    p.nj = N <= 32 ? 1 : (k <= 3 && N > 64 ? 4 : 2);
    p.cp = (Cin + 7) / 8 * 8;
    p.np = (N + 7) / 8 * 8;
    p.cblocks = (p.cp + kDwmCh - 1) / kDwmCh;
    const int tpb = dwm_taps(k, p.nj);
    p.tblocks = (k * k + tpb - 1) / tpb;
    p.n_tiles = (N + 32 * p.nj - 1) / (32 * p.nj);
    p.tiles_w = (W + kDwmCols - 1) / kDwmCols;
    p.tiles_h = (H + kDwmRows - 1) / kDwmRows;
    p.tiles = (long long)B * p.tiles_h * p.tiles_w;
    const long long outs = (long long)p.cblocks * p.tblocks * p.n_tiles;
    const long long slots =
        std::max(1LL, std::min(kDwmMaxSlots, kDwmTargetBlocks / outs));
    p.tiles_per_slot = (p.tiles + slots - 1) / slots;
    p.slots = (int)((p.tiles + p.tiles_per_slot - 1) / p.tiles_per_slot);
    p.pad_x = Cin % 8 != 0 || reinterpret_cast<uintptr_t>(xh) % 16 != 0;
    p.pad_g = N % 8 != 0 || reinterpret_cast<uintptr_t>(dg) % 16 != 0;
    if (outs / p.n_tiles > 0x7fffffffLL || p.n_tiles > 65535) return false;
    p.xpad_floats = p.pad_x ? round4((npix * p.cp + 1) / 2) : 0;
    p.gpad_floats = p.pad_g ? round4((npix * p.np + 1) / 2) : 0;
  } else {
    p.m_tiles = (int)((M + kDwTile - 1) / kDwTile);
    p.n_tiles = (N + kDwTile - 1) / kDwTile;
    const int tiles = p.m_tiles * p.n_tiles;
    p.slots = std::min(kDwMaxSlots,
                       std::max(1, (kDwTargetBlocks + tiles - 1) / tiles));
    long long per = (npix + p.slots - 1) / p.slots;
    per = (per + kDwPix - 1) / kDwPix * kDwPix;
    p.pix_per_slot = (int)per;
    if (p.n_tiles > 65535) return false;
  }
  p.part_floats = round4((long long)p.slots * M * N);
  *out = p;
  return true;
}

template <int K, int NJ>
int launch_dw_mma_k(const DwPlan& p, const __nv_bfloat16* x,
                    const __nv_bfloat16* g, float* part, int H, int W, int Cin,
                    int N, cudaStream_t s) {
  using S = DwmShape<K, NJ>;
  int err = (int)cudaFuncSetAttribute(dw_mma_kernel<K, NJ>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      S::kSmem);
  if (err) return err;
  const dim3 grid(p.cblocks * p.tblocks, p.n_tiles, p.slots);
  dw_mma_kernel<K, NJ><<<grid, kDwmThreads, S::kSmem, s>>>(
      x, g, part, H, W, Cin, p.cp, N, p.np, p.cblocks, p.tiles_w, p.tiles_h,
      p.tiles, p.tiles_per_slot);
  return (int)cudaGetLastError();
}

template <int K>
int launch_dw_mma_nj(const DwPlan& p, const __nv_bfloat16* x,
                     const __nv_bfloat16* g, float* part, int H, int W,
                     int Cin, int N, cudaStream_t s) {
  switch (p.nj) {
    case 1: return launch_dw_mma_k<K, 1>(p, x, g, part, H, W, Cin, N, s);
    case 2: return launch_dw_mma_k<K, 2>(p, x, g, part, H, W, Cin, N, s);
    case 4:  // plan_dw takes 128 columns for k <= 3 only
      if constexpr (K <= 3) return launch_dw_mma_k<K, 4>(p, x, g, part, H, W, Cin, N, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_pad(const __nv_bfloat16* src, __nv_bfloat16* dst, long long rows,
               int C, int Cp, cudaStream_t s) {
  const long long n = rows * (Cp / 8);
  pad_channels_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(src, dst, rows,
                                                                  C, Cp);
  return (int)cudaGetLastError();
}

// (b) and (c) for dw: the slot partials into the workspace `work` (after
// the padded operand copies the plan asks for), then their sum in order
// into `dw`.
template <typename T>
int launch_dw(const DwPlan& p, const void* xh, const void* dgates,
              float* work, void* dw, int B, int H, int W, int Cin, int N,
              int k, cudaStream_t s) {
  const int M = k * k * Cin;
  float* part = work;
  int err = 0;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // every bf16 shape runs on the tensor cores: no other kernel takes it
    if (!p.mma) return (int)cudaErrorInvalidValue;
    const auto* x = static_cast<const __nv_bfloat16*>(xh);
    const auto* g = static_cast<const __nv_bfloat16*>(dgates);
    const long long npix = (long long)B * H * W;
    if (p.pad_x) {
      auto* xp = reinterpret_cast<__nv_bfloat16*>(work + p.part_floats);
      if ((err = launch_pad(x, xp, npix, Cin, p.cp, s))) return err;
      x = xp;
    }
    if (p.pad_g) {
      auto* gp = reinterpret_cast<__nv_bfloat16*>(work + p.part_floats + p.xpad_floats);
      if ((err = launch_pad(g, gp, npix, N, p.np, s))) return err;
      g = gp;
    }
    switch (k) {
      case 1: err = launch_dw_mma_nj<1>(p, x, g, part, H, W, Cin, N, s); break;
      case 3: err = launch_dw_mma_nj<3>(p, x, g, part, H, W, Cin, N, s); break;
      case 5: err = launch_dw_mma_nj<5>(p, x, g, part, H, W, Cin, N, s); break;
      case 7: err = launch_dw_mma_nj<7>(p, x, g, part, H, W, Cin, N, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    if (p.mma) return (int)cudaErrorInvalidValue;
    const dim3 grid(p.m_tiles, p.n_tiles, p.slots);
    dw_partial_kernel<<<grid, kDwThreads, 0, s>>>(
        static_cast<const float*>(xh), static_cast<const float*>(dgates), part,
        H, W, Cin, N, k, M, (long long)B * H * W, p.pix_per_slot);
    err = (int)cudaGetLastError();
  }
  if (err) return err;
  const long long mn = (long long)M * N;
  sum_slots_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      part, static_cast<float*>(dw), p.slots, mn);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_dw(const void* xh, const void* dgates, void* dw, void* work, int B,
            int H, int W, int Cin, int N, int k, void* stream) {
  DwPlan p;
  if (!plan_dw(std::is_same<T, __nv_bfloat16>::value, xh, dgates, B, H, W,
               Cin, N, k, &p))
    return (int)cudaErrorInvalidValue;
  return launch_dw<T>(p, xh, dgates, static_cast<float*>(work), dw, B, H, W,
                      Cin, N, k, static_cast<cudaStream_t>(stream));
}

struct BwdPlan {
  CellLaunch cell;
  DwPlan dw;
  long long db_rows;
  long long floats;  // workspace: dw's (slots and padded copies), then db rows
};

bool plan_bwd(bool bf16, const void* xh, int B, int H, int W, int Cin, int hid,
              int k, BwdPlan* out) {
  BwdPlan p;
  if (!plan_cell(bf16, xh, B, H, W, Cin, hid, k, true, &p.cell)) return false;
  if (!plan_dw(bf16, xh, nullptr, B, H, W, Cin, 4 * hid, k, &p.dw)) return false;
  p.db_rows = (long long)p.cell.grid.x * p.cell.grid.y * p.cell.grid.z;
  p.floats = p.dw.floats() + p.db_rows * 4 * hid;
  *out = p;
  return true;
}

template <typename T>
int backward(const void* xh, const void* w, const void* b, const void* c,
             const void* dh, const void* dc, void* dgates, void* dc_prev,
             void* dw, void* db, void* work, const void* wpack, int B, int H,
             int W, int Cin, int hid, int k, void* stream) {
  BwdPlan p;
  if (!plan_bwd(std::is_same<T, __nv_bfloat16>::value, xh, B, H, W, Cin,
                hid, k, &p))
    return (int)cudaErrorInvalidValue;
  // the plan took dgates as aligned (it is this call's output)
  if (p.dw.mma && !p.dw.pad_g && reinterpret_cast<uintptr_t>(dgates) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = 4 * hid;
  float* dw_work = static_cast<float*>(work);
  float* db_part = dw_work + p.dw.floats();

  const BackwardEpi<T> epi{
      static_cast<const float*>(c), static_cast<const float*>(dh),
      static_cast<const float*>(dc), static_cast<T*>(dgates),
      static_cast<float*>(dc_prev), hid, db_part};
  int err = launch_cell<T>(p.cell, xh, w, wpack, b, epi, H, W, Cin, hid, k, stream);
  if (err) return err;

  if (dw != nullptr) {  // a null dw runs (a) and db alone
    err = launch_dw<T>(p.dw, xh, dgates, dw_work, dw, B, H, W, Cin, N, k, s);
    if (err) return err;
  }
  sum_rows_kernel<<<N, kRowThreads, 0, s>>>(db_part, static_cast<float*>(db),
                                            p.db_rows, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace niswan_cell_bwd_{f32,bf16} needs for these shapes and
// this xh pointer (its alignment picks the copies and the padded copy of
// dw); -1 if no kernel takes them.
long long niswan_cell_bwd_workspace(int bf16, const void* xh, int B, int H,
                                    int W, int Cin, int hid, int k) {
  BwdPlan p;
  if (!plan_bwd(bf16 != 0, xh, B, H, W, Cin, hid, k, &p)) return -1;
  return p.floats;
}

// Floats of workspace niswan_conv_dw_{f32,bf16} needs (the slot partials
// and any zero-padded operand copy); -1 if no kernel takes them.
long long niswan_conv_dw_workspace(int bf16, const void* xh,
                                   const void* dgates, int B, int H, int W,
                                   int Cin, int N, int k) {
  DwPlan p;
  if (!plan_dw(bf16 != 0, xh, dgates, B, H, W, Cin, N, k, &p)) return -1;
  return p.floats();
}

// The plan of dw (b) for these shapes: 1 the tensor cores, 0 the FP32
// pipes, -1 no kernel takes them.  The same for niswan_conv_dw_* and the
// dw of niswan_cell_bwd_* (N = 4*hid).
int niswan_conv_dw_uses_mma(int bf16, int B, int H, int W, int Cin, int N,
                            int k) {
  DwPlan p;
  if (!plan_dw(bf16 != 0, nullptr, nullptr, B, H, W, Cin, N, k, &p)) return -1;
  return p.mma ? 1 : 0;
}

// dw (k,k,Cin,N) f32 = sum over pixels of im2col(xh) x dgates, for xh
// (B,H,W,Cin) and dgates (B,H,W,N) of one dtype: (b) and (c) above.
int niswan_conv_dw_f32(const void* xh, const void* dgates, void* dw,
                       void* work, int B, int H, int W, int Cin, int N, int k,
                       void* stream) {
  return conv_dw<float>(xh, dgates, dw, work, B, H, W, Cin, N, k, stream);
}

int niswan_conv_dw_bf16(const void* xh, const void* dgates, void* dw,
                        void* work, int B, int H, int W, int Cin, int N, int k,
                        void* stream) {
  return conv_dw<__nv_bfloat16>(xh, dgates, dw, work, B, H, W, Cin, N, k,
                                stream);
}

// Each returns the cudaError_t of its launches (0 = success).  They are
// asynchronous on `stream`; nothing is synchronised or allocated here.  A
// null `dw` skips (b): the gate recompute (a) and db alone, for timing.
// `wpack` is w's packed image (niswan_pack_cell_weights) where the wgmma
// mainloop takes the shapes, else null.
int niswan_cell_bwd_f32(const void* xh, const void* w, const void* b,
                        const void* c, const void* dh, const void* dc,
                        void* dgates, void* dc_prev, void* dw, void* db,
                        void* work, const void* wpack, int B, int H, int W, int Cin, int hid,
                        int k, void* stream) {
  return backward<float>(xh, w, b, c, dh, dc, dgates, dc_prev, dw, db, work, wpack,
                         B, H, W, Cin, hid, k, stream);
}

int niswan_cell_bwd_bf16(const void* xh, const void* w, const void* b,
                         const void* c, const void* dh, const void* dc,
                         void* dgates, void* dc_prev, void* dw, void* db,
                         void* work, const void* wpack, int B, int H, int W, int Cin, int hid,
                         int k, void* stream) {
  return backward<__nv_bfloat16>(xh, w, b, c, dh, dc, dgates, dc_prev, dw, db,
                                 work, wpack, B, H, W, Cin, hid, k, stream);
}

}  // extern "C"
