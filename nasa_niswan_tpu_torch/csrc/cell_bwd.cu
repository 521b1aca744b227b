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
//      forward's implicit-GEMM mainloop (cell_mainloop.cuh: tensor cores for
//      bf16 with hid in {8, 16, 32, 64}, FP32 pipes otherwise), and the
//      epilogue applies the elementwise backward of the nonlinearities and
//      the state update (convgrad_pallas.py:147-163) in registers.  It writes
//      dgates rounded to the compute dtype, dc_prev, and per block the f32
//      sums of its dgates (the db partials, one row per block).
//  (b) dw_partial_mma_kernel (bf16, Cin and 4*hid multiples of 8: tensor
//      cores) or dw_partial_kernel (otherwise: FP32 pipes): dw as a GEMM of
//      M = k*k*Cin rows by N = 4*hid columns over K = B*H*W pixels (123,200
//      at the training shapes), split over the pixels into a fixed number of
//      slots; each block owns a tile of dw and one slot and writes its f32
//      partial tile.  The TPU kernel instead kept dw resident across its
//      sequential grid; CUDA blocks run in no order, hence the slots.
//  (c) sum_slots_kernel / sum_rows_kernel: dw and db summed over the slots
//      and block rows, each in a fixed order.
//
// (b) and (c) for dw also run on their own (niswan_conv_dw_*): the weight
// gradient of the per-cell training route, whose forward kept the gates.
//
// The workspace (slot partials and db partials) is allocated by the caller;
// niswan_cell_bwd_workspace says how many floats it needs.
//
// What bounds it: at the training shapes (B=8, 100x154, layer 1 Cin=72,
// hid=64, k=5) (a) is the forward's 114 GFLOP gate conv again, and (b) a
// further 114 GFLOP (M=1,800 x N=256 x K=123,200).  On the FP32 pipes each
// thread of (b) holds an 8 x 8 register tile fed by two 16-byte shared loads
// per operand and pixel; the tensor-core (b) is bounded by its staging, one
// pass of 64 pixels per pair of barriers, with one pixel decomposition per
// 16-byte load of xh.

#include "cell_mainloop.cuh"

namespace {

using namespace niswan;

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
    const float i = sigmoid(pi);
    const float f = sigmoid(pf);
    const float g = tanhf(pg);
    const float og = sigmoid(po);
    const float c32 = c[o];
    const float tc = tanhf(c32 * f + i * g);
    const float dhv = dh[o];
    const float dct = dc[o] + dhv * og * (1.0f - tc * tc);
    const float d_i = dct * g * i * (1.0f - i);
    const float d_f = dct * c32 * f * (1.0f - f);
    const float d_g = dct * i * (1.0f - g * g);
    const float d_o = dhv * tc * og * (1.0f - og);
    T* dg = dgates + pix * 4 * hid + j;
    dg[0] = from_f32<T>(d_i);
    dg[hid] = from_f32<T>(d_f);
    dg[2 * hid] = from_f32<T>(d_g);
    dg[3 * hid] = from_f32<T>(d_o);
    dc_prev[o] = dct * f;
    sum[0] += d_i;
    sum[1] += d_f;
    sum[2] += d_g;
    sum[3] += d_o;
  }
};

// ---- (b) dw = im2col(xh)^T . dgates, split over pixel slots ------------------

constexpr int kDwmTileM = 128, kDwmTileN = 64, kDwmPix = 64;  // mma kernel
constexpr int kDwTile = 128;    // dw rows and columns per block
constexpr int kDwPix = 16;      // pixels staged per pass
constexpr int kDwThreads = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int kDwTargetBlocks = 512;
constexpr int kDwMaxSlots = 64;

struct DwPlan {
  bool mma;
  int m_tiles, n_tiles, slots, pix_per_slot;
};

// The slot count follows the shape and dtype only (never the device or the
// run), so the summation order, and with it every bit of dw, is fixed.
DwPlan plan_dw(bool mma, long long npix, int M, int N) {
  DwPlan p;
  p.mma = mma;
  const int tm = mma ? kDwmTileM : kDwTile, tn = mma ? kDwmTileN : kDwTile;
  const int pix = mma ? kDwmPix : kDwPix;
  p.m_tiles = (M + tm - 1) / tm;
  p.n_tiles = (N + tn - 1) / tn;
  const int tiles = p.m_tiles * p.n_tiles;
  p.slots = std::min(kDwMaxSlots,
                     std::max(1, (kDwTargetBlocks + tiles - 1) / tiles));
  long long per = (npix + p.slots - 1) / p.slots;
  per = (per + pix - 1) / pix * pix;
  p.pix_per_slot = (int)per;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
dw_partial_kernel(const T* __restrict__ xh, const T* __restrict__ dg,
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
            a = to_f32(xh[((bi * H + yy) * W + xx) * C + ch]);
        }
        if (n < N) bv = to_f32(dg[p * N + n]);
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

// The same partial tiles on the tensor cores, for bf16 operands with Cin and
// 4*hid multiples of 8: mma.sync m16n8k16 (f32 accumulate) with M = dw rows
// (tap, channel), N = gate columns and K = pixels.  Both operands are
// pixel-major in memory, so each pass stages 64 pixels of them as they are
// (16-byte loads: 8 channels of one tap, or 8 gate columns) and ldmatrix.trans
// turns them into the row-major A and column-major B fragments.  A block owns
// a 128 x 64 tile of dw with 8 warps, 4 along M x 2 along N, each 32 x 32.
// The next pass's loads are issued into registers before this pass's mmas.

constexpr int kDwmStrideA = kDwmTileM + 8;  // bf16 per staged pixel row
constexpr int kDwmStrideB = kDwmTileN + 8;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__global__ void __launch_bounds__(kDwThreads)
dw_partial_mma_kernel(const __nv_bfloat16* __restrict__ xh,
                      const __nv_bfloat16* __restrict__ dg,
                      float* __restrict__ part, int H, int W, int C, int N,
                      int k, int M, long long npix, int pix_per_slot) {
  __shared__ __align__(16) __nv_bfloat16 s_a[kDwmPix * kDwmStrideA];
  __shared__ __align__(16) __nv_bfloat16 s_b[kDwmPix * kDwmStrideB];
  const int m0 = blockIdx.x * kDwmTileM;
  const int n0 = blockIdx.y * kDwmTileN;
  const int slot = blockIdx.z;
  const long long p_begin = (long long)slot * pix_per_slot;
  const long long p_end = min(npix, p_begin + pix_per_slot);
  const int P = k / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int grp = lane >> 2, quad = lane & 3;

  // staging roles: A, 8 channels (one m-group) x 4 pixels; B, 8 gate
  // columns x 2 pixels
  const int ag = threadIdx.x % (kDwmTileM / 8), ap = threadIdx.x / (kDwmTileM / 8);
  const int am = m0 + 8 * ag;
  const int atap = am / C, ach = am % C;
  const int aoy = atap / k - P, aox = atap % k - P;
  const int bg = threadIdx.x % (kDwmTileN / 8), bp = threadIdx.x / (kDwmTileN / 8);
  const int bn = n0 + 8 * bg;
  uint4 ra[4], rb[2];

  auto load = [&](long long p0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long p = p0 + ap + 16 * r;
      ra[r] = make_uint4(0, 0, 0, 0);
      if (p < p_end && am < M) {
        const int x = (int)(p % W);
        const long long t = p / W;
        const int y = (int)(t % H);
        const long long bi = t / H;
        const int yy = y + aoy, xx = x + aox;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          ra[r] = *reinterpret_cast<const uint4*>(
              xh + ((bi * H + yy) * W + xx) * C + ach);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long p = p0 + bp + 32 * r;
      rb[r] = make_uint4(0, 0, 0, 0);
      if (p < p_end && bn < N)
        rb[r] = *reinterpret_cast<const uint4*>(dg + p * N + bn);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<uint4*>(s_a + (ap + 16 * r) * kDwmStrideA + 8 * ag) = ra[r];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint4*>(s_b + (bp + 32 * r) * kDwmStrideB + 8 * bg) = rb[r];
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

  // ldmatrix row addresses: lane -> matrix lane / 8, row lane % 8
  const int lr = lane & 7, li = lane >> 3;
  if (p_begin < p_end) {
    load(p_begin);
    store();
  }
  __syncthreads();
  for (long long p0 = p_begin; p0 < p_end; p0 += kDwmPix) {
    const bool more = p0 + kDwmPix < p_end;
    if (more) load(p0 + kDwmPix);
#pragma unroll
    for (int ks = 0; ks < kDwmPix; ks += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4_trans(a[mt], s_a + (ks + lr + 8 * (li >> 1)) * kDwmStrideA +
                                     wm * 32 + mt * 16 + 8 * (li & 1));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(b[np], s_b + (ks + lr + 8 * (li & 1)) * kDwmStrideB +
                                     wn * 32 + (2 * np + (li >> 1)) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)],
                   b[nt >> 1][2 * (nt & 1) + 1]);
    }
    __syncthreads();  // every warp is done with this pass
    if (more) {
      store();
      __syncthreads();
    }
  }

  // accumulator (row, col): d0,d1 -> (grp, 2*quad + {0,1}); d2,d3 -> (grp+8, same)
  float* out = part + (size_t)slot * M * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = m0 + wm * 32 + mt * 16 + grp;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * quad;
      if (n >= N) continue;
      if (m < M)
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (m + 8 < M)
        *reinterpret_cast<float2*>(out + (size_t)(m + 8) * N + n) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
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

// (b) and (c) for dw: the slot partials into `dw_part`, then their sum in
// order into `dw`.
template <typename T>
int launch_dw(const DwPlan& p, const void* xh, const void* dgates,
              float* dw_part, void* dw, int B, int H, int W, int Cin, int N,
              int k, cudaStream_t s) {
  const int M = k * k * Cin;
  const dim3 grid(p.m_tiles, p.n_tiles, p.slots);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (p.mma)
      dw_partial_mma_kernel<<<grid, kDwThreads, 0, s>>>(
          static_cast<const T*>(xh), static_cast<const T*>(dgates), dw_part, H,
          W, Cin, N, k, M, (long long)B * H * W, p.pix_per_slot);
  }
  if (!p.mma)
    dw_partial_kernel<T><<<grid, kDwThreads, 0, s>>>(
        static_cast<const T*>(xh), static_cast<const T*>(dgates), dw_part, H,
        W, Cin, N, k, M, (long long)B * H * W, p.pix_per_slot);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long mn = (long long)M * N;
  sum_slots_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      dw_part, static_cast<float*>(dw), p.slots, mn);
  return (int)cudaGetLastError();
}

// dw alone, for a gate cotangent computed elsewhere (the per-cell training
// route, whose forward kept the gates): the tensor-core dw takes bf16 with
// Cin and N multiples of 8 and 16-byte aligned xh and dgates.
bool plan_conv_dw(bool bf16, const void* xh, const void* dgates, int B, int H,
                  int W, int Cin, int N, int k, DwPlan* out) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || N < 1 ||
      (k != 1 && k != 3 && k != 5 && k != 7))
    return false;
  const bool mma = bf16 && Cin % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(xh) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dgates) % 16 == 0;
  const DwPlan p = plan_dw(mma, (long long)B * H * W, k * k * Cin, N);
  if (p.n_tiles > 65535) return false;
  *out = p;
  return true;
}

template <typename T>
int conv_dw(const void* xh, const void* dgates, void* dw, void* work, int B,
            int H, int W, int Cin, int N, int k, void* stream) {
  DwPlan p;
  if (!plan_conv_dw(std::is_same<T, __nv_bfloat16>::value, xh, dgates, B, H,
                    W, Cin, N, k, &p))
    return (int)cudaErrorInvalidValue;
  return launch_dw<T>(p, xh, dgates, static_cast<float*>(work), dw, B, H, W,
                      Cin, N, k, static_cast<cudaStream_t>(stream));
}

struct BwdPlan {
  CellLaunch cell;
  DwPlan dw;
  long long db_rows;
  long long floats;  // workspace: dw slots, then db rows
};

// The tensor-core dw takes bf16 with Cin and 4*hid multiples of 8 and
// 16-byte aligned xh (its 16-byte loads stay inside one tap's channels).
bool plan_bwd(bool bf16, const void* xh, const void* w, int B, int H, int W,
              int Cin, int hid, int k, BwdPlan* out) {
  BwdPlan p;
  if (!plan_cell(bf16, w, B, H, W, Cin, hid, k, true, &p.cell)) return false;
  const int M = k * k * Cin, N = 4 * hid;
  const long long npix = (long long)B * H * W;
  const bool mma = bf16 && Cin % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(xh) % 16 == 0;
  p.dw = plan_dw(mma, npix, M, N);
  if (p.dw.n_tiles > 65535) return false;
  p.db_rows = (long long)p.cell.grid.x * p.cell.grid.y * p.cell.grid.z;
  p.floats = (long long)p.dw.slots * M * N + p.db_rows * N;
  *out = p;
  return true;
}

template <typename T>
int backward(const void* xh, const void* w, const void* b, const void* c,
             const void* dh, const void* dc, void* dgates, void* dc_prev,
             void* dw, void* db, void* work, int B, int H, int W, int Cin,
             int hid, int k, void* stream) {
  BwdPlan p;
  if (!plan_bwd(std::is_same<T, __nv_bfloat16>::value, xh, w, B, H, W, Cin,
                hid, k, &p))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = k * k * Cin, N = 4 * hid;
  float* dw_part = static_cast<float*>(work);
  float* db_part = dw_part + (size_t)p.dw.slots * M * N;

  const BackwardEpi<T> epi{
      static_cast<const float*>(c), static_cast<const float*>(dh),
      static_cast<const float*>(dc), static_cast<T*>(dgates),
      static_cast<float*>(dc_prev), hid, db_part};
  int err = launch_cell<T>(p.cell, xh, w, b, epi, H, W, Cin, hid, k, stream);
  if (err) return err;

  err = launch_dw<T>(p.dw, xh, dgates, dw_part, dw, B, H, W, Cin, N, k, s);
  if (err) return err;
  sum_rows_kernel<<<N, kRowThreads, 0, s>>>(db_part, static_cast<float*>(db),
                                            p.db_rows, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace niswan_cell_bwd_{f32,bf16} needs for these shapes and
// these xh and weight pointers (their alignment picks the kernels); -1 if no
// kernel takes them.
long long niswan_cell_bwd_workspace(int bf16, const void* xh, const void* w,
                                    int B, int H, int W, int Cin, int hid,
                                    int k) {
  BwdPlan p;
  if (!plan_bwd(bf16 != 0, xh, w, B, H, W, Cin, hid, k, &p)) return -1;
  return p.floats;
}

// Floats of workspace niswan_conv_dw_{f32,bf16} needs (the slot
// partials); -1 if no kernel takes them.
long long niswan_conv_dw_workspace(int bf16, const void* xh,
                                   const void* dgates, int B, int H, int W,
                                   int Cin, int N, int k) {
  DwPlan p;
  if (!plan_conv_dw(bf16 != 0, xh, dgates, B, H, W, Cin, N, k, &p)) return -1;
  return (long long)p.slots * k * k * Cin * N;
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
// asynchronous on `stream`; nothing is synchronised or allocated here.
int niswan_cell_bwd_f32(const void* xh, const void* w, const void* b,
                        const void* c, const void* dh, const void* dc,
                        void* dgates, void* dc_prev, void* dw, void* db,
                        void* work, int B, int H, int W, int Cin, int hid,
                        int k, void* stream) {
  return backward<float>(xh, w, b, c, dh, dc, dgates, dc_prev, dw, db, work, B,
                         H, W, Cin, hid, k, stream);
}

int niswan_cell_bwd_bf16(const void* xh, const void* w, const void* b,
                         const void* c, const void* dh, const void* dc,
                         void* dgates, void* dc_prev, void* dw, void* db,
                         void* work, int B, int H, int W, int Cin, int hid,
                         int k, void* stream) {
  return backward<__nv_bfloat16>(xh, w, b, c, dh, dc, dgates, dc_prev, dw, db,
                                 work, B, H, W, Cin, hid, k, stream);
}

}  // extern "C"
