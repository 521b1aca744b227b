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
//      order, hence the slots.  bf16 runs dw_mma_kernel_wgmma on the tensor
//      cores for every shape; f32 runs dw_partial_kernel on the FP32 pipes.
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
// operands must reach the tensor cores from shared memory at wgmma's rate,
// each fetched from L2 as few times as possible, with the copies
// overlapping the mmas, at any channel count (config #3's layer 1 takes
// Cin = 70, the 20-level fusion 126).  dw_mma_kernel_wgmma (bf16;
// section (b) below): two consumer
// warpgroups of wgmma accumulators over 8-channel row octets and 128 (or
// 64) gate columns, fed by one TMA producer through full / empty
// mbarriers; every tap from one staged halo by shifted ldmatrix.trans.  It
// takes any Cin and N: a ragged channel count (Cin or N not a multiple of
// 8, or an unaligned operand, which no tensor map can describe) is first
// copied once into a zero-padded buffer of the workspace by
// pad_channels_kernel (17.7 MB written at config #3's layer 1, ~11 us at
// 3.35 TB/s).  The padded rows of dw are never written.

#include <cuda.h>  // CUtensorMap (its encoder is looked up in libcuda at run time)

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
// wgmma.m64nNk16 (f32 accumulate) with M = dw rows (tap, channel), K =
// pixels and N = gate columns.  The M rows come in octets: an octet is the
// 8 channels [8g, 8g + 8) of one tap, and octet o is (plane g = o / k*k,
// tap o % k*k), so Cin 72 or 70 takes 9 planes and Cin 8 one, with no
// 16-channel rounding.  A block owns `octs` consecutive octets (at most
// 16 ACC) x BN gate columns over the pixel tiles of one slot:
//  * two consumer warpgroups, each with ACC accumulators of m64 x BN (BN
//    128, ACC 2 or BN 64, ACC 4: 128 f32 registers a thread); accumulator a
//    of warpgroup wg holds the 8 octets from o0 + 8 (wg ACC + a), warp w of
//    it the two octets 2w, 2w + 1 (its m16 rows);
//  * one producer thread keeps a ring of stages full through TMA, each
//    stage one 8 x 16 pixel tile: the tile's dgates as BN / 64 slabs of 64
//    columns (128 bytes a pixel, 128-byte swizzle), and the tile's xh halo
//    ((8+k-1) x (16+k-1) pixels, zero outside the frame and past Cin: the
//    tensor map's out-of-bounds fill) as one plane of 8 channels (16 bytes
//    a pixel) for each plane the block's octets touch, so an ldmatrix row
//    set (8 pixels of a plane) is 128 contiguous bytes at any tap shift
//    and conflict-free.  full / empty mbarriers hand the stages over; no
//    block-wide barrier per tile; the producer's warpgroup gives its
//    registers to the consumers (setmaxnreg);
//  * per tile row (a k16 step of 16 pixels) each warp ldmatrix.trans'es
//    its A fragment from the halo: rows 0-7 from its first octet's plane
//    at that octet's tap shift, rows 8-15 from its second's (the TPU
//    kernel's roll of dgates per dx, done on the other operand), so one
//    staged halo feeds every tap; B is the dgates slab, read by the tensor
//    cores through a descriptor (MN-major, transpose bit set).  Two tile
//    rows make one commit group; A is double buffered across groups;
//  * dgates is staged once per row block and column block, not once per
//    16 channels, and each staged byte feeds 16 ACC octets of rows.
// The plan (plan_dw) picks BN from N, the octets per block from ACC, k
// and Cin (fewer where two stages would not fit), and the slots so that
// the grid fills one wave of an H100's 132 SMs, one block per SM.

constexpr int kDwgRows = 8;                        // frame rows of a pixel tile: a k16 step each
constexpr int kDwgCols = 16;                       // frame columns of a tile: a k16 step's pixels
constexpr int kDwgSlabCols = 64;                   // gate columns of a slab: 128 bytes a pixel
constexpr int kDwgSlabBytes = kDwgRows * kDwgCols * 128;
constexpr int kDwgConsumers = 256;                 // two consumer warpgroups
constexpr int kDwgThreads = kDwgConsumers + 128;   // + a producer warpgroup (one thread works)
constexpr int kDwgConsumerRegs = 232;              // setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 64K
constexpr int kDwgProducerRegs = 40;
constexpr int kDwgRing = 4;                        // most stages in the ring
constexpr int kDwgLead = 1152;                     // the mbarriers, the stages' 1024-byte alignment
constexpr int kDwgSms = 132;                       // an H100's SMs: one block each
// wgmma B descriptor of a slab: MN-major, 128-byte swizzle (layout 1), the
// next 8 pixels (K) 1024 bytes on (SBO), the next 64 columns (N) a slab on
// (LBO); the start address (>> 4) is added per stage and tile row
constexpr uint64_t kDwgDesc = (uint64_t)1 << 62 | (uint64_t)(kDwgSlabBytes >> 4) << 16 |
                             (uint64_t)(1024 >> 4) << 32;

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the box of `map` at coordinates (c0, c1, c2, c3) into shared memory at
// dst, completing on the mbarrier `bar`; out-of-bounds elements read zero
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(bar)
      : "memory");
}

// The halo plane of 8 channels of (8+k-1) x (16+k-1) pixels, 16 bytes a
// pixel, in a stage: 128-byte aligned for TMA
__host__ __device__ constexpr int dw_plane_bytes(int k) {
  return ((kDwgRows + k - 1) * (kDwgCols + k - 1) * 16 + 127) / 128 * 128;
}

// xmap: xh (B,H,W,cp) in boxes of (8 channels, 16+K-1, 8+K-1, 1);
// gmap: dgates (B,H,W,np) in boxes of (64 columns, 16, 8, 1), swizzled.
// Grid: (row blocks x column blocks, slots); the block writes the f32
// partial of its rows and columns into its slot's (k,k,Cin,N) slice.
template <int K, int BN, int ACC>
__global__ void __launch_bounds__(kDwgThreads, 1)
dw_mma_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap gmap, float* __restrict__ part,
                    int H, int Cin, int N, int octets, int octs, int ring, int stage_bytes,
                    int cblocks, int tiles_w, int tiles_h, long long tiles,
                    long long tiles_per_slot) {
  constexpr int P = K / 2;
  constexpr int KK = K * K;
  constexpr int kHaloW = kDwgCols + K - 1;
  constexpr int kHaloH = kDwgRows + K - 1;
  constexpr int kSlabs = BN / kDwgSlabCols;
  constexpr uint32_t kHaloOff = kSlabs * kDwgSlabBytes;  // the halo's planes follow the slabs
  constexpr int kPlane = dw_plane_bytes(K);
  extern __shared__ __align__(1024) unsigned char dw_smem[];
  const uint32_t bars = smem_u32(dw_smem);  // full[kDwgRing], then empty[kDwgRing]
  const uint32_t stages = (bars + 64 + 1023) & ~1023u;
  const int rb = blockIdx.x / cblocks;
  const int n0 = (blockIdx.x - rb * cblocks) * BN;
  const int o0 = rb * octs;
  const int o_end = min(octets, o0 + octs);
  const int g_lo = o0 / KK;
  const int span = (o_end - 1) / KK - g_lo + 1;  // planes of this block's octets
  const long long t0 = (long long)blockIdx.y * tiles_per_slot;
  const int n_tiles = (int)max(0LL, min(tiles, t0 + tiles_per_slot) - t0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kDwgRing; ++i) {
      mbar_init(bars + 8 * i, 1);                              // the producer
      mbar_init(bars + 8 * (kDwgRing + i), kDwgConsumers / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // pixel tile t: image b, first row y0, first column x0
  auto tile_at = [&](long long t, int& b, int& y0, int& x0) {
    const long long t2 = t / tiles_w;
    x0 = (int)(t - t2 * tiles_w) * kDwgCols;
    y0 = (int)(t2 % tiles_h) * kDwgRows;
    b = (int)(t2 / tiles_h);
  };

  if (tid >= kDwgConsumers) {
    // producer: one thread keeps the ring full; its warpgroup hands its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kDwgProducerRegs));
    if (tid == kDwgConsumers) {
      const uint32_t bytes = kHaloOff + (uint32_t)(span * kHaloW * kHaloH * 16);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ring;
        if (i >= ring) mbar_wait(bars + 8 * (kDwgRing + s), ((i / ring) - 1) & 1);
        int b, y0, x0;
        tile_at(t0 + i, b, y0, x0);
        const uint32_t dst = stages + s * stage_bytes, full = bars + 8 * s;
        mbar_expect_tx(full, bytes);
#pragma unroll
        for (int j = 0; j < kSlabs; ++j)
          tma_load_4d(dst + j * kDwgSlabBytes, &gmap, n0 + j * kDwgSlabCols, x0, y0, b, full);
        for (int g = 0; g < span; ++g)
          tma_load_4d(dst + kHaloOff + g * kPlane, &xmap, 8 * (g_lo + g), x0 - P, y0 - P, b,
                      full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kDwgConsumerRegs));
  const int lane = tid & 31, wg = tid >> 7, w = (tid >> 5) & 3;
  const int grp = lane >> 2, q = lane & 3;
  // ldmatrix row of this lane: matrix lane / 8 = (pixels 0-7 | 8-15) x
  // (first | second octet of the warp), its pixel 8 (lane / 16) + lane % 8
  // of the k16 step.  Rows past the block's last octet read the first
  // octet's and are never written: every accumulator runs, so no wgmma
  // sits on a divergent path (which serialized them all, C7520: layer 1
  // 0.319 ms against 0.240 on an H100, PERF.md)
  const int pix = 8 * (lane >> 4) + (lane & 7);
  uint32_t aoff[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    int o = o0 + (wg * ACC + a) * 8 + 2 * w + ((lane >> 3) & 1);
    if (o >= o_end) o = o0;
    const int tap = o % KK;
    aoff[a] = kHaloOff + (o / KK - g_lo) * kPlane + ((tap / K) * kHaloW + tap % K + pix) * 16;
  }
  constexpr uint32_t kRowBytes = kHaloW * 16;

  float acc[ACC][BN / 2];
#pragma unroll
  for (int a = 0; a < ACC; ++a)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[a][i] = 0.0f;

  uint32_t a0[2][ACC][4], a1[2][ACC][4];
  int slot = 0, rel_slot = 0;
  uint32_t phase = 0;
  bool release = false;
  for (int i = 0; i < n_tiles; ++i) {
    int b, y0, x0;
    tile_at(t0 + i, b, y0, x0);
    // row pairs holding a row of the frame (a row past it reads zero dgates)
    const int pairs = (min(kDwgRows, H - y0) + 1) / 2;
    mbar_wait(bars + 8 * slot, phase);
    const uint32_t st = stages + slot * stage_bytes;
    const uint64_t desc = kDwgDesc | (uint64_t)((st >> 4) & 0x3FFF);
    // tile rows r, r + 1 in one commit group: A of every accumulator, then
    // their wgmmas on the slab rows (16 pixels x 128 bytes = 2048 bytes a
    // row).  ptxas serializes the wgmmas behind the ldmatrix that defines
    // their A (C7513); on an H100 one row a group measured 2.5% slower at
    // layer 1 and four rows 2-5% slower at k 5 (PERF.md)
    auto step = [&](uint32_t (&af)[2][ACC][4], int r) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int a = 0; a < ACC; ++a)
          ldsm_x4_trans(af[j][a], st + aoff[a] + (r + j) * kRowBytes);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int a = 0; a < ACC; ++a)
          WgmmaRS<BN, 1>::mma(acc[a], af[j][a], desc + (uint64_t)((r + j) * (2048 >> 4)));
      wgmma_commit();
      wgmma_wait<1>();  // the previous pair is done: its A registers (and stage) are free
      if (release) {
        if (lane == 0) mbar_arrive(bars + 8 * (kDwgRing + rel_slot));
        release = false;
      }
    };
    for (int p = 0; p < pairs; p += 2) {
      step(a0, 2 * p);
      if (p + 1 < pairs) step(a1, 2 * p + 2);
    }
    if (pairs & 1) wgmma_wait<0>();  // the next tile starts again from a0
    release = true;
    rel_slot = slot;
    if (++slot == ring) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();

  // accumulator (row, col): [4i + 2h + e] -> (16w + grp + 8h, 8i + 2q + e);
  // row 16w + grp + 8h is channel grp of the warp's octet h.  Channels
  // past Cin (the zero-filled plane) and columns past N are not written.
  const size_t M = (size_t)KK * Cin;
  float* out = part + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + (wg * ACC + a) * 8 + 2 * w + h;
      const int c = 8 * (o / KK) + grp;
      if (o >= o_end || c >= Cin) continue;
      float* row = out + ((size_t)(o % KK) * Cin + c) * N;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int n = n0 + 8 * i + 2 * q;
        const float v0 = acc[a][4 * i + 2 * h], v1 = acc[a][4 * i + 2 * h + 1];
        if (n + 1 < N && N % 2 == 0) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < N) row[n] = v0;
          if (n + 1 < N) row[n + 1] = v1;
        }
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
  bool wgmma = false;
  int n_tiles = 0, slots = 0;
  // FP32 pipes: m_tiles x n_tiles x slots blocks of pix_per_slot pixels
  int m_tiles = 0, pix_per_slot = 0;
  // tensor cores: (rblocks x n_tiles column blocks of bn) x slots blocks,
  // each `octs` of the `octets` row octets, walking tiles_per_slot of the
  // `tiles` pixel tiles through a ring of `ring` stages of stage_bytes;
  // its halo `span` planes; cp, np the padded channel pitches of xh and
  // dgates
  int bn = 0, acc = 0, octets = 0, octs = 0, rblocks = 0, span = 0, ring = 0;
  int stage_bytes = 0, tiles_w = 0, tiles_h = 0, cp = 0, np = 0;
  size_t smem = 0;
  long long tiles = 0, tiles_per_slot = 0;
  bool pad_x = false, pad_g = false;
  // workspace floats: slot partials, then the padded xh and dgates copies
  long long part_floats = 0, xpad_floats = 0, gpad_floats = 0;
  long long floats() const { return part_floats + xpad_floats + gpad_floats; }
};

// The planes the halo of a block of `octs` octets must hold, the most
// over the row blocks; octet o lies in plane o / kk.
inline int dw_span(int octets, int octs, int kk) {
  int span = 1;
  for (int o0 = 0; o0 < octets; o0 += octs)
    span = std::max(span, (std::min(octets, o0 + octs) - 1) / kk - o0 / kk + 1);
  return span;
}

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
    p.wgmma = true;
    p.cp = (Cin + 7) / 8 * 8;
    p.np = (N + 7) / 8 * 8;
    const int kk = k * k;
    p.octets = kk * (p.cp / 8);
    // 64 columns (four m64n64 accumulators a warpgroup) up to N 64, else
    // 128 (two m64n128)
    p.bn = N <= kDwgSlabCols ? kDwgSlabCols : 2 * kDwgSlabCols;
    p.acc = 256 / p.bn;
    p.n_tiles = (N + p.bn - 1) / p.bn;
    // 16 acc octets a block, an accumulator's 8 fewer at a time while two
    // stages exceed shared memory
    for (p.octs = 16 * p.acc;; p.octs -= 8) {
      p.span = dw_span(p.octets, p.octs, kk);
      p.stage_bytes = p.bn / kDwgSlabCols * kDwgSlabBytes +
                      (p.span * dw_plane_bytes(k) + 1023) / 1024 * 1024;
      if (p.octs == 8 || kDwgLead + 2 * p.stage_bytes <= kMaxSmem) break;
    }
    if (kDwgLead + 2 * p.stage_bytes > kMaxSmem) return false;
    p.rblocks = (p.octets + p.octs - 1) / p.octs;
    p.ring = std::min(kDwgRing, (kMaxSmem - kDwgLead) / p.stage_bytes);
    p.smem = kDwgLead + (size_t)p.ring * p.stage_bytes;
    p.tiles_w = (W + kDwgCols - 1) / kDwgCols;
    p.tiles_h = (H + kDwgRows - 1) / kDwgRows;
    p.tiles = (long long)B * p.tiles_h * p.tiles_w;
    // one block per SM: as many slots as fill one wave of them
    const long long outs = (long long)p.rblocks * p.n_tiles;
    const long long slots = std::min(p.tiles, std::max(1LL, kDwgSms / outs));
    p.tiles_per_slot = (p.tiles + slots - 1) / slots;
    p.slots = (int)((p.tiles + p.tiles_per_slot - 1) / p.tiles_per_slot);
    p.pad_x = Cin % 8 != 0 || reinterpret_cast<uintptr_t>(xh) % 16 != 0;
    p.pad_g = N % 8 != 0 || reinterpret_cast<uintptr_t>(dg) % 16 != 0;
    if (outs > 0x7fffffffLL) return false;
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

// cuTensorMapEncodeTiled, looked up in libcuda at run time (nothing links
// libcuda); null where the lookup fails
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
    cudaGetLastError();  // a failed query leaves no error for the next launch
  }
  return fn;
}

// The tensor map of a bf16 (B,H,W,C) tensor (C % 8 == 0, 16-byte
// aligned) in boxes of (bc channels, bw columns, bh rows, 1 image), the
// 128-byte swizzle or none; elements out of bounds read zero.
bool nhwc_map(CUtensorMap* map, const void* t, int B, int H, int W, int C, int bc, int bw,
              int bh, bool swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int K, int BN, int ACC>
int launch_dw_wgmma_k(const DwPlan& p, const __nv_bfloat16* x, const __nv_bfloat16* g,
                      float* part, int B, int H, int W, int Cin, int N, cudaStream_t s) {
  CUtensorMap xmap, gmap;
  if (!nhwc_map(&xmap, x, B, H, W, p.cp, 8, kDwgCols + K - 1, kDwgRows + K - 1, false) ||
      !nhwc_map(&gmap, g, B, H, W, p.np, kDwgSlabCols, kDwgCols, kDwgRows, true))
    return (int)cudaErrorInvalidValue;
  auto kernel = dw_mma_kernel_wgmma<K, BN, ACC>;
  // once per kernel, to the card's most, so a CUDA graph capture makes no
  // attribute call
  static int ready = 0;
  if (!ready) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err) return err;
    ready = 1;
  }
  const dim3 grid(p.rblocks * p.n_tiles, p.slots);
  kernel<<<grid, kDwgThreads, p.smem, s>>>(xmap, gmap, part, H, Cin, N, p.octets, p.octs,
                                            p.ring, p.stage_bytes, p.n_tiles, p.tiles_w,
                                            p.tiles_h, p.tiles, p.tiles_per_slot);
  return (int)cudaGetLastError();
}

template <int K>
int launch_dw_wgmma(const DwPlan& p, const __nv_bfloat16* x, const __nv_bfloat16* g,
                    float* part, int B, int H, int W, int Cin, int N, cudaStream_t s) {
  if (p.bn == kDwgSlabCols) return launch_dw_wgmma_k<K, 64, 4>(p, x, g, part, B, H, W, Cin, N, s);
  return launch_dw_wgmma_k<K, 128, 2>(p, x, g, part, B, H, W, Cin, N, s);
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
    if (!p.wgmma) return (int)cudaErrorInvalidValue;
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
      case 1: err = launch_dw_wgmma<1>(p, x, g, part, B, H, W, Cin, N, s); break;
      case 3: err = launch_dw_wgmma<3>(p, x, g, part, B, H, W, Cin, N, s); break;
      case 5: err = launch_dw_wgmma<5>(p, x, g, part, B, H, W, Cin, N, s); break;
      case 7: err = launch_dw_wgmma<7>(p, x, g, part, B, H, W, Cin, N, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    if (p.wgmma) return (int)cudaErrorInvalidValue;
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
  if (p.dw.wgmma && !p.dw.pad_g && reinterpret_cast<uintptr_t>(dgates) % 16)
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

// The plan of dw (b) for these shapes: 1 dw_mma_kernel_wgmma, 0 the FP32
// pipes, -1 no kernel takes them.  The same for niswan_conv_dw_* and the
// dw of niswan_cell_bwd_* (N = 4*hid).
int niswan_conv_dw_plan(int bf16, int B, int H, int W, int Cin, int N, int k) {
  DwPlan p;
  if (!plan_dw(bf16 != 0, nullptr, nullptr, B, H, W, Cin, N, k, &p)) return -1;
  return p.wgmma ? 1 : 0;
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
