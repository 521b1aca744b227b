// Fused ConvLSTM cell forward for Hopper (sm_90a), with a plain C interface
// (loaded with ctypes by nasa_niswan_tpu_torch/ops/_build.py).
//
// Replaces the TPU kernel nasa_niswan_tpu/ops/convlstm_pallas2.py
// ::_cell_kernel_v2 in its three modes; in the plain mode it also computes
// the v1 kernel nasa_niswan_tpu/ops/convlstm_pallas.py::_cell_kernel, which
// is the same cell in the same standard layout.  One launch computes one
// cell step:
//
//   gates = conv_same(xh, w) + b [+ xg]  xh (B,H,W,Cin), w (k,k,Cin,4*hid) HWIO
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the gate blocks
//   c' = c * f + i * g,  h' = o * tanh(c')
//
// xh and w are bf16 or f32; c, b, h' and c' are f32 and every sum is taken in
// f32.  All tensors are dense NHWC / HWIO; the conv's SAME zero padding is
// applied at every frame edge by the tile loader.
//
// Modes (nullable pointers of the one entry point per dtype; with both off
// the kernel reads no xg and writes no gates):
//   xg          hoisted input gates (B,H,W,4*hid) in the compute dtype are
//               added in f32 to the gates; xh is then h alone and w is w_h
//               (the training and serving form of precompute_input_conv);
//   emit_gates  the f32 pre-activation gates, rounded to the compute dtype,
//               are written (B,H,W,4*hid) in block order i, f, g, o: the
//               residual of the per-cell training route, whose backward
//               then needs no gate recompute.
// Both may be on at once.  The plain mode has a second entry point that
// reads its input as the two tensors x and h where they lie, bit-equal to
// the launch on their concatenation (niswan_convlstm_cell_parts_bf16).
//
// The gate conv is one of the two mainloops of cell_mainloop.cuh, whose
// source note says what bounds it and how the design answers: bf16 operands
// with hid in {8, 16, 32, 64} run on the tensor cores (wgmma, weights
// through an asynchronous ring from their packed image, which the caller
// makes once per weight tensor with niswan_pack_cell_weights), everything
// else on the FP32 pipes.  The epilogue below is
// the state update; the four gates of a (pixel, j) meet in one thread, so
// it is thread-local and the 4*hid gate tensor reaches device memory only
// in the emit_gates mode.  No atomics: reruns are bit-identical.

#include "cell_mainloop.cuh"

namespace {

using namespace niswan;

__device__ __forceinline__ void cell_update(float pi, float pf, float pg, float po,
                                            float c, float& h_new, float& c_new) {
  c_new = c * sigmoid(pf) + sigmoid(pi) * tanhf(pg);
  h_new = sigmoid(po) * tanhf(c_new);
}

// The state update, with a nullable hoisted-gate input and a nullable gate
// output, both in the compute dtype T; with both null it reads and writes
// nothing more than the plain cell.
template <typename T>
struct CellEpi {
  const float* c;
  float* h_out;
  float* c_out;
  int hid;
  const T* xg;  // (B,H,W,4*hid) or null
  T* gates;     // (B,H,W,4*hid) or null
  float* db_part;  // unused: no reduction
  static constexpr bool kReduce = false;

  __device__ __forceinline__ void apply(size_t pix, int j, float pi, float pf,
                                        float pg, float po,
                                        float (&)[4]) const {
    const size_t g0 = pix * 4 * hid + j;
    if (xg != nullptr) {
      pi += to_f32(xg[g0]);
      pf += to_f32(xg[g0 + hid]);
      pg += to_f32(xg[g0 + 2 * hid]);
      po += to_f32(xg[g0 + 3 * hid]);
    }
    if (gates != nullptr) {
      gates[g0] = from_f32<T>(pi);
      gates[g0 + hid] = from_f32<T>(pf);
      gates[g0 + 2 * hid] = from_f32<T>(pg);
      gates[g0 + 3 * hid] = from_f32<T>(po);
    }
    const size_t o = pix * hid + j;
    cell_update(pi, pf, pg, po, c[o], h_out[o], c_out[o]);
  }

  // channels j, j + 1 (j even; bf16 only): f32 and bf16 pairs
  __device__ __forceinline__ void apply2(size_t pix, int j, const float (&p)[2][4],
                                         float (&)[2][4]) const {
    float q[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int g = 0; g < 4; ++g) q[e][g] = p[e][g];
    const size_t g0 = pix * 4 * hid + j;
    if (xg != nullptr) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xg + g0 + g * hid));
        q[0][g] += v.x;
        q[1][g] += v.y;
      }
    }
    if (gates != nullptr) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        *reinterpret_cast<__nv_bfloat162*>(gates + g0 + g * hid) =
            __floats2bfloat162_rn(q[0][g], q[1][g]);
    }
    const size_t o = pix * hid + j;
    const float2 cv = *reinterpret_cast<const float2*>(c + o);
    float2 h, cn;
    cell_update(q[0][0], q[0][1], q[0][2], q[0][3], cv.x, h.x, cn.x);
    cell_update(q[1][0], q[1][1], q[1][2], q[1][3], cv.y, h.y, cn.y);
    *reinterpret_cast<float2*>(c_out + o) = cn;
    *reinterpret_cast<float2*>(h_out + o) = h;
  }
};

template <typename T>
int forward(const void* xh, const void* w, const void* b, const void* c,
            const void* xg, void* h_out, void* c_out, void* gates, const void* wpack,
            int B, int H, int W, int Cin, int hid, int k, void* stream) {
  CellLaunch L;
  if (!plan_cell(std::is_same<T, __nv_bfloat16>::value, xh, B, H, W, Cin, hid,
                 k, false, &L))
    return (int)cudaErrorInvalidValue;
  const CellEpi<T> epi{static_cast<const float*>(c), static_cast<float*>(h_out),
                       static_cast<float*>(c_out), hid,
                       static_cast<const T*>(xg), static_cast<T*>(gates),
                       nullptr};
  return launch_cell<T>(L, xh, w, wpack, b, epi, H, W, Cin, hid, k, stream);
}

template <int K>
size_t two_part_budget_k(int hid, size_t xh_smem) {
  using E = CellEpi<__nv_bfloat16>;
  switch (hid) {
    case 8: return parts_smem_budget<K, 1, E>(xh_smem);
    case 16: return parts_smem_budget<K, 2, E>(xh_smem);
    case 32: return parts_smem_budget<K, 4, E>(xh_smem);
    case 64: return parts_smem_budget<K, 8, E>(xh_smem);
    default: return kMaxSmem;
  }
}

// The plan of the two-part launch: false where no kernel takes the
// shapes, they are not on the wgmma mainloop, Cin is over one channel
// group, or a part's layout takes no route (plan_parts).
bool plan_two_part(const void* x, int x_f32, const long long* xs, const void* h, int h_f32,
                   const long long* hs, int B, int H, int W, int Cx, int hid, int k,
                   CellLaunch* L, HaloParts* parts) {
  if (Cx + hid > kGroupCh || !plan_cell(true, nullptr, B, H, W, Cx + hid, hid, k, false, L) ||
      !L->wgmma)
    return false;
  *parts = HaloParts{};
  parts->part[0] = HaloPart{x, xs[0], xs[1], xs[2], xs[3], Cx, x_f32 != 0};
  parts->part[1] = HaloPart{h, hs[0], hs[1], hs[2], hs[3], hid, h_f32 != 0};
  size_t budget;
  switch (k) {
    case 1: budget = two_part_budget_k<1>(hid, L->smem); break;
    case 3: budget = two_part_budget_k<3>(hid, L->smem); break;
    case 5: budget = two_part_budget_k<5>(hid, L->smem); break;
    default: budget = two_part_budget_k<7>(hid, L->smem); break;
  }
  return plan_parts(*parts, *L, k, budget);
}

}  // namespace

extern "C" {

// Which mainloop takes these shapes: 1 the tensor cores (wgmma), 0 the
// FP32 pipes, -1 none.  The same plan serves the gate recompute of
// niswan_cell_bwd_*.
int niswan_cell_plan(int bf16, int B, int H, int W, int Cin, int hid, int k) {
  CellLaunch L;
  if (!plan_cell(bf16 != 0, nullptr, B, H, W, Cin, hid, k, false, &L)) return -1;
  return L.wgmma ? 1 : 0;
}

// Floats of the packed weights of the wgmma mainloop for these shapes
// (0 where the FP32 pipes take them: no packing); -1 if no kernel takes them.
long long niswan_cell_pack_floats(int bf16, int Cin, int hid, int k) {
  CellLaunch L;
  if (!plan_cell(bf16 != 0, nullptr, 1, 1, 1, Cin, hid, k, false, &L)) return -1;
  return L.wgmma ? L.pack_floats() : 0;
}

// w (k,k,Cin,4*hid) bf16 -> its packed image `out` (niswan_cell_pack_floats
// floats, 16-byte aligned), which niswan_convlstm_cell_bf16 and
// niswan_cell_bwd_bf16 read as `wpack`; valid as long as w is unchanged.
int niswan_pack_cell_weights(const void* w, void* out, int Cin, int hid, int k,
                             void* stream) {
  return pack_cell_weights(w, out, Cin, hid, k, static_cast<cudaStream_t>(stream));
}

// Each returns the cudaError_t of its launch (0 = success).  It is
// asynchronous on `stream`; nothing is synchronised or allocated here.
// `xg` (hoisted input gates, compute dtype) and `gates` (gate output,
// compute dtype) are each null when their mode is off; with both null the
// launch is the plain mode.  The xg sum is (conv + b) + xg in f32.  `wpack`
// is w's packed image where the wgmma mainloop takes the shapes, else null.
int niswan_convlstm_cell_f32(const void* xh, const void* w, const void* b,
                             const void* c, const void* xg, void* h_out,
                             void* c_out, void* gates, const void* wpack, int B,
                             int H, int W, int Cin, int hid, int k, void* stream) {
  return forward<float>(xh, w, b, c, xg, h_out, c_out, gates, wpack, B, H, W,
                        Cin, hid, k, stream);
}

int niswan_convlstm_cell_bf16(const void* xh, const void* w, const void* b,
                              const void* c, const void* xg, void* h_out,
                              void* c_out, void* gates, const void* wpack, int B,
                              int H, int W, int Cin, int hid, int k, void* stream) {
  return forward<__nv_bfloat16>(xh, w, b, c, xg, h_out, c_out, gates, wpack, B,
                                H, W, Cin, hid, k, stream);
}

// The plain mode reading its input [x; h] from x (B,H,W,Cx) and h
// (B,H,W,hid) where they lie: each bf16 or f32 (x_f32, h_f32), with its own
// element strides (batch, row, column, channel).  The wgmma mainloop only
// (bf16 weights, hid in {8, 16, 32, 64}) and Cx + hid <= 128; h' and c'
// are bit-equal to niswan_convlstm_cell_bf16 on [x; h] concatenated and
// cast to bf16.  Returns -1, having launched nothing, where the two-part
// launch does not take the shapes or the parts' layouts.
int niswan_convlstm_cell_parts_bf16(
    const void* x, int x_f32, long long xsb, long long xsy, long long xsx, long long xsc,
    const void* h, int h_f32, long long hsb, long long hsy, long long hsx, long long hsc,
    const void* b, const void* c, void* h_out, void* c_out, const void* wpack, int B,
    int H, int W, int Cx, int hid, int k, void* stream) {
  const long long xs[4] = {xsb, xsy, xsx, xsc}, hs[4] = {hsb, hsy, hsx, hsc};
  CellLaunch L;
  HaloParts parts;
  if (!plan_two_part(x, x_f32, xs, h, h_f32, hs, B, H, W, Cx, hid, k, &L, &parts)) return -1;
  const CellEpi<__nv_bfloat16> epi{static_cast<const float*>(c), static_cast<float*>(h_out),
                                   static_cast<float*>(c_out), hid, nullptr, nullptr,
                                   nullptr};
  return launch_cell<__nv_bfloat16, CellEpi<__nv_bfloat16>, true>(
      L, nullptr, nullptr, wpack, b, epi, H, W, Cx + hid, hid, k, stream, parts);
}

const char* niswan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
