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
// Both may be on at once.  The gates are written in block order from the
// mainloop's de-interleaved (i, f, g, o) of channel j, not in the tensor-core
// path's interleaved column order n = 4j + g.
//
// The gate conv is one of the two mainloops of cell_mainloop.cuh: bf16
// operands with hid in {8, 16, 32, 64} run on the tensor cores (mma.sync),
// everything else on the FP32 pipes.  The epilogue below is the state
// update; the four gates of a (pixel, j) meet in one thread, so it is
// thread-local and the 4*hid gate tensor reaches device memory only in the
// emit_gates mode.  No atomics: reruns are bit-identical.
//
// What bounds it: at the serving shapes (B=1, 100x154, layer 1 Cin=126,
// hid=64, k=5) the gate conv is an M=15,400 x N=256 x K=3,150 product, about
// 25 GFLOP of the step's 29, against ~17 MB of traffic: compute-bound on
// paper.  The FP32 kernel issues 4 weight loads and 4 shared loads per 16
// FMAs, so its load/store unit is the limit.  The tensor-core kernel
// restages a 32 x N weight slice from L2 for every (channel chunk, tap),
// ~200 MB of L2 reads per layer-1 step over 130 blocks of 8 rows, with two
// barriers per stage; that staging, not the mma rate, is its limit.  wgmma
// with TMA-fed, multi-stage tiles is the later, fast version.

#include "cell_mainloop.cuh"

namespace {

using namespace niswan;

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
    const float ig = sigmoid(pi);
    const float fg = sigmoid(pf);
    const float gg = tanhf(pg);
    const float og = sigmoid(po);
    const float c_new = c[o] * fg + ig * gg;
    c_out[o] = c_new;
    h_out[o] = og * tanhf(c_new);
  }
};

template <typename T>
int forward(const void* xh, const void* w, const void* b, const void* c,
            const void* xg, void* h_out, void* c_out, void* gates, int B, int H,
            int W, int Cin, int hid, int k, void* stream) {
  CellLaunch L;
  if (!plan_cell(std::is_same<T, __nv_bfloat16>::value, w, B, H, W, Cin, hid,
                 k, false, &L))
    return (int)cudaErrorInvalidValue;
  const CellEpi<T> epi{static_cast<const float*>(c), static_cast<float*>(h_out),
                       static_cast<float*>(c_out), hid,
                       static_cast<const T*>(xg), static_cast<T*>(gates),
                       nullptr};
  return launch_cell<T>(L, xh, w, b, epi, H, W, Cin, hid, k, stream);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = success).  The launch is
// asynchronous on `stream`; nothing is synchronised or allocated here.
// `xg` (hoisted input gates, compute dtype) and `gates` (gate output,
// compute dtype) are each null when their mode is off; with both null the
// launch is the plain mode.  The xg sum is (conv + b) + xg in f32.
int niswan_convlstm_cell_f32(const void* xh, const void* w, const void* b,
                             const void* c, const void* xg, void* h_out,
                             void* c_out, void* gates, int B, int H, int W,
                             int Cin, int hid, int k, void* stream) {
  return forward<float>(xh, w, b, c, xg, h_out, c_out, gates, B, H, W, Cin,
                        hid, k, stream);
}

int niswan_convlstm_cell_bf16(const void* xh, const void* w, const void* b,
                              const void* c, const void* xg, void* h_out,
                              void* c_out, void* gates, int B, int H, int W,
                              int Cin, int hid, int k, void* stream) {
  return forward<__nv_bfloat16>(xh, w, b, c, xg, h_out, c_out, gates, B, H, W,
                                Cin, hid, k, stream);
}

const char* niswan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
