// One elementary pass of the general 3D multipass warp on Hopper: kernel H
// (resample_pass).
//
// Replaces biahub_tpu/kernels/pallas_resample.py:129 _resample_kernel
// (launched at :242 by shear_resample_pallas, :201) and :256
// _resample_kernel_dyn (launched at :344 by shear_resample_pallas_dyn,
// :312), with the semantics of the XLA form biahub_tpu/kernels/
// multipass_warp.py:153-209 _apply_pass. A general affine factors into
// elementary passes (multipass_warp.py _factor_canonical); each resamples
// one axis r of the common frame at
//
//   c = (cr * i_r + tau) + co * i_o        (no co term when o == r)
//
// with the Catmull-Rom band (order 3, taps i0-1 .. i0+2, the multipass
// default) or the linear band (order 1, taps i0, i0+1), i0 = floor(c),
// t = c - i0, taps clamped to the frame, and `fill` where c leaves
// [0, size_r - 1]. The frame has the same shape in and out.
//
// Every operation is float32 with the __f*_rn intrinsics in the
// reference's operand order (no contraction into FMAs), so floor(), the
// domain test and the band weights round as the plain PyTorch version's
// separate ops do, and an identity pass (cr = 1, co = 0, tau = 0: t = 0,
// weights exactly (0, 1, 0, 0)) copies the frame bit for bit.
//
// The coefficients are read from a device table: volume b of the batch
// reads (cr, co, tau) at coeffs[b * cstride + 3 * slot]; cstride 0 is one
// concrete matrix for the whole batch (_resample_kernel), cstride 21 a
// (B, 7, 3) table with one row set per matrix (_resample_kernel_dyn, the
// batched multipass of stabilize).
//
// The TPU's (O, R, T) -> (O, T, R) layout handoff and the transposes
// between passes exist for its lane tiling and are not carried over: H reads
// and writes the frame in ZYX, parametrised by (r, o), and the wrapper
// ping-pongs two frame buffers.
//
// Bound on one H100 SXM (3.35 TB/s): bytes. A pass reads and writes one
// frame once: a (120, 1060, 520) float32 frame is 265 MB each way, 0.16 ms.
// About 30 float32 operations per voxel are far under the card's rate.
// Design: one block per frame row (b, p0, p1), threads along the row's
// contiguous axis p2, so stores are coalesced; for r = 0 or 1 the four taps
// of neighbouring threads are neighbouring addresses of four rows (|co| is
// small for the rotations stabilize and registration fit), for r = 2 they
// are a short contiguous run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int clampi(int i, int n) { return min(max(i, 0), n - 1); }

__global__ void __launch_bounds__(kThreads)
resample_pass_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     const float* __restrict__ coeffs, int cstride, int slot, int F0,
                     int F1, int F2, int r, int o, int order, float fill) {
  const long long row = blockIdx.x;  // (b * F0 + p0) * F1 + p1
  const int p1 = static_cast<int>(row % F1);
  const long long bp0 = row / F1;
  const int p0 = static_cast<int>(bp0 % F0);
  const int b = static_cast<int>(bp0 / F0);
  const float* cb = coeffs + static_cast<long long>(b) * cstride + 3 * slot;
  const float cr = __ldg(cb), co = __ldg(cb + 1), tau = __ldg(cb + 2);
  const int size_r = r == 0 ? F0 : (r == 1 ? F1 : F2);
  const long long stride_r = r == 0 ? static_cast<long long>(F1) * F2 : (r == 1 ? F2 : 1);
  const float hi = static_cast<float>(size_r - 1);
  float* out_row = dst + row * F2;
  for (int p2 = threadIdx.x; p2 < F2; p2 += kThreads) {
    const int i_r = r == 0 ? p0 : (r == 1 ? p1 : p2);
    float c = __fadd_rn(__fmul_rn(cr, static_cast<float>(i_r)), tau);
    if (o != r) {
      const int i_o = o == 0 ? p0 : (o == 1 ? p1 : p2);
      c = __fadd_rn(c, __fmul_rn(co, static_cast<float>(i_o)));
    }
    const float fl = floorf(c);
    const float t = __fsub_rn(c, fl);
    // floor(c) clamped to [-3, size_r + 1] before the int conversion: the
    // same clamped taps, and the conversion stays in range.
    const int i0 = static_cast<int>(fminf(fmaxf(fl, -3.f), static_cast<float>(size_r + 1)));
    // The voxel's row with p_r = 0; the taps are offsets along r from it.
    const float* base = src + (row * F2 + p2 - i_r * stride_r);
    float acc;
    if (order == 1) {
      const float w0 = __fsub_rn(1.f, t);
      acc = __fmul_rn(w0, __ldg(base + clampi(i0, size_r) * stride_r));
      acc = __fadd_rn(acc, __fmul_rn(t, __ldg(base + clampi(i0 + 1, size_r) * stride_r)));
    } else {
      const float t2 = __fmul_rn(t, t);
      const float t3 = __fmul_rn(t2, t);
      const float wm = __fsub_rn(__fadd_rn(__fmul_rn(-0.5f, t3), t2), __fmul_rn(0.5f, t));
      const float w0 = __fadd_rn(__fsub_rn(__fmul_rn(1.5f, t3), __fmul_rn(2.5f, t2)), 1.f);
      const float w1 =
          __fadd_rn(__fadd_rn(__fmul_rn(-1.5f, t3), __fmul_rn(2.f, t2)), __fmul_rn(0.5f, t));
      const float w2 = __fsub_rn(__fmul_rn(0.5f, t3), __fmul_rn(0.5f, t2));
      acc = __fmul_rn(wm, __ldg(base + clampi(i0 - 1, size_r) * stride_r));
      acc = __fadd_rn(acc, __fmul_rn(w0, __ldg(base + clampi(i0, size_r) * stride_r)));
      acc = __fadd_rn(acc, __fmul_rn(w1, __ldg(base + clampi(i0 + 1, size_r) * stride_r)));
      acc = __fadd_rn(acc, __fmul_rn(w2, __ldg(base + clampi(i0 + 2, size_r) * stride_r)));
    }
    out_row[p2] = (c >= 0.f && c <= hi) ? acc : fill;
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// src, dst: (B, F0, F1, F2) float32, distinct; coeffs: float32 on the
// device, (cr, co, tau) of volume b at b * cstride + 3 * slot. r: the
// resampled axis (0-2); o: the other axis of the shear (o == r: none).
// order: 1 or 3.
int resample_pass(const void* src, void* dst, const void* coeffs, int cstride, int slot,
                  int B, int F0, int F1, int F2, int r, int o, int order, float fill,
                  void* stream) {
  const long long rows = static_cast<long long>(B) * F0 * F1;
  resample_pass_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst),
      static_cast<const float*>(coeffs), cstride, slot, F0, F1, F2, r, o, order, fill);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
