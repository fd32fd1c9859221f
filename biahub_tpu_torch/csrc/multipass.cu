// One elementary pass of the general 3D multipass warp on Hopper, kernel H
// (resample_pass), and its VJP, kernels I (resample_pass_deriv) and J
// (resample_pass_adjoint).
//
// H replaces biahub_tpu/kernels/pallas_resample.py:129 _resample_kernel
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
//
// I and J replace pallas_resample.py:1226 _resample_kernel_dyn_deriv
// (launched at :1324 through _dyn_call, by shear_resample_deriv_dyn :1340)
// and :1271 _resample_kernel_dyn_adjoint (launched at :1358 by
// shear_resample_adjoint_dyn :1348): the custom VJP of a pass
// (multipass_warp.py:590-626 _pallas_pass_ad), here the exact gradient of
// H's function, clamped edge taps included (the Pallas adjoint drops them).
// Both recompute c with H's device function, so floor() and the domain test
// route every sample as the forward pass did.
//
// I: for pass input src and output cotangent ybar, the three sums
// (sum ybar*dv*i_r, sum ybar*dv*i_o, sum ybar*dv) over the in-domain
// samples, dv the band-derivative resample of src at c (d weight / d t:
// (-1, 1) for order 1, the Catmull-Rom derivative of pallas_resample.py:
// 1257-1265 for order 3). The TPU kernel writes the whole dv frame and XLA
// reduces it; I never stores dv: t is promoted to double, the derivative
// band, the products and a block's sums are double (float32 over ~1e8
// terms would drift by ~1e-4), and each block writes its row's three
// partials; the wrapper sums them. Bound: bytes (reads src and ybar once).
//
// J: dbar[p] = sum over in-domain q of w_k(c_q) * ybar[q] where
// clamp(floor(c_q) + k) == p, a deterministic gather (no atomics): each
// thread owns one p and scans the q whose taps can reach it, the span of
// c in [p - kmax - 1, p - kmin + 1] solved for q (swapped when cr < 0) and
// widened by one, computed per thread from cr (no host synchronize, no
// fixed maximum scale). Taps clamped at the frame edge fold into p = 0 or
// size_r - 1 and come only from c in [0, 1) or [size_r - 2, size_r - 1],
// inside that span. Bound: bytes (reads ybar once, writes dbar once); the
// window costs ~(band + 3) / |cr| recomputed coordinates per voxel.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int clampi(int i, int n) { return min(max(i, 0), n - 1); }

// The pass's coordinate, in H's operand order.
__device__ __forceinline__ float pass_coord(float cr, float co, float tau, int i_r, int i_o,
                                            bool shear) {
  float c = __fadd_rn(__fmul_rn(cr, static_cast<float>(i_r)), tau);
  if (shear) c = __fadd_rn(c, __fmul_rn(co, static_cast<float>(i_o)));
  return c;
}

// floor(c) clamped to [-3, size_r + 1] before the int conversion (the same
// clamped taps, and the conversion stays in range), and t = c - floor(c).
__device__ __forceinline__ int tap_floor(float c, int size_r, float* t) {
  const float fl = floorf(c);
  *t = __fsub_rn(c, fl);
  return static_cast<int>(fminf(fmaxf(fl, -3.f), static_cast<float>(size_r + 1)));
}

// The band's weights w[0..3] for taps i0-1 .. i0+2 (order 3) or w[1..2] for
// i0, i0+1 (order 1; w[0] = w[3] = 0).
__device__ __forceinline__ void band_weights(float t, int order, float* w) {
  if (order == 1) {
    w[0] = 0.f;
    w[1] = __fsub_rn(1.f, t);
    w[2] = t;
    w[3] = 0.f;
    return;
  }
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  w[0] = __fsub_rn(__fadd_rn(__fmul_rn(-0.5f, t3), t2), __fmul_rn(0.5f, t));
  w[1] = __fadd_rn(__fsub_rn(__fmul_rn(1.5f, t3), __fmul_rn(2.5f, t2)), 1.f);
  w[2] = __fadd_rn(__fadd_rn(__fmul_rn(-1.5f, t3), __fmul_rn(2.f, t2)), __fmul_rn(0.5f, t));
  w[3] = __fsub_rn(__fmul_rn(0.5f, t3), __fmul_rn(0.5f, t2));
}

struct Row {
  long long row;  // (b * F0 + p0) * F1 + p1
  int p0, p1, b;
};

__device__ __forceinline__ Row this_row(int F0, int F1) {
  Row w;
  w.row = blockIdx.x;
  w.p1 = static_cast<int>(w.row % F1);
  const long long bp0 = w.row / F1;
  w.p0 = static_cast<int>(bp0 % F0);
  w.b = static_cast<int>(bp0 / F0);
  return w;
}

__device__ __forceinline__ int axis_index(int axis, int p0, int p1, int p2) {
  return axis == 0 ? p0 : (axis == 1 ? p1 : p2);
}

__global__ void __launch_bounds__(kThreads)
resample_pass_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     const float* __restrict__ coeffs, int cstride, int slot, int F0,
                     int F1, int F2, int r, int o, int order, float fill) {
  const Row w = this_row(F0, F1);
  const float* cb = coeffs + static_cast<long long>(w.b) * cstride + 3 * slot;
  const float cr = __ldg(cb), co = __ldg(cb + 1), tau = __ldg(cb + 2);
  const int size_r = r == 0 ? F0 : (r == 1 ? F1 : F2);
  const long long stride_r = r == 0 ? static_cast<long long>(F1) * F2 : (r == 1 ? F2 : 1);
  const float hi = static_cast<float>(size_r - 1);
  float* out_row = dst + w.row * F2;
  for (int p2 = threadIdx.x; p2 < F2; p2 += kThreads) {
    const int i_r = axis_index(r, w.p0, w.p1, p2);
    const float c = pass_coord(cr, co, tau, i_r, axis_index(o, w.p0, w.p1, p2), o != r);
    float t;
    const int i0 = tap_floor(c, size_r, &t);
    // The voxel's row with p_r = 0; the taps are offsets along r from it.
    const float* base = src + (w.row * F2 + p2 - i_r * stride_r);
    float acc;
    if (order == 1) {
      const float w0 = __fsub_rn(1.f, t);
      acc = __fmul_rn(w0, __ldg(base + clampi(i0, size_r) * stride_r));
      acc = __fadd_rn(acc, __fmul_rn(t, __ldg(base + clampi(i0 + 1, size_r) * stride_r)));
    } else {
      float wk[4];
      band_weights(t, 3, wk);
      acc = __fmul_rn(wk[0], __ldg(base + clampi(i0 - 1, size_r) * stride_r));
      acc = __fadd_rn(acc, __fmul_rn(wk[1], __ldg(base + clampi(i0, size_r) * stride_r)));
      acc = __fadd_rn(acc, __fmul_rn(wk[2], __ldg(base + clampi(i0 + 1, size_r) * stride_r)));
      acc = __fadd_rn(acc, __fmul_rn(wk[3], __ldg(base + clampi(i0 + 2, size_r) * stride_r)));
    }
    out_row[p2] = (c >= 0.f && c <= hi) ? acc : fill;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
resample_pass_deriv_kernel(const float* __restrict__ src, const float* __restrict__ ybar,
                           const float* __restrict__ coeffs, int cstride, int slot, int F0,
                           int F1, int F2, int r, int o, int order,
                           double* __restrict__ partials) {
  const Row w = this_row(F0, F1);
  const float* cb = coeffs + static_cast<long long>(w.b) * cstride + 3 * slot;
  const float cr = __ldg(cb), co = __ldg(cb + 1), tau = __ldg(cb + 2);
  const int size_r = r == 0 ? F0 : (r == 1 ? F1 : F2);
  const long long stride_r = r == 0 ? static_cast<long long>(F1) * F2 : (r == 1 ? F2 : 1);
  const float hi = static_cast<float>(size_r - 1);
  const bool shear = o != r;
  double s_r = 0.0, s_o = 0.0, s_1 = 0.0;
  for (int p2 = threadIdx.x; p2 < F2; p2 += kThreads) {
    const int i_r = axis_index(r, w.p0, w.p1, p2);
    const int i_o = axis_index(o, w.p0, w.p1, p2);
    const float c = pass_coord(cr, co, tau, i_r, i_o, shear);
    if (!(c >= 0.f && c <= hi)) continue;  // H wrote the fill: no derivative
    float t;
    const int i0 = tap_floor(c, size_r, &t);
    const float* base = src + (w.row * F2 + p2 - i_r * stride_r);
    double dv;
    if (order == 1) {
      const double v0 = __ldg(base + clampi(i0, size_r) * stride_r);
      const double v1 = __ldg(base + clampi(i0 + 1, size_r) * stride_r);
      dv = __dadd_rn(__dmul_rn(-1.0, v0), __dmul_rn(1.0, v1));
    } else {
      const double td = t;
      const double t2 = __dmul_rn(td, td);
      const double dw[4] = {
          __dsub_rn(__dadd_rn(__dmul_rn(-1.5, t2), __dmul_rn(2.0, td)), 0.5),
          __dsub_rn(__dmul_rn(4.5, t2), __dmul_rn(5.0, td)),
          __dadd_rn(__dadd_rn(__dmul_rn(-4.5, t2), __dmul_rn(4.0, td)), 0.5),
          __dsub_rn(__dmul_rn(1.5, t2), __dmul_rn(1.0, td)),
      };
      dv = __dmul_rn(dw[0], static_cast<double>(__ldg(base + clampi(i0 - 1, size_r) * stride_r)));
      for (int k = 1; k < 4; ++k) {
        const double v = __ldg(base + clampi(i0 + k - 1, size_r) * stride_r);
        dv = __dadd_rn(dv, __dmul_rn(dw[k], v));
      }
    }
    const double g = __dmul_rn(static_cast<double>(__ldg(ybar + w.row * F2 + p2)), dv);
    s_r = __dadd_rn(s_r, __dmul_rn(g, static_cast<double>(i_r)));
    if (shear) s_o = __dadd_rn(s_o, __dmul_rn(g, static_cast<double>(i_o)));
    s_1 = __dadd_rn(s_1, g);
  }
  __shared__ double part[3][kThreads / 32];
  s_r = warp_sum(s_r);
  s_o = warp_sum(s_o);
  s_1 = warp_sum(s_1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = s_r;
    part[1][warp] = s_o;
    part[2][warp] = s_1;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double s = 0.0;
    for (int k = 0; k < kThreads / 32; ++k) s += part[threadIdx.x][k];
    partials[w.row * 3 + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
resample_pass_adjoint_kernel(const float* __restrict__ ybar, float* __restrict__ dst,
                             const float* __restrict__ coeffs, int cstride, int slot, int F0,
                             int F1, int F2, int r, int o, int order) {
  const Row w = this_row(F0, F1);
  const float* cb = coeffs + static_cast<long long>(w.b) * cstride + 3 * slot;
  const float cr = __ldg(cb), co = __ldg(cb + 1), tau = __ldg(cb + 2);
  const int size_r = r == 0 ? F0 : (r == 1 ? F1 : F2);
  const long long stride_r = r == 0 ? static_cast<long long>(F1) * F2 : (r == 1 ? F2 : 1);
  const float hi = static_cast<float>(size_r - 1);
  const bool shear = o != r;
  // Tap offsets k of the band: kmin .. kmax.
  const int kmin = order == 1 ? 0 : -1, kmax = order == 1 ? 1 : 2;
  for (int p2 = threadIdx.x; p2 < F2; p2 += kThreads) {
    const int p = axis_index(r, w.p0, w.p1, p2);
    const int i_o = axis_index(o, w.p0, w.p1, p2);
    // The q whose coordinate lies in [p - kmax - 1, p - kmin + 1]: every
    // unclamped tap that lands on p, and the clamped edge taps.
    const double base_c = static_cast<double>(tau) +
                          (shear ? static_cast<double>(co) * static_cast<double>(i_o) : 0.0);
    double qa = (static_cast<double>(p - kmax - 1) - base_c) / static_cast<double>(cr);
    double qb = (static_cast<double>(p - kmin + 1) - base_c) / static_cast<double>(cr);
    if (qa > qb) {
      const double sw = qa;
      qa = qb;
      qb = sw;
    }
    const int q_lo = static_cast<int>(fmax(floor(qa) - 1.0, 0.0));
    const int q_hi = static_cast<int>(fmin(ceil(qb) + 1.0, static_cast<double>(size_r - 1)));
    // The voxel's line along r with q = 0.
    const float* line = ybar + (w.row * F2 + p2 - p * stride_r);
    float acc = 0.f;
    for (int q = q_lo; q <= q_hi; ++q) {
      const float c = pass_coord(cr, co, tau, q, i_o, shear);
      if (!(c >= 0.f && c <= hi)) continue;
      float t;
      const int i0 = tap_floor(c, size_r, &t);
      if (clampi(i0 + kmin, size_r) > p || clampi(i0 + kmax, size_r) < p) continue;
      float wk[4];
      band_weights(t, order, wk);
      const float yq = __ldg(line + q * stride_r);
      for (int k = kmin; k <= kmax; ++k) {
        if (clampi(i0 + k, size_r) == p) acc = __fadd_rn(acc, __fmul_rn(wk[k + 1], yq));
      }
    }
    dst[w.row * F2 + p2] = acc;
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

// src, ybar: (B, F0, F1, F2) float32; partials: (B * F0 * F1, 3) float64,
// one row's three sums each. The rest as resample_pass.
int resample_pass_deriv(const void* src, const void* ybar, const void* coeffs, int cstride,
                        int slot, int B, int F0, int F1, int F2, int r, int o, int order,
                        void* partials, void* stream) {
  const long long rows = static_cast<long long>(B) * F0 * F1;
  resample_pass_deriv_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(ybar),
      static_cast<const float*>(coeffs), cstride, slot, F0, F1, F2, r, o, order,
      static_cast<double*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// ybar, dst: (B, F0, F1, F2) float32, distinct. The rest as resample_pass.
int resample_pass_adjoint(const void* ybar, void* dst, const void* coeffs, int cstride,
                          int slot, int B, int F0, int F1, int F2, int r, int o, int order,
                          void* stream) {
  const long long rows = static_cast<long long>(B) * F0 * F1;
  resample_pass_adjoint_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ybar), static_cast<float*>(dst),
      static_cast<const float*>(coeffs), cstride, slot, F0, F1, F2, r, o, order);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
