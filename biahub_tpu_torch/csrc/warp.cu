// In-plane affine warp on Hopper: kernels E (warp_zy) and F (warp_x_masked).
//
// A z-decoupled output->input affine m (z row (mzz, 0, 0, tz); the y and x
// rows free of z) factors into two passes (biahub_tpu/kernels/affine.py:
// 350-357, inplane_affine_warp_zyx_pallas{,_batched}):
//
// E replaces pallas_resample.py:857 _resample2_kernel_t and :1034
// _resample2_kernel_t_manual (launched at :922 and :1133; body
// _resample2_t_body, :794-854). For each output (zo, yo) and each INPUT
// column x it lerps along z at zi = (mzz*zo + 0*x) + tz, then along y at
// yi = (b0*yo + b1*x) + b2:
//   out[b, zo, yo, x] = lerp_y(lerp_z(in[b, :, y0, x]), lerp_z(in[b, :, y1, x]))
// F replaces pallas_resample.py:426 _resample_kernel_t and :1054
// _resample_kernel_t_manual (launched at :487 and :1203; body
// _resample_t_body, :365-423). It lerps E's output along x at
// xi = (mxx*xo + mxy*yo) + tx and applies the exact constant-fill mask of m:
// for each axis i, c_i = ((m[i,1]*yo + m[i,0]*zo) + m[i,2]*xo) + m[i,3], and
// the voxel is `fill` unless 0 <= c_i <= in_shape[i]-1 on all three axes.
//
// Cases the kernels must get right:
// - Taps clamp to the frame edge (the TPU's band weights clip into a window
//   that abuts the frame exactly where the coordinates leave it); the only
//   constant fill is F's mask. E's y taps use the integer input column x,
//   so clamped values do reach unmasked voxels.
// - Every coordinate (the lerps' and the mask's) is computed in float32 from
//   the float32 coefficients, in the reference's operand order, with the
//   __f*_rn intrinsics (no fused multiply-add), so floor() and the mask's
//   comparisons cannot flip. FMA contraction is allowed inside the lerps.
// - Each lerp is v0*(1-f) + v1*f with f = c - floor(c), z before y.
//
// The coefficients are read from device memory (21 float32, the layout of
// biahub_tpu_torch/kernels/affine.py inplane_coefficients), so one build
// serves every matrix and no host sync is needed to change them. With
// cstride = 21 each volume b of the batch reads its own row b of a (B, 21)
// table, F's mask included: this replaces the traced-coefficient forms
// pallas_resample.py:862 _resample2_kernel_t_dyn (launched at :969), :430
// _resample_kernel_t_dyn (:526), and the untransposed :643 _resample2_kernel
// and :648 _resample2_kernel_dyn (:720, :777) that stabilize's batches of
// per-timepoint matrices run (make_batched_inplane_kernel,
// translation_warp_zyx's mask_oob route). cstride = 0 is one matrix for the
// whole batch.
//
// Bound on one H100 SXM (3.35 TB/s): bytes. At the headline deskewed batch
// (8, 86, 1024, 484) each pass reads and writes one 170.5 MB volume per
// input volume: 0.102 ms per volume, 0.814 ms per batch of 8 (about 15 flop
// per output voxel, far under the float32 rate). Design: one block per
// output row (b, zo, yo), large extents on gridDim.x; threads run along the
// row's contiguous axis (x for E, xo for F), so stores are coalesced and
// loads are near-coalesced rows (|b1| and |mxy| are small for register and
// stabilize matrices). Neighbouring blocks share input rows, which L2
// serves. The xzy input read of E (input_xzy) uses the same code with other
// strides.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCoeffs = 21;

__device__ __forceinline__ float coord(float cr, float r, float co, float o, float tau) {
  return __fadd_rn(__fadd_rn(__fmul_rn(cr, r), __fmul_rn(co, o)), tau);
}

// The two taps of a lerp at c, each clamped to [0, n-1], and the weight of
// the upper one. floor(c) is clamped to [-1, n] in float first, which gives
// the same taps and keeps the int conversion in range.
struct Taps {
  int i0, i1;
  float f;
};

__device__ __forceinline__ Taps taps(float c, int n) {
  const float fl = floorf(c);
  const int i = static_cast<int>(fminf(fmaxf(fl, -1.f), static_cast<float>(n)));
  return {min(max(i, 0), n - 1), min(max(i + 1, 0), n - 1), __fsub_rn(c, fl)};
}

__device__ __forceinline__ float lerp(float v0, float v1, float f) {
  return v0 * (1.f - f) + v1 * f;
}

// in: strides (sb, sz, sy, sx) in elements of a (B, Zi, Yi, Xi) volume;
// out: (B, Zo, Yo, Xi) contiguous. One block per output row on gridDim.x.
__global__ void __launch_bounds__(kThreads)
warp_zy_kernel(const float* __restrict__ in, float* __restrict__ out,
               const float* __restrict__ coeffs, int cstride, int Zi, int Yi, int Xi,
               int Zo, int Yo, long long sb, long long sz, long long sy, long long sx) {
  const long long row = blockIdx.x;
  const int yo = static_cast<int>(row % Yo);
  const long long bz = row / Yo;
  const int zo = static_cast<int>(bz % Zo);
  const int b = static_cast<int>(bz / Zo);
  const float* cb = coeffs + b * cstride;
  const float mzz = __ldg(cb + 0), zco = __ldg(cb + 1), tz = __ldg(cb + 2);
  const float b0 = __ldg(cb + 3), b1 = __ldg(cb + 4), b2 = __ldg(cb + 5);
  const float* vol = in + b * sb;
  float* o = out + row * Xi;
  for (int x = threadIdx.x; x < Xi; x += kThreads) {
    const float xf = static_cast<float>(x);
    const Taps tz_ = taps(coord(mzz, static_cast<float>(zo), zco, xf, tz), Zi);
    const Taps ty_ = taps(coord(b0, static_cast<float>(yo), b1, xf, b2), Yi);
    const float* p = vol + x * sx;
    const long long z0 = tz_.i0 * sz, z1 = tz_.i1 * sz;
    const long long y0 = ty_.i0 * sy, y1 = ty_.i1 * sy;
    const float a0 = lerp(__ldg(p + z0 + y0), __ldg(p + z1 + y0), tz_.f);
    const float a1 = lerp(__ldg(p + z0 + y1), __ldg(p + z1 + y1), tz_.f);
    o[x] = lerp(a0, a1, ty_.f);
  }
}

// in: (B, Zo, Yo, Xi) contiguous; out: (B, Zo, Yo, Xo) contiguous.
// hi_*: in_shape - 1 of the warp's logical ZYX input, as float32.
__global__ void __launch_bounds__(kThreads)
warp_x_masked_kernel(const float* __restrict__ in, float* __restrict__ out,
                     const float* __restrict__ coeffs, int cstride, int Zo, int Yo,
                     int Xi, int Xo, float hi_z, float hi_y, float hi_x, float fill) {
  __shared__ float c[kCoeffs];
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / (static_cast<long long>(Yo) * Zo));
  if (threadIdx.x < kCoeffs) c[threadIdx.x] = coeffs[b * cstride + threadIdx.x];
  __syncthreads();
  const float yo = static_cast<float>(row % Yo);
  const float zo = static_cast<float>((row / Yo) % Zo);
  const float* src = in + row * Xi;
  float* o = out + row * Xo;
  const float hi[3] = {hi_z, hi_y, hi_x};
  for (int x = threadIdx.x; x < Xo; x += kThreads) {
    const float xo = static_cast<float>(x);
    const Taps t = taps(coord(c[6], xo, c[7], yo, c[8]), Xi);
    const float v = lerp(__ldg(src + t.i0), __ldg(src + t.i1), t.f);
    bool inside = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* a = c + 9 + 4 * i;  // m[i,1], m[i,0], m[i,2], m[i,3]
      const float ci = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(a[0], yo), __fmul_rn(a[1], zo)),
                    __fmul_rn(a[2], xo)),
          a[3]);
      inside = inside && ci >= 0.f && ci <= hi[i];
    }
    o[x] = inside ? v : fill;
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// E. in: (B, Zi, Yi, Xi) float32, or (B, Xi, Zi, Yi) with xzy = 1;
// out: (B, Zo, Yo, Xi) float32; coeffs: 21 float32 on the device
// (cstride = 0), or a (B, 21) table, one row per volume (cstride = 21).
int warp_zy(const void* in, void* out, const void* coeffs, int cstride, int B, int Zi,
            int Yi, int Xi, int Zo, int Yo, int xzy, void* stream) {
  const long long plane = static_cast<long long>(Zi) * Yi * Xi;
  const long long sz = xzy ? Yi : static_cast<long long>(Yi) * Xi;
  const long long sy = xzy ? 1 : Xi;
  const long long sx = xzy ? static_cast<long long>(Zi) * Yi : 1;
  const long long rows = static_cast<long long>(B) * Zo * Yo;
  warp_zy_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(coeffs), cstride, Zi, Yi, Xi, Zo, Yo, plane, sz, sy,
      sx);
  return static_cast<int>(cudaGetLastError());
}

// F. in: (B, Zo, Yo, Xi) float32; out: (B, Zo, Yo, Xo) float32; coeffs
// and cstride as for E.
int warp_x_masked(const void* in, void* out, const void* coeffs, int cstride, int B,
                  int Zo, int Yo, int Xi, int Xo, float hi_z, float hi_y, float hi_x,
                  float fill, void* stream) {
  const long long rows = static_cast<long long>(B) * Zo * Yo;
  warp_x_masked_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(coeffs), cstride, Zo, Yo, Xi, Xo, hi_z, hi_y, hi_x,
      fill);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
