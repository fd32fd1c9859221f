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
// - Each lerp is v0*(1-f) + v1*f with f = c - floor(c), z before y, E's
//   with the __f*_rn intrinsics (no contraction), so that its tiled and
//   direct routes and its two reads give the same bits.
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
// per output voxel, far under the float32 rate).
//
// E's design. One block owns a run of output tiles: one b, a chunk of up
// to 16 consecutive zo and one (yo, x) tile, T consecutive yo by W
// consecutive x, the same for every zo of the chunk. The coordinates are
// affine and each rounded operation is monotone in each index, so the
// clamped floors at the tile's corners bound every tap: y rows [ylo, yhi]
// from the four (yo, x) corners (the same for every zo, since y does not
// depend on zo), z rows [zlo, zhi] from the two x ends at each zo. The
// block stages that window (z rows x y rows x the W input columns) in
// shared memory with cp.async, two stages deep: the next zo's window lands
// while this one's outputs are computed, so each input element comes from
// device memory about once per tile and not once per tap. The tile follows
// the input's contiguous axis:
// - zyx read: T = 32 yo by W = 64 x; rows of 256 bytes in 16-byte copies
//   kept in L1 too (cp.async.ca: consecutive zo share a z row), lanes
//   along x, so stores are 128 contiguous bytes along the output's x;
// - xzy read (input_xzy): T = 64 yo by W = 32 x; the staged runs are y
//   windows (16-byte copies from a multiple of 4), lanes along yo, and the
//   outputs go through a (T, W + 1) shared-memory tile, transposed, so
//   stores are again 128 contiguous bytes along x.
// Lanes read 32 different banks either way. A tile whose window exceeds
// its stage (a large shear |b1| or scale, as a 40-degree rotation gives,
// or coordinates that are not finite) is computed with direct gathers from
// device memory instead, with the same coordinate, tap and lerp code, so
// the routes and the two reads are bit-equal. kernels/warp_cuda.py
// zy_window mirrors the window in numpy (a hypothesis test holds every tap
// inside it).
//
// F: one block per output row (b, zo, yo), threads along xo, so stores are
// coalesced and loads are near-coalesced rows (|mxy| is small for register
// and stabilize matrices); neighbouring blocks share input rows, which L2
// serves.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCoeffs = 21;
// E: 8 warps, four blocks an SM (64 registers; on the H100 this ran faster
// than three blocks at 104 registers, five at 48, 128 threads a block or a
// third stage); two stages of its window, kStage floats each.
constexpr int kEThreads = 256, kEWarps = kEThreads / 32, kEBlocks = 4;
constexpr int kStage = 6144, kStages = 2;

__device__ __forceinline__ float coord(float cr, float r, float co, float o, float tau) {
  return __fadd_rn(__fadd_rn(__fmul_rn(cr, r), __fmul_rn(co, o)), tau);
}

// floor(c) clamped to [-1, n] in float, which gives the same clamped taps
// and keeps the int conversion in range.
__device__ __forceinline__ int clamped_floor(float c, int n) {
  return static_cast<int>(fminf(fmaxf(floorf(c), -1.f), static_cast<float>(n)));
}

// The two taps of a lerp at c, each clamped to [0, n-1], and the weight of
// the upper one.
struct Taps {
  int i0, i1;
  float f;
};

__device__ __forceinline__ Taps taps(float c, int n) {
  const int i = clamped_floor(c, n);
  return {min(max(i, 0), n - 1), min(max(i + 1, 0), n - 1), __fsub_rn(c, floorf(c))};
}

__device__ __forceinline__ float lerp(float v0, float v1, float f) {
  return v0 * (1.f - f) + v1 * f;
}

// E's lerp: one expression for every route and read, no contraction.
__device__ __forceinline__ float lerp_rn(float v0, float v1, float f) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.f, f)), __fmul_rn(v1, f));
}

// The rows [lo, hi] that the taps of coordinates whose clamped floors span
// [fmin, fmax] reach.
__device__ __forceinline__ void tap_rows(int fmin, int fmax, int n, int* lo, int* hi) {
  *lo = min(max(fmin, 0), n - 1);
  *hi = min(max(fmax + 1, 0), n - 1);
}

// E's tile: T yo by W x. zyx: lanes along x, warps along yo; xzy: lanes
// along yo, warps along x, the outputs transposed through shared memory.
template <bool kXzy>
struct ETile {
  static constexpr int T = kXzy ? 64 : 32;
  static constexpr int W = kXzy ? 32 : 64;
  static constexpr int kOut = kXzy ? T * (W + 1) : 0;  // the xzy read's output tile
};

// in: a (B, Zi, Yi, Xi) volume (zyx) or a (B, Xi, Zi, Yi) one (kXzy), with
// strides (sb, sz, sy, sx) in elements; out: (B, Zo, Yo, Xi) contiguous.
// Block blockIdx.x: x tile fastest, then yo tile, then zo chunk, then b.
// vec4: 16-byte copies (the staged runs 16-byte aligned).
template <bool kXzy>
__global__ void __launch_bounds__(kEThreads, kEBlocks)
warp_zy_kernel(const float* __restrict__ in, float* __restrict__ out,
               const float* __restrict__ coeffs, int cstride, int Zi, int Yi, int Xi,
               int Zo, int Yo, long long sb, long long sz, long long sy, long long sx,
               int zchunk, int n_yt, int n_xt, int n_zc, int vec4) {
  constexpr int T = ETile<kXzy>::T, W = ETile<kXzy>::W;
  extern __shared__ float stage[];  // kStages stages of kStage floats, then the output tile
  float* otile = stage + kStages * kStage;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long blk = blockIdx.x;
  const int xt = static_cast<int>(blk % n_xt);
  blk /= n_xt;
  const int yt = static_cast<int>(blk % n_yt);
  blk /= n_yt;
  const int zc = static_cast<int>(blk % n_zc);
  const int b = static_cast<int>(blk / n_zc);
  const int x0 = xt * W, xw = min(W, Xi - x0);
  const int yo0 = yt * T, yh = min(T, Yo - yo0);
  const int zbeg = zc * zchunk, zend = min(zbeg + zchunk, Zo);
  const float* cb = coeffs + b * cstride;
  const float mzz = __ldg(cb + 0), zco = __ldg(cb + 1), tz = __ldg(cb + 2);
  const float b0 = __ldg(cb + 3), b1 = __ldg(cb + 4), b2 = __ldg(cb + 5);
  const float* vol = in + b * sb;
  float* o = out + static_cast<long long>(b) * Zo * Yo * Xi;
  const float xa = static_cast<float>(x0), xb = static_cast<float>(x0 + xw - 1);

  // The y window, from the tile's four (yo, x) corners.
  const float ya = static_cast<float>(yo0), yb = static_cast<float>(yo0 + yh - 1);
  const float c00 = coord(b0, ya, b1, xa, b2), c01 = coord(b0, ya, b1, xb, b2);
  const float c10 = coord(b0, yb, b1, xa, b2), c11 = coord(b0, yb, b1, xb, b2);
  const bool y_finite = isfinite(c00) && isfinite(c01) && isfinite(c10) && isfinite(c11);
  int ylo, yhi;
  {
    const int f00 = clamped_floor(c00, Yi), f01 = clamped_floor(c01, Yi);
    const int f10 = clamped_floor(c10, Yi), f11 = clamped_floor(c11, Yi);
    tap_rows(min(min(f00, f01), min(f10, f11)), max(max(f00, f01), max(f10, f11)), Yi, &ylo,
             &yhi);
  }
  const int ny = yhi - ylo + 1;
  // The xzy read stages runs of y from ys (ylo, or ylo rounded down to a
  // multiple of 4 for 16-byte copies), ry floats apart.
  const int ys = kXzy && vec4 ? ylo & ~3 : ylo;
  const int ry = kXzy && vec4 ? ((yhi - ys) / 4 + 1) * 4 : ny;

  // The z window [zlo, zlo + nz) at zo, from the tile's two x ends;
  // whether it and the y window fit a stage.
  auto z_window = [&](int zo, int* zlo, int* nz) -> bool {
    const float zf = static_cast<float>(zo);
    const float ca = coord(mzz, zf, zco, xa, tz), cz = coord(mzz, zf, zco, xb, tz);
    const int fa = clamped_floor(ca, Zi), fz = clamped_floor(cz, Zi);
    int zhi;
    tap_rows(min(fa, fz), max(fa, fz), Zi, zlo, &zhi);
    *nz = zhi - *zlo + 1;
    const int need = kXzy ? *nz * W * ry : *nz * ny * W;
    return y_finite && isfinite(ca) && isfinite(cz) && need <= kStage;
  };

  auto issue = [&](int zo, float* s) {
    int zlo, nz;
    if (!z_window(zo, &zlo, &nz)) return;
    if (kXzy) {
      // Runs (z, x) of y; a warp copies along a run.
      for (int run = warp; run < nz * W; run += kEWarps) {
        const int z = run / W, xl = run % W;
        const bool ok = xl < xw;
        const float* src = vol + (zlo + z) * sz + (x0 + xl) * sx + ys;
        float* dst = s + run * ry;
        if (vec4) {
          for (int j = 4 * lane; j < ry; j += 128) cp_async16(dst + j, ok ? src + j : vol, ok);
        } else {
          for (int j = lane; j < ry; j += 32) cp_async4(dst + j, ok ? src + j : vol, ok);
        }
      }
    } else if (vec4) {
      // Rows (z, y) of W x in 16-byte pieces, 16 threads a row.
      const int piece = threadIdx.x & 15;
      const bool ok = x0 + 4 * piece < Xi;
      for (int row = threadIdx.x >> 4; row < nz * ny; row += kEThreads / 16) {
        const float* src = vol + (zlo + row / ny) * sz + (ylo + row % ny) * sy + x0 + 4 * piece;
        cp_async16_ca(s + row * W + 4 * piece, ok ? src : vol, ok);
      }
    } else {
      for (int row = warp; row < nz * ny; row += kEWarps) {
        const float* src = vol + (zlo + row / ny) * sz + (ylo + row % ny) * sy + x0;
        for (int xl = lane; xl < W; xl += 32) {
          const bool ok = xl < xw;
          cp_async4(s + row * W + xl, ok ? src + xl : vol, ok);
        }
      }
    }
  };

  // One output: the z taps of its x (tzp), the y taps at (yo, x), the four
  // values from the stage or from device memory, z lerps, then the y lerp.
  auto value = [&](bool staged, const float* s, int zlo, const Taps& tzp, int yo, int xl) {
    const int x = x0 + xl;
    const Taps typ = taps(coord(b0, static_cast<float>(yo), b1, static_cast<float>(x), b2), Yi);
    float v00, v10, v01, v11;  // v<z><y>
    if (staged) {
      const int z0 = tzp.i0 - zlo, z1 = tzp.i1 - zlo;
      if (kXzy) {
        const int y0 = typ.i0 - ys, y1 = typ.i1 - ys;
        v00 = s[(z0 * W + xl) * ry + y0];
        v10 = s[(z1 * W + xl) * ry + y0];
        v01 = s[(z0 * W + xl) * ry + y1];
        v11 = s[(z1 * W + xl) * ry + y1];
      } else {
        const int y0 = typ.i0 - ylo, y1 = typ.i1 - ylo;
        v00 = s[(z0 * ny + y0) * W + xl];
        v10 = s[(z1 * ny + y0) * W + xl];
        v01 = s[(z0 * ny + y1) * W + xl];
        v11 = s[(z1 * ny + y1) * W + xl];
      }
    } else {
      const float* p = vol + x * sx;
      const long long z0 = tzp.i0 * sz, z1 = tzp.i1 * sz;
      const long long y0 = typ.i0 * sy, y1 = typ.i1 * sy;
      v00 = __ldg(p + z0 + y0);
      v10 = __ldg(p + z1 + y0);
      v01 = __ldg(p + z0 + y1);
      v11 = __ldg(p + z1 + y1);
    }
    return lerp_rn(lerp_rn(v00, v10, tzp.f), lerp_rn(v01, v11, tzp.f), typ.f);
  };

  auto compute = [&](int zo, const float* s) {
    int zlo, nz;
    const bool staged = z_window(zo, &zlo, &nz);
    const float zf = static_cast<float>(zo);
    float* oz = o + static_cast<long long>(zo) * Yo * Xi;
    if (kXzy) {
      // Lanes along yo (the stage's contiguous y), into the output tile.
#pragma unroll
      for (int j = 0; j < W / kEWarps; ++j) {
        const int xl = warp + kEWarps * j;
        if (xl >= xw) continue;
        const Taps tzp = taps(coord(mzz, zf, zco, static_cast<float>(x0 + xl), tz), Zi);
#pragma unroll
        for (int i = 0; i < T / 32; ++i) {
          const int yl = lane + 32 * i;
          if (yl < yh) otile[yl * (W + 1) + xl] = value(staged, s, zlo, tzp, yo0 + yl, xl);
        }
      }
      __syncthreads();
      // Rows of the output tile along x.
      for (int yl = warp; yl < yh; yl += kEWarps) {
        if (lane < xw) oz[static_cast<long long>(yo0 + yl) * Xi + x0 + lane] = otile[yl * (W + 1) + lane];
      }
    } else {
#pragma unroll
      for (int j = 0; j < W / 32; ++j) {
        const int xl = lane + 32 * j;
        if (xl >= xw) continue;
        const Taps tzp = taps(coord(mzz, zf, zco, static_cast<float>(x0 + xl), tz), Zi);
#pragma unroll
        for (int i = 0; i < T / kEWarps; ++i) {
          const int yl = warp + kEWarps * i;
          if (yl < yh) {
            oz[static_cast<long long>(yo0 + yl) * Xi + x0 + xl] =
                value(staged, s, zlo, tzp, yo0 + yl, xl);
          }
        }
      }
    }
  };

  for (int i = 0; i < kStages - 1; ++i) {
    if (zbeg + i < zend) issue(zbeg + i, stage + i * kStage);
    cp_async_commit();
  }
  for (int zo = zbeg; zo < zend; ++zo) {
    const int next = zo + kStages - 1;
    if (next < zend) issue(next, stage + (next - zbeg) % kStages * kStage);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    compute(zo, stage + (zo - zbeg) % kStages * kStage);
    __syncthreads();
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
  // Chunks of at most 16 zo.
  const int n_zc = (Zo + 15) / 16, zchunk = (Zo + n_zc - 1) / n_zc;
  const int T = xzy ? ETile<true>::T : ETile<false>::T;
  const int W = xzy ? ETile<true>::W : ETile<false>::W;
  const int n_yt = (Yo + T - 1) / T, n_xt = (Xi + W - 1) / W;
  const long long blocks = static_cast<long long>(B) * n_zc * n_yt * n_xt;
  // 16-byte copies: the staged runs (zyx rows, xzy y runs) 16-byte aligned.
  const int vec4 = (xzy ? Yi : Xi) % 4 == 0 && reinterpret_cast<unsigned long long>(in) % 16 == 0;
  const size_t smem = (kStages * kStage + (xzy ? ETile<true>::kOut : 0)) * sizeof(float);
  const auto* src = static_cast<const float*>(in);
  auto* dst = static_cast<float*>(out);
  const auto* c = static_cast<const float*>(coeffs);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto kernel = xzy ? warp_zy_kernel<true> : warp_zy_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (xzy) {
    warp_zy_kernel<true><<<static_cast<unsigned>(blocks), kEThreads, smem, s>>>(
        src, dst, c, cstride, Zi, Yi, Xi, Zo, Yo, plane, sz, sy, sx, zchunk, n_yt, n_xt, n_zc,
        vec4);
  } else {
    warp_zy_kernel<false><<<static_cast<unsigned>(blocks), kEThreads, smem, s>>>(
        src, dst, c, cstride, Zi, Yi, Xi, Zo, Yo, plane, sz, sy, sx, zchunk, n_yt, n_xt, n_zc,
        vec4);
  }
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
