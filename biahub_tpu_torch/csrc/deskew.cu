// Light-sheet deskew with slice averaging, batched, on Hopper (kernel D).
//
// Replaces biahub_tpu/kernels/pallas_deskew.py:210 _deskew_kernel_manual_zyx
// (launched from deskew_zyx_pallas_batched, pallas_deskew.py:450), and by the
// same arithmetic _deskew_kernel (:45), _deskew_kernel_t (:95) and
// _deskew_kernel_manual (:137), which differ from it only in output layout
// and DMA scheme. The TPU kernels run the scan-axis lerp as banded one-hot
// MXU matmuls; here each output voxel is two loads and a lerp.
//
// in  (B, Z_in, Y_in, X_in) float32: Z_in the scan axis, Y_in the tilt axis,
//     X_in the coverslip axis.
// out (B, G, X_in, X_out) float32, G = ceil(Y_in / avg):
//   out[b, g, yo, xo] = (1/avg) * sum_{j<avg} lerp(zo = min(g*avg+j, Y_in-1))
//   lerp(zo) = v0 * (1 - frac) + v1 * frac,  v_t = in[b, i0+t, Y_in-1-zo, xi]
//   in_z = px*xo - (px*ct)*zo + offset,  i0 = floor(in_z),  frac = in_z - i0
//   xi = yo with skip_flip, else X_in-1-yo.
//
// Cases the kernel must get right (biahub_tpu/kernels/deskew.py:227-263 and
// pallas_deskew.py:56-91):
// - in_z is computed in float32 from the float32 casts of px, px*ct and
//   offset (each formed in double on the host), in exactly that order, with
//   no fused multiply-add (the __f*_rn intrinsics forbid contraction): another
//   order can move floor(in_z) across an integer and shift a sample by a
//   whole voxel.
// - A tap outside [0, Z_in) contributes 0; it is not clamped to the edge.
// - The tail group is edge-padded: zo clamps to Z_out - 1 (= Y_in - 1), so a
//   short last group averages repeated copies of the last slice, as
//   average_n_slices does.
// - The output Y axis reads the input X axis reversed unless skip_flip.
//
// out_layout: with xzy = 1 the same values are stored as (B, X_out, G, X_in),
// the layout of _deskew_kernel_t and _deskew_kernel_manual (pallas_deskew.py
// :95, :137; launched at :626 and :475), which the warp's input_xzy read
// takes. Only the store differs, so the two layouts agree to the bit.
//
// Bound on one H100 SXM (3.35 TB/s): bytes (about 10 flop per output voxel).
// The kernel must read the scan rows the geometry touches, once: for each
// tilt row the span of floor(in_z) over X_out (about 181 of 256 at the
// headline 256x256x1024 volume, avg 3, X_out 484), 190.0 MB per volume, and
// write 170.5 MB (86 x 1024 x 484 f32): 0.108 ms per volume, 0.861 ms per
// batch of 8, as chip_smoke.py computes it.
//
// Design: a block owns one (b, g) and a strip of kStrip yo (the input's
// contiguous X axis) and walks X_out in chunks of cx xo. The taps of a
// chunk's outputs for tilt row j lie in the scan rows [lo_j, lo_j + n_j):
// floor(in_z) at the chunk's first and last xo (in_z is monotone in xo),
// one more for the second tap, clipped to [0, Z_in). The block stages those
// rows of its strip, avg windows of at most `rows` rows (the wrapper's
// kernels/deskew_cuda.py deskew_plan, from the same float32 arithmetic),
// in shared memory with cp.async (16-byte copies when the strip's rows are
// aligned), double-buffered: the next chunk's windows are in flight while
// this chunk's outputs are computed. So every input element of the
// strip leaves HBM once (a window's few rows of overlap with the next come
// from L2), each copy is a run of the strip's 512 bytes, and every tap reads
// shared memory. Each chunk first tabulates its avg x cx taps (stage
// offsets and weights, a zero row for a tap outside the volume), so an
// output costs two shared loads and four flops a tilt row. The zyx store
// runs a warp along xo (a window row is padded to kPitch floats, so a
// warp's taps, ~12 rows of one column, fall in distinct banks but for
// pairs 8 rows apart) and stores runs of cx values along X_out; the xzy
// store runs a warp along yo and stores along it. The
// per-voxel arithmetic (in_z's order, the zero taps, the tail group's
// clamp, the order of the sum over j) is that of the kernel it replaced, so
// the values are the same bits.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kStrip = 128;         // yo a block
constexpr int kPitch = kStrip + 4;  // floats a staged row (16-byte aligned)
constexpr int kThreads = 256;

// The scan coordinate of output (zo, xo), in the reference's float32 order.
__device__ __forceinline__ float scan_coord(float px, float pxct, float offset, int xo, int zo) {
  return __fadd_rn(__fsub_rn(__fmul_rn(px, static_cast<float>(xo)),
                             __fmul_rn(pxct, static_cast<float>(zo))),
                   offset);
}

// First scan row and row count of the window of tilt zo for xo in [xa, xb].
__device__ __forceinline__ int2 scan_window(float px, float pxct, float offset, int xa, int xb,
                                            int zo, int Z_in, int rows) {
  const int fa = static_cast<int>(floorf(scan_coord(px, pxct, offset, xa, zo)));
  const int fb = static_cast<int>(floorf(scan_coord(px, pxct, offset, xb, zo)));
  const int lo = max(min(fa, fb), 0), hi = min(max(fa, fb) + 1, Z_in - 1);
  return make_int2(lo, min(max(hi - lo + 1, 0), rows));
}

// A chunk's taps of tilt row j at output xo: the stage offsets of the two
// taps (the zero row for a tap outside [0, Z_in)) and their weights 1 -
// frac and frac.
struct __align__(16) Tap {
  int o0, o1;
  float w0, w1;
};

template <bool kXzy>
__global__ void __launch_bounds__(kThreads)
deskew_kernel(const float* __restrict__ in, float* __restrict__ out, int Z_in, int Y_in,
              int X_in, int X_out, int groups, int avg, float px, float pxct, float offset,
              float inv_avg, int skip_flip, int cx, int rows) {
  extern __shared__ float dsm[];
  // [2][avg][rows][kPitch] windows, a zero row, the windows' first rows
  // [2][avg], then the chunk's taps [avg][cx]
  const int win = avg * rows * kPitch;
  const int zero = 2 * win;
  int* first = reinterpret_cast<int*>(dsm + zero + kPitch);
  Tap* taps = reinterpret_cast<Tap*>(first + ((2 * avg + 3) & ~3));
  const int b = blockIdx.y / groups, g = blockIdx.y - b * groups;
  const int yo0 = blockIdx.x * kStrip;
  const int xlo = skip_flip ? yo0 : X_in - yo0 - kStrip;  // input x of stage column 0
  const bool vec = (X_in & 3) == 0 && (reinterpret_cast<size_t>(in) & 15) == 0 && xlo >= 0 &&
                   xlo + kStrip <= X_in;
  const size_t plane = static_cast<size_t>(Y_in) * X_in;
  const float* vol = in + static_cast<size_t>(b) * Z_in * plane;
  const int nchunks = (X_out + cx - 1) / cx;
  for (int i = threadIdx.x; i < kPitch; i += blockDim.x) dsm[zero + i] = 0.f;

  // The windows of chunk c into stage s, as one commit group (none past
  // the last chunk).
  auto fetch = [&](int c, int s) {
    const int xa = c * cx, xb = min(xa + cx, X_out) - 1;
    for (int j = 0; c < nchunks && j < avg; ++j) {
      const int zo = min(g * avg + j, Y_in - 1);
      const int2 w = scan_window(px, pxct, offset, xa, xb, zo, Z_in, rows);
      if (threadIdx.x == 0) first[s * avg + j] = w.x;
      const float* src = vol + static_cast<size_t>(Y_in - 1 - zo) * X_in + xlo;
      float* dst = dsm + s * win + j * rows * kPitch;
      if (vec) {
        for (int i = threadIdx.x; i < w.y * (kStrip / 4); i += blockDim.x) {
          const int r = i / (kStrip / 4), q = 4 * (i - r * (kStrip / 4));
          cp_async16(dst + r * kPitch + q, src + (w.x + r) * plane + q);
        }
      } else {
        for (int i = threadIdx.x; i < w.y * kStrip; i += blockDim.x) {
          const int r = i / kStrip, q = i - r * kStrip;
          const bool ok = xlo + q >= 0 && xlo + q < X_in;
          cp_async4(dst + r * kPitch + q, ok ? src + (w.x + r) * plane + q : in, ok);
        }
      }
    }
    cp_async_commit();
  };

  // A thread's outputs: xzy along yo (two threads a yo, alternate xo); zyx
  // along xo (kThreads / cx yo at a time), its taps held across its yo.
  const int lane_x = kXzy ? threadIdx.x / kStrip : threadIdx.x % cx;
  const int step_x = kXzy ? kThreads / kStrip : cx;
  const int lane_y = kXzy ? threadIdx.x % kStrip : threadIdx.x / cx;
  const int step_y = kXzy ? kStrip : kThreads / cx;
  fetch(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    fetch(c + 1, (c + 1) & 1);
    cp_async_wait<1>();
    __syncthreads();
    const int s = c & 1, xa = c * cx, xe = min(xa + cx, X_out);
    for (int i = threadIdx.x; i < avg * cx; i += blockDim.x) {
      const int j = i / cx, xo = xa + i - j * cx;
      const int zo = min(g * avg + j, Y_in - 1);
      const float in_z = scan_coord(px, pxct, offset, xo, zo);
      const float f0 = floorf(in_z);
      const float frac = __fsub_rn(in_z, f0);
      const int i0 = static_cast<int>(f0);
      const int r0 = s * win + (j * rows + i0 - first[s * avg + j]) * kPitch;
      taps[i] = Tap{(i0 >= 0 && i0 < Z_in) ? r0 : zero,
                    (i0 + 1 >= 0 && i0 + 1 < Z_in) ? r0 + kPitch : zero,
                    __fsub_rn(1.f, frac), frac};
    }
    __syncthreads();
    for (int xo = xa + lane_x; xo < xe; xo += step_x) {
      for (int yl = lane_y; yl < kStrip && yo0 + yl < X_in; yl += step_y) {
        const int yo = yo0 + yl;
        const float* colp = dsm + (skip_flip ? yl : kStrip - 1 - yl);  // yo's input x
        float acc = 0.f;
        for (int j = 0; j < avg; ++j) {
          const Tap t = taps[j * cx + xo - xa];
          acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(colp[t.o0], t.w0), __fmul_rn(colp[t.o1], t.w1)));
        }
        const float v = avg == 1 ? acc : __fmul_rn(acc, inv_avg);
        if (kXzy) {
          out[((static_cast<size_t>(b) * X_out + xo) * groups + g) * X_in + yo] = v;
        } else {
          out[((static_cast<size_t>(b) * groups + g) * X_in + yo) * X_out + xo] = v;
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// in: (B, Z_in, Y_in, X_in) float32; out: (B, groups, X_in, X_out) float32,
// or (B, X_out, groups, X_in) with xzy = 1. px, pxct, offset: float32 casts
// of px_to_scan_ratio, px*cos(angle) and the centring offset
// (deskew.py:240-242). cx, rows, smem: kernels/deskew_cuda.py deskew_plan's
// chunk of xo, window rows per tilt row and shared-memory bytes.
int deskew(const void* in, void* out, int B, int Z_in, int Y_in, int X_in, int X_out, int avg,
           float px, float pxct, float offset, float inv_avg, int skip_flip, int xzy, int cx,
           int rows, int smem, void* stream) {
  const int groups = (Y_in + avg - 1) / avg;
  const size_t need = (2 * static_cast<size_t>(avg) * rows * kPitch + kPitch +
                       ((2 * avg + 3) & ~3) + 4 * static_cast<size_t>(avg) * cx) * 4;
  if (cx < 1 || cx > 32 || (32 % cx) != 0 || rows < 2 || avg < 1 ||
      need > static_cast<size_t>(smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* kernel = xzy ? deskew_kernel<true> : deskew_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((X_in + kStrip - 1) / kStrip, B * groups);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), Z_in, Y_in, X_in, X_out, groups,
      avg, px, pxct, offset, inv_avg, skip_flip, cx, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
