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
// batch of 8, as chip_smoke.py computes it. Design: a block owns a 32 (yo)
// x 32 (xo) output tile of one group. Threads run along yo, which is the
// input's contiguous X axis, so every tap load is 128 B of one input row. In
// the zyx layout the tile goes through shared memory so the stores run along
// X_out, also 128 B per warp; in the xzy layout yo is the contiguous output
// axis and each thread stores its value directly. The taps of neighbouring
// xo share input rows, which L1 serves.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;

template <bool kXzy>
__global__ void __launch_bounds__(kTile * kRows)
deskew_kernel(const float* __restrict__ in, float* __restrict__ out, int Z_in,
              int Y_in, int X_in, int X_out, int groups, int avg, float px,
              float pxct, float offset, float inv_avg, int skip_flip) {
  __shared__ float tile[kTile][kTile + 1];  // [xo][yo]
  const int xo0 = blockIdx.x * kTile, yo0 = blockIdx.y * kTile;
  const int b = blockIdx.z / groups, g = blockIdx.z - b * groups;
  const int yo = yo0 + threadIdx.x;
  const int xi = skip_flip ? yo : X_in - 1 - yo;
  const size_t plane = static_cast<size_t>(Y_in) * X_in;
  const float* vol = in + static_cast<size_t>(b) * Z_in * plane;

  for (int r = threadIdx.y; r < kTile; r += kRows) {
    const int xo = xo0 + r;
    float acc = 0.f;
    if (yo < X_in && xo < X_out) {
      for (int j = 0; j < avg; ++j) {
        const int zo = min(g * avg + j, Y_in - 1);
        const float in_z = __fadd_rn(
            __fsub_rn(__fmul_rn(px, static_cast<float>(xo)),
                      __fmul_rn(pxct, static_cast<float>(zo))),
            offset);
        const float f0 = floorf(in_z);
        const float frac = __fsub_rn(in_z, f0);
        const int i0 = static_cast<int>(f0);
        const float* row = vol + static_cast<size_t>(Y_in - 1 - zo) * X_in + xi;
        const float v0 = (i0 >= 0 && i0 < Z_in) ? row[i0 * plane] : 0.f;
        const float v1 = (i0 + 1 >= 0 && i0 + 1 < Z_in) ? row[(i0 + 1) * plane] : 0.f;
        acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(v0, __fsub_rn(1.f, frac)),
                                       __fmul_rn(v1, frac)));
      }
    }
    const float v = avg == 1 ? acc : __fmul_rn(acc, inv_avg);
    if (kXzy) {
      if (yo < X_in && xo < X_out) {
        out[((static_cast<size_t>(b) * X_out + xo) * groups + g) * X_in + yo] = v;
      }
    } else {
      tile[r][threadIdx.x] = v;
    }
  }
  if (kXzy) return;
  __syncthreads();

  const size_t out_plane = static_cast<size_t>(X_in) * X_out;
  float* o = out + (static_cast<size_t>(b) * groups + g) * out_plane;
  for (int r = threadIdx.y; r < kTile; r += kRows) {
    const int yo_w = yo0 + r, xo_w = xo0 + threadIdx.x;
    if (yo_w < X_in && xo_w < X_out) {
      o[static_cast<size_t>(yo_w) * X_out + xo_w] = tile[threadIdx.x][r];
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// in: (B, Z_in, Y_in, X_in) float32; out: (B, groups, X_in, X_out) float32,
// or (B, X_out, groups, X_in) with xzy = 1. px, pxct, offset: float32 casts
// of px_to_scan_ratio, px*cos(angle) and the centring offset
// (deskew.py:240-242).
int deskew(const void* in, void* out, int B, int Z_in, int Y_in, int X_in,
           int X_out, int avg, float px, float pxct, float offset,
           float inv_avg, int skip_flip, int xzy, void* stream) {
  const int groups = (Y_in + avg - 1) / avg;
  const dim3 grid((X_out + kTile - 1) / kTile, (X_in + kTile - 1) / kTile, B * groups);
  auto* kernel = xzy ? deskew_kernel<true> : deskew_kernel<false>;
  kernel<<<grid, dim3(kTile, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), Z_in, Y_in, X_in,
      X_out, groups, avg, px, pxct, offset, inv_avg, skip_flip);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
