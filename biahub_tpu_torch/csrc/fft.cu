// Fourier filtering of ZYX volumes as float32 shared-memory FFT passes on
// Hopper.
//
// Replaces the Pallas passes of biahub_tpu/kernels/pallas_fft.py:
//
//   A  fwd_yx_kernel    <- _fwd_yx_kernel (pallas_fft.py:286, launched from
//                          _run_pass_a): rfft along X, then DFT along Y, per
//                          z slice; float32 or uint16 in.
//   B  z_filter_kernel  <- _pass_b_kernel (pallas_fft.py:442, launched from
//                          _run_fourier_pipeline): DFT along Z, times a
//                          filter, inverse DFT along Z, in place. Two
//                          modes: the prepared real Tikhonov filter
//                          tf/(tf^2+reg) (n_filt == 1, kernel B), and a
//                          complex Hermitian filter (n_filt == 2, :479-480,
//                          kernel Bc: fourier_filter_zyx_pallas, :1285, the
//                          phase and fluorescence reconstructions).
//   C  inv_yx_kernel    <- _inv_yx_kernel (pallas_fft.py:530, launched from
//                          _run_pass_c): inverse DFT along Y, then irfft
//                          along X, per z slice; writes plain ZYX float32.
//   Bx z_cross_kernel   <- _pass_b_cross_kernel (pallas_fft.py:1338, launched
//                          from _run_pass_b_cross): DFT along Z of two
//                          spectra, the phase cross-power H_ref*conj(H_mov)
//                          (none / magnitude / classic, _cross_power
//                          :1317), inverse DFT along Z. A, A, Bx, C is the
//                          phase cross-correlation of pcc_corr_pallas.
//   K  z_filter_kernel  <- _fwd_z_filter_kernel (pallas_spectral.py:198,
//      <kInverse false>    launched at :767): B's forward half, DFT along Z
//                          then the filter (real, or complex with n_filt ==
//                          2), stored in place with no inverse.
//   L  y_inv_kernel     <- _inv_y_pad_kernel (pallas_spectral.py:249,
//                          launched at :800): inverse DFT along Y of each kz
//                          slice, in place.
//   K and L feed kernel M (spectral.cu), the spectral deskew's lerp + irfft.
//
// The spectrum between the passes is the rfft half-spectrum (Z, Y, X/2+1)
// as interleaved complex64, the layout of torch.fft.rfftn, so each pass has
// a one-line plain PyTorch version (biahub_tpu_torch/kernels/fft.py). The
// TPU kernels compute O(N^2) DFTs as bf16-split MXU matmuls; on Hopper every
// pass is memory-bound and a float32 matmul DFT would cost ~5e11 flop per
// volume, so each line is a radix-2 FFT in shared memory instead (O(N log N),
// full float32, no tensor cores: TF32 keeps 10 mantissa bits and could not
// meet the reference's 1e-5). None of the TPU's layout devices is carried
// over: no Nyquist peel (the kx = X/2 bin is simply the last column, and the
// ragged last kx tile is masked), no radix splits across kernels, no slab or
// yzx_pad layouts. Normalisation: B scales by 1/Z, C by 1/(Y*X), L by 1/Y;
// K does not scale. The line code is fft_lines.cuh, shared with spectral.cu.
//
// Lines of any length. A power-of-two axis is one radix-2 FFT, and its
// kernels are the kAny = false instantiations, whose code and shared-memory
// layout are those of the power-of-two-only kernels. Any other length n
// (the deskewed mantis FOV is 86 x 1024 x 484, half spectrum 243 wide) runs
// Bluestein's chirp convolution on the same radix-2 machinery, in the
// kAny = true instantiations: with w_k = exp(-i pi k^2 / n),
// exp(-2 pi i jk/n) = w_j w_k conj(w_{j-k}), so a line is multiplied by w,
// circularly convolved with conj(w) through two radix-2 FFTs of M >= 2n - 1
// points and multiplied by w again. The chirp's phase is reduced in
// integers (k^2 mod 2n) and taken with sincospi in double before rounding
// to float: a float k^2/n loses ~1e-4 rad once k^2/n nears 1000. Mixed
// radix (2^a times a dense odd DFT, the TPU's way) would cost O(n * odd)
// per line, O(n^2) for a prime; Bluestein is O(M log M) for every n at
// twice the shared memory of a line, so a row or column tile holds half
// the lines. Limits (shared memory): powers of two up to 8192, other
// lengths up to 4096 (M <= 8192) for A, B and C; Bx, in double, Z up to
// 2048 for powers of two and 1024 otherwise.
//
// Bounds on one H100 SXM (3.35 TB/s; each input read once, each output
// written once), all bytes-bound:
//   headline 256x256x1024 volume:
//   A  268.4 MB f32 in (134.2 MB uint16) + 269.0 MB spectrum out
//      = 537.4 MB, 0.160 ms (uint16: 403.2 MB, 0.120 ms). ~3.0 Gflop of
//      FFT work is 0.045 ms at the 67 Tflop/s float32 rate.
//   B  269.0 MB spectrum in and out + 134.5 MB filter = 672.4 MB, 0.201 ms
//   C  269.0 MB spectrum in + 268.4 MB volume out = 537.4 MB, 0.160 ms
//   deskewed FOV 86x1024x484 (reconstruction):
//   A, C  170.5 MB volume + 171.2 MB spectrum = 341.7 MB, 0.102 ms
//   Bc 171.2 MB spectrum in and out + 171.2 MB complex filter = 513.6 MB,
//      0.153 ms
//   Bx at the stabilization crop 64x1024x256: two 67.6 MB spectra in, one
//      out = 202.9 MB, 0.061 ms (B's design: one read, one write; its
//      arithmetic is double, ~0.8 Gflop, 0.024 ms at 34 Tflop/s).
//   K  269.0 MB spectrum in and out + 134.5 MB filter = 672.4 MB, 0.201 ms
//      (complex filter: 269.0 MB, 807.0 MB, 0.241 ms)
//   L  269.0 MB spectrum in and out = 538.0 MB, 0.161 ms
// What the design does about them: every global access is a row segment
// of consecutive elements read or written by one warp, and every FFT
// stage stays in shared memory. A and C are one block per z slice in two
// phases (rows, then kx column tiles), and the slice passes through device
// memory between the phases: that is about twice the bound's traffic
// unless L2 keeps the slice. B reads and writes the spectrum once. A
// Bluestein line does three times a power-of-two line's FFT work on twice
// its length. Making A and C keep the slice on chip is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "fft_lines.cuh"

namespace {

constexpr int kThreads = 512;
// Shared-memory budget of one working tile (row pairs, or a column tile).
constexpr int kTileBytes = 96 * 1024;

// FFT along Y of every kx column of one (Y, xh) complex slice, in place in
// device memory, tk = 1 << log2tk columns at a time (the ragged last tile is
// zero-padded in shared memory and masked on the store), times `scale` on
// the store (1 in A and C, which is exact).
template <bool kAny>
__device__ void columns_y(float2* slice, float2* buf, const Axis<float2>& ay, int xh,
                          int log2tk, bool inverse, float scale = 1.0f) {
  const int Y = ay.n, tk = 1 << log2tk;
  for (int k0 = 0; k0 < xh; k0 += tk) {
    for (int t = threadIdx.x; t < (Y << log2tk); t += blockDim.x) {
      const int y = t >> log2tk, k = k0 + (t & (tk - 1));
      buf[t] = k < xh ? slice[static_cast<size_t>(y) * xh + k]
                      : make_float2(0.f, 0.f);
    }
    __syncthreads();
    lines_dif<kAny>(buf, ay, tk, log2tk, 1, tk, inverse, true);
    for (int t = threadIdx.x; t < (Y << log2tk); t += blockDim.x) {
      const int ky = t >> log2tk, c = t & (tk - 1), k = k0 + c;
      if (k < xh) {
        const float2 v = buf[(at<kAny>(ay, ky) << log2tk) + c];
        slice[static_cast<size_t>(ky) * xh + k] = make_float2(v.x * scale, v.y * scale);
      }
    }
    __syncthreads();
  }
}

// Kernel A. One block per z slice. Phase 1: rows 2q and 2q+1 ride one
// complex FFT as re + i*im, split into their two half-spectra (an odd Y's
// last row rides with zeros). Phase 2: the DFT along Y over kx column
// tiles. uint16 converts to float32 exactly in registers, and the
// arithmetic after the load is the same code for both input types, so a
// uint16 volume gives the bits of its float32 copy. kAny: the tables of
// one axis at a time sit in the first `tab` elements, X's for phase 1 and
// Y's for phase 2.
template <bool kAny>
__global__ void __launch_bounds__(kThreads)
fwd_yx_kernel(const void* __restrict__ in, int is_u16, float2* __restrict__ out,
              int Y, int X, int pairs, int log2tk, int tab) {
  extern __shared__ float2 smem[];
  const int xh = X / 2 + 1;
  Axis<float2> ax, ay;
  float2* buf;
  if constexpr (kAny) {
    buf = smem + tab;
    ax = make_axis(smem, X);
  } else {
    ax = pow2_axis(smem, X);
    ay = pow2_axis(smem + X / 2, Y);
    buf = smem + X / 2 + Y / 2;
    make_twiddles(smem, X);
    make_twiddles(smem + X / 2, Y);
  }
  const int mx = 1 << ax.log2m;
  const size_t z = blockIdx.x;
  const float* in32 = static_cast<const float*>(in) + z * Y * X;
  const uint16_t* in16 = static_cast<const uint16_t*>(in) + z * Y * X;
  float2* spec = out + z * Y * xh;
  __syncthreads();

  const int npairs = (Y + 1) / 2;
  for (int q0 = 0; q0 < npairs; q0 += pairs) {
    const int nq = min(pairs, npairs - q0);
    for (int t = threadIdx.x; t < nq * X; t += blockDim.x) {
      int q, x;
      if constexpr (kAny) {
        q = t / X;
        x = t - q * X;
      } else {
        q = t >> ax.log2m;
        x = t & (X - 1);
      }
      const int row = 2 * (q0 + q);
      const bool has_b = !kAny || row + 1 < Y;
      const size_t r0 = static_cast<size_t>(row) * X + x;
      float a, b = 0.f;
      if (is_u16) {
        a = static_cast<float>(in16[r0]);
        if (has_b) b = static_cast<float>(in16[r0 + X]);
      } else {
        a = in32[r0];
        if (has_b) b = in32[r0 + X];
      }
      buf[q * mx + x] = make_float2(a, b);
    }
    __syncthreads();
    lines_dif<kAny>(buf, ax, nq, 0, mx, 1, false, false);
    // F0[k] = (S[k] + conj S[X-k]) / 2,  F1[k] = (S[k] - conj S[X-k]) / 2i
    for (int t = threadIdx.x; t < nq * xh; t += blockDim.x) {
      const int q = t / xh, k = t - q * xh;
      const float2* line = buf + q * mx;
      const float2 sk = line[at<kAny>(ax, k)];
      const float2 sc = line[at<kAny>(ax, k == 0 ? 0 : X - k)];
      const int row = 2 * (q0 + q);
      const size_t o = static_cast<size_t>(row) * xh + k;
      spec[o] = make_float2(0.5f * (sk.x + sc.x), 0.5f * (sk.y - sc.y));
      if (!kAny || row + 1 < Y) spec[o + xh] = make_float2(0.5f * (sk.y + sc.y), 0.5f * (sc.x - sk.x));
    }
    __syncthreads();
  }
  if constexpr (kAny) ay = make_axis(smem, Y);
  columns_y<kAny>(spec, buf, ay, xh, log2tk, false);
}

// Kernel B (kComplex false) and Bc (kComplex true). One block per (ky,
// tile of tk kx columns): the tile's Z-lines are loaded once, transformed
// forward (a power-of-two Z leaves frequency kz at position brev(kz)),
// multiplied there by the filter, transformed back with 1/Z, and stored in
// place. B's filter is the prepared real float32 Tikhonov filter; Bc's is
// complex64, the product (hr fr - hi fi, hr fi + hi fr) of
// pallas_fft.py:479-480. Kernel K (kInverse false, either filter) stops
// after the filter and stores the filtered spectrum, kz in natural order,
// with no inverse and no 1/Z: the spectral deskew's pass B'1.
template <bool kAny, bool kComplex, bool kInverse = true>
__global__ void __launch_bounds__(kThreads)
z_filter_kernel(float2* __restrict__ spec, const void* __restrict__ filt,
                int Z, int Y, int xh, int log2tk, int tab) {
  extern __shared__ float2 smem[];
  const int tk = 1 << log2tk;
  Axis<float2> az;
  float2* buf;
  if constexpr (kAny) {
    buf = smem + tab;
    az = make_axis(smem, Z);
  } else {
    az = pow2_axis(smem, Z);
    buf = smem + Z / 2;
    make_twiddles(smem, Z);
  }
  const int k0 = blockIdx.x * tk;
  const size_t zstride = static_cast<size_t>(Y) * xh;
  const size_t base = static_cast<size_t>(blockIdx.y) * xh + k0;
  for (int t = threadIdx.x; t < (Z << log2tk); t += blockDim.x) {
    const int z = t >> log2tk, c = t & (tk - 1);
    buf[t] = k0 + c < xh ? spec[z * zstride + base + c] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  lines_dif<kAny>(buf, az, tk, log2tk, 1, tk, false, true);
  for (int t = threadIdx.x; t < (Z << log2tk); t += blockDim.x) {
    const int j = t >> log2tk, c = t & (tk - 1);
    const size_t f = at<kAny>(az, j) * zstride + base + c;
    const float2 h = buf[t];
    float2 v;
    if constexpr (kComplex) {
      const float2 fc = k0 + c < xh ? static_cast<const float2*>(filt)[f]
                                    : make_float2(0.f, 0.f);
      v = make_float2(h.x * fc.x - h.y * fc.y, h.x * fc.y + h.y * fc.x);
    } else {
      const float fr = k0 + c < xh ? static_cast<const float*>(filt)[f] : 0.f;
      v = make_float2(h.x * fr, h.y * fr);
    }
    if constexpr (kInverse) {
      buf[t] = v;
    } else if (k0 + c < xh) {
      spec[f] = v;  // the filter's own index: frequency kz, natural order
    }
  }
  if constexpr (!kInverse) return;
  __syncthreads();
  lines_dit<kAny>(buf, az, tk, log2tk, 1, tk, true, true);
  const float inv_z = 1.0f / static_cast<float>(Z);
  for (int t = threadIdx.x; t < (Z << log2tk); t += blockDim.x) {
    const int z = t >> log2tk, c = t & (tk - 1);
    if (k0 + c < xh) {
      spec[z * zstride + base + c] = make_float2(buf[t].x * inv_z, buf[t].y * inv_z);
    }
  }
}

// Kernel L. One block per kz slice of the (Z, Y, xh) spectrum: the inverse
// DFT along Y of every kx column, in place, times 1/Y (the spectral deskew's
// pass B'2, pallas_spectral.py:249). The front-padded y-major store of the
// TPU kernel is not carried over: kernel M reads tilt row y by its stride.
template <bool kAny>
__global__ void __launch_bounds__(kThreads)
y_inv_kernel(float2* __restrict__ spec, int Y, int xh, int log2tk, int tab) {
  extern __shared__ float2 smem[];
  Axis<float2> ay;
  float2* buf;
  if constexpr (kAny) {
    buf = smem + tab;
    ay = make_axis(smem, Y);
  } else {
    ay = pow2_axis(smem, Y);
    buf = smem + Y / 2;
    make_twiddles(smem, Y);
    __syncthreads();
  }
  columns_y<kAny>(spec + static_cast<size_t>(blockIdx.x) * Y * xh, buf, ay, xh, log2tk, true,
                  1.0f / static_cast<float>(Y));
}

constexpr double kEps = 1.1920928955078125e-07;  // float32 eps, the reference's clamp

// Kernel Bx. One block per (ky, tile of tk kx columns), as B. The tile's
// Z-lines of both spectra sit side by side in shared memory (ref in columns
// [0, tk), mov in [tk, 2tk)) and ride one forward transform of 2tk lines,
// so both hold frequency kz at the same position and the cross-power is
// pointwise. It replaces the ref columns, which go back through the
// inverse (with 1/Z) and are stored into out. ref is only read (the
// vs-first path reuses it); out may be mov: a block reads its whole tile
// before it writes it, and tiles are disjoint. norm: 0 none, 1 magnitude
// (|c|), 2 classic (sqrt(|H1|^2 |H2|^2), the Pallas kernel's operands).
//
// Between the load and the store everything is double: the normalizations
// divide by |c|, and a bin near zero beside a large one in the same Z-line
// (the DC column's) turns float32 rounding of the transform into an error
// of order one in its phase. In double the result is the exact function of
// the complex64 spectra to float32 rounding. The pass stays bytes-bound
// (~0.8 Gflop of double at the stabilization crop), at half the tile.
template <bool kAny>
__global__ void __launch_bounds__(kThreads)
z_cross_kernel(const float2* __restrict__ ref, const float2* mov, float2* out,
               int Z, int Y, int xh, int log2tk, int norm, int tab) {
  extern __shared__ double2 dsmem[];
  const int tk = 1 << log2tk, w = 2 * tk;
  Axis<double2> az;
  double2* buf;
  if constexpr (kAny) {
    buf = dsmem + tab;
    az = make_axis(dsmem, Z);
  } else {
    az = pow2_axis(dsmem, Z);
    buf = dsmem + Z / 2;
    make_twiddles(dsmem, Z);
  }
  const int k0 = blockIdx.x * tk;
  const size_t zstride = static_cast<size_t>(Y) * xh;
  const size_t base = static_cast<size_t>(blockIdx.y) * xh + k0;
  for (int t = threadIdx.x; t < (Z << (log2tk + 1)); t += blockDim.x) {
    const int z = t >> (log2tk + 1), c = t & (w - 1), col = c & (tk - 1);
    const float2* src = c < tk ? ref : mov;
    const float2 v = k0 + col < xh ? src[z * zstride + base + col] : make_float2(0.f, 0.f);
    buf[t] = make_double2(v.x, v.y);
  }
  __syncthreads();
  lines_dif<kAny>(buf, az, w, log2tk + 1, 1, w, false, true);
  for (int t = threadIdx.x; t < (Z << log2tk); t += blockDim.x) {
    double2* p = buf + (t >> log2tk) * w + (t & (tk - 1));
    const double2 a = p[0], b = p[tk];
    double cr = a.x * b.x + a.y * b.y;
    double ci = a.y * b.x - a.x * b.y;
    if (norm != 0) {
      const double d = fmax(
          norm == 1 ? sqrt(cr * cr + ci * ci)
                    : sqrt((a.x * a.x + a.y * a.y) * (b.x * b.x + b.y * b.y)),
          kEps);
      cr = cr / d;
      ci = ci / d;
    }
    p[0] = make_double2(cr, ci);
  }
  __syncthreads();
  lines_dit<kAny>(buf, az, tk, log2tk, 1, w, true, true);
  const double inv_z = 1.0 / static_cast<double>(Z);
  for (int t = threadIdx.x; t < (Z << log2tk); t += blockDim.x) {
    const int z = t >> log2tk, c = t & (tk - 1);
    if (k0 + c < xh) {
      const double2 v = buf[z * w + c];
      out[z * zstride + base + c] = make_float2(static_cast<float>(v.x * inv_z),
                                                static_cast<float>(v.y * inv_z));
    }
  }
}

// Kernel C. One block per z slice. Phase 1: inverse DFT along Y over kx
// column tiles, in place (the spectrum is scratch afterwards). Phase 2: rows
// 2q and 2q+1 ride one complex inverse FFT of S = F0 + i*F1 built from their
// half-spectra by Hermitian extension; the real part is row 2q, the
// imaginary part row 2q+1 (an odd Y's last row rides with zeros). As irfft
// does, the imaginary parts of the DC bin and, for an even X, the Nyquist
// bin are ignored. kAny: Y's tables for phase 1, then X's, as in A.
template <bool kAny>
__global__ void __launch_bounds__(kThreads)
inv_yx_kernel(float2* __restrict__ spec, float* __restrict__ out, int Y, int X,
              int pairs, int log2tk, int tab) {
  extern __shared__ float2 smem[];
  const int xh = X / 2 + 1;
  Axis<float2> ax, ay;
  float2* buf;
  if constexpr (kAny) {
    buf = smem + tab;
    ay = make_axis(smem, Y);
  } else {
    ax = pow2_axis(smem, X);
    ay = pow2_axis(smem + X / 2, Y);
    buf = smem + X / 2 + Y / 2;
    make_twiddles(smem, X);
    make_twiddles(smem + X / 2, Y);
  }
  const size_t z = blockIdx.x;
  float2* sp = spec + z * Y * xh;
  float* o = out + z * Y * X;
  __syncthreads();

  columns_y<kAny>(sp, buf, ay, xh, log2tk, true);
  if constexpr (kAny) ax = make_axis(smem, X);
  const int mx = 1 << ax.log2m;

  const float scale = 1.0f / (static_cast<float>(Y) * static_cast<float>(X));
  const int npairs = (Y + 1) / 2;
  for (int q0 = 0; q0 < npairs; q0 += pairs) {
    const int nq = min(pairs, npairs - q0);
    for (int t = threadIdx.x; t < nq * xh; t += blockDim.x) {
      const int q = t / xh, k = t - q * xh;
      const int row = 2 * (q0 + q);
      const float2* r = sp + static_cast<size_t>(row) * xh;
      float2 a = r[k], b = !kAny || row + 1 < Y ? r[k + xh] : make_float2(0.f, 0.f);
      if (k == 0 || 2 * k == X) {
        a.y = 0.f;
        b.y = 0.f;
      }
      float2* line = buf + q * mx;
      line[k] = make_float2(a.x - b.y, a.y + b.x);
      if (k > 0 && 2 * k < X) line[X - k] = make_float2(a.x + b.y, b.x - a.y);
    }
    __syncthreads();
    lines_dif<kAny>(buf, ax, nq, 0, mx, 1, true, false);
    for (int t = threadIdx.x; t < nq * X; t += blockDim.x) {
      int q, x;
      if constexpr (kAny) {
        q = t / X;
        x = t - q * X;
      } else {
        q = t >> ax.log2m;
        x = t & (X - 1);
      }
      const float2 v = buf[q * mx + at<kAny>(ax, x)];
      const int row = 2 * (q0 + q);
      const size_t r0 = static_cast<size_t>(row) * X + x;
      o[r0] = v.x * scale;
      if (!kAny || row + 1 < Y) o[r0 + X] = v.y * scale;
    }
    __syncthreads();
  }
}

int log2i(int n) { return 31 - __builtin_clz(static_cast<unsigned>(n)); }

// log2 of the widest column tile (<= 32 lines) of m points within budget.
int tile_log2(int m) {
  int l = 5;
  while (l > 0 && (static_cast<size_t>(m) << l) * sizeof(float2) > kTileBytes) --l;
  return l;
}

// log2 of Bx's column tile: two spectra's Z-lines of m double2 points
// share the budget, so m <= kTileBytes / 32 = 3072 at one column; -1 when
// even that does not fit.
int cross_tile_log2(int m) {
  int l = 5;
  while (l >= 0 && (static_cast<size_t>(m) << (l + 1)) * sizeof(double2) > kTileBytes) --l;
  return l;
}

// Row pairs per phase-1 chunk of rows of m points.
int row_pairs(int m) {
  return std::max(1, std::min(8, kTileBytes / static_cast<int>(m * sizeof(float2))));
}

// Launch shape shared by the per-slice kernels A and C. Powers of two keep
// both axes' twiddles side by side; otherwise one axis' tables at a time.
struct SliceLaunch {
  bool any;
  int ltk, pairs, tab;
  size_t smem;
  SliceLaunch(int Y, int X) : any(!is_pow2(Y) || !is_pow2(X)) {
    const int my = 1 << radix_log2(Y), mx = 1 << radix_log2(X);
    ltk = tile_log2(my);
    pairs = row_pairs(mx);
    const size_t tile =
        std::max(static_cast<size_t>(pairs) * mx, static_cast<size_t>(my) << ltk);
    tab = static_cast<int>(any ? std::max(table_elems(X), table_elems(Y)) : X / 2 + Y / 2);
    smem = (tab + tile) * sizeof(float2);
  }
};

template <bool kComplex, bool kInverse = true>
int launch_z_filter(void* spec, const void* filt, int Z, int Y, int xh, void* stream) {
  const bool any = !is_pow2(Z);
  const int mz = 1 << radix_log2(Z), ltk = tile_log2(mz);
  const int tab = static_cast<int>(any ? table_elems(Z) : Z / 2);
  const size_t smem = (tab + (static_cast<size_t>(mz) << ltk)) * sizeof(float2);
  auto kernel = any ? z_filter_kernel<true, kComplex, kInverse>
                    : z_filter_kernel<false, kComplex, kInverse>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((xh + (1 << ltk) - 1) >> ltk, Y);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(spec), filt, Z, Y, xh, ltk, tab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// in: (Z, Y, X) float32 (is_u16 = 0) or uint16 (is_u16 = 1); out: (Z, Y,
// X/2+1) complex64. Y and X in [2, 8192] if powers of two, else [2, 4096]
// (checked by the Python wrapper).
int fwd_yx(const void* in, int is_u16, void* out, int Z, int Y, int X, void* stream) {
  const SliceLaunch s(Y, X);
  auto kernel = s.any ? fwd_yx_kernel<true> : fwd_yx_kernel<false>;
  cudaError_t e = allow_smem(kernel, s.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<Z, kThreads, s.smem, static_cast<cudaStream_t>(stream)>>>(
      in, is_u16, static_cast<float2*>(out), Y, X, s.pairs, s.ltk, s.tab);
  return static_cast<int>(cudaGetLastError());
}

// spec: (Z, Y, xh) complex64, filtered in place; filt: (Z, Y, xh) float32.
// Z in [2, 8192] if a power of two, else [2, 4096]; Y <= 65535.
int z_filter(void* spec, const void* filt, int Z, int Y, int xh, void* stream) {
  return launch_z_filter<false>(spec, filt, Z, Y, xh, stream);
}

// As z_filter with a complex64 (Z, Y, xh) filter.
int z_filter_complex(void* spec, const void* filt, int Z, int Y, int xh, void* stream) {
  return launch_z_filter<true>(spec, filt, Z, Y, xh, stream);
}

// Kernel K: spec (Z, Y, xh) complex64 = fft(spec, Z) * filt in place, no
// inverse; filt (Z, Y, xh) float32 (is_complex = 0) or complex64 (1). Z as
// for z_filter.
int z_fwd_filter(void* spec, const void* filt, int is_complex, int Z, int Y, int xh,
                 void* stream) {
  return is_complex ? launch_z_filter<true, false>(spec, filt, Z, Y, xh, stream)
                    : launch_z_filter<false, false>(spec, filt, Z, Y, xh, stream);
}

// Kernel L: spec (Z, Y, xh) complex64 = ifft(spec, Y) in place (with 1/Y).
// Y as for fwd_yx.
int y_inv(void* spec, int Z, int Y, int xh, void* stream) {
  const bool any = !is_pow2(Y);
  const int my = 1 << radix_log2(Y), ltk = tile_log2(my);
  const int tab = static_cast<int>(any ? table_elems(Y) : Y / 2);
  const size_t smem = (tab + (static_cast<size_t>(my) << ltk)) * sizeof(float2);
  auto kernel = any ? y_inv_kernel<true> : y_inv_kernel<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<Z, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(spec), Y, xh, ltk, tab);
  return static_cast<int>(cudaGetLastError());
}

// ref, mov, out: (Z, Y, xh) complex64; out may be mov, never ref. Z in
// [2, 2048] if a power of two, else [2, 1024] (two spectra's Z-lines of
// double fit the tile budget), Y <= 65535; norm 0 none, 1 magnitude, 2
// classic.
int z_cross(const void* ref, const void* mov, void* out, int Z, int Y, int xh,
            int norm, void* stream) {
  const bool any = !is_pow2(Z);
  const int mz = 1 << radix_log2(Z), ltk = cross_tile_log2(mz);
  if (ltk < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tab = static_cast<int>(any ? table_elems(Z) : Z / 2);
  const size_t smem = (tab + (static_cast<size_t>(mz) << (ltk + 1))) * sizeof(double2);
  auto kernel = any ? z_cross_kernel<true> : z_cross_kernel<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((xh + (1 << ltk) - 1) >> ltk, Y);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(ref), static_cast<const float2*>(mov),
      static_cast<float2*>(out), Z, Y, xh, ltk, norm, tab);
  return static_cast<int>(cudaGetLastError());
}

// spec: (Z, Y, X/2+1) complex64 (left as scratch); out: (Z, Y, X) float32.
// Y and X as for fwd_yx.
int inv_yx(void* spec, void* out, int Z, int Y, int X, void* stream) {
  const SliceLaunch s(Y, X);
  auto kernel = s.any ? inv_yx_kernel<true> : inv_yx_kernel<false>;
  cudaError_t e = allow_smem(kernel, s.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<Z, kThreads, s.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(spec), static_cast<float*>(out), Y, X, s.pairs, s.ltk, s.tab);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
