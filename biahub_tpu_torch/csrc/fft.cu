// Tikhonov deconvolution as three float32 shared-memory FFT passes on Hopper.
//
// Replaces the three Pallas passes of biahub_tpu/kernels/pallas_fft.py:
//
//   A  fwd_yx_kernel    <- _fwd_yx_kernel (pallas_fft.py:286, launched from
//                          _run_pass_a): rfft along X, then DFT along Y, per
//                          z slice; float32 or uint16 in.
//   B  z_filter_kernel  <- _pass_b_kernel (pallas_fft.py:442, launched from
//                          _run_fourier_pipeline): DFT along Z, times the
//                          prepared real filter tf/(tf^2+reg), inverse DFT
//                          along Z, in place.
//   C  inv_yx_kernel    <- _inv_yx_kernel (pallas_fft.py:530, launched from
//                          _run_pass_c): inverse DFT along Y, then irfft
//                          along X, per z slice; writes plain ZYX float32.
//   Bx z_cross_kernel   <- _pass_b_cross_kernel (pallas_fft.py:1338, launched
//                          from _run_pass_b_cross): DFT along Z of two
//                          spectra, the phase cross-power H_ref*conj(H_mov)
//                          (none / magnitude / classic, _cross_power
//                          :1317), inverse DFT along Z. A, A, Bx, C is the
//                          phase cross-correlation of pcc_corr_pallas.
//
// The spectrum between the passes is the rfft half-spectrum (Z, Y, X/2+1)
// as interleaved complex64, the layout of torch.fft.rfftn, so each pass has
// a one-line plain PyTorch version (biahub_tpu_torch/kernels/fft.py). The
// TPU kernels compute O(N^2) DFTs as bf16-split MXU matmuls; on Hopper every
// pass is memory-bound and a float32 matmul DFT would cost ~5e11 flop per
// volume, so each line is a radix-2 FFT in shared memory instead (O(N log N),
// full float32, no tensor cores: TF32 keeps 10 mantissa bits and could not
// meet the reference's 1e-5). None of the TPU's layout devices is carried
// over: no Nyquist peel (the kx = X/2 bin is simply the 513th column, and the
// ragged last kx tile is masked), no radix splits across kernels, no slab or
// yzx_pad layouts. Normalisation: B scales by 1/Z, C by 1/(Y*X).
//
// Bounds on one H100 SXM (3.35 TB/s; each input read once, each output
// written once) at the headline 256x256x1024 volume, all three bytes-bound:
//   A  268.4 MB f32 in (134.2 MB uint16) + 269.0 MB spectrum out
//      = 537.4 MB, 0.160 ms (uint16: 403.2 MB, 0.120 ms). ~3.0 Gflop of
//      FFT work is 0.045 ms at the 67 Tflop/s float32 rate.
//   B  269.0 MB spectrum in and out + 134.5 MB filter = 672.4 MB, 0.201 ms
//   C  269.0 MB spectrum in + 268.4 MB volume out = 537.4 MB, 0.160 ms
//   Bx at the stabilization crop 64x1024x256: two 67.6 MB spectra in, one
//      out = 202.9 MB, 0.061 ms (B's design: one read, one write; its
//      arithmetic is double, ~0.8 Gflop, 0.024 ms at 34 Tflop/s).
// What the design does about them: every global access is a row segment
// of 32 consecutive elements (256 B of complex64) read or written by one
// warp, and every FFT stage stays in shared memory. A and C are one block
// per z slice in two phases (rows, then kx column tiles), and the 1 MB
// slice passes through device memory between the phases: that is about
// twice the bound's traffic unless L2 keeps the slice. B reads and writes
// the spectrum once. Making A and C keep the slice on chip is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
// Shared-memory budget of one working tile (row pairs, or a column tile).
constexpr int kTileBytes = 96 * 1024;

__device__ __forceinline__ int brev(int i, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2n));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// tw[k] = exp(-2 pi i k / n) for k < n / 2 (n a power of two, so the
// argument of sincospif is exact).
__device__ void make_twiddles(float2* tw, int n) {
  for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
    float s, c;
    sincospif(-2.0f * static_cast<float>(k) / static_cast<float>(n), &s, &c);
    tw[k] = make_float2(c, s);
  }
}

__device__ void make_twiddles(double2* tw, int n) {
  for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
    double s, c;
    sincospi(-2.0 * static_cast<double>(k) / static_cast<double>(n), &s, &c);
    tw[k] = make_double2(c, s);
  }
}

// In-place radix-2 FFTs of `nlines` lines of length n = 1 << log2n held in
// shared memory; element e of line l is buf[l * lstride + e * estride].
// DIF: natural order in, bit-reversed out. DIT: bit-reversed in, natural
// out. `inverse` conjugates the twiddles (no scaling). With `line_fast`
// consecutive threads take consecutive lines (column tiles: lstride 1,
// nlines = 1 << log2lines), else consecutive butterflies of one line (rows:
// estride 1), so a warp touches consecutive words in both layouts. Ends on
// a __syncthreads(). C is float2, or double2 for kernel Bx.
template <bool DIF, typename C>
__device__ void block_fft(C* buf, int log2n, int nlines, int log2lines,
                          int lstride, int estride, const C* tw,
                          bool inverse, bool line_fast) {
  const int half = 1 << (log2n - 1);
  const int total = nlines * half;
  for (int s = 0; s < log2n; ++s) {
    const int log2m = DIF ? (log2n - 1 - s) : s;  // half span m = 1 << log2m
    const int m = 1 << log2m;
    const int tshift = log2n - 1 - log2m;  // twiddle stride n / (2m)
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      int l, b;
      if (line_fast) {
        l = t & (nlines - 1);
        b = t >> log2lines;
      } else {
        l = t >> (log2n - 1);
        b = t & (half - 1);
      }
      const int k = b & (m - 1);
      const int i = ((b >> log2m) << (log2m + 1)) + k;
      C w = tw[k << tshift];
      if (inverse) w.y = -w.y;
      C* p = buf + l * lstride;
      const C a = p[i * estride];
      C c = p[(i + m) * estride];
      if (DIF) {
        p[i * estride] = C{a.x + c.x, a.y + c.y};
        p[(i + m) * estride] = cmul(C{a.x - c.x, a.y - c.y}, w);
      } else {
        c = cmul(c, w);
        p[i * estride] = C{a.x + c.x, a.y + c.y};
        p[(i + m) * estride] = C{a.x - c.x, a.y - c.y};
      }
    }
    __syncthreads();
  }
}

// FFT along Y of every kx column of one (Y, xh) complex slice, in place in
// device memory, tk = 1 << log2tk columns at a time (the ragged last tile is
// zero-padded in shared memory and masked on the store).
__device__ void columns_y(float2* slice, float2* buf, const float2* twy,
                          int log2y, int xh, int log2tk, bool inverse) {
  const int Y = 1 << log2y, tk = 1 << log2tk;
  for (int k0 = 0; k0 < xh; k0 += tk) {
    for (int t = threadIdx.x; t < (Y << log2tk); t += blockDim.x) {
      const int y = t >> log2tk, k = k0 + (t & (tk - 1));
      buf[t] = k < xh ? slice[static_cast<size_t>(y) * xh + k]
                      : make_float2(0.f, 0.f);
    }
    __syncthreads();
    block_fft<true>(buf, log2y, tk, log2tk, 1, tk, twy, inverse, true);
    for (int t = threadIdx.x; t < (Y << log2tk); t += blockDim.x) {
      const int ky = t >> log2tk, c = t & (tk - 1), k = k0 + c;
      if (k < xh) {
        slice[static_cast<size_t>(ky) * xh + k] =
            buf[(brev(ky, log2y) << log2tk) + c];
      }
    }
    __syncthreads();
  }
}

// Kernel A. One block per z slice. Phase 1: rows 2q and 2q+1 ride one
// complex FFT as re + i*im, split into their two half-spectra. Phase 2: the
// DFT along Y over kx column tiles. uint16 converts to float32 exactly in
// registers, and the arithmetic after the load is the same code for both
// input types, so a uint16 volume gives the bits of its float32 copy.
__global__ void __launch_bounds__(kThreads)
fwd_yx_kernel(const void* __restrict__ in, int is_u16, float2* __restrict__ out,
              int log2y, int log2x, int pairs, int log2tk) {
  extern __shared__ float2 smem[];
  const int Y = 1 << log2y, X = 1 << log2x, xh = X / 2 + 1;
  float2* twx = smem;
  float2* twy = twx + X / 2;
  float2* buf = twy + Y / 2;
  make_twiddles(twx, X);
  make_twiddles(twy, Y);
  const size_t z = blockIdx.x;
  const float* in32 = static_cast<const float*>(in) + z * Y * X;
  const uint16_t* in16 = static_cast<const uint16_t*>(in) + z * Y * X;
  float2* spec = out + z * Y * xh;
  __syncthreads();

  for (int q0 = 0; q0 < Y / 2; q0 += pairs) {
    const int nq = min(pairs, Y / 2 - q0);
    for (int t = threadIdx.x; t < (nq << log2x); t += blockDim.x) {
      const int q = t >> log2x, x = t & (X - 1);
      const size_t r0 = static_cast<size_t>(2 * (q0 + q)) * X + x;
      float a, b;
      if (is_u16) {
        a = static_cast<float>(in16[r0]);
        b = static_cast<float>(in16[r0 + X]);
      } else {
        a = in32[r0];
        b = in32[r0 + X];
      }
      buf[t] = make_float2(a, b);
    }
    __syncthreads();
    block_fft<true>(buf, log2x, nq, 0, X, 1, twx, false, false);
    // F0[k] = (S[k] + conj S[X-k]) / 2,  F1[k] = (S[k] - conj S[X-k]) / 2i
    for (int t = threadIdx.x; t < nq * xh; t += blockDim.x) {
      const int q = t / xh, k = t - q * xh;
      const float2* line = buf + (q << log2x);
      const float2 sk = line[brev(k & (X - 1), log2x)];
      const float2 sc = line[brev((X - k) & (X - 1), log2x)];
      const size_t o = static_cast<size_t>(2 * (q0 + q)) * xh + k;
      spec[o] = make_float2(0.5f * (sk.x + sc.x), 0.5f * (sk.y - sc.y));
      spec[o + xh] = make_float2(0.5f * (sk.y + sc.y), 0.5f * (sc.x - sk.x));
    }
    __syncthreads();
  }
  columns_y(spec, buf, twy, log2y, xh, log2tk, false);
}

// Kernel B. One block per (ky, tile of tk kx columns): the tile's Z-lines
// are loaded once, transformed forward (DIF, so frequency kz sits at
// position brev(kz)), scaled by the filter there, transformed back (DIT,
// bit-reversed in, natural out) with 1/Z, and stored in place.
__global__ void __launch_bounds__(kThreads)
z_filter_kernel(float2* __restrict__ spec, const float* __restrict__ filt,
                int log2z, int Y, int xh, int log2tk) {
  extern __shared__ float2 smem[];
  const int Z = 1 << log2z, tk = 1 << log2tk;
  float2* twz = smem;
  float2* buf = twz + Z / 2;
  make_twiddles(twz, Z);
  const int k0 = blockIdx.x * tk;
  const size_t zstride = static_cast<size_t>(Y) * xh;
  const size_t base = static_cast<size_t>(blockIdx.y) * xh + k0;
  for (int t = threadIdx.x; t < (Z << log2tk); t += blockDim.x) {
    const int z = t >> log2tk, c = t & (tk - 1);
    buf[t] = k0 + c < xh ? spec[z * zstride + base + c] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  block_fft<true>(buf, log2z, tk, log2tk, 1, tk, twz, false, true);
  for (int t = threadIdx.x; t < (Z << log2tk); t += blockDim.x) {
    const int j = t >> log2tk, c = t & (tk - 1);
    const float f = k0 + c < xh ? filt[brev(j, log2z) * zstride + base + c] : 0.f;
    buf[t] = make_float2(buf[t].x * f, buf[t].y * f);
  }
  __syncthreads();
  block_fft<false>(buf, log2z, tk, log2tk, 1, tk, twz, true, true);
  const float inv_z = 1.0f / static_cast<float>(Z);
  for (int t = threadIdx.x; t < (Z << log2tk); t += blockDim.x) {
    const int z = t >> log2tk, c = t & (tk - 1);
    if (k0 + c < xh) {
      spec[z * zstride + base + c] = make_float2(buf[t].x * inv_z, buf[t].y * inv_z);
    }
  }
}

constexpr double kEps = 1.1920928955078125e-07;  // float32 eps, the reference's clamp

// Kernel Bx. One block per (ky, tile of tk kx columns), as B. The tile's
// Z-lines of both spectra sit side by side in shared memory (ref in columns
// [0, tk), mov in [tk, 2tk)) and ride one forward DIF transform of 2tk
// lines, so both hold frequency kz at position brev(kz) and the cross-power
// is pointwise. It replaces the ref columns, which go back through the
// inverse (DIT, with 1/Z) and are stored into out. ref is only read (the
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
__global__ void __launch_bounds__(kThreads)
z_cross_kernel(const float2* __restrict__ ref, const float2* mov, float2* out,
               int log2z, int Y, int xh, int log2tk, int norm) {
  extern __shared__ double2 dsmem[];
  const int Z = 1 << log2z, tk = 1 << log2tk, w = 2 * tk;
  double2* twz = dsmem;
  double2* buf = twz + Z / 2;
  make_twiddles(twz, Z);
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
  block_fft<true>(buf, log2z, w, log2tk + 1, 1, w, twz, false, true);
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
  block_fft<false>(buf, log2z, tk, log2tk, 1, w, twz, true, true);
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
// imaginary part row 2q+1. As irfft does, the imaginary parts of the DC and
// Nyquist bins are ignored.
__global__ void __launch_bounds__(kThreads)
inv_yx_kernel(float2* __restrict__ spec, float* __restrict__ out, int log2y,
              int log2x, int pairs, int log2tk) {
  extern __shared__ float2 smem[];
  const int Y = 1 << log2y, X = 1 << log2x, xh = X / 2 + 1;
  float2* twx = smem;
  float2* twy = twx + X / 2;
  float2* buf = twy + Y / 2;
  make_twiddles(twx, X);
  make_twiddles(twy, Y);
  const size_t z = blockIdx.x;
  float2* sp = spec + z * Y * xh;
  float* o = out + z * Y * X;
  __syncthreads();

  columns_y(sp, buf, twy, log2y, xh, log2tk, true);

  const float scale = 1.0f / (static_cast<float>(Y) * static_cast<float>(X));
  for (int q0 = 0; q0 < Y / 2; q0 += pairs) {
    const int nq = min(pairs, Y / 2 - q0);
    for (int t = threadIdx.x; t < nq * xh; t += blockDim.x) {
      const int q = t / xh, k = t - q * xh;
      const float2* r = sp + static_cast<size_t>(2 * (q0 + q)) * xh;
      float2 a = r[k], b = r[k + xh];
      if (k == 0 || k == X / 2) {
        a.y = 0.f;
        b.y = 0.f;
      }
      float2* line = buf + (q << log2x);
      line[k] = make_float2(a.x - b.y, a.y + b.x);
      if (k > 0 && k < X / 2) line[X - k] = make_float2(a.x + b.y, b.x - a.y);
    }
    __syncthreads();
    block_fft<true>(buf, log2x, nq, 0, X, 1, twx, true, false);
    for (int t = threadIdx.x; t < (nq << log2x); t += blockDim.x) {
      const int q = t >> log2x, x = t & (X - 1);
      const float2 v = buf[(q << log2x) + brev(x, log2x)];
      const size_t r0 = static_cast<size_t>(2 * (q0 + q)) * X + x;
      o[r0] = v.x * scale;
      o[r0 + X] = v.y * scale;
    }
    __syncthreads();
  }
}

int log2i(int n) { return 31 - __builtin_clz(static_cast<unsigned>(n)); }

// log2 of the widest column tile (<= 32 lines) of length n within budget.
int tile_log2(int n) {
  int l = 5;
  while (l > 0 && (static_cast<size_t>(n) << l) * sizeof(float2) > kTileBytes) --l;
  return l;
}

// log2 of Bx's column tile: two spectra's Z-lines of double2 share the
// budget, so Z <= kTileBytes / 32 = 3072 at one column; -1 when even that
// does not fit.
int cross_tile_log2(int z) {
  int l = 5;
  while (l >= 0 && (static_cast<size_t>(z) << (l + 1)) * sizeof(double2) > kTileBytes) --l;
  return l;
}

// Row pairs per phase-1 chunk of rows of length x.
int row_pairs(int x) {
  return std::max(1, std::min(8, kTileBytes / static_cast<int>(x * sizeof(float2))));
}

// Launch shape shared by the per-slice kernels A and C.
struct SliceLaunch {
  int ly, lx, ltk, pairs;
  size_t smem;
  SliceLaunch(int Y, int X)
      : ly(log2i(Y)), lx(log2i(X)), ltk(tile_log2(Y)), pairs(row_pairs(X)) {
    const size_t tile =
        std::max(static_cast<size_t>(pairs) * X, static_cast<size_t>(Y) << ltk);
    smem = (X / 2 + Y / 2 + tile) * sizeof(float2);
  }
};

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// in: (Z, Y, X) float32 (is_u16 = 0) or uint16 (is_u16 = 1); out: (Z, Y,
// X/2+1) complex64. Z, Y, X powers of two in [2, 8192] (checked by the
// Python wrapper).
int fwd_yx(const void* in, int is_u16, void* out, int Z, int Y, int X, void* stream) {
  const SliceLaunch s(Y, X);
  cudaError_t e = cudaFuncSetAttribute(
      fwd_yx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_yx_kernel<<<Z, kThreads, s.smem, static_cast<cudaStream_t>(stream)>>>(
      in, is_u16, static_cast<float2*>(out), s.ly, s.lx, s.pairs, s.ltk);
  return static_cast<int>(cudaGetLastError());
}

// spec: (Z, Y, xh) complex64, filtered in place; filt: (Z, Y, xh) float32.
// Z a power of two in [2, 8192], Y <= 65535.
int z_filter(void* spec, const void* filt, int Z, int Y, int xh, void* stream) {
  const int lz = log2i(Z), ltk = tile_log2(Z);
  const size_t smem = (Z / 2 + (static_cast<size_t>(Z) << ltk)) * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      z_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((xh + (1 << ltk) - 1) >> ltk, Y);
  z_filter_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(spec), static_cast<const float*>(filt), lz, Y, xh, ltk);
  return static_cast<int>(cudaGetLastError());
}

// ref, mov, out: (Z, Y, xh) complex64; out may be mov, never ref. Z a power
// of two in [2, 2048] (the largest whose two Z-lines fit the tile budget),
// Y <= 65535; norm 0 none, 1 magnitude, 2 classic.
int z_cross(const void* ref, const void* mov, void* out, int Z, int Y, int xh,
            int norm, void* stream) {
  const int lz = log2i(Z), ltk = cross_tile_log2(Z);
  if (ltk < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (Z / 2 + (static_cast<size_t>(Z) << (ltk + 1))) * sizeof(double2);
  cudaError_t e = cudaFuncSetAttribute(
      z_cross_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((xh + (1 << ltk) - 1) >> ltk, Y);
  z_cross_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(ref), static_cast<const float2*>(mov),
      static_cast<float2*>(out), lz, Y, xh, ltk, norm);
  return static_cast<int>(cudaGetLastError());
}

// spec: (Z, Y, X/2+1) complex64 (left as scratch); out: (Z, Y, X) float32.
int inv_yx(void* spec, void* out, int Z, int Y, int X, void* stream) {
  const SliceLaunch s(Y, X);
  cudaError_t e = cudaFuncSetAttribute(
      inv_yx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  inv_yx_kernel<<<Z, kThreads, s.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(spec), static_cast<float*>(out), s.ly, s.lx, s.pairs, s.ltk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
