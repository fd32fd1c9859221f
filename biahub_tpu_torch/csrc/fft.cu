// Fourier filtering of ZYX volumes as float32 shared-memory FFT passes on
// Hopper.
//
// Replaces the Pallas passes of biahub_tpu/kernels/pallas_fft.py:
//
//   A  fwd_yx_kernel    <- _fwd_yx_kernel (pallas_fft.py:286, launched from
//                          _run_pass_a): rfft along X, then DFT along Y, per
//                          z slice (a thread-block cluster each); float32 or
//                          uint16 in.
//   B  z_line_kernel    <- _pass_b_kernel (pallas_fft.py:442, launched from
//                          _run_fourier_pipeline): DFT along Z, times a
//                          filter, inverse DFT along Z, in place. Two
//                          modes: the prepared real Tikhonov filter
//                          tf/(tf^2+reg) (n_filt == 1, kernel B), and a
//                          complex Hermitian filter (n_filt == 2, :479-480,
//                          kernel Bc: fourier_filter_zyx_pallas, :1285, the
//                          phase and fluorescence reconstructions).
//   C  inv_yx_kernel    <- _inv_yx_kernel (pallas_fft.py:530, launched from
//                          _run_pass_c): inverse DFT along Y, then irfft
//                          along X, per z slice (a cluster each); writes
//                          plain ZYX float32.
//   Bx z_cross_kernel   <- _pass_b_cross_kernel (pallas_fft.py:1338, launched
//                          from _run_pass_b_cross): DFT along Z of two
//                          spectra, the phase cross-power H_ref*conj(H_mov)
//                          (none / magnitude / classic, _cross_power
//                          :1317), inverse DFT along Z. A, A, Bx, C is the
//                          phase cross-correlation of pcc_corr_pallas.
//   K  z_fwd_filter_kernel <- _fwd_z_filter_kernel (pallas_spectral.py:198,
//                          launched at :767): B's forward half, DFT along Z
//                          then the filter (real, or complex with n_filt ==
//                          2), stored in place with no inverse.
//   L  y_inv_kernel     <- _inv_y_pad_kernel (pallas_spectral.py:249,
//                          launched at :800): inverse DFT along Y of each kz
//                          slice, in place: C's column phase alone, one
//                          block a column tile, the 1/Y in its last pass.
//   K and L feed kernel M (spectral.cu), the spectral deskew's lerp + irfft.
//
// The spectrum between the passes is the rfft half-spectrum (Z, Y, X/2+1)
// as interleaved complex64, the layout of torch.fft.rfftn, so each pass has
// a one-line plain PyTorch version (biahub_tpu_torch/kernels/fft.py). The
// TPU kernels compute O(N^2) DFTs as bf16-split MXU matmuls; on Hopper every
// pass is memory-bound and a float32 matmul DFT would cost ~5e11 flop per
// volume, so each line is an FFT in shared memory instead (O(N log N), full
// float32, no tensor cores: TF32 keeps 10 mantissa bits and could not meet
// the reference's 1e-5): mixed-radix passes in registers in A, B, Bc, C
// and L (fft_radix.cuh), and in Bx in double, radix-2 stages in K. None of
// the TPU's layout
// devices is carried over: no Nyquist peel (the kx = X/2 bin is simply the
// last column, and the ragged last kx tile is masked), no radix splits
// across kernels, no slab or yzx_pad layouts. Normalisation: B scales by 1/Z, C by 1/(Y*X), L by 1/Y;
// K does not scale; Bx by 1/Z. The radix-2 and Bluestein line code is
// fft_lines.cuh, shared with spectral.cu; the mixed-radix passes are
// fft_radix.cuh.
//
// Lines of any length. In K a power-of-two axis is one radix-2 FFT, and
// its kernel is the kAny = false instantiation, whose code and
// shared-memory layout are those of the power-of-two-only kernel. In
// A, B, Bc, Bx, C and L every 2,3,5,7,11-smooth axis (each length the paths meet,
// the odd test shapes' primes apart) runs the mixed-radix passes. Any
// other length n runs Bluestein's chirp convolution on the radix-2 machinery, in the kAny =
// true instantiations (and in A, C and L's Bluestein branch; B, Bc and Bx run
// it on the mixed-radix passes, see z_line_kernel): with w_k =
// exp(-i pi k^2 / n), exp(-2 pi i jk/n) = w_j w_k conj(w_{j-k}), so a line
// is multiplied by w, circularly convolved with conj(w) through two radix-2
// FFTs of M >= 2n - 1 points and multiplied by w again. The chirp's phase is reduced in
// integers (k^2 mod 2n) and taken with sincospi in double before rounding
// to float: a float k^2/n loses ~1e-4 rad once k^2/n nears 1000. A dense
// odd DFT (the TPU's way) would cost O(n * odd) per line, O(n^2) for a
// prime; Bluestein is O(M log M) for every n at twice the shared memory of
// a line, so a row or column tile holds half the lines. Limits (shared
// memory): powers of two up to 8192, other lengths up to 4096 (M <= 8192)
// for A, B, Bc, C, K and L; Bx, in double, Z up to 2048 for powers of two
// and 1024 otherwise.
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
//      out = 202.9 MB, 0.061 ms (one read, one write; its arithmetic is
//      double, ~0.8 Gflop, 0.024 ms at 34 Tflop/s); at custom_padding's
//      77x1232x155, 352.9 MB, 0.105 ms.
//   K  269.0 MB spectrum in and out + 134.5 MB filter = 672.4 MB, 0.201 ms
//      (complex filter: 269.0 MB, 807.0 MB, 0.241 ms)
//   L  269.0 MB spectrum in and out = 538.0 MB, 0.161 ms
// What the design does about them: every global access is a row segment
// of consecutive elements read or written by one warp, and every FFT
// stage stays in shared memory or registers. B reads and writes the
// spectrum once. A Bluestein line does twice a smooth line's FFT work on
// about twice its length (B, Bc: four transforms of M for two of n).
//
// B and Bc were, like A and C before them, bound by shared memory and
// barriers: 8 + 8 radix-2 stages over a tile at Z = 256, each a block
// barrier, and three 256-point FFTs a way for Z = 86. Now (z_line_kernel)
// a tile runs fft_radix.cuh's passes (16 x 16 at Z = 256: two barriers
// each way; Bluestein on 176 = 16 x 11 at Z = 86), its first pass reading
// the tile cp.async staged with its filter, the filter fused into the last
// forward pass, the last inverse pass storing to device memory.
//
// A and C. On this card they were bound by their instructions and
// barriers, not by HBM: a radix-2 line in shared memory is log2 n passes
// over the tile with a block-wide barrier each (about 300 a slice at the
// headline), a 484-point row ran Bluestein (three 1024-point FFTs), and
// one block per z slice left SMs idle at Z = 64 (a shard, the PCC crop)
// and Z = 86 (the deskewed FOV) on 132 SMs. Now (1) a line is a Stockham
// sequence of radix-16/8/4/2/3/5/7/11 passes in registers, one barrier a
// pass (1024 = 16x8x8, 484 = 4x11x11, 1232 = 16x11x7: three passes each);
// (2) the first pass of a tile reads device memory and the last writes it
// (A's rows in; C's rows in through the Hermitian extension and out; both
// kernels' kx columns in and out), so a column tile of a two-pass Y is one
// barrier and one shared tile (A's split of its two real rows needs S[k]
// and S[X - k] from two threads' butterflies, so A's rows leave through
// shared memory); (3) a slice belongs to a cluster of 8 blocks (fewer
// when it has fewer tiles; kernels/fft.py slice_plan), which share its row
// tiles, meet at a cluster barrier and share its column tiles, so Z = 33
// slices fill the card. The slice still passes through
// device memory between the phases (about twice the bound's bytes unless
// L2 keeps it); holding it in the cluster's distributed shared memory is
// later work. A line's arithmetic depends on Y and X alone, so the result
// is bit-equal over every Z, cluster and shard.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "cp_async.cuh"
#include "fft_lines.cuh"
#include "fft_radix.cuh"

namespace {

constexpr int kThreads = 512;
// Shared-memory budget of one working tile (row pairs, or a column tile).
constexpr int kTileBytes = 96 * 1024;

// Kernels A and C: one thread-block cluster of `cluster` blocks per z
// slice (kernels/fft.py slice_plan).
// The blocks of a cluster share the slice's row tiles, meet at a cluster
// barrier, then share its kx column tiles; the slice's half-spectrum
// passes between the two phases through device memory, written by the
// cluster itself. An axis whose length is 2,3,5,7,11-smooth runs the
// mixed-radix passes of fft_radix.cuh (plan code != 0); any other length
// runs the Bluestein lines of fft_lines.cuh.
constexpr int kSliceThreads = 256;

struct SlicePlan {
  long long ycode, xcode;  // radix plan codes of Y and X; 0: Bluestein
  int pairs;               // row pairs per row tile
  int log2tk;              // log2 of the kx columns per column tile
  int ytab, xtab;          // table elements at the front of shared memory,
                           // column phase and row phase
  int cluster;             // blocks per z slice
};

// Orders the row phase's global stores before the column phase's loads
// (or the reverse) across the slice's blocks. Loads after it bypass L1
// (__ldcg): another SM may have written the line since.
__device__ __forceinline__ void slice_barrier(int cluster) {
  if (cluster > 1) {
    __threadfence();
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// kx columns k0 .. k0 + lines - 1 of one (Y, xh) slice in device memory,
// read (bypassing L1) and written by a radix pass; a column past xh reads
// as zeros and is not stored.
struct Columns {
  float2* slice;
  int xh, k0;
  __device__ __forceinline__ float2 ld(int l, int e) const {
    const int k = k0 + l;
    return k < xh ? __ldcg(slice + static_cast<size_t>(e) * xh + k) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void st(int l, int e, float2 v) const {
    const int k = k0 + l;
    if (k < xh) slice[static_cast<size_t>(e) * xh + k] = v;
  }
};

// Columns whose stores are scaled (kernel L's 1/Y, applied by the last
// pass; loads as Columns).
struct ScaledColumns {
  Columns cols;
  float scale;
  __device__ __forceinline__ void st(int l, int e, float2 v) const {
    cols.st(l, e, make_float2(v.x * scale, v.y * scale));
  }
};

// The FFT along Y of every kx column of one (Y, xh) slice, in place:
// column tiles rank, rank + cluster, ... of the block's cluster. The radix
// passes read the tile's columns from device memory in their first pass
// and write them back in their last, times `scale` with kScaled (kernel L;
// A and C store unscaled, and their code is the kScaled = false one).
template <bool kInv, bool kScaled = false>
__device__ void slice_columns(float2* slice, float2* smem, int Y, int xh, const SlicePlan& sp,
                              int rank, float scale = 1.0f) {
  float2* tw = smem;
  float2* buf = smem + sp.ytab;
  const int tk = 1 << sp.log2tk, step = sp.cluster * tk, total = Y << sp.log2tk;
  const bool radix = sp.ycode != 0;
  RadixPlan py;
  Axis<float2> ay;
  if (radix) {
    py = decode_plan(sp.ycode);
    make_radix_twiddles(tw, py);
    __syncthreads();
  } else {
    ay = make_axis(tw, Y);
  }
  for (int k0 = rank * tk; k0 < xh; k0 += step) {
    const Columns cols{slice, xh, k0};
    const ScaledColumns scaled{cols, scale};
    if (radix) {
      if constexpr (kScaled) {
        radix_run<kInv>(cols, scaled, buf, buf + padded(total), Tile{tk, Y, sp.log2tk}, py, tw);
      } else {
        radix_run<kInv>(cols, cols, buf, buf + padded(total), Tile{tk, Y, sp.log2tk}, py, tw);
      }
    } else {
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        buf[i] = cols.ld(i & (tk - 1), i >> sp.log2tk);
      }
      __syncthreads();
      lines_dif<true>(buf, ay, tk, sp.log2tk, 1, tk, kInv, true);
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        if constexpr (kScaled) {
          scaled.st(i & (tk - 1), i >> sp.log2tk, buf[i]);
        } else {
          cols.st(i & (tk - 1), i >> sp.log2tk, buf[i]);
        }
      }
    }
    __syncthreads();
  }
}

// X's tables for a row phase: the radix plan's twiddles, or Bluestein's
// (then rows are `mx` points apart, else X points in a padded tile).
struct RowAxis {
  bool radix;
  RadixPlan plan;
  Axis<float2> blue;
  int mx;
};

__device__ RowAxis row_axis(float2* tw, int X, long long xcode) {
  RowAxis a;
  a.radix = xcode != 0;
  if (a.radix) {
    a.plan = decode_plan(xcode);
    a.mx = X;
    make_radix_twiddles(tw, a.plan);
    __syncthreads();
  } else {
    a.blue = make_axis(tw, X);
    a.mx = 1 << a.blue.log2m;
  }
  return a;
}

// Kernel A's input rows 2q and 2q+1 (from row0) as the real and imaginary
// parts of line q; an odd Y's last row pairs with zeros.
struct RowPairs {
  const float* in32;
  const uint16_t* in16;
  int is_u16, X, Y, row0;
  __device__ __forceinline__ float2 ld(int q, int x) const {
    const int row = row0 + 2 * q;
    const bool has_b = row + 1 < Y;
    const size_t r0 = static_cast<size_t>(row) * X + x;
    float a, b = 0.f;
    if (is_u16) {
      a = static_cast<float>(in16[r0]);
      if (has_b) b = static_cast<float>(in16[r0 + X]);
    } else {
      a = in32[r0];
      if (has_b) b = in32[r0 + X];
    }
    return make_float2(a, b);
  }
};

// Bin k of kernel A's two rows from their complex FFT S: F0[k] = (S[k] +
// conj S[X-k]) / 2 in row f0, F1[k] = (S[k] - conj S[X-k]) / 2i in the
// next (when there is one).
__device__ __forceinline__ void split_store(float2* f0, bool has_f1, int xh, int k, float2 sk,
                                            float2 sc) {
  f0[k] = make_float2(0.5f * (sk.x + sc.x), 0.5f * (sk.y - sc.y));
  if (has_f1) f0[k + xh] = make_float2(0.5f * (sk.y + sc.y), 0.5f * (sc.x - sk.x));
}

// Kernel C's input rows 2q and 2q+1 (from row0) of the half-spectrum as
// line q, S = F0 + i*F1 by Hermitian extension: point e <= X/2 from bin e,
// point e > X/2 from the conjugates of bin X - e (read from L2 twice, once
// for each). As irfft does, the imaginary parts of the DC bin and, for an
// even X, the Nyquist bin are ignored; an odd Y's last row pairs with
// zeros.
struct HermitianRows {
  const float2* spec;
  int X, Y, row0;
  __device__ __forceinline__ float2 ld(int q, int e) const {
    const int row = row0 + 2 * q, xh = X / 2 + 1;
    const int k = 2 * e <= X ? e : X - e;
    const float2* r = spec + static_cast<size_t>(row) * xh + k;
    float2 a = __ldcg(r);
    float2 b = row + 1 < Y ? __ldcg(r + xh) : make_float2(0.f, 0.f);
    if (k == 0 || 2 * k == X) {
      a.y = 0.f;
      b.y = 0.f;
    }
    return k == e ? make_float2(a.x - b.y, a.y + b.x) : make_float2(a.x + b.y, b.x - a.y);
  }
};

// Kernel C's output rows 2q and 2q+1 (from row0): the real and imaginary
// parts of line q, times scale.
struct RealRows {
  float* out;
  int X, Y, row0;
  float scale;
  __device__ __forceinline__ void st(int q, int x, float2 v) const {
    const int row = row0 + 2 * q;
    const size_t r0 = static_cast<size_t>(row) * X + x;
    out[r0] = v.x * scale;
    if (row + 1 < Y) out[r0 + X] = v.y * scale;
  }
};

// Kernel A. Rows 2q and 2q+1 ride one complex FFT as re + i*im, split into
// their two half-spectra (an odd Y's last row rides with zeros); then the
// DFT along Y over kx column tiles. uint16 converts to float32 exactly in
// registers, and the arithmetic after the load is the same code for both
// input types, so a uint16 volume gives the bits of its float32 copy.
__global__ void __launch_bounds__(kSliceThreads, 2)
fwd_yx_kernel(const void* __restrict__ in, int is_u16, float2* __restrict__ out, int Y, int X,
              SlicePlan sp) {
  extern __shared__ float2 smem[];
  const int rank = static_cast<int>(blockIdx.x % sp.cluster);
  const size_t z = blockIdx.x / sp.cluster;
  const int xh = X / 2 + 1, npairs = (Y + 1) / 2;
  const float* in32 = static_cast<const float*>(in) + z * Y * X;
  const uint16_t* in16 = static_cast<const uint16_t*>(in) + z * Y * X;
  float2* spec = out + z * Y * xh;
  float2* tw = smem;
  float2* buf = smem + sp.xtab;
  float2* other = buf + padded(sp.pairs * X);
  const RowAxis ax = row_axis(tw, X, sp.xcode);
  const bool radix = ax.radix;
  const int mx = ax.mx;

  for (int q0 = rank * sp.pairs; q0 < npairs; q0 += sp.cluster * sp.pairs) {
    const int nq = min(sp.pairs, npairs - q0);
    const RowPairs rows{in32, in16, is_u16, X, Y, 2 * q0};
    if (radix) {
      // the first pass reads the rows from device memory; the split reads
      // S[k] and S[X - k] of the transform in shared memory
      int ns;
      const float2* res = radix_head<false>(rows, buf, other, Tile{nq, X, -1}, ax.plan,
                                            ax.plan.passes, tw, ns);
      // bin k of row pair q, stepped by blockDim without a division
      int q = threadIdx.x / xh, k = threadIdx.x - q * xh;
      const int dq = blockDim.x / xh, dk = blockDim.x - dq * xh;
      for (; q < nq; q += dq, k += dk) {
        if (k >= xh) {
          k -= xh;
          if (++q >= nq) break;
        }
        const int row = 2 * (q0 + q);
        split_store(spec + static_cast<size_t>(row) * xh, row + 1 < Y, xh, k,
                    res[pad(q * X + k)], res[pad(q * X + (k == 0 ? 0 : X - k))]);
      }
    } else {
      for (int i = threadIdx.x; i < nq * X; i += blockDim.x) {
        const int q = i / X, x = i - q * X;
        buf[q * mx + x] = rows.ld(q, x);
      }
      __syncthreads();
      lines_dif<true>(buf, ax.blue, nq, 0, mx, 1, false, false);
      for (int i = threadIdx.x; i < nq * xh; i += blockDim.x) {
        const int q = i / xh, k = i - q * xh, row = 2 * (q0 + q);
        split_store(spec + static_cast<size_t>(row) * xh, row + 1 < Y, xh, k, buf[q * mx + k],
                    buf[q * mx + (k == 0 ? 0 : X - k)]);
      }
    }
    __syncthreads();
  }
  slice_barrier(sp.cluster);
  slice_columns<false>(spec, smem, Y, xh, sp, rank);
}

// Kernel C. The inverse DFT along Y over kx column tiles, in place (the
// spectrum is scratch afterwards); then rows 2q and 2q+1 ride one complex
// inverse FFT of S = F0 + i*F1 built from their half-spectra by Hermitian
// extension: the real part is row 2q, the imaginary part row 2q+1 (an odd
// Y's last row rides with zeros). As irfft does, the imaginary parts of
// the DC bin and, for an even X, the Nyquist bin are ignored.
__global__ void __launch_bounds__(kSliceThreads, 2)
inv_yx_kernel(float2* __restrict__ spec, float* __restrict__ out, int Y, int X, SlicePlan sp) {
  extern __shared__ float2 smem[];
  const int rank = static_cast<int>(blockIdx.x % sp.cluster);
  const size_t z = blockIdx.x / sp.cluster;
  const int xh = X / 2 + 1, npairs = (Y + 1) / 2;
  float2* sl = spec + z * Y * xh;
  float* o = out + z * Y * X;
  slice_columns<true>(sl, smem, Y, xh, sp, rank);
  slice_barrier(sp.cluster);

  float2* tw = smem;
  float2* buf = smem + sp.xtab;
  float2* other = buf + padded(sp.pairs * X);
  const RowAxis ax = row_axis(tw, X, sp.xcode);
  const bool radix = ax.radix;
  const int mx = ax.mx;
  const float scale = 1.0f / (static_cast<float>(Y) * static_cast<float>(X));
  for (int q0 = rank * sp.pairs; q0 < npairs; q0 += sp.cluster * sp.pairs) {
    const int nq = min(sp.pairs, npairs - q0);
    const HermitianRows in{sl, X, Y, 2 * q0};
    const RealRows rows{o, X, Y, 2 * q0, scale};
    if (radix) {
      // the first pass reads the half-spectrum rows from device memory, the
      // last writes the real rows there
      radix_run<true>(in, rows, buf, other, Tile{nq, X, -1}, ax.plan, tw);
    } else {
      for (int i = threadIdx.x; i < nq * X; i += blockDim.x) {
        const int q = i / X, e = i - q * X;
        buf[q * mx + e] = in.ld(q, e);
      }
      __syncthreads();
      lines_dif<true>(buf, ax.blue, nq, 0, mx, 1, true, false);
      for (int i = threadIdx.x; i < nq * X; i += blockDim.x) {
        const int q = i / X, x = i - q * X;
        rows.st(q, x, buf[q * mx + x]);
      }
    }
    __syncthreads();
  }
}

// Kernels B (kComplex false) and Bc (kComplex true): the Z-lines of the
// (Z, lines) spectrum plane, lines = Y * xh, one line per (ky, kx), at stride
// `lines`. A tile is tk consecutive lines (consecutive (ky, kx) columns, so
// a z row of a tile is one run of tk * 8 bytes and only the plane's last tile
// is ragged: no tile is spent on the lone kx = X/2 column). A block walks
// tiles blockIdx.x, + gridDim.x, ...: cp.async stages a tile and its filter
// in shared memory (with two stages the next tile's copies are in flight
// while this one runs), then fft_radix.cuh's register-resident Stockham
// passes run in column layout: the forward transform, its first pass
// reading the stage; the filter applied by its last pass's stores (natural
// order: point kz times filt[kz]); the inverse transform, whose last pass
// stores to device memory times 1/Z. At Z = 256 = 16 x 16 that is two
// passes each way, one barrier a pass. A Z with a prime factor above 11
// runs Bluestein on the passes at M = kernels/fft.py z_line_length(Z)
// points (176 = 16 x 11 for Z = 86): the line times the chirp w, FFT, times
// K (the spectrum of conj(w) wrapped to M, over M), inverse FFT; the
// forward's closing w and the inverse's opening conj(w) cancel (|w| = 1),
// so the filter is applied alone; FFT, times conj(K), inverse FFT, times
// conj(w) / Z (kBlue: a Bluestein line's own instantiation, so a smooth
// line's kernel carries none of its code). The twiddles, chirp and K come
// from the wrapper (kernels/fft.py z_line_table, float64 rounded once). A
// line's arithmetic
// depends on Z alone, never on the tile, block or grid, so the sharded
// route's per-shard B is bit-equal to the unsharded one.
struct ZPlan {
  long long code;  // radix plan of the line's m points
  int m, log2tk, stages, fstage, tab_smem;
};

// Entries of B's table read from shared memory (s) where the block holds
// them, else from device memory (g): a uniform branch, so each load is a
// shared or a global one, never generic.
struct ZTab {
  const float2* s;
  const float2* g;
  __device__ __forceinline__ float2 operator[](int i) const { return s != nullptr ? s[i] : g[i]; }
};

// Point e < t.n of line l of a stage tile times chirp[e]; zeros beyond n
// (Bluestein's first pass).
struct ChirpStage {
  const float2* p;
  Tile t;
  ZTab chirp;
  __device__ __forceinline__ float2 ld(int l, int e) const {
    return e < t.n ? cmul(p[tile_at(t, l, e)], chirp[e]) : make_float2(0.f, 0.f);
  }
};

// A pass's stores into a tile times mul[e] (conjugated with conj):
// Bluestein's K after the FFT.
struct MulLines {
  float2* p;
  Tile t;
  ZTab mul;
  bool conj;
  __device__ __forceinline__ void st(int l, int e, float2 v) const {
    p[tile_at(t, l, e)] = cmul(v, conj_if(mul[e], conj));
  }
};

// The filter's stores into a tile: point e < n of line l times the
// filter, from its stage (point e of line l at e * t.lines + l) or, with
// fs null, from device memory (fg[e * gstride + l]); zeros for e >= n and
// for lines past the plane's end.
template <bool kComplex>
struct FilterLines {
  using F = typename std::conditional<kComplex, float2, float>::type;
  float2* p;
  Tile t;
  int n, valid;
  const F* fs;
  const F* fg;
  size_t gstride;
  __device__ __forceinline__ void st(int l, int e, float2 v) const {
    float2 r = make_float2(0.f, 0.f);
    if (e < n && l < valid) {
      const F h = fs != nullptr ? fs[(e << t.log2lines) + l] : fg[e * gstride + l];
      if constexpr (kComplex) {
        r = make_float2(v.x * h.x - v.y * h.y, v.x * h.y + v.y * h.x);
      } else {
        r = make_float2(v.x * h, v.y * h);
      }
    }
    p[tile_at(t, l, e)] = r;
  }
};

// The last pass's stores to device memory: point e < n of line l < valid,
// times conj(chirp[e]) (Bluestein) and scale.
struct ZLinesOut {
  float2* spec;
  size_t zstride;
  int n, valid;
  bool blue;
  ZTab chirp;
  float scale;
  __device__ __forceinline__ void st(int l, int e, float2 v) const {
    if (e < n && l < valid) {
      if (blue) v = cmul(v, conj_if(chirp[e], true));
      spec[e * zstride + l] = make_float2(v.x * scale, v.y * scale);
    }
  }
};

// The buffer a plan's last pass writes when its first reads a and the
// passes between alternate b, a, b, ...
template <class C>
__device__ __forceinline__ C* last_buffer(C* a, C* b, int passes) {
  return (passes & 1) ? b : a;
}

// The plan's passes over a tile: the first reads src (over buffer a), the
// ones between alternate between b and a, the last writes dst (into
// last_buffer(a, b, passes) when dst is a tile). A barrier after each pass.
template <bool kInv, class Src, class Dst, class C>
__device__ __forceinline__ void line_passes(Src src, Dst dst, C* a, C* b, const Tile t,
                                            const RadixPlan pl, const C* tw) {
  if (pl.passes == 1) {
    radix_pass_r<kInv>(pl.radix(0), src, dst, t, 1, tw);
    __syncthreads();
    return;
  }
  radix_pass_r<kInv>(pl.radix(0), src, SmemTile<C>{b, t}, t, 1, tw);
  __syncthreads();
  int ns = pl.radix(0);
  for (int p = 1; p + 1 < pl.passes; ++p) {
    C* from = (p & 1) ? b : a;
    radix_pass_r<kInv>(pl.radix(p), SmemTile<C>{from, t}, SmemTile<C>{(p & 1) ? a : b, t}, t,
                       ns, tw);
    __syncthreads();
    ns *= pl.radix(p);
  }
  const int p = pl.passes - 1;
  radix_pass_r<kInv>(pl.radix(p), SmemTile<C>{(p & 1) ? b : a, t}, dst, t, ns, tw);
  __syncthreads();
}

__device__ __forceinline__ void cp_async_el(float2* dst, const float2* src, bool ok) {
  cp_async8(dst, src, ok);
}

__device__ __forceinline__ void cp_async_el(float* dst, const float* src, bool ok) {
  cp_async4(dst, src, ok);
}

// Tile c0's Z-lines into the stage dst (column layout st) and, with
// fstage, its filter into fdst (point e of line l at e * tk + l), as one
// commit group; lines past the plane's end read as zeros.
template <class F>
__device__ __forceinline__ void fetch_tile(float2* dst, F* fdst, const float2* spec, const F* filt,
                                           int c0, int lines, size_t zstride, const Tile st,
                                           bool fstage) {
  for (int i = threadIdx.x; i < (st.n << st.log2lines); i += blockDim.x) {
    const int l = i & (st.lines - 1), e = i >> st.log2lines;
    const bool ok = c0 + l < lines;
    const size_t g = ok ? e * zstride + c0 + l : 0;
    cp_async8(dst + tile_at(st, l, e), spec + g, ok);
    if (fstage) cp_async_el(fdst + i, filt + g, ok);
  }
  cp_async_commit();
}

template <bool kComplex, bool kBlue>
__global__ void __launch_bounds__(256, 2)
z_line_kernel(float2* __restrict__ spec, const void* __restrict__ filt,
              const float2* __restrict__ table, int Z, int lines, ZPlan zp) {
  using F = typename FilterLines<kComplex>::F;
  extern __shared__ float2 smem[];
  const RadixPlan pl = decode_plan(zp.code);
  const int n = Z, m = zp.m, tk = 1 << zp.log2tk;
  constexpr bool blue = kBlue;  // m != n
  // the twiddles always in shared memory; a Bluestein line's chirp and K
  // there too with tab_smem, else read from device memory
  const int tab_len = m - 1 + (blue && zp.tab_smem ? n + m : 0);
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) smem[i] = table[i];
  const float2* tw = smem;
  const ZTab chirp = zp.tab_smem ? ZTab{smem + m - 1, nullptr} : ZTab{nullptr, table + m - 1};
  const ZTab kern{chirp.s != nullptr ? chirp.s + n : nullptr,
                  chirp.g != nullptr ? chirp.g + n : nullptr};
  // stages[zp.stages], the work tile, the filter's stages
  float2* s = smem + tab_len;
  const int buf = padded(tk * m);
  float2* work = s + zp.stages * buf;
  F* fstage = reinterpret_cast<F*>(work + buf);
  const Tile st{tk, n, zp.log2tk}, wt{tk, m, zp.log2tk};
  const size_t zstride = static_cast<size_t>(lines);
  const int ntiles = (lines + tk - 1) >> zp.log2tk;
  const F* gfilt = static_cast<const F*>(filt);
  const bool fst = zp.fstage != 0;

  __syncthreads();
  int slot = 0;
  int tile = blockIdx.x;
  if (tile < ntiles) fetch_tile(s, fstage, spec, gfilt, tile << zp.log2tk, lines, zstride, st, fst);
  for (; tile < ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (zp.stages == 2) {
      if (next < ntiles) {
        fetch_tile(s + (slot ^ 1) * buf, fstage + (slot ^ 1) * (tk * n), spec, gfilt,
                   next << zp.log2tk, lines, zstride, st, fst);
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = tile << zp.log2tk, valid = min(tk, lines - c0);
    float2* cur = s + slot * buf;
    const F* fs = fst ? fstage + slot * (tk * n) : nullptr;
    const ZLinesOut out{spec + c0, zstride, n, valid, blue, chirp, 1.0f / static_cast<float>(Z)};
    if constexpr (!blue) {
      float2* fb = last_buffer(cur, work, pl.passes);
      line_passes<false>(SmemLines{cur, wt},
                         FilterLines<kComplex>{fb, wt, n, valid, fs, gfilt + c0, zstride}, cur,
                         work, wt, pl, tw);
      line_passes<true>(SmemLines{fb, wt}, out, fb, fb == cur ? work : cur, wt, pl, tw);
    } else {
      float2* k1 = last_buffer(cur, work, pl.passes);
      float2* o1 = k1 == cur ? work : cur;
      line_passes<false>(ChirpStage{cur, st, chirp}, MulLines{k1, wt, kern, false}, cur, work,
                         wt, pl, tw);
      float2* fb = last_buffer(k1, o1, pl.passes);
      float2* o2 = fb == k1 ? o1 : k1;
      line_passes<true>(SmemLines{k1, wt},
                        FilterLines<kComplex>{fb, wt, n, valid, fs, gfilt + c0, zstride}, k1, o1,
                        wt, pl, tw);
      float2* k2 = last_buffer(fb, o2, pl.passes);
      float2* o3 = k2 == fb ? o2 : fb;
      line_passes<false>(SmemLines{fb, wt}, MulLines{k2, wt, kern, true}, fb, o2, wt, pl, tw);
      line_passes<true>(SmemLines{k2, wt}, out, k2, o3, wt, pl, tw);
    }
    if (zp.stages == 2) {
      slot ^= 1;
    } else if (next < ntiles) {
      fetch_tile(s, fstage, spec, gfilt, next << zp.log2tk, lines, zstride, st, fst);
    }
  }
  cp_async_wait<0>();
}

// Kernel K (z_fwd_filter_kernel): the spectral deskew's pass B'1. One block
// per (ky, tile of tk kx columns): the tile's Z-lines are loaded once,
// transformed forward (a power-of-two Z leaves frequency kz at position
// brev(kz)), multiplied there by the filter (the prepared real float32
// Tikhonov filter, or complex64 with kComplex: (hr fr - hi fi, hr fi + hi
// fr), pallas_fft.py:479-480), and stored in place, kz in natural order,
// with no inverse and no scaling.
template <bool kAny, bool kComplex>
__global__ void __launch_bounds__(kThreads)
z_fwd_filter_kernel(float2* __restrict__ spec, const void* __restrict__ filt,
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
    if (k0 + c >= xh) continue;
    const size_t f = at<kAny>(az, j) * zstride + base + c;
    const float2 h = buf[t];
    if constexpr (kComplex) {
      const float2 fc = static_cast<const float2*>(filt)[f];
      spec[f] = make_float2(h.x * fc.x - h.y * fc.y, h.x * fc.y + h.y * fc.x);
    } else {
      const float fr = static_cast<const float*>(filt)[f];
      spec[f] = make_float2(h.x * fr, h.y * fr);
    }
  }
}

// Kernel L (y_inv_kernel): the inverse DFT along Y of every kx column of
// the (Z, Y, xh) spectrum, in place, times 1/Y (the spectral deskew's pass
// B'2, pallas_spectral.py:249): kernel C's column phase (slice_columns)
// alone. Block b takes column tile b % sp.cluster of kz slice b /
// sp.cluster (kernels/fft.py column_plan: sp.cluster is the slice's tile
// count, so each block runs one tile; the blocks of a slice share nothing,
// so they are launched as independent blocks, not as a cluster). The
// mixed-radix passes read the tile from device memory in their first pass
// and store it times 1/Y in their last; a Y with a prime factor above 11
// runs Bluestein's lines. The front-padded y-major store of the TPU kernel
// is not carried over: kernel M reads tilt row y by its stride.
__global__ void __launch_bounds__(kSliceThreads, 2)
y_inv_kernel(float2* __restrict__ spec, int Y, int xh, SlicePlan sp) {
  extern __shared__ float2 smem[];
  const int rank = static_cast<int>(blockIdx.x % sp.cluster);
  const size_t z = blockIdx.x / sp.cluster;
  slice_columns<true, true>(spec + z * Y * xh, smem, Y, xh, sp, rank,
                            1.0f / static_cast<float>(Y));
}

constexpr double kEps = 1.1920928955078125e-07;  // float32 eps, the reference's clamp

// Kernel Bx (z_cross_kernel): B's z_line_kernel carried over to two
// spectra, in double. A tile is tk consecutive (ky, kx) lines of each
// spectrum (ref in lines [0, tk), mov in [tk, 2tk) of a 2tk-line tile,
// column layout), staged by cp.async, two deep where they fit: one
// 128-byte run per z per spectrum. The forward transform of the 2tk lines
// runs fft_radix.cuh's Stockham passes in double2 with the wrapper's
// double twiddles (64 = 8 x 8, 77 = 11 x 7: two passes each way; blocks
// of 128 threads with up to 170 registers, so that no butterfly spills); the
// inverse transform of the tk cross-power lines reads, in its first pass,
// point kz of both spectra's lines and forms the phase cross-power
// H_ref * conj(H_mov) (norm 0 none, 1 magnitude |c|, 2 classic
// sqrt(|H1|^2 |H2|^2), clamped at float32's eps), and its last pass stores
// to device memory times 1/Z, rounded to complex64. A Z with a prime
// factor above 11 runs Bluestein on the passes at M = kernels/fft.py
// z_line_length(Z): each forward line times the chirp w, FFT, times K,
// inverse FFT gives A with fft = w A; the cross-power of the A's is the
// spectra's (|w| = 1) and takes the inverse's opening conj(w); FFT, times
// conj(K), inverse FFT, times conj(w) / Z. ref is only read (the vs-first
// path reuses it); out may be mov: a tile is read whole before it is
// written, and tiles are disjoint.
//
// Between the load and the store everything is double: the normalizations
// divide by |c|, and a bin near zero beside a large one in the same Z-line
// (the DC column's) turns float32 rounding of the transform into an error
// of order one in its phase. In double the result is the exact function of
// the complex64 spectra to float32 rounding.
struct XPlan {
  long long code;  // radix plan of the line's m points
  int m, log2tk, stages, tab_smem;
};

// Entries of Bx's table read from shared memory (s) or device memory (g).
struct XTab {
  const double2* s;
  const double2* g;
  __device__ __forceinline__ double2 operator[](int i) const { return s != nullptr ? s[i] : g[i]; }
};

// Point e of line l of the float2 stage in double, times chirp[e] for
// Bluestein (zeros beyond its n points).
struct CrossStage {
  const float2* p;
  Tile t;
  bool blue;
  XTab chirp;
  __device__ __forceinline__ double2 ld(int l, int e) const {
    if (e >= t.n) return make_double2(0.0, 0.0);
    const float2 v = p[tile_at(t, l, e)];
    const double2 d = make_double2(v.x, v.y);
    return blue ? cmul(d, chirp[e]) : d;
  }
};

// The inverse's first reads: point e of cross-power line l from lines l
// (ref) and l + lines (mov) of the forward tile t2, times conj(chirp[e])
// for Bluestein; zeros for e >= n.
struct CrossLines {
  const double2* p;
  Tile t2;
  int lines, n, norm;
  bool blue;
  XTab chirp;
  __device__ __forceinline__ double2 ld(int l, int e) const {
    if (e >= n) return make_double2(0.0, 0.0);
    const double2 a = p[tile_at(t2, l, e)], b = p[tile_at(t2, l + lines, e)];
    double cr = a.x * b.x + a.y * b.y;
    double ci = a.y * b.x - a.x * b.y;
    if (norm != 0) {
      // one reciprocal: in double its rounding is far below the float32 result's
      const double d = norm == 1 ? sqrt(cr * cr + ci * ci)
                                 : sqrt((a.x * a.x + a.y * a.y) * (b.x * b.x + b.y * b.y));
      const double r = 1.0 / fmax(d, kEps);
      cr *= r;
      ci *= r;
    }
    const double2 c = make_double2(cr, ci);
    return blue ? cmul(c, conj_if(chirp[e], true)) : c;
  }
};

// A pass's stores into a double tile times mul[e] (conjugated with conj).
struct MulTile {
  double2* p;
  Tile t;
  XTab mul;
  bool conj;
  __device__ __forceinline__ void st(int l, int e, double2 v) const {
    p[tile_at(t, l, e)] = cmul(v, conj_if(mul[e], conj));
  }
};

// The last pass's stores to device memory: point e < n of line l < valid,
// times conj(chirp[e]) (Bluestein) and 1/Z, rounded to complex64.
struct CrossOut {
  float2* out;
  size_t zstride;
  int n, valid;
  bool blue;
  XTab chirp;
  double scale;
  __device__ __forceinline__ void st(int l, int e, double2 v) const {
    if (e < n && l < valid) {
      if (blue) v = cmul(v, conj_if(chirp[e], true));
      out[e * zstride + l] = make_float2(static_cast<float>(v.x * scale),
                                         static_cast<float>(v.y * scale));
    }
  }
};

// Tile c0's Z-lines of both spectra into the stage dst (st: 2tk lines,
// ref then mov), one commit group; lines past the plane's end read as
// zeros.
__device__ __forceinline__ void fetch_pair(float2* dst, const float2* ref, const float2* mov,
                                           int c0, int lines, size_t zstride, const Tile st) {
  const int tk = st.lines >> 1;
  for (int i = threadIdx.x; i < (st.n << st.log2lines); i += blockDim.x) {
    const int l = i & (st.lines - 1), e = i >> st.log2lines;
    const int c = l & (tk - 1);
    const bool ok = c0 + c < lines;
    const size_t g = ok ? e * zstride + c0 + c : 0;
    cp_async8(dst + tile_at(st, l, e), (l < tk ? ref : mov) + g, ok);
  }
  cp_async_commit();
}

template <bool kBlue>
__global__ void __launch_bounds__(128, 3)
z_cross_kernel(const float2* __restrict__ ref, const float2* mov, float2* out,
               const double2* __restrict__ table, int Z, int lines, int norm, XPlan xp) {
  extern __shared__ double2 dsmem[];
  const RadixPlan pl = decode_plan(xp.code);
  const int n = Z, m = xp.m, tk = 1 << xp.log2tk;
  const int tab_len = m - 1 + (kBlue && xp.tab_smem ? n + m : 0);
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) dsmem[i] = table[i];
  const double2* tw = dsmem;
  const XTab chirp = xp.tab_smem ? XTab{dsmem + m - 1, nullptr} : XTab{nullptr, table + m - 1};
  const XTab kern{chirp.s != nullptr ? chirp.s + n : nullptr,
                  chirp.g != nullptr ? chirp.g + n : nullptr};
  // the work tiles w1, w2 (2tk lines of m points each), then the stages
  const int wbuf = padded(2 * tk * m), sbuf = padded(2 * tk * n);
  double2* w1 = dsmem + tab_len;
  double2* w2 = w1 + wbuf;
  float2* stage = reinterpret_cast<float2*>(w2 + wbuf);
  const Tile st{2 * tk, n, xp.log2tk + 1}, wt2{2 * tk, m, xp.log2tk + 1}, wt1{tk, m, xp.log2tk};
  const size_t zstride = static_cast<size_t>(lines);
  const int ntiles = (lines + tk - 1) >> xp.log2tk;
  const double scale = 1.0 / static_cast<double>(Z);

  __syncthreads();
  int slot = 0;
  int tile = blockIdx.x;
  if (tile < ntiles) fetch_pair(stage, ref, mov, tile << xp.log2tk, lines, zstride, st);
  for (; tile < ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (xp.stages == 2) {
      if (next < ntiles) {
        fetch_pair(stage + (slot ^ 1) * sbuf, ref, mov, next << xp.log2tk, lines, zstride, st);
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = tile << xp.log2tk, valid = min(tk, lines - c0);
    const CrossStage src{stage + slot * sbuf, st, kBlue, chirp};
    const CrossOut dst{out + c0, zstride, n, valid, kBlue, chirp, scale};
    if constexpr (!kBlue) {
      double2* f = last_buffer(w1, w2, pl.passes);
      line_passes<false>(src, SmemTile<double2>{f, wt2}, w1, w2, wt2, pl, tw);
      double2* o = f == w1 ? w2 : w1;
      line_passes<true>(CrossLines{f, wt2, tk, n, norm, false, chirp}, dst, f, o, wt1, pl, tw);
    } else {
      // forward: A = iFFT(FFT(x w) K) of the 2tk lines
      double2* k1 = last_buffer(w1, w2, pl.passes);
      line_passes<false>(src, MulTile{k1, wt2, kern, false}, w1, w2, wt2, pl, tw);
      double2* o1 = k1 == w1 ? w2 : w1;
      double2* a = last_buffer(k1, o1, pl.passes);
      line_passes<true>(SmemTile<double2>{k1, wt2}, SmemTile<double2>{a, wt2}, k1, o1, wt2, pl,
                        tw);
      // inverse: iFFT(FFT(cross(A) conj(w)) conj(K)) conj(w) / Z of the tk lines
      double2* o2 = a == k1 ? o1 : k1;
      double2* k2 = last_buffer(a, o2, pl.passes);
      line_passes<false>(CrossLines{a, wt2, tk, n, norm, true, chirp},
                         MulTile{k2, wt1, kern, true}, a, o2, wt1, pl, tw);
      double2* o3 = k2 == a ? o2 : a;
      line_passes<true>(SmemTile<double2>{k2, wt1}, dst, k2, o3, wt1, pl, tw);
    }
    if (xp.stages == 2) {
      slot ^= 1;
    } else if (next < ntiles) {
      fetch_pair(stage, ref, mov, next << xp.log2tk, lines, zstride, st);
    }
  }
  cp_async_wait<0>();
}

// log2 of the widest column tile (<= 32 lines) of m points within budget.
int tile_log2(int m) {
  int l = 5;
  while (l > 0 && (static_cast<size_t>(m) << l) * sizeof(float2) > kTileBytes) --l;
  return l;
}

template <bool kComplex>
int launch_z_fwd_filter(void* spec, const void* filt, int Z, int Y, int xh, void* stream) {
  const bool any = !is_pow2(Z);
  const int mz = 1 << radix_log2(Z), ltk = tile_log2(mz);
  const int tab = static_cast<int>(any ? table_elems(Z) : Z / 2);
  const size_t smem = (tab + (static_cast<size_t>(mz) << ltk)) * sizeof(float2);
  auto kernel = any ? z_fwd_filter_kernel<true, kComplex> : z_fwd_filter_kernel<false, kComplex>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((xh + (1 << ltk) - 1) >> ltk, Y);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(spec), filt, Z, Y, xh, ltk, tab);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of z_line_kernel's shared memory for a plan (kernels/fft.py
// _z_plan_smem): the twiddles (and, with tab_smem, a Bluestein line's
// chirp and K), the stage tiles and the work tile, the filter's stages.
size_t z_line_smem(const ZPlan& zp, int Z, bool complex_filter) {
  const int tk = 1 << zp.log2tk;
  const size_t tab = zp.m - 1 + (zp.m != Z && zp.tab_smem ? Z + zp.m : 0);
  const size_t filt = zp.fstage ? static_cast<size_t>(zp.stages) * tk * Z *
                                      (complex_filter ? 8 : 4) : 0;
  return 8 * (tab + (zp.stages + 1) * static_cast<size_t>(padded(tk * zp.m))) + filt;
}

// B and Bc's launch with the wrapper's plan (kernels/fft.py z_plan): a
// plan whose radices do not multiply to m, whose m is neither Z nor at
// least 2Z - 1, or whose shared memory does not cover its layout is
// refused.
template <bool kComplex>
int launch_z_line(void* spec, const void* filt, const void* table, long long code, int m,
                  int log2tk, int threads, int stages, int fstage, int tab_smem, int grid,
                  int smem, int Z, int lines, void* stream) {
  const ZPlan zp{code, m, log2tk, stages, fstage, tab_smem};
  const RadixPlan pl = decode_plan(code);
  if (pl.passes < 1 || pl.n != m || (m != Z && m < 2 * Z - 1) || log2tk < 0 || log2tk > 5 ||
      stages < 1 || stages > 2 || threads < 32 || threads > 256 || grid < 1 || lines < 1 ||
      z_line_smem(zp, Z, kComplex) > static_cast<size_t>(smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = m != Z ? z_line_kernel<kComplex, true> : z_line_kernel<kComplex, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(spec), filt, static_cast<const float2*>(table), Z, lines, zp);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of z_cross_kernel's shared memory for a plan (kernels/fft.py
// _cross_plan_smem): the m - 1 double twiddles (and with tab_smem a
// Bluestein line's n + m chirp and K entries), the two work tiles of 2tk
// lines of m double2 points, the float2 stages of 2tk lines of n points.
size_t cross_smem(const XPlan& xp, int Z) {
  const int tk = 1 << xp.log2tk;
  const size_t tab = xp.m - 1 + (xp.m != Z && xp.tab_smem ? Z + xp.m : 0);
  return 16 * (tab + 2 * static_cast<size_t>(padded(2 * tk * xp.m))) +
         8 * static_cast<size_t>(xp.stages) * padded(2 * tk * Z);
}

// A and C's launch: Z clusters of sp.cluster blocks. A refused cluster
// launch returns its error (the wrapper names the plan); nothing falls
// back to another cluster size.
template <typename K, typename... Args>
int launch_slices(K kernel, int Z, const SlicePlan& sp, int smem, void* stream, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(Z) * static_cast<unsigned>(sp.cluster));
  cfg.blockDim = dim3(kSliceThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(sp.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args..., sp);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Shared-memory elements a phase over an axis of n points lays out from
// the front, with its table region `tab` elements long and `lines` lines
// (0 when the table does not fit it): radix twiddles and the padded tiles
// its passes alternate between (one when each pass reads or writes device
// memory: at most `direct` passes), or Bluestein's tables and one tile of
// M-point lines.
size_t phase_elems(int n, long long code, int tab, int lines, int direct) {
  if (code != 0) {
    const RadixPlan pl = decode_plan(code);
    if (pl.n != n || tab < n - 1) return 0;
    return tab + (pl.passes <= direct ? 1 : 2) * static_cast<size_t>(padded(lines * n));
  }
  if (static_cast<size_t>(tab) < table_elems(n)) return 0;
  return tab + (static_cast<size_t>(lines) << radix_log2(n));
}

// A plan the kernels can run: each code's radices multiply to its axis (0:
// Bluestein), tables and tiles within smem bytes, a cluster of 1 to 8.
bool plan_fits(const SlicePlan& sp, int smem, int Y, int X) {
  if (sp.pairs < 1 || sp.log2tk < 0 || sp.log2tk > 5 || sp.cluster < 1 || sp.cluster > 8) {
    return false;
  }
  // columns: the first pass reads, the last writes device memory; A's rows
  // keep their last pass in shared memory for the split
  const size_t cols = phase_elems(Y, sp.ycode, sp.ytab, 1 << sp.log2tk, 2);
  const size_t rows = phase_elems(X, sp.xcode, sp.xtab, sp.pairs, 1);
  return cols != 0 && rows != 0 && std::max(cols, rows) * sizeof(float2) <= static_cast<size_t>(smem);
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// in: (Z, Y, X) float32 (is_u16 = 0) or uint16 (is_u16 = 1); out: (Z, Y,
// X/2+1) complex64. The plan (ycode .. smem) is kernels/fft.py slice_plan's
// for (Z, Y, X) on this card.
int fwd_yx(const void* in, int is_u16, void* out, long long ycode, long long xcode, int pairs,
           int log2tk, int ytab, int xtab, int cluster, int smem, int Z, int Y, int X,
           void* stream) {
  const SlicePlan sp{ycode, xcode, pairs, log2tk, ytab, xtab, cluster};
  if (!plan_fits(sp, smem, Y, X)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_slices(fwd_yx_kernel, Z, sp, smem, stream, in, is_u16,
                       static_cast<float2*>(out), Y, X);
}

// spec: (Z, Y, xh) complex64, filtered in place; filt: (Z, Y, xh) float32;
// table: kernels/fft.py z_line_table(Z); the plan (code .. smem) is
// z_plan(Z)'s, lines = Y * xh. Z in [2, 8192] if a power of two, else [2,
// 4096].
int z_filter(void* spec, const void* filt, const void* table, long long code, int m,
             int log2tk, int threads, int stages, int fstage, int tab_smem, int grid, int smem,
             int Z, int lines, void* stream) {
  return launch_z_line<false>(spec, filt, table, code, m, log2tk, threads, stages, fstage,
                              tab_smem, grid, smem, Z, lines, stream);
}

// As z_filter with a complex64 (Z, Y, xh) filter and z_plan(Z, True).
int z_filter_complex(void* spec, const void* filt, const void* table, long long code, int m,
                     int log2tk, int threads, int stages, int fstage, int tab_smem, int grid,
                     int smem, int Z, int lines, void* stream) {
  return launch_z_line<true>(spec, filt, table, code, m, log2tk, threads, stages, fstage,
                             tab_smem, grid, smem, Z, lines, stream);
}

// Kernel K: spec (Z, Y, xh) complex64 = fft(spec, Z) * filt in place, no
// inverse; filt (Z, Y, xh) float32 (is_complex = 0) or complex64 (1). Z in
// [2, 8192] if a power of two, else [2, 4096]; Y <= 65535.
int z_fwd_filter(void* spec, const void* filt, int is_complex, int Z, int Y, int xh,
                 void* stream) {
  return is_complex ? launch_z_fwd_filter<true>(spec, filt, Z, Y, xh, stream)
                    : launch_z_fwd_filter<false>(spec, filt, Z, Y, xh, stream);
}

// Kernel L: spec (Z, Y, xh) complex64 = ifft(spec, Y) in place (with 1/Y).
// The plan (ycode .. smem) is kernels/fft.py column_plan's for (Z, Y, xh):
// Y's radix code (0: Bluestein), log2 of the columns a tile, the table
// elements, the tiles a kz slice (one block each) and the shared memory.
// Y as for fwd_yx; a plan whose tiles do not cover xh or whose shared
// memory does not cover its layout is refused.
int y_inv(void* spec, long long ycode, int log2tk, int ytab, int tiles, int smem, int Z, int Y,
          int xh, void* stream) {
  const SlicePlan sp{ycode, 0, 1, log2tk, ytab, 0, tiles};
  const size_t need = phase_elems(Y, ycode, ytab, 1 << std::max(0, std::min(log2tk, 5)), 2);
  if (log2tk < 0 || log2tk > 5 || tiles < 1 || (static_cast<long long>(tiles) << log2tk) < xh ||
      need == 0 || need * sizeof(float2) > static_cast<size_t>(smem) ||
      static_cast<long long>(Z) * tiles >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = allow_smem(y_inv_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  y_inv_kernel<<<static_cast<unsigned>(Z) * static_cast<unsigned>(tiles), kSliceThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<float2*>(spec), Y, xh, sp);
  return static_cast<int>(cudaGetLastError());
}

// ref, mov, out: (Z, Y, xh) complex64; out may be mov, never ref; table:
// kernels/fft.py cross_table(plan) (complex128); the plan (code .. smem) is
// cross_plan(Z)'s, lines = Y * xh. Z in [2, 2048] if a power of two, else
// [2, 1024]; norm 0 none, 1 magnitude, 2 classic.
int z_cross(const void* ref, const void* mov, void* out, const void* table, long long code,
            int m, int log2tk, int threads, int stages, int tab_smem, int grid, int smem, int Z,
            int lines, int norm, void* stream) {
  const XPlan xp{code, m, log2tk, stages, tab_smem};
  const RadixPlan pl = decode_plan(code);
  if (pl.passes < 1 || pl.n != m || (m != Z && m < 2 * Z - 1) || log2tk < 0 || log2tk > 4 ||
      stages < 1 || stages > 2 || threads < 32 || threads > 128 || grid < 1 || lines < 1 ||
      norm < 0 || norm > 2 || cross_smem(xp, Z) > static_cast<size_t>(smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = m != Z ? z_cross_kernel<true> : z_cross_kernel<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(ref), static_cast<const float2*>(mov),
      static_cast<float2*>(out), static_cast<const double2*>(table), Z, lines, norm, xp);
  return static_cast<int>(cudaGetLastError());
}

// spec: (Z, Y, X/2+1) complex64 (left as scratch); out: (Z, Y, X) float32.
// The plan as for fwd_yx.
int inv_yx(void* spec, void* out, long long ycode, long long xcode, int pairs, int log2tk,
           int ytab, int xtab, int cluster, int smem, int Z, int Y, int X, void* stream) {
  const SlicePlan sp{ycode, xcode, pairs, log2tk, ytab, xtab, cluster};
  if (!plan_fits(sp, smem, Y, X)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_slices(inv_yx_kernel, Z, sp, smem, stream, static_cast<float2*>(spec),
                       static_cast<float*>(out), Y, X);
}

}  // extern "C"
