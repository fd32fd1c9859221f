// Line transforms shared by the FFT kernels (fft.cu: A and C's Bluestein
// lines, K, L; complex products for all) and the spectral deskew kernel
// (spectral.cu: M): in-place radix-2
// FFTs of lines held in shared memory, and Bluestein's chirp convolution on
// them for lengths that are not powers of two (see fft.cu's header for the
// method and its limits). Everything here has internal linkage: each source
// that includes it compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int brev(int i, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log2n));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

template <typename C>
__device__ __forceinline__ C conj_if(C a, bool conj) {
  if (conj) a.y = -a.y;
  return a;
}

__device__ __forceinline__ void from_double(float2& out, double re, double im) {
  out = make_float2(static_cast<float>(re), static_cast<float>(im));
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

// In-place radix-2 FFTs of `nlines` lines of length n = 1 << log2n held in
// shared memory; element e of line l is buf[l * lstride + e * estride].
// DIF: natural order in, bit-reversed out. DIT: bit-reversed in, natural
// out. `inverse` conjugates the twiddles (no scaling). With `line_fast`
// consecutive threads take consecutive lines (column tiles: lstride 1,
// nlines = 1 << log2lines), else consecutive butterflies of one line (rows:
// estride 1), so a warp touches consecutive words in both layouts. Ends on
// a __syncthreads().
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

__host__ __device__ inline bool is_pow2(int n) { return (n & (n - 1)) == 0; }

// log2 of the radix-2 length M of an n-point line: n for a power of two,
// else the least power of two >= 2n - 1 (Bluestein's linear convolution).
__host__ __device__ inline int radix_log2(int n) {
  const int need = is_pow2(n) ? n : 2 * n - 1;
  int l = 1;
  while ((1 << l) < need) ++l;
  return l;
}

// Elements of an axis' tables: M/2 twiddles, and for Bluestein the n-point
// chirp and the M-point convolution kernel.
__host__ __device__ inline size_t table_elems(int n) {
  const size_t m = static_cast<size_t>(1) << radix_log2(n);
  return is_pow2(n) ? m / 2 : m / 2 + n + m;
}

// One axis' line transform: n points on M = 1 << log2m. A power of two
// (blue false, M == n) leaves frequency j at position brev(j); Bluestein
// (blue true) at position j. tw: M/2 twiddles; chirp: w_k; kern: the
// radix-2 DIF spectrum (bit-reversed) of conj(w) wrapped to M, times 1/M.
template <typename C>
struct Axis {
  int n, log2m;
  bool blue;
  const C* tw;
  const C* chirp;
  const C* kern;
};

template <typename C>
__device__ Axis<C> pow2_axis(const C* tw, int n) {
  return Axis<C>{n, 31 - __clz(n), false, tw, nullptr, nullptr};
}

// Builds an axis of n points with its tables at mem (table_elems(n)
// elements). Ends on a __syncthreads().
template <typename C>
__device__ Axis<C> make_axis(C* mem, int n) {
  const int log2m = radix_log2(n), m = 1 << log2m;
  make_twiddles(mem, m);
  if (is_pow2(n)) {
    __syncthreads();
    return pow2_axis(mem, n);
  }
  C* chirp = mem + m / 2;
  C* kern = chirp + n;
  const long long two_n = 2LL * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    double s, c;
    sincospi(-static_cast<double>((static_cast<long long>(k) * k) % two_n) / n, &s, &c);
    from_double(chirp[k], c, s);
  }
  // conj(w) at offsets 0 .. n-1 and, wrapped, at M-1 .. M-n+1; zero between
  // (2n - 1 <= M, so the two ranges are disjoint).
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int k = j < n ? j : (j > m - n ? m - j : -1);
    double s = 0.0, c = 0.0;
    if (k >= 0) sincospi(static_cast<double>((static_cast<long long>(k) * k) % two_n) / n, &s, &c);
    from_double(kern[j], c, s);
  }
  __syncthreads();
  block_fft<true>(kern, log2m, 1, 0, m, 1, mem, false, false);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    kern[j].x /= m;  // exact: M is a power of two
    kern[j].y /= m;
  }
  __syncthreads();
  return Axis<C>{n, log2m, true, mem, chirp, kern};
}

// f(e, v) -> new value of element e < M of every line, laid out as in
// block_fft. Ends on a __syncthreads().
template <typename C, typename F>
__device__ void for_lines(C* buf, int log2m, int nlines, int log2lines, int lstride,
                          int estride, bool line_fast, F f) {
  const int m = 1 << log2m;
  for (int t = threadIdx.x; t < nlines * m; t += blockDim.x) {
    int l, e;
    if (line_fast) {
      l = t & (nlines - 1);
      e = t >> log2lines;
    } else {
      l = t >> log2m;
      e = t & (m - 1);
    }
    C& v = buf[l * lstride + e * estride];
    v = f(e, v);
  }
  __syncthreads();
}

// Bluestein: the n-point DFT (inverse: conjugate chirp and kernel, no
// scaling) of lines holding their n points in natural order at elements
// [0, n); elements [n, M) may hold anything. Leaves frequency j at element
// j < n. Ends on a __syncthreads().
template <typename C>
__device__ void bluestein(C* buf, const Axis<C>& ax, int nlines, int log2lines,
                          int lstride, int estride, bool inverse, bool line_fast) {
  const int n = ax.n;
  const C* w = ax.chirp;
  const C* kern = ax.kern;
  for_lines(buf, ax.log2m, nlines, log2lines, lstride, estride, line_fast,
            [=](int e, C v) { return e < n ? cmul(v, conj_if(w[e], inverse)) : C{0, 0}; });
  block_fft<true>(buf, ax.log2m, nlines, log2lines, lstride, estride, ax.tw, false, line_fast);
  for_lines(buf, ax.log2m, nlines, log2lines, lstride, estride, line_fast,
            [=](int e, C v) { return cmul(v, conj_if(kern[e], inverse)); });
  block_fft<false>(buf, ax.log2m, nlines, log2lines, lstride, estride, ax.tw, true, line_fast);
  for_lines(buf, ax.log2m, nlines, log2lines, lstride, estride, line_fast,
            [=](int e, C v) { return e < n ? cmul(v, conj_if(w[e], inverse)) : v; });
}

// Position of frequency j (or of sample j, for lines_dit's input) in a
// transformed line.
template <bool kAny, typename C>
__device__ __forceinline__ int at(const Axis<C>& ax, int j) {
  if constexpr (kAny) {
    if (ax.blue) return j;
  }
  return brev(j, ax.log2m);
}

// Transform of lines in natural order; frequency j lands at at(ax, j).
template <bool kAny, typename C>
__device__ void lines_dif(C* buf, const Axis<C>& ax, int nlines, int log2lines, int lstride,
                          int estride, bool inverse, bool line_fast) {
  if constexpr (kAny) {
    if (ax.blue) {
      bluestein(buf, ax, nlines, log2lines, lstride, estride, inverse, line_fast);
      return;
    }
  }
  block_fft<true>(buf, ax.log2m, nlines, log2lines, lstride, estride, ax.tw, inverse,
                  line_fast);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
