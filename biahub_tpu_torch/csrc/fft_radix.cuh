// Register-resident mixed-radix line FFTs for kernels A, B, Bc and C (fft.cu),
// in float2, and for kernel Bx in double2: every function below is a
// template on the complex type C, whose real type's constants come from
// Coef<float> (the float literals A, B, Bc and C have always compiled) or
// Coef<double> (the same decimals as double literals).
//
// A line of n = r_0 r_1 ... r_{P-1} points (every r_p in {2, 4, 8, 16, 3,
// 5, 7, 11}) runs as P Stockham passes (decimation in time, natural order
// in and out). Pass p, with ns = r_0 ... r_{p-1} points already combined:
// butterfly j < n / r loads the r points j + q n / r (q < r) into
// registers, multiplies point q by w^(q k), k = j mod ns, w = exp(-2 pi i /
// (ns r)), takes their r-point DFT in registers (constant coefficients) and
// stores output q at (j - k) r + k + q ns. Each pass reads a tile of lines
// from one shared-memory buffer and writes the other: one read, one write
// and one barrier. The plan (the radices, in order) comes from the Python
// wrapper (kernels/fft.py radix_plan) packed 5 bits a radix, first radix
// lowest; tests/test_torch_fft_radix.py models these index maps, twiddles
// and coefficients.
//
// Twiddles: pass p's (r - 1) ns factors w^(q k) sit at ns - 1 + (q - 1) ns
// + k of one table of n - 1 entries (the passes' ns - 1 offsets telescope),
// computed in double with sincospi from the integer ratio q k / (ns r) and
// rounded to float (Bx's double table comes from the wrapper). A line's arithmetic depends on its length alone, never
// on the tile, the block or the cluster that computes it.
//
// Tiles are padded one element in 16 (pad()): a pass's stride-r stores of
// its first passes (ns < 16) would otherwise fall into few banks.

#pragma once

#include <cuda_runtime.h>

#include "fft_lines.cuh"

namespace {

// A plan code: 5 bits a radix, first pass lowest, 0 after the last; n is
// the radices' product. Radix p is read off the code, so no array is
// indexed at run time.
struct RadixPlan {
  long long code;
  int n, passes;
  __host__ __device__ int radix(int p) const { return static_cast<int>((code >> (5 * p)) & 31); }
};

__host__ __device__ inline RadixPlan decode_plan(long long code) {
  RadixPlan p{code, 1, 0};
  for (long long c = code; c != 0 && p.passes < 12; c >>= 5, ++p.passes) {
    p.n *= static_cast<int>(c & 31);
  }
  return p;
}

// Shared-memory position of linear tile index i: one element of padding in 16.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// Elements a padded tile of e points spans.
__host__ __device__ inline int padded(int e) { return e + (e >> 4) + 1; }

// A tile of `lines` lines of n points. Row layout (log2lines < 0): point e
// of line l at linear index l n + e. Column layout: at (e << log2lines) + l,
// lines = 1 << log2lines, so a warp's threads take neighbouring lines.
struct Tile {
  int lines, n, log2lines;
};

__device__ __forceinline__ int tile_at(const Tile& t, int l, int e) {
  return pad(t.log2lines >= 0 ? (e << t.log2lines) + l : l * t.n + e);
}

// Pass twiddle tables of a plan (n - 1 entries at tw). Block-wide; the
// caller synchronizes before use.
__device__ void make_radix_twiddles(float2* tw, const RadixPlan& pl) {
  int ns = 1;
  for (int p = 0; p < pl.passes; ++p) {
    const int r = pl.radix(p), span = ns * r;
    for (int i = threadIdx.x; i < (r - 1) * ns; i += blockDim.x) {
      const int q = i / ns + 1, k = i - (q - 1) * ns;
      double s, c;
      sincospi(-2.0 * static_cast<double>(q * k) / static_cast<double>(span), &s, &c);
      tw[ns - 1 + i] = make_float2(static_cast<float>(c), static_cast<float>(s));
    }
    ns = span;
  }
}

// The complex type's real type, constructor and DFT constants (below).
template <class C>
struct Coef;

// cos and sin of 2 pi m / 16 for m < 8 (switches, not arrays: an array
// indexed in a loop that does not unroll would live in local memory).
__host__ __device__ constexpr float cos16(int m) {
  switch (m) {
    case 0: return 1.0f;
    case 1: return 0.92387953251128674f;
    case 2: return 0.70710678118654757f;
    case 3: return 0.38268343236508984f;
    case 4: return 0.0f;
    case 5: return -0.38268343236508973f;
    case 6: return -0.70710678118654746f;
    default: return -0.92387953251128674f;
  }
}

__host__ __device__ constexpr float sin16(int m) { return m == 0 ? 0.0f : cos16(m < 4 ? 4 - m : m - 4); }

// a times exp(-2 pi i M / 16) (kInv: exp(+2 pi i M / 16)), M < 8.
template <bool kInv, int M, class C>
__device__ __forceinline__ C rot16(C a) {
  using K = Coef<C>;
  using T = typename K::Real;
  if constexpr (M == 0) {
    return a;
  } else if constexpr (M == 4) {
    return kInv ? K::make(-a.y, a.x) : K::make(a.y, -a.x);
  } else {
    constexpr T c = K::cos16(M), s = kInv ? K::sin16(M) : -K::sin16(M);
    return K::make(a.x * c - a.y * s, a.x * s + a.y * c);
  }
}

__host__ __device__ constexpr int ilog2c(int n) { return n <= 1 ? 0 : 1 + ilog2c(n / 2); }

__host__ __device__ constexpr int brevc(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// Butterfly k of every span-2H group of a radix-2 DIF stage, and the
// stages below it (template recursion, so every index is a constant).
template <int R, bool kInv, int H, int I0, int K, class C>
__device__ __forceinline__ void dif_butterflies(C (&v)[R]) {
  if constexpr (I0 < R) {
    if constexpr (K < H) {
      const C a = v[I0 + K], b = v[I0 + K + H];
      v[I0 + K] = Coef<C>::make(a.x + b.x, a.y + b.y);
      v[I0 + K + H] = rot16<kInv, K * (8 / H)>(Coef<C>::make(a.x - b.x, a.y - b.y));
      dif_butterflies<R, kInv, H, I0, K + 1>(v);
    } else {
      dif_butterflies<R, kInv, H, I0 + 2 * H, 0>(v);
    }
  }
}

template <int R, bool kInv, int H, class C>
__device__ __forceinline__ void dif_stages(C (&v)[R]) {
  dif_butterflies<R, kInv, H, 0, 0>(v);
  if constexpr (H > 1) dif_stages<R, kInv, H / 2>(v);
}

template <int R, int I, class C>
__device__ __forceinline__ void unscramble(const C (&t)[R], C (&v)[R]) {
  if constexpr (I < R) {
    v[brevc(I, ilog2c(R))] = t[I];
    unscramble<R, I + 1>(t, v);
  }
}

// R-point DFT of v in registers, R a power of two up to 16: radix-2
// decimation in frequency, then the bit-reversed result put in order.
template <int R, bool kInv, class C>
__device__ __forceinline__ void dft_pow2(C (&v)[R]) {
  if constexpr (R > 1) dif_stages<R, kInv, R / 2>(v);
  C t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) t[i] = v[i];
  unscramble<R, 0>(t, v);
}

// cos and sin of 2 pi m / r for r in {3, 5, 7, 11} and 0 < m <= (r - 1) / 2.
__host__ __device__ constexpr float unit_cos(int r, int m) {
  switch (r * 16 + m) {
    case 3 * 16 + 1: return -0.5f;
    case 5 * 16 + 1: return 0.30901699437494745f;
    case 5 * 16 + 2: return -0.80901699437494734f;
    case 7 * 16 + 1: return 0.62348980185873359f;
    case 7 * 16 + 2: return -0.22252093395631434f;
    case 7 * 16 + 3: return -0.90096886790241903f;
    case 11 * 16 + 1: return 0.84125353283118121f;
    case 11 * 16 + 2: return 0.41541501300188644f;
    case 11 * 16 + 3: return -0.142314838273285f;
    case 11 * 16 + 4: return -0.65486073394528499f;
    default: return -0.95949297361449737f;  // 11, 5
  }
}

__host__ __device__ constexpr float unit_sin(int r, int m) {
  switch (r * 16 + m) {
    case 3 * 16 + 1: return 0.86602540378443865f;
    case 5 * 16 + 1: return 0.95105651629515353f;
    case 5 * 16 + 2: return 0.58778525229247325f;
    case 7 * 16 + 1: return 0.7818314824680298f;
    case 7 * 16 + 2: return 0.97492791218182362f;
    case 7 * 16 + 3: return 0.43388373911755823f;
    case 11 * 16 + 1: return 0.54064081745559756f;
    case 11 * 16 + 2: return 0.90963199535451833f;
    case 11 * 16 + 3: return 0.9898214418809328f;
    case 11 * 16 + 4: return 0.75574957435425827f;
    default: return 0.28173255684142967f;  // 11, 5
  }
}

// cos and sin of 2 pi m / r for 0 < m < r.
__host__ __device__ constexpr float cos_rm(int r, int m) {
  return unit_cos(r, 2 * m < r ? m : r - m);
}

__host__ __device__ constexpr float sin_rm(int r, int m) {
  return 2 * m < r ? unit_sin(r, m) : -unit_sin(r, r - m);
}

// The same constants as double literals, for kernel Bx.
__host__ __device__ constexpr double cos16_d(int m) {
  switch (m) {
    case 0: return 1.0;
    case 1: return 0.92387953251128674;
    case 2: return 0.70710678118654757;
    case 3: return 0.38268343236508984;
    case 4: return 0.0;
    case 5: return -0.38268343236508973;
    case 6: return -0.70710678118654746;
    default: return -0.92387953251128674;
  }
}

__host__ __device__ constexpr double sin16_d(int m) {
  return m == 0 ? 0.0 : cos16_d(m < 4 ? 4 - m : m - 4);
}

__host__ __device__ constexpr double unit_cos_d(int r, int m) {
  switch (r * 16 + m) {
    case 3 * 16 + 1: return -0.5;
    case 5 * 16 + 1: return 0.30901699437494745;
    case 5 * 16 + 2: return -0.80901699437494734;
    case 7 * 16 + 1: return 0.62348980185873359;
    case 7 * 16 + 2: return -0.22252093395631434;
    case 7 * 16 + 3: return -0.90096886790241903;
    case 11 * 16 + 1: return 0.84125353283118121;
    case 11 * 16 + 2: return 0.41541501300188644;
    case 11 * 16 + 3: return -0.142314838273285;
    case 11 * 16 + 4: return -0.65486073394528499;
    default: return -0.95949297361449737;  // 11, 5
  }
}

__host__ __device__ constexpr double unit_sin_d(int r, int m) {
  switch (r * 16 + m) {
    case 3 * 16 + 1: return 0.86602540378443865;
    case 5 * 16 + 1: return 0.95105651629515353;
    case 5 * 16 + 2: return 0.58778525229247325;
    case 7 * 16 + 1: return 0.7818314824680298;
    case 7 * 16 + 2: return 0.97492791218182362;
    case 7 * 16 + 3: return 0.43388373911755823;
    case 11 * 16 + 1: return 0.54064081745559756;
    case 11 * 16 + 2: return 0.90963199535451833;
    case 11 * 16 + 3: return 0.9898214418809328;
    case 11 * 16 + 4: return 0.75574957435425827;
    default: return 0.28173255684142967;  // 11, 5
  }
}

template <>
struct Coef<float2> {
  using Real = float;
  static __device__ __forceinline__ float2 make(float x, float y) { return make_float2(x, y); }
  __host__ __device__ static constexpr float cos16(int m) { return ::cos16(m); }
  __host__ __device__ static constexpr float sin16(int m) { return ::sin16(m); }
  __host__ __device__ static constexpr float cos_rm(int r, int m) { return ::cos_rm(r, m); }
  __host__ __device__ static constexpr float sin_rm(int r, int m) { return ::sin_rm(r, m); }
};

template <>
struct Coef<double2> {
  using Real = double;
  static __device__ __forceinline__ double2 make(double x, double y) {
    return make_double2(x, y);
  }
  __host__ __device__ static constexpr double cos16(int m) { return cos16_d(m); }
  __host__ __device__ static constexpr double sin16(int m) { return sin16_d(m); }
  __host__ __device__ static constexpr double cos_rm(int r, int m) {
    return unit_cos_d(r, 2 * m < r ? m : r - m);
  }
  __host__ __device__ static constexpr double sin_rm(int r, int m) {
    return 2 * m < r ? unit_sin_d(r, m) : -unit_sin_d(r, r - m);
  }
};

// R-point DFT of v in registers, R an odd prime: with a_n = v_n + v_{R-n}
// and b_n = v_n - v_{R-n}, X_k = v_0 + sum a_n cos(2 pi nk/R) -+ i sum b_n
// sin(2 pi nk/R), X_{R-k} with the other sign. Template recursion over k
// and n keeps every coefficient a compile-time constant.
template <int R, int K, int N, class C>
__device__ __forceinline__ void odd_sums(const C (&a)[(R + 1) / 2], const C (&b)[(R + 1) / 2],
                                         C& ac, C& bs) {
  if constexpr (2 * N < R) {
    using T = typename Coef<C>::Real;
    constexpr T c = Coef<C>::cos_rm(R, (N * K) % R), s = Coef<C>::sin_rm(R, (N * K) % R);
    ac = Coef<C>::make(ac.x + a[N].x * c, ac.y + a[N].y * c);
    bs = Coef<C>::make(bs.x + b[N].x * s, bs.y + b[N].y * s);
    odd_sums<R, K, N + 1>(a, b, ac, bs);
  }
}

template <int R, bool kInv, int K, class C>
__device__ __forceinline__ void odd_outputs(const C& v0, const C (&a)[(R + 1) / 2],
                                            const C (&b)[(R + 1) / 2], C (&out)[R]) {
  if constexpr (2 * K < R) {
    C ac = v0, bs = Coef<C>::make(0, 0);
    odd_sums<R, K, 1>(a, b, ac, bs);
    // forward: X_k = ac - i bs, X_{R-k} = ac + i bs; the inverse swaps them
    const C minus = Coef<C>::make(ac.x + bs.y, ac.y - bs.x);
    const C plus = Coef<C>::make(ac.x - bs.y, ac.y + bs.x);
    out[K] = kInv ? plus : minus;
    out[R - K] = kInv ? minus : plus;
    odd_outputs<R, kInv, K + 1>(v0, a, b, out);
  }
}

template <int R, bool kInv, class C>
__device__ __forceinline__ void dft_odd(C (&v)[R]) {
  constexpr int H = (R - 1) / 2;
  C a[H + 1], b[H + 1];
  C sum = v[0];
#pragma unroll
  for (int n = 1; n <= H; ++n) {
    a[n] = Coef<C>::make(v[n].x + v[R - n].x, v[n].y + v[R - n].y);
    b[n] = Coef<C>::make(v[n].x - v[R - n].x, v[n].y - v[R - n].y);
    sum = Coef<C>::make(sum.x + a[n].x, sum.y + a[n].y);
  }
  C out[R];
  out[0] = sum;
  odd_outputs<R, kInv, 1>(v[0], a, b, out);
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = out[i];
}

template <int R, bool kInv, class C>
__device__ __forceinline__ void dft(C (&v)[R]) {
  if constexpr ((R & (R - 1)) == 0) {
    dft_pow2<R, kInv>(v);
  } else {
    dft_odd<R, kInv>(v);
  }
}

// Point e of line l of a tile in shared memory. Every pass reads its points
// through a source's ld(l, e) and writes them through a destination's
// st(l, e, v): a tile in shared memory, or (first and last pass) the
// kernel's lines in device memory.
template <class C>
struct SmemTile {
  C* p;
  Tile t;
  __device__ __forceinline__ C ld(int l, int e) const { return p[tile_at(t, l, e)]; }
  __device__ __forceinline__ void st(int l, int e, C v) const { p[tile_at(t, l, e)] = v; }
};

using SmemLines = SmemTile<float2>;

// Points e + q step (q < R) of line l: through the source's ld or the
// destination's st point by point, or in a shared-memory tile, where the
// step spans whole groups of 16 elements, as one add a point (pad() is
// then linear in q).
template <int R, class Src, class C>
__device__ __forceinline__ void load_run(const Src& src, int l, int e, int step, C (&v)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) v[q] = src.ld(l, e + q * step);
}

template <int R, class Dst, class C>
__device__ __forceinline__ void store_run(const Dst& dst, int l, int e, int step,
                                          const C (&v)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) dst.st(l, e + q * step, v[q]);
}

__device__ __forceinline__ int tile_step(const Tile& t, int step) {
  return t.log2lines >= 0 ? step << t.log2lines : step;
}

template <int R, class C>
__device__ __forceinline__ void load_run(const SmemTile<C>& src, int l, int e, int step,
                                         C (&v)[R]) {
  const int s = tile_step(src.t, step);
  if ((s & 15) == 0) {
    const C* base = src.p + tile_at(src.t, l, e);
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = base[q * (s + (s >> 4))];
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = src.ld(l, e + q * step);
  }
}

template <int R, class C>
__device__ __forceinline__ void store_run(const SmemTile<C>& dst, int l, int e, int step,
                                          const C (&v)[R]) {
  const int s = tile_step(dst.t, step);
  if ((s & 15) == 0) {
    C* base = dst.p + tile_at(dst.t, l, e);
#pragma unroll
    for (int q = 0; q < R; ++q) base[q * (s + (s >> 4))] = v[q];
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q) dst.st(l, e + q * step, v[q]);
  }
}

// i / d and i % d, by a shift and a mask when d is a power of two (every
// pass of a power-of-two line).
__device__ __forceinline__ int div_by(int i, int d) {
  return (d & (d - 1)) == 0 ? i >> (__ffs(d) - 1) : i / d;
}

__device__ __forceinline__ int mod_by(int i, int d) {
  return (d & (d - 1)) == 0 ? i & (d - 1) : i % d;
}

// Line l and butterfly (or point) j of work item i of a tile.
__device__ __forceinline__ void line_item(const Tile& t, int per_line, int i, int& l, int& j) {
  if (t.log2lines >= 0) {
    l = i & ((1 << t.log2lines) - 1);
    j = i >> t.log2lines;
  } else {
    l = div_by(i, per_line);
    j = i - l * per_line;
  }
}

// One Stockham pass of radix R over every line of the tile, src to dst.
template <int R, bool kInv, class Src, class Dst, class C>
__device__ void radix_pass(Src src, Dst dst, const Tile t, int ns, const C* __restrict__ tw) {
  const int nr = t.n / R;
  const int total = t.lines * nr;
  const C* w = tw + ns - 1;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int l, j;
    line_item(t, nr, i, l, j);
    C v[R];
    load_run<R>(src, l, j, nr, v);
    const int k = mod_by(j, ns);
    if (ns > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q) v[q] = cmul(v[q], conj_if(w[(q - 1) * ns + k], kInv));
    }
    dft<R, kInv>(v);
    store_run<R>(dst, l, (j - k) * R + k, ns, v);
  }
}

template <bool kInv, class Src, class Dst, class C>
__device__ void radix_pass_r(int r, Src src, Dst dst, const Tile t, int ns, const C* tw) {
  switch (r) {
    case 2: radix_pass<2, kInv>(src, dst, t, ns, tw); break;
    case 3: radix_pass<3, kInv>(src, dst, t, ns, tw); break;
    case 4: radix_pass<4, kInv>(src, dst, t, ns, tw); break;
    case 5: radix_pass<5, kInv>(src, dst, t, ns, tw); break;
    case 7: radix_pass<7, kInv>(src, dst, t, ns, tw); break;
    case 8: radix_pass<8, kInv>(src, dst, t, ns, tw); break;
    case 11: radix_pass<11, kInv>(src, dst, t, ns, tw); break;
    default: radix_pass<16, kInv>(src, dst, t, ns, tw); break;
  }
}

// The plan's first `passes` passes (at least one) over a tile: the first
// reads src (device memory, or a shared buffer other than a), the others
// alternate between the shared buffers a and b, one barrier each. Returns
// the buffer holding the result and sets ns to the points it combines.
template <bool kInv, class Src, class C>
__device__ C* radix_head(Src src, C* a, C* b, const Tile t, const RadixPlan pl, int passes,
                         const C* tw, int& ns) {
  radix_pass_r<kInv>(pl.radix(0), src, SmemTile<C>{a, t}, t, 1, tw);
  __syncthreads();
  ns = pl.radix(0);
  for (int p = 1; p < passes; ++p) {
    radix_pass_r<kInv>(pl.radix(p), SmemTile<C>{a, t}, SmemTile<C>{b, t}, t, ns, tw);
    __syncthreads();
    ns *= pl.radix(p);
    C* s = a;
    a = b;
    b = s;
  }
  return a;
}

// The plan's passes over a tile, src to dst: radix_head, then the last
// pass writes dst (device memory). A one-pass plan goes through a and a
// copy, so that dst may be src. The caller synchronizes before it reuses
// a or b.
template <bool kInv, class Src, class Dst, class C>
__device__ void radix_run(Src src, Dst dst, C* a, C* b, const Tile t, const RadixPlan pl,
                          const C* tw) {
  int ns;
  if (pl.passes == 1) {
    const SmemTile<C> from{radix_head<kInv>(src, a, b, t, pl, 1, tw, ns), t};
    for (int i = threadIdx.x; i < t.lines * t.n; i += blockDim.x) {
      int l, e;
      line_item(t, t.n, i, l, e);
      dst.st(l, e, from.ld(l, e));
    }
    return;
  }
  C* cur = radix_head<kInv>(src, a, b, t, pl, pl.passes - 1, tw, ns);
  radix_pass_r<kInv>(pl.radix(pl.passes - 1), SmemTile<C>{cur, t}, dst, t, ns, tw);
}

}  // namespace
