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
// frame once: a (118, 1338, 636) float32 frame is 402 MB each way, 0.24 ms.
// About 30 float32 operations per voxel are far under the card's rate.
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
// reduces it; I never stores dv. t is promoted to double, and the
// derivative band, the products and the sums are double: float32 sums over
// the ~1e8 terms of a frame round each add at ~6e-8 of the running sum and
// drift by ~1e-4 of the result, where I is held to 1e-6 of it. Bound: bytes
// (reads src and ybar once).
//
// H and I's design: one staged tile walk. r = 0 or 1: a tile is P
// consecutive p along r by L lanes of the frame's contiguous axis p2 (H 16
// by 128, I 32 by 64), at one (b, s), s the index on the axis that is
// neither r nor 2; a block (b, s, p tile) walks the lane tiles of its p
// tile. r = 2: a unit is up to kRow = 1024 p of one frame row; a block (b,
// p0, kRows = 8 rows of p1) walks its rows' units, four a tile. Each rounded
// float32 operation of pass_coord is monotone in each index, so the clamped
// floors at a tile's corners bound every tap: the window along r is
// [floor(c_lo) + kmin, floor(c_hi) + kmax] clamped to the frame
// (pass_window; r = 2: one contiguous run of the row). While a block
// computes one tile it stages the next tile's windows with cp.async (runs
// of 256 or 512 bytes along p2, or the row's run, in 16-, 8- or 4-byte
// pieces as the frame's width allows), two stages deep, and I stages the
// matching ybar tile with them; each thread then computes its outputs from
// shared memory (a warp along 32 lanes of a row, or a quarter of the block
// along a row unit), so stores stay coalesced along p2 and every source row
// is read from device memory about once per tile and not once per tap. A
// tile whose window exceeds its stage (|cr| large against the tile, a large
// shear across the lanes, coordinates that are not finite) reads its taps
// from device memory instead, in the same kernel. Both routes compute each
// sample with the same device functions in the same operand order, so an
// output's bits do not depend on the route or the tile (H equals the plain
// version bit for bit; an identity pass copies the frame), and I's
// per-sample products neither. I's thread keeps
// its three sums over the block's whole run of tiles; the block reduces
// them in a fixed order and writes one partial triple; one torch sum over
// the blocks of a volume gives the result, the same bits run to run.
// kernels/multipass_cuda.py mirrors the window and the walk (tests hold
// that the window contains every tap and that the walk covers the frame
// once).
//
// J: dbar[p] = sum over in-domain q of w_k(c_q) * ybar[q] where
// clamp(floor(c_q) + k) == p, a deterministic gather (no atomics): each
// output p sums, in ascending q and then k, __fadd_rn(acc, __fmul_rn(w,
// ybar[q])). The q whose taps reach p have c in [p - kmax - 1, p - kmin + 1]
// (taps clamped at the frame edge fold into p = 0 or size_r - 1 and come
// only from c in [0, 1 - kmin) or [size_r - 1 - kmax, size_r - 1], inside
// that span). Bound: bytes (reads ybar once, writes dbar once).
// J's design. A tile is P = 32 consecutive p along r by 32 lanes of the
// contiguous axis p2 (r = 0 or 1), or 1024 p of one frame row (r = 2). A
// block walks a run of tiles (the lane tiles of one p tile; 8 rows), and
// stages the next tile's ybar over its q range with cp.async (coalesced
// runs) while it computes this one. The q range is solved once a tile, in
// double, from the span above at the tile's ends (and at the lanes' ends,
// when the shear's other axis is p2), widened by one q. Each q's (floor,
// in-domain, band weights) is computed once into a shared-memory table:
// one entry per (q, lane) when o = 2 and r < 2, rebuilt each tile; else
// one per q, built once for the block's run when the run shares it. The
// floors are monotone in q, so the q whose taps reach p are contiguous:
// each thread starts at its p's window (the span solved in float32 with
// 1/cr, widened by one q), skips to the first such q and stops after the
// last, and adds each in-domain q's taps that land on p in ascending k
// (one inside the axis; the clamped edge taps fold several onto p = 0 or
// size_r - 1), with __fadd_rn(acc, __fmul_rn(w, ybar)). The terms and
// their order are those of the per-voxel form below (adjoint_direct: each
// p's window solved in double, every coordinate recomputed), which J was
// before it took tiles, so the two give the same bits. A
// tile whose q range exceeds its stage (|cr| small against the tile, cr =
// 0, coordinates that are not finite) is computed with that per-voxel code
// instead, with its double window and direct loads.
// kernels/multipass_cuda.py mirrors both windows (a test holds that they
// contain every q that reaches the tile).
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

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

// H's sample: the band's resample at t from the clamped taps, tap(i) the
// source at row i along r, added in ascending k.
template <int kOrder, class Tap>
__device__ __forceinline__ float band_value(float t, int i0, int size_r, const Tap& tap) {
  if (kOrder == 1) {
    const float w0 = __fsub_rn(1.f, t);
    const float acc = __fmul_rn(w0, tap(clampi(i0, size_r)));
    return __fadd_rn(acc, __fmul_rn(t, tap(clampi(i0 + 1, size_r))));
  }
  float wk[4];
  band_weights(t, 3, wk);
  float acc = __fmul_rn(wk[0], tap(clampi(i0 - 1, size_r)));
  acc = __fadd_rn(acc, __fmul_rn(wk[1], tap(clampi(i0, size_r))));
  acc = __fadd_rn(acc, __fmul_rn(wk[2], tap(clampi(i0 + 1, size_r))));
  return __fadd_rn(acc, __fmul_rn(wk[3], tap(clampi(i0 + 2, size_r))));
}

// I's sample: the band-derivative resample at t, in double.
template <int kOrder, class Tap>
__device__ __forceinline__ double band_derivative(float t, int i0, int size_r, const Tap& tap) {
  if (kOrder == 1) {  // weights (-1, 1): v1 - v0, exact in double
    const double v0 = tap(clampi(i0, size_r));
    const double v1 = tap(clampi(i0 + 1, size_r));
    return __dsub_rn(v1, v0);
  }
  const double td = t;
  const double t2 = __dmul_rn(td, td);
  const double dw[4] = {
      __dsub_rn(__dadd_rn(__dmul_rn(-1.5, t2), __dmul_rn(2.0, td)), 0.5),
      __dsub_rn(__dmul_rn(4.5, t2), __dmul_rn(5.0, td)),
      __dadd_rn(__dadd_rn(__dmul_rn(-4.5, t2), __dmul_rn(4.0, td)), 0.5),
      __dsub_rn(__dmul_rn(1.5, t2), __dmul_rn(1.0, td)),
  };
  double dv = __dmul_rn(dw[0], static_cast<double>(tap(clampi(i0 - 1, size_r))));
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const double v = tap(clampi(i0 + k - 1, size_r));
    dv = __dadd_rn(dv, __dmul_rn(dw[k], v));
  }
  return dv;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// H and I's tiles and stages (see the design above): 8 warps; r < 2: P p
// by L lanes (H 16 by 128, I 32 by 64), a stage of P + 32 window rows (|cr|
// up to ~2 at small shears); r = 2: units of up to kRow p of a row, a block
// walking kRows rows, RowUnits units a tile (H 4, I 4), a stage of kMaxRun
// floats of each unit's row. kStages stages: one tile in flight while one is
// computed. Found on the H100 against other tile sizes, stages and units
// (PERF.md): wide lane tiles (runs of 256 or 512 bytes) and several row units
// a tile, so that each barrier covers ~2K outputs, mattered; a third stage
// did not.
constexpr int kHThreads = 256, kHWarps = kHThreads / 32;
constexpr int kRow = 1024, kRows = 8;
constexpr int kMaxRun = kRow + 64, kRunPitch = kMaxRun + 8;
constexpr int kStages = 2;
template <bool kDeriv>
struct Tiles {
  static constexpr int P = kDeriv ? 32 : 16, L = kDeriv ? 64 : 128;
  static constexpr int MaxRows = P + 32;
  static constexpr int RowUnits = 4;
};

// The rows [lo, hi] along r that the clamped taps of a tile reach, and
// whether the tile stages them.
struct Window {
  int lo, hi;
  bool ok;
};

// The window of the outputs p in [p_lo, p_hi] whose shear index lies in
// [o_lo, o_hi]: pass_coord's rounded operations are monotone in each index,
// so tap_floor at the four corners bounds every output's floor. Staged when
// the corners' coordinates are finite (then every one between is) and the
// window holds at most max_rows rows.
template <int kOrder>
__device__ __forceinline__ Window pass_window(float cr, float co, float tau, bool shear,
                                              int o_lo, int o_hi, int p_lo, int p_hi,
                                              int size_r, int max_rows) {
  constexpr int kmin = kOrder == 1 ? 0 : -1, kmax = kOrder == 1 ? 1 : 2;
  int fmin = size_r + 1, fmax = -3;
  bool finite = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float c = pass_coord(cr, co, tau, e & 1 ? p_hi : p_lo, e & 2 ? o_hi : o_lo, shear);
    finite = finite && isfinite(c);
    float t;
    const int f = tap_floor(c, size_r, &t);
    fmin = min(fmin, f);
    fmax = max(fmax, f);
  }
  Window w{clampi(fmin + kmin, size_r), clampi(fmax + kmax, size_r), false};
  w.ok = finite && w.hi - w.lo + 1 <= max_rows;
  return w;
}

// One pass's operands: the frame (B, F0, F1, F2), its input src, H's output
// dst, I's cotangent ybar, and the coefficients of volume b.
struct Pass {
  const float* __restrict__ src;
  const float* __restrict__ ybar;
  float* __restrict__ dst;
  float cr, co, tau, fill;
  int F0, F1, F2, r, o;
  int vec;  // floats a staged copy moves: 4, 2 or 1 (F2 and the frames' alignment)
};

// One staged copy of vec floats (valid false: zeros).
__device__ __forceinline__ void copy_piece(float* dst, const float* src, int vec, bool valid) {
  if (vec == 4) {
    cp_async16(dst, src, valid);
  } else if (vec == 2) {
    cp_async8(dst, src, valid);
  } else {
    cp_async4(dst, src, valid);
  }
}

// I's running sums: ybar*dv times i_r, times i_o, and alone.
struct Sums {
  double r = 0.0, o = 0.0, one = 0.0;
  __device__ __forceinline__ void add(double g, int i_r, int i_o, bool shear) {
    r = __dadd_rn(r, __dmul_rn(g, static_cast<double>(i_r)));
    if (shear) o = __dadd_rn(o, __dmul_rn(g, static_cast<double>(i_o)));
    one = __dadd_rn(one, g);
  }
};

// One output at p (shear index i_o) whose taps tap() reads: H stores its
// value (or the fill) at dst[at] and returns 0; I returns ybar*dv (y: ybar
// at p), 0 outside the domain.
template <int kOrder, bool kDeriv, class Tap>
__device__ __forceinline__ double sample(const Pass& ps, int size_r, bool shear, int p, int i_o,
                                         long long at, const Tap& tap, float y) {
  const float c = pass_coord(ps.cr, ps.co, ps.tau, p, i_o, shear);
  const bool inside = c >= 0.f && c <= static_cast<float>(size_r - 1);
  float t;
  const int i0 = tap_floor(c, size_r, &t);
  if (kDeriv) {
    if (!inside) return 0.0;  // H wrote the fill: no derivative
    return __dmul_rn(static_cast<double>(y), band_derivative<kOrder>(t, i0, size_r, tap));
  }
  ps.dst[at] = inside ? band_value<kOrder>(t, i0, size_r, tap) : ps.fill;
  return 0.0;
}

// r = 0 or 1: block (b, s, p tile pt) walks the lane tiles. win: kStages
// stages of kMaxRows x kL floats; ys (I): kStages of kP x kL.
template <int kOrder, bool kDeriv>
__device__ __forceinline__ void walk_lane_tiles(const Pass& ps, int b, int s, int pt, float* win,
                                                float* ys, Sums& acc) {
  using T = Tiles<kDeriv>;
  constexpr int kP = T::P, kL = T::L, kMaxRows = T::MaxRows;
  const int r = ps.r, F2 = ps.F2;
  const int size_r = r == 0 ? ps.F0 : ps.F1;
  const long long stride_r = r == 0 ? static_cast<long long>(ps.F1) * F2 : F2;
  const long long stride_s = r == 0 ? F2 : static_cast<long long>(ps.F1) * F2;
  const long long base = static_cast<long long>(b) * ps.F0 * ps.F1 * F2 + s * stride_s;
  const bool shear = ps.o != r, lane_o = shear && ps.o == 2;
  const int n_lt = (F2 + kL - 1) / kL;
  const int p_lo = pt * kP, p_hi = min(p_lo + kP, size_r) - 1;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;

  // The lane tile's window (the same for every lane tile unless lane_o).
  auto window = [&](int lt) {
    const int l0 = lt * kL, l1 = min(l0 + kL, F2) - 1;
    return pass_window<kOrder>(ps.cr, ps.co, ps.tau, shear, lane_o ? l0 : s, lane_o ? l1 : s,
                               p_lo, p_hi, size_r, kMaxRows);
  };
  const Window fixed = window(0);
  auto issue = [&](int lt) {
    const Window w = lane_o ? window(lt) : fixed;
    const int stage = lt % kStages;
    const int l0 = lt * kL;
    // n rows of kL lanes from row `first` along r, in pieces of vec floats.
    auto rows = [&](float* to, const float* from, int first, int n) {
      const int shift = __ffs(kL / ps.vec) - 1;
      for (int e = threadIdx.x; e < n << shift; e += kHThreads) {
        const int row = e >> shift, col = (e & ((1 << shift) - 1)) * ps.vec;
        const bool ok = l0 + col < F2;
        copy_piece(to + row * kL + col, ok ? from + base + (first + row) * stride_r + l0 + col : from,
                   ps.vec, ok);
      }
    };
    if (w.ok) rows(win + stage * kMaxRows * kL, ps.src, w.lo, w.hi - w.lo + 1);
    if (kDeriv) rows(ys + stage * kP * kL, ps.ybar, p_lo, p_hi - p_lo + 1);
  };

  for (int lt = 0; lt < kStages - 1; ++lt) {
    if (lt < n_lt) issue(lt);
    cp_async_commit();
  }
  for (int lt = 0; lt < n_lt; ++lt) {
    if (lt + kStages - 1 < n_lt) issue(lt + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Window cur = lane_o ? window(lt) : fixed;
#pragma unroll
    for (int j = 0; j < kL / 32; ++j) {
      const int p2 = lt * kL + lane + 32 * j;
      if (p2 >= F2) break;
      const int i_o = ps.o == 2 ? p2 : s;
      const float* w = win + (lt % kStages) * kMaxRows * kL + lane + 32 * j;
      const float* y = ys + (lt % kStages) * kP * kL + lane + 32 * j;
      const long long col = base + p2;
#pragma unroll
      for (int i = 0; i < kP / kHWarps; ++i) {
        const int p = p_lo + g + kHWarps * i;
        if (p > p_hi) break;
        const float yp = kDeriv ? y[(p - p_lo) * kL] : 0.f;
        const double gp =
            cur.ok ? sample<kOrder, kDeriv>(ps, size_r, shear, p, i_o, col + p * stride_r,
                                            [&](int q) { return w[(q - cur.lo) * kL]; }, yp)
                   : sample<kOrder, kDeriv>(ps, size_r, shear, p, i_o, col + p * stride_r,
                                            [&](int q) { return __ldg(ps.src + col + q * stride_r); },
                                            yp);
        if (kDeriv) acc.add(gp, p, i_o, shear);
      }
    }
    __syncthreads();
  }
}

// r = 2: block (b, p0, row block rb) walks the units of kRows rows of p1 (a
// unit: up to kRow p of one row), kUnits units a tile, each computed by
// kHThreads / kUnits threads. win: kStages x kUnits runs of kRunPitch
// floats; ys (I): kStages x kUnits of kRow.
template <int kOrder, bool kDeriv>
__device__ __forceinline__ void walk_row_tiles(const Pass& ps, int b, int p0, int rb, float* win,
                                               float* ys, Sums& acc) {
  constexpr int kUnits = Tiles<kDeriv>::RowUnits, kGroup = kHThreads / kUnits;
  const int F2 = ps.F2;
  const int n_pt = (F2 + kRow - 1) / kRow;
  const int row0 = rb * kRows, n_units = (min(row0 + kRows, ps.F1) - row0) * n_pt;
  const int n_tiles = (n_units + kUnits - 1) / kUnits;
  const int unit = threadIdx.x / kGroup, gt = threadIdx.x % kGroup;
  const bool shear = ps.o != 2;
  auto p_lo_of = [&](int u) { return (u % n_pt) * kRow; };
  auto p_hi_of = [&](int u) { return min(p_lo_of(u) + kRow, F2) - 1; };
  auto i_o_of = [&](int u) { return ps.o == 0 ? p0 : row0 + u / n_pt; };
  auto line_of = [&](int u) {
    return ((static_cast<long long>(b) * ps.F0 + p0) * ps.F1 + row0 + u / n_pt) * F2;
  };
  auto window = [&](int u) {
    return pass_window<kOrder>(ps.cr, ps.co, ps.tau, shear, i_o_of(u), i_o_of(u), p_lo_of(u),
                               p_hi_of(u), F2, kMaxRun);
  };
  // A staged run starts at a multiple of vec floats (the window's start
  // rounded down) and holds whole pieces.
  auto run_start = [&](const Window& w) { return w.lo & -ps.vec; };
  // This thread's group stages its unit of tile t.
  auto issue = [&](int t) {
    const int u = t * kUnits + unit;
    if (u >= n_units) return;
    const Window w = window(u);
    const long long line = line_of(u);
    const int slot = (t % kStages) * kUnits + unit;
    if (w.ok) {
      const int a = run_start(w);
      for (int q = gt * ps.vec; q <= w.hi - a; q += kGroup * ps.vec)
        copy_piece(win + slot * kRunPitch + q, ps.src + line + a + q, ps.vec, true);
    }
    if (kDeriv) {
      const int p_lo = p_lo_of(u);
      for (int q = gt * ps.vec; q <= p_hi_of(u) - p_lo; q += kGroup * ps.vec)
        copy_piece(ys + slot * kRow + q, ps.ybar + line + p_lo + q, ps.vec, true);
    }
  };

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int u = t * kUnits + unit;
    if (u < n_units) {
      const Window cur = window(u);
      const long long line = line_of(u);
      const int p_lo = p_lo_of(u), p_hi = p_hi_of(u), i_o = i_o_of(u);
      const int slot = (t % kStages) * kUnits + unit;
      const float* w = win + slot * kRunPitch;
      const float* y = ys + slot * kRow;
      const int a = run_start(cur);
      for (int p = p_lo + gt; p <= p_hi; p += kGroup) {
        const float yp = kDeriv ? y[p - p_lo] : 0.f;
        const double gp =
            cur.ok ? sample<kOrder, kDeriv>(ps, F2, shear, p, i_o, line + p,
                                            [&](int q) { return w[q - a]; }, yp)
                   : sample<kOrder, kDeriv>(ps, F2, shear, p, i_o, line + p,
                                            [&](int q) { return __ldg(ps.src + line + q); }, yp);
        if (kDeriv) acc.add(gp, p, i_o, shear);
      }
    }
    __syncthreads();
  }
}

// Kernel arguments shared by H and I.
#define PASS_PARAMS                                                                        \
  const float *__restrict__ src, const float *__restrict__ ybar, float *__restrict__ dst, \
      const float *__restrict__ coeffs, int cstride, int slot, int F0, int F1, int F2, int r, \
      int o, float fill, int vec, int n_tiles, double *__restrict__ partials

__device__ __forceinline__ Pass make_pass(const float* src, const float* ybar, float* dst,
                                          const float* coeffs, int cstride, int slot, int b,
                                          int F0, int F1, int F2, int r, int o, float fill,
                                          int vec) {
  const float* cb = coeffs + static_cast<long long>(b) * cstride + 3 * slot;
  return Pass{src,  ybar, dst, __ldg(cb), __ldg(cb + 1), __ldg(cb + 2), fill, F0, F1, F2, r, o,
              vec};
}

// I's block total: the threads' sums reduced in a fixed order, one (3,)
// partial per block.
__device__ __forceinline__ void block_partials(Sums acc, double* partials) {
  __shared__ double part[3][kHWarps];
  acc.r = warp_sum(acc.r);
  acc.o = warp_sum(acc.o);
  acc.one = warp_sum(acc.one);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = acc.r;
    part[1][warp] = acc.o;
    part[2][warp] = acc.one;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double s = 0.0;
    for (int k = 0; k < kHWarps; ++k) s += part[threadIdx.x][k];
    partials[blockIdx.x * 3ll + threadIdx.x] = s;
  }
}

// r = 0 or 1: block (b, s, p tile), n_tiles p tiles along r.
// The floats of H's (kDeriv false) or I's shared memory: the window's
// stages, then I's ybar stages.
template <bool kDeriv>
__host__ __device__ constexpr int lane_smem_floats() {
  using T = Tiles<kDeriv>;
  return kStages * (T::MaxRows + (kDeriv ? T::P : 0)) * T::L;
}
template <bool kDeriv>
__host__ __device__ constexpr int row_smem_floats() {
  return kStages * Tiles<kDeriv>::RowUnits * (kRunPitch + (kDeriv ? kRow : 0));
}

template <int kOrder, bool kDeriv>
__device__ __forceinline__ void lane_tiles_block(PASS_PARAMS) {
  extern __shared__ float4 hsmem4[];
  float* win = reinterpret_cast<float*>(hsmem4);
  float* ys = win + kStages * Tiles<kDeriv>::MaxRows * Tiles<kDeriv>::L;
  const int n_s = r == 0 ? F1 : F0;
  long long blk = blockIdx.x;
  const int pt = static_cast<int>(blk % n_tiles);
  blk /= n_tiles;
  const int s = static_cast<int>(blk % n_s);
  const int b = static_cast<int>(blk / n_s);
  const Pass ps =
      make_pass(src, ybar, dst, coeffs, cstride, slot, b, F0, F1, F2, r, o, fill, vec);
  Sums acc;
  walk_lane_tiles<kOrder, kDeriv>(ps, b, s, pt, win, ys, acc);
  if (kDeriv) block_partials(acc, partials);
}

// r = 2: block (b, p0, row block), n_tiles row blocks along p1.
template <int kOrder, bool kDeriv>
__device__ __forceinline__ void row_tiles_block(PASS_PARAMS) {
  extern __shared__ float4 hsmem4[];
  float* win = reinterpret_cast<float*>(hsmem4);
  float* ys = win + kStages * Tiles<kDeriv>::RowUnits * kRunPitch;
  long long blk = blockIdx.x;
  const int rb = static_cast<int>(blk % n_tiles);
  blk /= n_tiles;
  const int p0 = static_cast<int>(blk % F0);
  const int b = static_cast<int>(blk / F0);
  const Pass ps =
      make_pass(src, ybar, dst, coeffs, cstride, slot, b, F0, F1, F2, r, o, fill, vec);
  Sums acc;
  walk_row_tiles<kOrder, kDeriv>(ps, b, p0, rb, win, ys, acc);
  if (kDeriv) block_partials(acc, partials);
}

template <int kOrder>
__global__ void __launch_bounds__(kHThreads) resample_pass_kernel(PASS_PARAMS) {
  lane_tiles_block<kOrder, false>(src, ybar, dst, coeffs, cstride, slot, F0, F1, F2, r, o, fill,
                                  vec, n_tiles, partials);
}

template <int kOrder>
__global__ void __launch_bounds__(kHThreads) resample_pass_row_kernel(PASS_PARAMS) {
  row_tiles_block<kOrder, false>(src, ybar, dst, coeffs, cstride, slot, F0, F1, F2, r, o, fill,
                                 vec, n_tiles, partials);
}

template <int kOrder>
__global__ void __launch_bounds__(kHThreads) resample_pass_deriv_kernel(PASS_PARAMS) {
  lane_tiles_block<kOrder, true>(src, ybar, dst, coeffs, cstride, slot, F0, F1, F2, r, o, fill,
                                 vec, n_tiles, partials);
}

template <int kOrder>
__global__ void __launch_bounds__(kHThreads) resample_pass_deriv_row_kernel(PASS_PARAMS) {
  row_tiles_block<kOrder, true>(src, ybar, dst, coeffs, cstride, slot, F0, F1, F2, r, o, fill,
                                vec, n_tiles, partials);
}

// The band's tap offsets k: kmin .. kmax.
__device__ __forceinline__ int band_lo(int order) { return order == 1 ? 0 : -1; }
__device__ __forceinline__ int band_hi(int order) { return order == 1 ? 1 : 2; }

// dbar at p along r of one line (ybar's line with q = 0 at `line`), in
// ascending q over the double window of the span, then k: J's per-voxel
// form, the route of a tile whose q range exceeds its stage.
__device__ float adjoint_direct(const float* __restrict__ line, long long stride_r, int p,
                                int i_o, float cr, float co, float tau, bool shear, int size_r,
                                int order) {
  const int kmin = band_lo(order), kmax = band_hi(order);
  const float hi = static_cast<float>(size_r - 1);
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
  return acc;
}

// J's tiles: kJP p by kJL lanes (r < 2, a block walks the lane tiles of
// its p tile), kJRow p of a row (r = 2, a block walks kJRows rows); the
// q range a row tile stages (r < 2: the host's max_q).
constexpr int kJThreads = 256, kJP = 32, kJL = 32, kJRow = 1024, kJRows = 8;
constexpr int kJMaxQRow = 1536;
// The keys a tile's bounds cover: its p, the band's reach and one more.
constexpr int kJNu = kJP + 5, kJNuRow = kJRow + 5;

// A tile's q range [q0, q1] (empty when q1 < q0), and whether it is solved
// and fits the tile's stage.
struct QRange {
  int q0, q1;
  bool ok;
};

// The q whose c lies in [p_lo - kmax - 1, p_hi - kmin + 1] for i_o in
// [o_lo, o_hi], solved in double with rcp = 1/cr at the ends, widened by one
// q, clipped to the axis; not ok when it cannot be solved (cr = 0, not
// finite) or exceeds max_q.
__device__ QRange tile_q_range(double rcp, float co, float tau, bool shear, int o_lo, int o_hi,
                               int p_lo, int p_hi, int order, int size_r, int max_q) {
  const int kmin = band_lo(order), kmax = band_hi(order);
  double lo = INFINITY, hi = -INFINITY;
  for (int e = 0; e < 2; ++e) {
    const int i_o = e ? o_hi : o_lo;
    const double base =
        shear ? __dadd_rn(static_cast<double>(tau),
                          __dmul_rn(static_cast<double>(co), static_cast<double>(i_o)))
              : static_cast<double>(tau);
    const double qa = __dmul_rn(__dsub_rn(static_cast<double>(p_lo - kmax - 1), base), rcp);
    const double qb = __dmul_rn(__dsub_rn(static_cast<double>(p_hi - kmin + 1), base), rcp);
    lo = fmin(lo, fmin(qa, qb));
    hi = fmax(hi, fmax(qa, qb));
  }
  QRange r{0, -1, false};
  if (!(isfinite(lo) && isfinite(hi))) return r;
  r.q0 = static_cast<int>(fmax(floor(lo) - 1.0, 0.0));
  r.q1 = static_cast<int>(fmin(ceil(hi) + 1.0, static_cast<double>(size_r - 1)));
  r.ok = r.q1 - r.q0 + 1 <= max_q;
  return r;
}

// The table entry of q: its clamped floor tap times 2, plus 1 when c is in
// the domain, and its band weights. The floors are monotone in q.
__device__ __forceinline__ void table_entry(float cr, float co, float tau, int q, int i_o,
                                            bool shear, int size_r, int order, int* packed,
                                            float4* w) {
  const float c = pass_coord(cr, co, tau, q, i_o, shear);
  float t;
  const int f = tap_floor(c, size_r, &t);
  float wk[4];
  band_weights(t, order, wk);
  *packed = 2 * f + ((c >= 0.f && c <= static_cast<float>(size_r - 1)) ? 1 : 0);
  *w = make_float4(wk[0], wk[1], wk[2], wk[3]);
}

// The keys: the floor i0 of each q, negated when cr < 0, rise with q. The
// q whose taps reach p are those with i0 in [p - kmax, p - kmin]: the keys
// in [ka(p), kb(p)). bounds[u - u0] is the first q of the tile whose key is
// at least u (q1 + 1 when none), for u in [u0, u0 + nu); with it p's q are
// [bounds[ka(p) - u0], bounds[kb(p) - u0]).
__device__ __forceinline__ int key_lo(bool up, int p, int kmin, int kmax) {
  return up ? p - kmax : kmin - p;
}
__device__ __forceinline__ int key_hi(bool up, int p, int kmin, int kmax) {
  return up ? p - kmin + 1 : kmax - p + 1;
}

// Fills bounds for one table column (entry of q at (q - q0) * tstride):
// entry e of 0 .. nq covers the keys above q0 + e - 1's and up to q0 + e's.
__device__ __forceinline__ void fill_bounds(const int* pk, int* bounds, int tstride, int q0,
                                            int nq, bool up, int u0, int nu, int e) {
  auto key = [&](int i) { return up ? pk[i * tstride] >> 1 : -(pk[i * tstride] >> 1); };
  const int lo = e == 0 ? u0 : max(key(e - 1) + 1, u0);
  const int hi = e == nq ? u0 + nu - 1 : min(key(e), u0 + nu - 1);
  for (int u = lo; u <= hi; ++u) bounds[(u - u0) * tstride] = q0 + e;
}

// dbar at p: its q in ascending order from the bounds, each in-domain one
// adding its taps that land on p in ascending k: one inside the axis (k =
// p - i0), several at its ends, where the clamped taps fold onto p.
template <int kOrder>
__device__ __forceinline__ float gather(const int* pk, const float4* ws, const float* ys,
                                        const int* bounds, int tstride, int ystride, int q0,
                                        bool up, int u0, int p, int size_r) {
  constexpr int kmin = kOrder == 1 ? 0 : -1, kmax = kOrder == 1 ? 1 : 2;
  const int qa = bounds[(key_lo(up, p, kmin, kmax) - u0) * tstride];
  const int qb = bounds[(key_hi(up, p, kmin, kmax) - u0) * tstride];
  const bool edge = p == 0 || p == size_r - 1;
  float acc = 0.f;
  for (int q = qa; q < qb; ++q) {
    const int e = (q - q0) * tstride;
    const int packed = pk[e];
    if (!(packed & 1)) continue;
    const int i0 = packed >> 1;
    const float yq = ys[(q - q0) * ystride];
    if (edge) {
      const float4 w4 = ws[e];
      const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int k = kmin; k <= kmax; ++k) {
        if (clampi(i0 + k, size_r) == p) acc = __fadd_rn(acc, __fmul_rn(wk[k + 1], yq));
      }
    } else {
      const float w = reinterpret_cast<const float*>(ws + e)[p - i0 + 1];
      acc = __fadd_rn(acc, __fmul_rn(w, yq));
    }
  }
  return acc;
}

// r = 0 or 1: one block per (b, s, p tile), s the frame index on the axis
// that is neither r nor 2; it walks the lane tiles along the frame's last
// axis, staging the next tile's ybar while it computes this one. The table
// has one entry per (q, lane) when o = 2 (rebuilt for each lane tile), else
// one per q (built once: the q range does not depend on the lanes). Shared
// memory: two ybar stages of max_q x 32, then the table's weights and
// floors.
template <int kOrder>
__global__ void __launch_bounds__(kJThreads)
resample_pass_adjoint_kernel(const float* __restrict__ ybar, float* __restrict__ dst,
                             const float* __restrict__ coeffs, int cstride, int slot, int F0,
                             int F1, int F2, int r, int o, int n_pt, int max_q) {
  extern __shared__ float4 jsmem[];
  const int size_r = r == 0 ? F0 : F1, n_s = r == 0 ? F1 : F0;
  long long blk = blockIdx.x;
  const int pt = static_cast<int>(blk % n_pt);
  blk /= n_pt;
  const int s = static_cast<int>(blk % n_s);
  const int b = static_cast<int>(blk / n_s);
  const float* cb = coeffs + static_cast<long long>(b) * cstride + 3 * slot;
  const float cr = __ldg(cb), co = __ldg(cb + 1), tau = __ldg(cb + 2);
  const bool shear = o != r, lane_o = shear && o == 2;
  static_assert(kJL == 32, "a lane tile is a warp");
  const int n_lt = (F2 + kJL - 1) / kJL, tcols = lane_o ? kJL : 1;
  const int p_lo = pt * kJP, p_hi = min(p_lo + kJP, size_r) - 1;
  const long long stride_r = r == 0 ? static_cast<long long>(F1) * F2 : F2;
  const long long stride_s = r == 0 ? F2 : static_cast<long long>(F1) * F2;
  const long long base_bs = static_cast<long long>(b) * F0 * F1 * F2 + s * stride_s;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  constexpr int kmin = kOrder == 1 ? 0 : -1, kmax = kOrder == 1 ? 1 : 2;
  const bool up = cr > 0.f;
  const int u0 = key_lo(up, up ? p_lo : p_hi, kmin, kmax);
  const int nu = p_hi - p_lo + kmax - kmin + 2;
  float4* ws = jsmem;
  int* pk = reinterpret_cast<int*>(ws + max_q * tcols);
  int* bounds = pk + max_q * tcols;
  float* ys = reinterpret_cast<float*>(bounds + kJNu * tcols);  // two stages

  const double rcp = __drcp_rn(static_cast<double>(cr));

  // The lane tile's q range (the same for every lane tile unless lane_o).
  auto range = [&](int lt) {
    const int l0 = lt * kJL, lw = min(kJL, F2 - l0);
    const int o_lo = lane_o ? l0 : s, o_hi = lane_o ? l0 + lw - 1 : s;
    return tile_q_range(rcp, co, tau, shear, o_lo, o_hi, p_lo, p_hi, kOrder, size_r, max_q);
  };
  auto issue = [&](int lt, const QRange& qr, float* y) {
    if (!qr.ok) return;
    const int l0 = lt * kJL;
    const bool ok = l0 + lane < F2;
    for (int q = g; q < qr.q1 - qr.q0 + 1; q += kJThreads / 32) {
      const float* src = ybar + base_bs + (qr.q0 + q) * stride_r + l0 + lane;
      cp_async4(y + q * kJL + lane, ok ? src : ybar, ok);
    }
  };
  // The table, then its bounds.
  auto build = [&](int lt, const QRange& qr) {
    if (!qr.ok) return;
    const int l0 = lt * kJL, nq = max(qr.q1 - qr.q0 + 1, 0);
    // Entry e: q = q0 + e / tcols, column e % tcols (tcols is 1 or 32).
    const int shift = lane_o ? 5 : 0, mask = tcols - 1;
    for (int e = threadIdx.x; e < nq * tcols; e += kJThreads) {
      const int i_o = lane_o ? min(l0 + (e & mask), F2 - 1) : s;
      table_entry(cr, co, tau, qr.q0 + (e >> shift), i_o, shear, size_r, kOrder, pk + e, ws + e);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < (nq + 1) * tcols; e += kJThreads) {
      const int col = e & mask;
      fill_bounds(pk + col, bounds + col, tcols, qr.q0, nq, up, u0, nu, e >> shift);
    }
  };

  QRange next = range(0);
  issue(0, next, ys);
  cp_async_commit();
  if (!lane_o) build(0, next);
  for (int lt = 0; lt < n_lt; ++lt) {
    const QRange cur = next;
    if (lt + 1 < n_lt) {
      if (lane_o) next = range(lt + 1);
      issue(lt + 1, next, ys + ((lt + 1) & 1) * max_q * kJL);
    }
    cp_async_commit();
    if (lane_o) build(lt, cur);
    cp_async_wait<1>();
    __syncthreads();
    const int l0 = lt * kJL;
    if (l0 + lane < F2) {
      const int i_o = lane_o ? l0 + lane : s;
      const float* y = ys + (lt & 1) * max_q * kJL + lane;
      const int col = lane_o ? lane : 0;
      for (int i = 0; i < kJP / 8; ++i) {
        const int p = p_lo + g + 8 * i;
        if (p > p_hi) continue;
        const long long at = base_bs + p * stride_r + l0 + lane;
        dst[at] = cur.ok ? gather<kOrder>(pk + col, ws + col, y, bounds + col, tcols, kJL,
                                          cur.q0, up, u0, p, size_r)
                         : adjoint_direct(ybar + at - p * stride_r, stride_r, p, i_o, cr, co,
                                          tau, shear, size_r, kOrder);
      }
    }
    __syncthreads();
  }
}

// r = 2: one block per (b, p0, kJRows rows of p1); it walks the rows and
// each row's tiles of kJRow p, staging the next tile's ybar while it
// computes this one. The table has one entry per q; it is rebuilt for each
// tile when o = 1 (the shear's index is the row's) or a row has more than
// one tile, else built once. Shared memory: the table's weights and floors
// (kJMaxQRow each), then two ybar stages.
template <int kOrder>
__global__ void __launch_bounds__(kJThreads)
resample_pass_adjoint_row_kernel(const float* __restrict__ ybar, float* __restrict__ dst,
                                 const float* __restrict__ coeffs, int cstride, int slot,
                                 int F0, int F1, int F2, int o, int n_rb) {
  extern __shared__ float4 jsmem[];
  long long blk = blockIdx.x;
  const int rb = static_cast<int>(blk % n_rb);
  blk /= n_rb;
  const int p0 = static_cast<int>(blk % F0);
  const int b = static_cast<int>(blk / F0);
  const float* cb = coeffs + static_cast<long long>(b) * cstride + 3 * slot;
  const float cr = __ldg(cb), co = __ldg(cb + 1), tau = __ldg(cb + 2);
  const bool shear = o != 2;
  const int n_pt = (F2 + kJRow - 1) / kJRow;
  const int row0 = rb * kJRows, n_tiles = (min(row0 + kJRows, F1) - row0) * n_pt;
  const bool rebuild = o == 1 || n_pt > 1;
  constexpr int kmin = kOrder == 1 ? 0 : -1, kmax = kOrder == 1 ? 1 : 2;
  const bool up = cr > 0.f;
  float4* ws = jsmem;
  int* pk = reinterpret_cast<int*>(ws + kJMaxQRow);
  int* bounds = pk + kJMaxQRow;
  float* ys = reinterpret_cast<float*>(bounds + kJNuRow);  // two stages
  // Tile t's p range and the first key of its bounds.
  auto p_range = [&](int t, int* p_lo, int* p_hi) {
    *p_lo = (t % n_pt) * kJRow;
    *p_hi = min(*p_lo + kJRow, F2) - 1;
  };
  auto key0 = [&](int t) {
    int p_lo, p_hi;
    p_range(t, &p_lo, &p_hi);
    return key_lo(up, up ? p_lo : p_hi, kmin, kmax);
  };

  const double rcp = __drcp_rn(static_cast<double>(cr));

  // Tile t: row p1 = row0 + t / n_pt, p from (t % n_pt) * kJRow.
  auto range = [&](int t) {
    int p_lo, p_hi;
    p_range(t, &p_lo, &p_hi);
    const int i_o = o == 0 ? p0 : row0 + t / n_pt;
    return tile_q_range(rcp, co, tau, shear, i_o, i_o, p_lo, p_hi, kOrder, F2, kJMaxQRow);
  };
  auto line_of = [&](int t) {
    return (static_cast<long long>(b) * F0 + p0) * F1 + row0 + t / n_pt;
  };
  auto issue = [&](int t, const QRange& qr, float* y) {
    if (!qr.ok) return;
    const float* line = ybar + line_of(t) * F2;
    for (int q = threadIdx.x; q < qr.q1 - qr.q0 + 1; q += kJThreads)
      cp_async4(y + q, line + qr.q0 + q);
  };
  // The table, then its bounds.
  auto build = [&](int t, const QRange& qr) {
    if (!qr.ok) return;
    const int i_o = o == 0 ? p0 : row0 + t / n_pt, nq = max(qr.q1 - qr.q0 + 1, 0);
    for (int q = threadIdx.x; q < nq; q += kJThreads)
      table_entry(cr, co, tau, qr.q0 + q, i_o, shear, F2, kOrder, pk + q, ws + q);
    __syncthreads();
    int p_lo, p_hi;
    p_range(t, &p_lo, &p_hi);
    for (int e = threadIdx.x; e <= nq; e += kJThreads)
      fill_bounds(pk, bounds, 1, qr.q0, nq, up, key0(t), p_hi - p_lo + kmax - kmin + 2, e);
  };

  QRange next = range(0);
  issue(0, next, ys);
  cp_async_commit();
  if (!rebuild) build(0, next);
  for (int t = 0; t < n_tiles; ++t) {
    const QRange cur = next;
    if (t + 1 < n_tiles) {
      if (rebuild) next = range(t + 1);
      issue(t + 1, next, ys + ((t + 1) & 1) * kJMaxQRow);
    }
    cp_async_commit();
    if (rebuild) build(t, cur);
    cp_async_wait<1>();
    __syncthreads();
    int p_lo, p_hi;
    p_range(t, &p_lo, &p_hi);
    const int i_o = o == 0 ? p0 : row0 + t / n_pt, u0 = key0(t);
    const long long row = line_of(t);
    const float* y = ys + (t & 1) * kJMaxQRow;
    for (int p = p_lo + static_cast<int>(threadIdx.x); p <= p_hi; p += kJThreads) {
      dst[row * F2 + p] =
          cur.ok ? gather<kOrder>(pk, ws, y, bounds, 1, 1, cur.q0, up, u0, p, F2)
                 : adjoint_direct(ybar + row * F2, 1, p, i_o, cr, co, tau, shear, F2, kOrder);
    }
    __syncthreads();
  }
}

// H's (kDeriv false) or I's grid: the blocks of one volume (r < 2: (s, p
// tile); r = 2: (p0, row block)), and the tiles along r or the row blocks
// along p1.
template <bool kDeriv>
void pass_grid(int F0, int F1, int F2, int r, long long* per_volume, int* n_tiles) {
  if (r == 2) {
    *n_tiles = (F1 + kRows - 1) / kRows;
    *per_volume = static_cast<long long>(F0) * *n_tiles;
  } else {
    const int size_r = r == 0 ? F0 : F1, n_s = r == 0 ? F1 : F0;
    *n_tiles = (size_r + Tiles<kDeriv>::P - 1) / Tiles<kDeriv>::P;
    *per_volume = static_cast<long long>(n_s) * *n_tiles;
  }
}

template <bool kDeriv>
int launch_pass(const void* src, const void* ybar, void* dst, const void* coeffs, int cstride,
                int slot, int B, int F0, int F1, int F2, int r, int o, int order, float fill,
                void* partials, long long n_partials, void* stream) {
  long long per_volume;
  int n_tiles;
  pass_grid<kDeriv>(F0, F1, F2, r, &per_volume, &n_tiles);
  const long long blocks = B * per_volume;
  if (blocks > 0x7fffffffll || (kDeriv && n_partials != blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  // Staged copies of 16 or 8 bytes where F2 and the frames allow them.
  auto aligned = [&](int bytes) {
    return F2 % (bytes / 4) == 0 && reinterpret_cast<unsigned long long>(src) % bytes == 0 &&
           reinterpret_cast<unsigned long long>(ybar) % bytes == 0;
  };
  const int vec = aligned(16) ? 4 : (aligned(8) ? 2 : 1);
  using Kernel = void (*)(const float*, const float*, float*, const float*, int, int, int, int,
                          int, int, int, float, int, int, double*);
  Kernel kernel;
  if (kDeriv) {
    kernel = r == 2 ? (order == 1 ? resample_pass_deriv_row_kernel<1>
                                  : resample_pass_deriv_row_kernel<3>)
                    : (order == 1 ? resample_pass_deriv_kernel<1> : resample_pass_deriv_kernel<3>);
  } else {
    kernel = r == 2 ? (order == 1 ? resample_pass_row_kernel<1> : resample_pass_row_kernel<3>)
                    : (order == 1 ? resample_pass_kernel<1> : resample_pass_kernel<3>);
  }
  const int smem = static_cast<int>(sizeof(float)) *
                   (r == 2 ? row_smem_floats<kDeriv>() : lane_smem_floats<kDeriv>());
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kHThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(ybar), static_cast<float*>(dst),
      static_cast<const float*>(coeffs), cstride, slot, F0, F1, F2, r, o, fill, vec, n_tiles,
      static_cast<double*>(partials));
  return static_cast<int>(cudaGetLastError());
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
  return launch_pass<false>(src, nullptr, dst, coeffs, cstride, slot, B, F0, F1, F2, r, o, order,
                            fill, nullptr, 0, stream);
}

// src, ybar: (B, F0, F1, F2) float32; partials: (B, n, 3) float64, n the
// blocks of one volume (pass_grid; kernels/multipass_cuda.py pass_blocks),
// a block's three sums each: the launch is refused when n_partials is not
// B * n. The rest as resample_pass.
int resample_pass_deriv(const void* src, const void* ybar, const void* coeffs, int cstride,
                        int slot, int B, int F0, int F1, int F2, int r, int o, int order,
                        void* partials, long long n_partials, void* stream) {
  return launch_pass<true>(src, ybar, nullptr, coeffs, cstride, slot, B, F0, F1, F2, r, o, order,
                           0.f, partials, n_partials, stream);
}

// ybar, dst: (B, F0, F1, F2) float32, distinct. The rest as resample_pass.
int resample_pass_adjoint(const void* ybar, void* dst, const void* coeffs, int cstride,
                          int slot, int B, int F0, int F1, int F2, int r, int o, int order,
                          void* stream) {
  const auto* y = static_cast<const float*>(ybar);
  auto* d = static_cast<float*>(dst);
  const auto* c = static_cast<const float*>(coeffs);
  const auto st = static_cast<cudaStream_t>(stream);
  if (r == 2) {
    const int n_rb = (F1 + kJRows - 1) / kJRows;
    const long long blocks = static_cast<long long>(B) * F0 * n_rb;
    const size_t smem =
        kJMaxQRow * (sizeof(float4) + sizeof(int) + 2 * sizeof(float)) + kJNuRow * sizeof(int);
    if (order == 1) {
      resample_pass_adjoint_row_kernel<1><<<static_cast<unsigned>(blocks), kJThreads, smem, st>>>(
          y, d, c, cstride, slot, F0, F1, F2, o, n_rb);
    } else {
      resample_pass_adjoint_row_kernel<3><<<static_cast<unsigned>(blocks), kJThreads, smem, st>>>(
          y, d, c, cstride, slot, F0, F1, F2, o, n_rb);
    }
  } else {
    const int size_r = r == 0 ? F0 : F1, n_s = r == 0 ? F1 : F0;
    const int n_pt = (size_r + kJP - 1) / kJP;
    const long long blocks = static_cast<long long>(B) * n_s * n_pt;
    // The q range a tile stages: 96 (|cr| down to about 0.5 at kJP = 32);
    // 48 with a table per (q, lane) (|cr| down to about 0.8), which keeps
    // the block's shared memory under 48 KB.
    const bool lane_o = o != r && o == 2;
    const int max_q = lane_o ? 48 : 96, tcols = lane_o ? kJL : 1;
    const size_t smem = max_q * (tcols * (sizeof(float4) + sizeof(int)) + 2 * kJL * sizeof(float)) +
                        kJNu * tcols * sizeof(int);
    auto kernel = order == 1 ? resample_pass_adjoint_kernel<1> : resample_pass_adjoint_kernel<3>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<static_cast<unsigned>(blocks), kJThreads, smem, st>>>(y, d, c, cstride, slot, F0, F1,
                                                                   F2, r, o, n_pt, max_q);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
