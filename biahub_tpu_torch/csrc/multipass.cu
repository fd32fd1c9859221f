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
// frame once: a (120, 1060, 520) float32 frame is 265 MB each way, 0.16 ms.
// About 30 float32 operations per voxel are far under the card's rate.
// Design: one block per frame row (b, p0, p1), threads along the row's
// contiguous axis p2, so stores are coalesced; for r = 0 or 1 the four taps
// of neighbouring threads are neighbouring addresses of four rows (|co| is
// small for the rotations stabilize and registration fit), for r = 2 they
// are a short contiguous run.
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
// reduces it; I never stores dv: t is promoted to double, the derivative
// band, the products and a block's sums are double (float32 over ~1e8
// terms would drift by ~1e-4), and each block writes its row's three
// partials; the wrapper sums them. Bound: bytes (reads src and ybar once).
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

constexpr int kThreads = 128;

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

struct Row {
  long long row;  // (b * F0 + p0) * F1 + p1
  int p0, p1, b;
};

__device__ __forceinline__ Row this_row(int F0, int F1) {
  Row w;
  w.row = blockIdx.x;
  w.p1 = static_cast<int>(w.row % F1);
  const long long bp0 = w.row / F1;
  w.p0 = static_cast<int>(bp0 % F0);
  w.b = static_cast<int>(bp0 / F0);
  return w;
}

__device__ __forceinline__ int axis_index(int axis, int p0, int p1, int p2) {
  return axis == 0 ? p0 : (axis == 1 ? p1 : p2);
}

__global__ void __launch_bounds__(kThreads)
resample_pass_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     const float* __restrict__ coeffs, int cstride, int slot, int F0,
                     int F1, int F2, int r, int o, int order, float fill) {
  const Row w = this_row(F0, F1);
  const float* cb = coeffs + static_cast<long long>(w.b) * cstride + 3 * slot;
  const float cr = __ldg(cb), co = __ldg(cb + 1), tau = __ldg(cb + 2);
  const int size_r = r == 0 ? F0 : (r == 1 ? F1 : F2);
  const long long stride_r = r == 0 ? static_cast<long long>(F1) * F2 : (r == 1 ? F2 : 1);
  const float hi = static_cast<float>(size_r - 1);
  float* out_row = dst + w.row * F2;
  for (int p2 = threadIdx.x; p2 < F2; p2 += kThreads) {
    const int i_r = axis_index(r, w.p0, w.p1, p2);
    const float c = pass_coord(cr, co, tau, i_r, axis_index(o, w.p0, w.p1, p2), o != r);
    float t;
    const int i0 = tap_floor(c, size_r, &t);
    // The voxel's row with p_r = 0; the taps are offsets along r from it.
    const float* base = src + (w.row * F2 + p2 - i_r * stride_r);
    float acc;
    if (order == 1) {
      const float w0 = __fsub_rn(1.f, t);
      acc = __fmul_rn(w0, __ldg(base + clampi(i0, size_r) * stride_r));
      acc = __fadd_rn(acc, __fmul_rn(t, __ldg(base + clampi(i0 + 1, size_r) * stride_r)));
    } else {
      float wk[4];
      band_weights(t, 3, wk);
      acc = __fmul_rn(wk[0], __ldg(base + clampi(i0 - 1, size_r) * stride_r));
      acc = __fadd_rn(acc, __fmul_rn(wk[1], __ldg(base + clampi(i0, size_r) * stride_r)));
      acc = __fadd_rn(acc, __fmul_rn(wk[2], __ldg(base + clampi(i0 + 1, size_r) * stride_r)));
      acc = __fadd_rn(acc, __fmul_rn(wk[3], __ldg(base + clampi(i0 + 2, size_r) * stride_r)));
    }
    out_row[p2] = (c >= 0.f && c <= hi) ? acc : fill;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
resample_pass_deriv_kernel(const float* __restrict__ src, const float* __restrict__ ybar,
                           const float* __restrict__ coeffs, int cstride, int slot, int F0,
                           int F1, int F2, int r, int o, int order,
                           double* __restrict__ partials) {
  const Row w = this_row(F0, F1);
  const float* cb = coeffs + static_cast<long long>(w.b) * cstride + 3 * slot;
  const float cr = __ldg(cb), co = __ldg(cb + 1), tau = __ldg(cb + 2);
  const int size_r = r == 0 ? F0 : (r == 1 ? F1 : F2);
  const long long stride_r = r == 0 ? static_cast<long long>(F1) * F2 : (r == 1 ? F2 : 1);
  const float hi = static_cast<float>(size_r - 1);
  const bool shear = o != r;
  double s_r = 0.0, s_o = 0.0, s_1 = 0.0;
  for (int p2 = threadIdx.x; p2 < F2; p2 += kThreads) {
    const int i_r = axis_index(r, w.p0, w.p1, p2);
    const int i_o = axis_index(o, w.p0, w.p1, p2);
    const float c = pass_coord(cr, co, tau, i_r, i_o, shear);
    if (!(c >= 0.f && c <= hi)) continue;  // H wrote the fill: no derivative
    float t;
    const int i0 = tap_floor(c, size_r, &t);
    const float* base = src + (w.row * F2 + p2 - i_r * stride_r);
    double dv;
    if (order == 1) {
      const double v0 = __ldg(base + clampi(i0, size_r) * stride_r);
      const double v1 = __ldg(base + clampi(i0 + 1, size_r) * stride_r);
      dv = __dadd_rn(__dmul_rn(-1.0, v0), __dmul_rn(1.0, v1));
    } else {
      const double td = t;
      const double t2 = __dmul_rn(td, td);
      const double dw[4] = {
          __dsub_rn(__dadd_rn(__dmul_rn(-1.5, t2), __dmul_rn(2.0, td)), 0.5),
          __dsub_rn(__dmul_rn(4.5, t2), __dmul_rn(5.0, td)),
          __dadd_rn(__dadd_rn(__dmul_rn(-4.5, t2), __dmul_rn(4.0, td)), 0.5),
          __dsub_rn(__dmul_rn(1.5, t2), __dmul_rn(1.0, td)),
      };
      dv = __dmul_rn(dw[0], static_cast<double>(__ldg(base + clampi(i0 - 1, size_r) * stride_r)));
      for (int k = 1; k < 4; ++k) {
        const double v = __ldg(base + clampi(i0 + k - 1, size_r) * stride_r);
        dv = __dadd_rn(dv, __dmul_rn(dw[k], v));
      }
    }
    const double g = __dmul_rn(static_cast<double>(__ldg(ybar + w.row * F2 + p2)), dv);
    s_r = __dadd_rn(s_r, __dmul_rn(g, static_cast<double>(i_r)));
    if (shear) s_o = __dadd_rn(s_o, __dmul_rn(g, static_cast<double>(i_o)));
    s_1 = __dadd_rn(s_1, g);
  }
  __shared__ double part[3][kThreads / 32];
  s_r = warp_sum(s_r);
  s_o = warp_sum(s_o);
  s_1 = warp_sum(s_1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = s_r;
    part[1][warp] = s_o;
    part[2][warp] = s_1;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double s = 0.0;
    for (int k = 0; k < kThreads / 32; ++k) s += part[threadIdx.x][k];
    partials[w.row * 3 + threadIdx.x] = s;
  }
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
  const long long rows = static_cast<long long>(B) * F0 * F1;
  resample_pass_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst),
      static_cast<const float*>(coeffs), cstride, slot, F0, F1, F2, r, o, order, fill);
  return static_cast<int>(cudaGetLastError());
}

// src, ybar: (B, F0, F1, F2) float32; partials: (B * F0 * F1, 3) float64,
// one row's three sums each. The rest as resample_pass.
int resample_pass_deriv(const void* src, const void* ybar, const void* coeffs, int cstride,
                        int slot, int B, int F0, int F1, int F2, int r, int o, int order,
                        void* partials, void* stream) {
  const long long rows = static_cast<long long>(B) * F0 * F1;
  resample_pass_deriv_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(ybar),
      static_cast<const float*>(coeffs), cstride, slot, F0, F1, F2, r, o, order,
      static_cast<double*>(partials));
  return static_cast<int>(cudaGetLastError());
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
