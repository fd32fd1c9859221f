// Spectral deconvolve + deskew on Hopper: kernel M, which emits the
// deskewed volume straight from the filtered spectrum, in two launches.
//
// Replaces pass C' of biahub_tpu/kernels/pallas_spectral.py, one kernel
// with two stores (as kernel D has):
//
//   M  lerp_contract_kernel, then lerp_irfft_kernel
//        <- _lerp_irfft_kernel (pallas_spectral.py:327, launched at :919):
//           the zyx store; _lerp_irfft_xzy_kernel (:434, launched at
//           :872): the (X', Z', Y') store the in-plane warp reads.
//
// Input: S, the (Z, Y, X/2+1) complex64 spectrum left by kernels A, K and L
// (fft.cu): DFT along Z times the filter, back along Y, the rfft half along
// X; and T, the (G*avg, X_out, Z) complex64 lerp-DFT table of
// kernels/spectral.py (prepare_spectral_deskew), with 1/(Z*avg) folded in.
//
// 1. lerp_contract_kernel: U[g, kx, x'] = sum_{j<avg} sum_kz T[z', x', kz]
//    S[kz, y, kx] over the group's tilt rows z' = g*avg + j, with y =
//    max(Y-1-z', 0): the reference's slab row j of its front-padded tilt
//    axis is tilt row y of the unpadded one (its padded rows replicate row
//    0, whose table rows are clamped to Z_out - 1: the edge-padded tail
//    group). Per group a complex (xh x avg*Z) by (avg*Z x X_out) product,
//    written to device memory as U, (G, xh, X_out) complex64, x' fastest.
// 2. lerp_irfft_kernel: the irfft of each x' column of U along kx (X
//    points, 1/X), two columns riding one complex inverse FFT as in kernel
//    C (the imaginary parts of kx = 0 and, for an even X, kx = X/2 ignored,
//    as irfft does: the reference's Nyquist peel is the last row), stored
//    as out[g, x, x'] (zyx: (G, X, X_out)) or out[x', g, x] (xzy: (X_out,
//    G, X)). Both stores write the same values: xzy is zyx transposed to
//    the bit.
//
// Bound (one H100 SXM: 3.35 TB/s; 495 Tflop/s TF32 on the tensor cores,
// 67 Tflop/s float32 outside them), at the headline 256x256x1024 volume
// with avg 3 (G 86, X_out 484): operations. The contraction is 258 tilt
// rows x 513 kx x 484 x' x 256 kz = 1.64e10 complex multiply-adds, 1.31e11
// float32 flop: 1.96 ms on the CUDA cores, 0.80 ms as three TF32 products
// for each of the four real ones (3.94e11 flop). Its bytes (the 269.0 MB
// spectrum, the 255.7 MB table, U's 170.9 MB out) take 0.21 ms; the irfft
// reads U and writes 85.2 MB, 0.08 ms, and does 5e9 flop.
//
// The contraction on the tensor cores, at float32 accuracy (3xTF32). A
// single TF32 product keeps 10 mantissa bits and cannot hold 2e-5 over a
// depth of avg*Z = 768 (1.7e-4 in tests/test_torch_spectral_tiles.py's
// model), so each float32 operand v is split into hi = v rounded to TF32
// (to nearest, ties away from zero: cvt.rna's value) and lo = v - hi (exact
// in float32) rounded to TF32; a real product is hi*hi + hi*lo + lo*hi,
// three TF32 products (each exact: 11 x 11 significand bits). What is
// dropped (lo*lo and lo's bits past TF32) is below 2^-21 of the product. A
// complex product is four real ones: Ur = Sr Tr + (-Si) Ti (the sign an
// immediate of the instruction) and Ui = Sr Ti + Si Tr, 12 products. The
// tensor cores' float32 sums truncate, so a sum chained over the whole
// depth drifts with it (1.7e-5 of max|U| at the headline, measured on an
// H100): each stage's products are a fresh sum (scale-d 0), added to the
// float32 sums in registers rounded to nearest (7e-7 of max|U| against
// float64, the plain float32 einsum 2.6e-6).
//
// Tiles: a block (256 threads, two warpgroups) owns 128 kx x 64 x' of one
// group, each warpgroup 64 kx: per 8 kz it issues wgmma.m64n64k8 with A in
// registers (S[kz, kx] as kx rows: each warp loads its 16 rows' fragments
// from shared memory and splits them) and B from shared memory (T's x'
// rows, K-major: its tile split once a stage by the whole block into four
// TF32 planes of 8 x 4 core matrices, no swizzle). The depth walks the
// group's avg tilt rows in stages of 16 kz: S's (16 kz x 128 kx) and T's (64
// x' x 16 kz) complex tiles, zero-filled past Z, X/2 and X_out, copied by
// cp.async three stages deep (rows padded to 132 and 20 elements: 8-byte
// loads hit 16 distinct bank pairs a half-warp). Registers: the two sums and
// the stage's two products, 128 float32 a thread, and the A fragments. The
// last row, kx = X/2 (for an even X, the Nyquist bin: a fifth 128-row tile
// of one row otherwise), is summed apart on the CUDA cores by the blocks of
// the first kx tile. On an H100 the chains alone take 1.25 ms at the
// headline (64% of the TF32 rate at this shape) and the staging about 0.8
// ms (3.2 GB from L2: S is read by each of the 8 x' tiles, T by each of the
// 4 kx tiles), and the two do not overlap: a producer warpgroup
// (spilling at its 168-register cap), planes of both operands double-
// buffered, clusters sharing S's tile through distributed shared memory,
// two blocks an SM and Karatsuba's three products were each as slow or
// slower (PERF.md).
//
// The irfft: a block takes tiles of `lines` column pairs of one group
// (column layout: neighbouring threads on neighbouring pairs, so a warp
// reads and writes runs of x' in both stores; the zyx store's rows take
// wider tiles, kernels/spectral_cuda.py irfft_plan), and runs fft_radix.cuh's
// mixed-radix passes as kernel C's rows do (1024 = 16 x 8 x 8): the first
// pass reads U through the Hermitian extension, the last stores the real
// and imaginary parts times 1/X. An X with a prime factor above 11 runs
// Bluestein's lines of fft_lines.cuh. Limits: X as kernels A and C take it
// (powers of two up to 8192, other lengths up to 4096); groups <= 65535.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "fft_lines.cuh"
#include "fft_radix.cuh"

namespace {

// -- 1. the contraction -----------------------------------------------------

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // kx a block: 64 a warpgroup
constexpr int kBN = 64;        // x' a block
constexpr int kBK = 16;        // kz a stage
constexpr int kStages = 3;
constexpr int kSS = kBM + 4;   // raw S tile row (kz) stride, float2
constexpr int kTS = kBK + 4;   // raw T tile row (x') stride, float2
constexpr int kRawElems = kBK * kSS + kBN * kTS + kBK;  // S, T, the last row's S
constexpr int kPlane = kBN * kBK;                        // floats of a B plane
constexpr int kPlanes = 4;  // T's real and imaginary parts, high and low

// v rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32's value, in two integer instructions.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32 (see the header).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// Float k of row n of a B plane: K-major 8 x 4 core matrices (128 bytes
// each), 4 along K (kz), 8 along N (x').
__device__ __forceinline__ int plane_at(int n, int k) {
  return ((n >> 3) * (kBK / 4) + (k >> 2)) * 32 + (n & 7) * 4 + (k & 3);
}

// Shared-memory descriptor of the 64 x 8 B tile from kz = 8 * k8 of a plane
// (no swizzle: the two core matrices along K 128 bytes apart, the 8 along
// N 512 bytes apart).
__device__ __forceinline__ uint64_t plane_desc(const float* plane, int k8) {
  const uint64_t addr = smem_addr(plane + k8 * 64);
  constexpr uint64_t lbo = 128, sbo = 128 * (kBK / 4);
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders the compiler's accesses to d after the last wait.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = kSign a b (scale_d 0) or d += kSign a b: one m64n64k8 TF32 product of
// the warpgroup, a in registers (each warp's 16 rows as mma.m16n8k8's A
// fragment), b the 64 x 8 K-major tile of `desc`, float32 out (each warp's
// 16 rows, mma.m16n8k8's C fragment for each 8 columns).
template <int kSign>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kSign));
}

// A real A operand split in two: its TF32 high and low parts.
struct SplitA {
  uint32_t hi[4], lo[4];
};

// d (+)= kSignD a bd and e (+)= kSignE a be: one A fragment against two
// B tiles, issued in turns.
template <int kSignD, int kSignE>
__device__ __forceinline__ void wgmma2(float (&d)[32], float (&e)[32], const uint32_t (&a)[4],
                                       uint64_t bd, uint64_t be, int scale_d) {
  wgmma_tf32<kSignD>(d, a, bd, scale_d);
  wgmma_tf32<kSignE>(e, a, be, scale_d);
}

__device__ __forceinline__ void cfma(float2& u, float2 s, float2 w) {
  u.x = fmaf(s.x, w.x, u.x);
  u.x = fmaf(-s.y, w.y, u.x);
  u.y = fmaf(s.x, w.y, u.y);
  u.y = fmaf(s.y, w.x, u.y);
}

// Block (m, n, g): U[g, m0 .. m0+127, n0 .. n0+63], and with m == 0 the
// last row U[g, X/2, n0 ..]. Rows past X/2 - 1 and columns past X_out are
// computed on zeros and not stored. Shared memory: the four B planes, then
// kStages raw stages.
__global__ void __launch_bounds__(kThreads, 1)
lerp_contract_kernel(const float2* __restrict__ spec, const float2* __restrict__ table,
                     float2* __restrict__ u, int Z, int Y, int X, int x_out, int avg) {
  extern __shared__ float4 smem4[];
  float* planes = reinterpret_cast<float*>(smem4);
  float2* raw = reinterpret_cast<float2*>(planes + kPlanes * kPlane);
  const int xh = X / 2 + 1, xm = xh - 1;  // kx < xm on the tensor cores, kx = xm apart
  const int g = blockIdx.z, m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const bool last_row = blockIdx.x == 0;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t zstride = static_cast<size_t>(Y) * xh;
  const int nk = (Z + kBK - 1) / kBK, nstages = avg * nk;

  // Copies of stage s (tilt row j, kz from k0) into raw buffer buf.
  auto issue = [&](int s, int buf) {
    const int j = s / nk, k0 = (s - j * nk) * kBK, zp = g * avg + j;
    const float2* srow = spec + static_cast<size_t>(max(Y - 1 - zp, 0)) * xh;
    const float2* trow = table + static_cast<size_t>(zp) * x_out * Z;
    float2* st = raw + buf * kRawElems;
#pragma unroll
    for (int i = 0; i < kBK * kBM / kThreads; ++i) {
      const int idx = t + i * kThreads, kk = idx / kBM, m = idx % kBM;
      const bool ok = k0 + kk < Z && m0 + m < xm;
      cp_async8(st + kk * kSS + m, ok ? srow + (k0 + kk) * zstride + m0 + m : spec, ok);
    }
    float2* tt = st + kBK * kSS;
#pragma unroll
    for (int i = 0; i < kBN * kBK / kThreads; ++i) {
      const int idx = t + i * kThreads, n = idx / kBK, kk = idx % kBK;
      const bool ok = k0 + kk < Z && n0 + n < x_out;
      cp_async8(tt + n * kTS + kk,
                ok ? trow + static_cast<size_t>(n0 + n) * Z + k0 + kk : table, ok);
    }
    if (last_row && t < kBK) {
      const bool ok = k0 + t < Z;
      cp_async8(tt + kBN * kTS + t, ok ? srow + (k0 + t) * zstride + xm : spec, ok);
    }
  };

  float ur[32], ui[32], pr[32], pi[32];  // the sums, and this stage's products
#pragma unroll
  for (int i = 0; i < 32; ++i) ur[i] = ui[i] = pr[i] = pi[i] = 0.f;
  // The last row's share: thread t sums column t % kBN over a quarter of
  // the stage's kz (t / kBN).
  float2 last = make_float2(0.f, 0.f);
  constexpr int kLastParts = kThreads / kBN;
  const int last_n = t % kBN, last_k = (t / kBN) * (kBK / kLastParts);
  const uint64_t desc_r_hi = plane_desc(planes, 0), desc_r_lo = plane_desc(planes + kPlane, 0);
  const uint64_t desc_i_hi = plane_desc(planes + 2 * kPlane, 0);
  const uint64_t desc_i_lo = plane_desc(planes + 3 * kPlane, 0);
  // This warp's 16 rows: kx = m0 + 16 * warp + gid (+8).
  const int arow = 16 * warp + gid;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) issue(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; every warpgroup is done with stage s - 1
    if (s + kStages - 1 < nstages) issue(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    const float2* ss = raw + (s % kStages) * kRawElems;
    const float2* tt = ss + kBK * kSS;
    // T's tile split into its four TF32 planes, K-major: a warp writes one
    // core matrix (8 x' x 4 kz, 32 consecutive floats) of each plane.
#pragma unroll
    for (int i = 0; i < kPlane / kThreads; ++i) {
      const int idx = t + i * kThreads, cm = idx >> 5;
      const int n = (cm / (kBK / 4)) * 8 + gid, kk = (cm % (kBK / 4)) * 4 + tig;
      const int at = plane_at(n, kk);
      const float2 v = tt[n * kTS + kk];
      uint32_t hi, lo;
      split_tf32(v.x, hi, lo);
      planes[at] = __uint_as_float(hi);
      planes[kPlane + at] = __uint_as_float(lo);
      split_tf32(v.y, hi, lo);
      planes[2 * kPlane + at] = __uint_as_float(hi);
      planes[3 * kPlane + at] = __uint_as_float(lo);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // A: S[kz, kx] at (m = arow (+8), k = 8 k8 + tig (+4)), split.
    SplitA ar[2], ai[2];
#pragma unroll
    for (int k8 = 0; k8 < 2; ++k8) {
      const float2* p = ss + (8 * k8 + tig) * kSS + arow;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = p[(i >> 1) * 4 * kSS + (i & 1) * 8];
        split_tf32(v.x, ar[k8].hi[i], ar[k8].lo[i]);
        split_tf32(v.y, ai[k8].hi[i], ai[k8].lo[i]);
      }
    }
    // This stage's products as fresh sums (the tensor cores' float32 sums
    // truncate: chained over the whole depth, their error would grow with
    // it), added to the accumulators rounded to nearest.
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < 2; ++k8) {
      const uint64_t o = static_cast<uint64_t>(k8 * 256) >> 4;  // 8 kz: two core matrices
      // the two sums' products in turns (neighbours independent), each
      // real product's small parts first
      wgmma2<1, 1>(pr, pi, ar[k8].lo, desc_r_hi + o, desc_i_hi + o, k8);
      wgmma2<1, 1>(pr, pi, ar[k8].hi, desc_r_lo + o, desc_i_lo + o, 1);
      wgmma2<1, 1>(pr, pi, ar[k8].hi, desc_r_hi + o, desc_i_hi + o, 1);
      wgmma2<-1, 1>(pr, pi, ai[k8].lo, desc_i_hi + o, desc_r_hi + o, 1);
      wgmma2<-1, 1>(pr, pi, ai[k8].hi, desc_i_lo + o, desc_r_lo + o, 1);
      wgmma2<-1, 1>(pr, pi, ai[k8].hi, desc_i_hi + o, desc_r_hi + o, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(pr);
    fence_operands(pi);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      ur[i] += pr[i];
      ui[i] += pi[i];
    }
    if (last_row) {
      const float2* sl = tt + kBN * kTS;
#pragma unroll
      for (int kk = 0; kk < kBK / kLastParts; ++kk) {
        cfma(last, sl[last_k + kk], tt[last_n * kTS + last_k + kk]);
      }
    }
  }
  cp_async_wait<0>();

  // U[g, kx, x'] from the accumulators: (gid (+8), 8 j + 2 tig (+1)) of the
  // warp's 16 rows.
  float2* ug = u + static_cast<size_t>(g) * xh * x_out;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int xp = n0 + 8 * j + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kx = m0 + arow + 8 * h;
      if (kx >= xm) continue;
      float2* row = ug + static_cast<size_t>(kx) * x_out;
      if (xp < x_out) row[xp] = make_float2(ur[4 * j + 2 * h], ui[4 * j + 2 * h]);
      if (xp + 1 < x_out) {
        row[xp + 1] = make_float2(ur[4 * j + 2 * h + 1], ui[4 * j + 2 * h + 1]);
      }
    }
  }
  if (last_row) {
    __syncthreads();  // the raw buffers are free
    float2* part = raw;
    if (t >= kBN) part[t - kBN] = last;
    __syncthreads();
    if (t < kBN && n0 + t < x_out) {
      float2 sum = last;
#pragma unroll
      for (int q = 0; q < kThreads / kBN - 1; ++q) {
        const float2 o = part[q * kBN + t];
        sum = make_float2(sum.x + o.x, sum.y + o.y);
      }
      ug[static_cast<size_t>(xm) * x_out + n0 + t] = sum;
    }
  }
}

// -- 2. the irfft -------------------------------------------------------------

constexpr int kLineThreads = 256;

// Line l of a tile: columns c0 + 2l and c0 + 2l + 1 of one group's U (xh
// rows of x_out) as S = U0 + i*U1, Hermitian-extended to X points (kernel
// C's HermitianRows, along columns): point e <= X/2 from row e, point e >
// X/2 from the conjugates of row X - e. The imaginary parts of row 0 and,
// for an even X, row X/2 are ignored, as irfft does; a column past x_out
// reads as zeros.
struct HermitianCols {
  const float2* u;
  int X, x_out, c0;
  __device__ __forceinline__ float2 ld(int l, int e) const {
    const int k = 2 * e <= X ? e : X - e, c = c0 + 2 * l;
    const float2* r = u + static_cast<size_t>(k) * x_out + c;
    float2 a = c < x_out ? __ldg(r) : make_float2(0.f, 0.f);
    float2 b = c + 1 < x_out ? __ldg(r + 1) : make_float2(0.f, 0.f);
    if (k == 0 || 2 * k == X) {
      a.y = 0.f;
      b.y = 0.f;
    }
    return k == e ? make_float2(a.x - b.y, a.y + b.x) : make_float2(a.x + b.y, b.x - a.y);
  }
};

// Line l's real and imaginary parts, times scale, as columns c0 + 2l and
// c0 + 2l + 1 of group g: out[g, x, x'] (zyx; one 8-byte store for an even
// x_out) or out[x', g, x] (kXzy).
template <bool kXzy>
struct RealCols {
  float* out;
  int X, x_out, groups, g, c0;
  float scale;
  __device__ __forceinline__ void st(int l, int x, float2 v) const {
    const int c = c0 + 2 * l;
    if (c >= x_out) return;
    if constexpr (kXzy) {
      float* p = out + (static_cast<size_t>(c) * groups + g) * X + x;
      p[0] = v.x * scale;
      if (c + 1 < x_out) p[static_cast<size_t>(groups) * X] = v.y * scale;
    } else {
      float* p = out + (static_cast<size_t>(g) * X + x) * x_out + c;
      if ((x_out & 1) == 0) {
        *reinterpret_cast<float2*>(p) = make_float2(v.x * scale, v.y * scale);
      } else {
        p[0] = v.x * scale;
        if (c + 1 < x_out) p[1] = v.y * scale;
      }
    }
  }
};

// Tiles blockIdx.x, + gridDim.x, ... of the groups' column pairs, each
// `lines` = 1 << log2l pairs of one group (kernels/spectral_cuda.py
// irfft_plan): X's radix passes in column layout (code != 0), else
// Bluestein's lines, `tab` table elements at the front of shared memory.
template <bool kXzy>
__global__ void __launch_bounds__(kLineThreads, 2)
lerp_irfft_kernel(const float2* __restrict__ u, float* __restrict__ out, int X, int x_out,
                  int groups, long long code, int log2l, int tab) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + tab;
  const int lines = 1 << log2l, xh = X / 2 + 1;
  const int per_g = (x_out + 2 * lines - 1) / (2 * lines), ntiles = groups * per_g;
  const bool radix = code != 0;
  RadixPlan pl;
  Axis<float2> ax;
  if (radix) {
    pl = decode_plan(code);
    make_radix_twiddles(tw, pl);
    __syncthreads();
  } else {
    ax = make_axis(tw, X);
  }
  const float scale = 1.0f / static_cast<float>(X);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int g = tile / per_g, c0 = (tile - g * per_g) * 2 * lines;
    const HermitianCols in{u + static_cast<size_t>(g) * xh * x_out, X, x_out, c0};
    const RealCols<kXzy> dst{out, X, x_out, groups, g, c0, scale};
    if (radix) {
      radix_run<true>(in, dst, buf, buf + padded(lines * X), Tile{lines, X, log2l}, pl, tw);
    } else {
      for (int i = threadIdx.x; i < (X << log2l); i += blockDim.x) {
        buf[i] = in.ld(i & (lines - 1), i >> log2l);
      }
      __syncthreads();
      lines_dif<true>(buf, ax, lines, log2l, 1, lines, true, true);
      for (int i = threadIdx.x; i < (X << log2l); i += blockDim.x) {
        dst.st(i & (lines - 1), i >> log2l, buf[i]);
      }
    }
    __syncthreads();
  }
}

// Shared-memory elements of the irfft's layout: the radix twiddles and one
// padded tile (two when the plan has more than two passes), or Bluestein's
// tables and a tile of M-point lines; 0 when `tab` does not hold the tables.
size_t irfft_elems(int X, long long code, int tab, int lines) {
  if (code != 0) {
    const RadixPlan pl = decode_plan(code);
    if (pl.n != X || tab < X - 1) return 0;
    return tab + (pl.passes <= 2 ? 1 : 2) * static_cast<size_t>(padded(lines * X));
  }
  if (static_cast<size_t>(tab) < table_elems(X)) return 0;
  return tab + (static_cast<size_t>(lines) << radix_log2(X));
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// Kernel M's contraction. spec: (Z, Y, X/2+1) complex64; table: (groups*avg,
// x_out, Z) complex64; u: (groups, X/2+1, x_out) complex64. groups <= 65535.
int lerp_contract(const void* spec, const void* table, void* u, int Z, int Y, int X, int x_out,
                  int groups, int avg, void* stream) {
  if (Z < 1 || Y < 1 || X < 2 || x_out < 1 || groups < 1 || groups > 65535 || avg < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = kPlanes * kPlane * sizeof(float) +
                      kStages * static_cast<size_t>(kRawElems) * sizeof(float2);
  cudaError_t e = allow_smem(lerp_contract_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int xm = X / 2;
  const dim3 grid((xm + kBM - 1) / kBM, (x_out + kBN - 1) / kBN, groups);
  lerp_contract_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float2*>(table),
      static_cast<float2*>(u), Z, Y, X, x_out, avg);
  return static_cast<int>(cudaGetLastError());
}

// Kernel M's irfft. u: (groups, X/2+1, x_out) complex64; out: (groups, X,
// x_out) float32 (xzy = 0) or (x_out, groups, X) (xzy = 1). The plan (code
// .. smem) is kernels/spectral_cuda.py irfft_plan(X, x_out)'s; a plan whose
// radices do not multiply to X or whose shared memory does not cover its
// layout is refused.
int lerp_irfft(const void* u, void* out, long long code, int log2l, int tab, int grid, int smem,
               int X, int x_out, int groups, int xzy, void* stream) {
  const size_t need = irfft_elems(X, code, tab, 1 << (log2l < 0 || log2l > 4 ? 0 : log2l));
  if (X < 2 || x_out < 1 || groups < 1 || log2l < 0 || log2l > 4 || grid < 1 || need == 0 ||
      need * sizeof(float2) > static_cast<size_t>(smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = xzy ? lerp_irfft_kernel<true> : lerp_irfft_kernel<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kLineThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(u), static_cast<float*>(out), X, x_out, groups, code, log2l,
      tab);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
