// Spectral deconvolve + deskew on Hopper: kernel M, which emits the
// deskewed volume straight from the filtered spectrum.
//
// Replaces pass C' of biahub_tpu/kernels/pallas_spectral.py, one kernel
// with two stores (as kernel D has):
//
//   M  lerp_irfft_kernel <- _lerp_irfft_kernel (pallas_spectral.py:327,
//                           launched at :919): the zyx store;
//                           _lerp_irfft_xzy_kernel (:434, launched at :872):
//                           the (X', Z', Y') store the in-plane warp reads.
//
// Input: S, the (Z, Y, X/2+1) complex64 spectrum left by kernels A, K and L
// (fft.cu): DFT along Z times the filter, back along Y, the rfft half along
// X; and T, the (G*avg, X_out, Z) complex64 lerp-DFT table of
// kernels/spectral.py (prepare_spectral_deskew), with 1/(Z*avg) folded in.
// For one output group g and a tile of TX x' columns a block
//
//   1. accumulates U[kx, x'] = sum_{j<avg} sum_kz T[z', x', kz] S[kz, y, kx]
//      over the group's tilt rows z' = g*avg + j, with y = max(Y-1-z', 0):
//      the reference's slab row j of its front-padded tilt axis is tilt
//      row y of the unpadded one (its padded rows replicate row 0, whose
//      table rows are clamped to Z_out - 1: the edge-padded tail group);
//   2. takes the irfft of each x' column along kx (X points, 1/X), two
//      columns riding one complex inverse FFT as in kernel C (the imaginary
//      parts of kx = 0 and, for an even X, kx = X/2 ignored, as irfft does:
//      the reference's Nyquist peel is this last column), and stores
//      out[g, x, x'] (zyx: (G, X, X_out)) or out[x', g, x] (xzy: (X_out, G,
//      X)). Both stores write the same values: xzy is zyx transposed to
//      the bit.
//
// Bound (one H100 SXM, 67 Tflop/s float32, 3.35 TB/s), at the headline
// 256x256x1024 volume with avg 3 (G 86, X_out 484): operations. The
// contraction is 258 tilt rows x 513 kx x 484 x' x 256 kz complex
// multiply-adds, 1.31e11 float32 flop, 1.96 ms; its bytes (the 269.0 MB
// spectrum, the 255.7 MB table, 85.2 MB out) take 0.18 ms. TF32 tensor
// cores keep 10 mantissa bits and cannot hold 1e-5 over a depth of
// avg*Z = 768, so this kernel uses none: every product is a float32 FMA.
//
// Design: 512 threads, 128 kx lanes x 4 x' groups. Thread (a, b) keeps in
// registers the accumulators of kx = kc0 + a + 128 i (i < 4) and x' =
// b*CX + c (c < CX), TX = 4*CX columns a block, CX = 8, 4 or 2, the widest
// whose shared memory fits. The last column, kx = X/2 (the Nyquist bin for
// an even X: xh = 513 would otherwise take a fifth kx row per lane), is
// summed apart: thread t < 16*TX adds one product per stage, and 16 lanes'
// shares are added by warp shuffles at the end. The contraction streams 16
// kz at a time (512 kx of S, the last column's 16 values, TX x' of T)
// through two shared-memory buffers filled by cp.async, so the copies of
// the next stage overlap the FMAs of this one; per kz a thread loads 4 +
// CX values (T as a warp broadcast, 16 bytes at a time) for 16*CX FMAs.
// The accumulators then go, as Hermitian-extended lines, into shared memory
// (one line per column pair, padded by one element against bank
// conflicts), which reuses the stage buffers when X/2 <= 512 and sits
// beside them otherwise (S is then streamed once per 512-wide kx chunk).
// Limits (shared memory): X up to 2048 for a power of two, 1025 otherwise.
// No tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
#include "fft_lines.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 128;                    // kx lanes
constexpr int kColGroups = kThreads / kLanes;  // x' groups
constexpr int kNkx = 4;                        // kx per lane per chunk
constexpr int kChunk = kLanes * kNkx;          // 512 kx per chunk
constexpr int kKc = 16;                        // kz per stage
constexpr size_t kSmemMax = 227 * 1024;        // dynamic shared memory of a block

// Elements of one stage buffer: kKc rows of kChunk S values, kKc S values
// of the last column, kKc rows of tx T values.
__host__ __device__ constexpr int stage_elems(int tx) { return kKc * (kChunk + 1 + tx); }

__device__ __forceinline__ void cfma(float2& u, float2 s, float2 w) {
  u.x = fmaf(s.x, w.x, u.x);
  u.x = fmaf(-s.y, w.y, u.x);
  u.y = fmaf(s.x, w.y, u.y);
  u.y = fmaf(s.y, w.x, u.y);
}

template <int CX, bool kAny>
__global__ void __launch_bounds__(kThreads, 1)
lerp_irfft_kernel(const float2* __restrict__ spec, const float2* __restrict__ table,
                  float* __restrict__ out, int Z, int Y, int X, int x_out, int groups,
                  int avg, int xzy, int tab) {
  constexpr int TX = kColGroups * CX;
  constexpr int NL = TX / 2;
  constexpr int SE = stage_elems(TX);
  extern __shared__ float2 smem[];
  const int xh = X / 2 + 1, xm = xh - 1;  // kx < xm in the chunks, kx = xm apart
  Axis<float2> ax;
  if constexpr (kAny) {
    ax = make_axis(smem, X);
  } else {
    ax = pow2_axis(smem, X);
    make_twiddles(smem, X);
    __syncthreads();
  }
  const int lstride = (1 << ax.log2m) + 1;
  const int nchunks = (xm + kChunk - 1) / kChunk;
  float2* lines = smem + tab;  // tab is even: 16-byte aligned
  float2* stage = nchunks > 1 ? lines + ((NL * lstride + 1) & ~1) : lines;
  const int g = blockIdx.y, x0 = blockIdx.x * TX;
  const int t = threadIdx.x, a = t % kLanes, b = t / kLanes;
  const size_t zstride = static_cast<size_t>(Y) * xh;
  const int nk = (Z + kKc - 1) / kKc, nstages = avg * nk;
  // The last column's share: thread t < kKc*TX sums column t >> 4 over kz
  // = k0 + (t & 15); 16 lanes of a warp then hold one column.
  const bool tail = t < kKc * TX;
  float2 tail_acc = make_float2(0.f, 0.f);

  for (int c0 = 0; c0 < nchunks; ++c0) {
    const int kc0 = c0 * kChunk;
    // Issues the copies of stage s (tilt row j, kz from k0) into buffer buf.
    auto issue = [&](int s, int buf) {
      const int j = s / nk, k0 = (s - j * nk) * kKc, zp = g * avg + j;
      const float2* srow = spec + static_cast<size_t>(max(Y - 1 - zp, 0)) * xh;
      float2* st = stage + buf * SE;
#pragma unroll
      for (int kk = 0; kk < kKc; ++kk) {
        const int kz = k0 + kk, kx = kc0 + t;
        const bool ok = kz < Z && kx < xm;
        cp_async8(st + kk * kChunk + t, ok ? srow + kz * zstride + kx : spec, ok);
      }
      if (t < kKc) {
        const bool ok = c0 == 0 && k0 + t < Z;
        cp_async8(st + kKc * kChunk + t, ok ? srow + (k0 + t) * zstride + xm : spec, ok);
      }
      if (tail) {
        const int c = t / kKc, kk = t - c * kKc, kz = k0 + kk, xp = x0 + c;
        const bool ok = kz < Z && xp < x_out;
        const float2* trow = table + static_cast<size_t>(zp) * x_out * Z;
        cp_async8(st + kKc * (kChunk + 1) + kk * TX + c,
                  ok ? trow + static_cast<size_t>(xp) * Z + kz : spec, ok);
      }
      cp_async_commit();
    };

    float2 acc[kNkx][CX];
#pragma unroll
    for (int i = 0; i < kNkx; ++i) {
#pragma unroll
      for (int c = 0; c < CX; ++c) acc[i][c] = make_float2(0.f, 0.f);
    }
    issue(0, 0);
    for (int s = 0; s < nstages; ++s) {
      if (s + 1 < nstages) {
        issue(s + 1, (s + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float2* st = stage + (s & 1) * SE;
      const float2* s_sm = st;
      const float2* l_sm = st + kKc * kChunk;
      const float2* t_sm = l_sm + kKc;
#pragma unroll 4
      for (int kk = 0; kk < kKc; ++kk) {
        float2 sv[kNkx], w[CX];
#pragma unroll
        for (int i = 0; i < kNkx; ++i) sv[i] = s_sm[kk * kChunk + a + kLanes * i];
        const float4* wp = reinterpret_cast<const float4*>(t_sm + kk * TX + b * CX);
#pragma unroll
        for (int c = 0; c < CX / 2; ++c) {
          const float4 v = wp[c];
          w[2 * c] = make_float2(v.x, v.y);
          w[2 * c + 1] = make_float2(v.z, v.w);
        }
#pragma unroll
        for (int i = 0; i < kNkx; ++i) {
#pragma unroll
          for (int c = 0; c < CX; ++c) cfma(acc[i][c], sv[i], w[c]);
        }
      }
      if (c0 == 0 && tail) cfma(tail_acc, l_sm[t & 15], t_sm[(t & 15) * TX + (t >> 4)]);
      __syncthreads();
    }
    // Columns 2q and 2q+1 ride line q as S = U0 + i*U1, Hermitian-extended
    // to X points (kernel C's phase 2); a thread holds both columns.
#pragma unroll
    for (int i = 0; i < kNkx; ++i) {
      const int kx = kc0 + a + kLanes * i;
      if (kx >= xm) continue;
#pragma unroll
      for (int c = 0; c < CX; c += 2) {
        float2 u0 = acc[i][c], u1 = acc[i][c + 1];
        if (kx == 0) {
          u0.y = 0.f;
          u1.y = 0.f;
        }
        float2* line = lines + ((b * CX + c) >> 1) * lstride;
        line[kx] = make_float2(u0.x - u1.y, u0.y + u1.x);
        if (kx > 0) line[X - kx] = make_float2(u0.x + u1.y, u1.x - u0.y);
      }
    }
  }
  // The last column: the 16 lanes of a column sum their shares; lane 0 of
  // each warp (column 2q) takes lane 16's (column 2q+1) and writes line q.
  if (tail) {
#pragma unroll
    for (int d = 8; d > 0; d >>= 1) {
      tail_acc.x += __shfl_xor_sync(0xffffffffu, tail_acc.x, d);
      tail_acc.y += __shfl_xor_sync(0xffffffffu, tail_acc.y, d);
    }
    const float2 u1 = make_float2(__shfl_down_sync(0xffffffffu, tail_acc.x, 16),
                                  __shfl_down_sync(0xffffffffu, tail_acc.y, 16));
    if ((t & 31) == 0) {
      float2 u0 = tail_acc, v1 = u1;
      if (xm == 0 || 2 * xm == X) {
        u0.y = 0.f;
        v1.y = 0.f;
      }
      float2* line = lines + (t >> 5) * lstride;
      line[xm] = make_float2(u0.x - v1.y, u0.y + v1.x);
      if (xm > 0 && 2 * xm < X) line[X - xm] = make_float2(u0.x + v1.y, v1.x - u0.y);
    }
  }
  __syncthreads();
  lines_dif<kAny>(lines, ax, NL, 0, lstride, 1, true, false);

  const float scale = 1.0f / static_cast<float>(X);
  const int ncol = min(TX, x_out - x0);
  if (!xzy) {
    for (int i = t; i < X * TX; i += kThreads) {
      const int x = i / TX, c = i - x * TX;
      if (c < ncol) {
        const float2 v = lines[(c >> 1) * lstride + at<kAny>(ax, x)];
        out[(static_cast<size_t>(g) * X + x) * x_out + x0 + c] = ((c & 1) ? v.y : v.x) * scale;
      }
    }
  } else {
    for (int i = t; i < X * ncol; i += kThreads) {
      const int c = i / X, x = i - c * X;
      const float2 v = lines[(c >> 1) * lstride + at<kAny>(ax, x)];
      out[(static_cast<size_t>(x0 + c) * groups + g) * X + x] = ((c & 1) ? v.y : v.x) * scale;
    }
  }
}

// Shared memory of a block with CX columns per x' group for an X-point
// irfft, in bytes; *tab gets the elements of X's tables, rounded up to even.
size_t lerp_smem(int cx, int X, int* tab) {
  const bool any = !is_pow2(X);
  const size_t mx = static_cast<size_t>(1) << radix_log2(X);
  const int tx = kColGroups * cx;
  const size_t lines = (tx / 2 * (mx + 1) + 1) & ~static_cast<size_t>(1);
  const size_t stages = 2 * static_cast<size_t>(stage_elems(tx));
  const size_t work = X / 2 > kChunk ? lines + stages : std::max(lines, stages);
  *tab = (static_cast<int>(any ? table_elems(X) : X / 2) + 1) & ~1;
  return (*tab + work) * sizeof(float2);
}

template <int CX>
int launch_lerp(const void* spec, const void* table, void* out, int Z, int Y, int X,
                int x_out, int groups, int avg, int xzy, int tab, size_t smem,
                void* stream) {
  auto kernel = is_pow2(X) ? lerp_irfft_kernel<CX, false> : lerp_irfft_kernel<CX, true>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int TX = kColGroups * CX;
  const dim3 grid((x_out + TX - 1) / TX, groups);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float2*>(table),
      static_cast<float*>(out), Z, Y, X, x_out, groups, avg, xzy, tab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// Kernel M. spec: (Z, Y, X/2+1) complex64; table: (groups*avg, x_out, Z)
// complex64; out: (groups, X, x_out) float32 (xzy = 0) or (x_out, groups,
// X) (xzy = 1). X in [2, 2048] if a power of two, else [2, 1025] (the
// shared memory of the narrowest tile; checked by the Python wrapper, and
// cudaErrorInvalidValue here); groups <= 65535.
int lerp_irfft(const void* spec, const void* table, void* out, int Z, int Y, int X,
               int x_out, int groups, int avg, int xzy, void* stream) {
  int tab;
  size_t smem;
  if ((smem = lerp_smem(8, X, &tab)) <= kSmemMax) {
    return launch_lerp<8>(spec, table, out, Z, Y, X, x_out, groups, avg, xzy, tab, smem, stream);
  }
  if ((smem = lerp_smem(4, X, &tab)) <= kSmemMax) {
    return launch_lerp<4>(spec, table, out, Z, Y, X, x_out, groups, avg, xzy, tab, smem, stream);
  }
  if ((smem = lerp_smem(2, X, &tab)) <= kSmemMax) {
    return launch_lerp<2>(spec, table, out, Z, Y, X, x_out, groups, avg, xzy, tab, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
