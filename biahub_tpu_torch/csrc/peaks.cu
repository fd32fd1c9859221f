// Bead-peak candidates on Hopper: kernel G (block_max_argmin).
//
// Replaces biahub_tpu/kernels/pallas_peaks.py:125 _peaks_kernel (launched at
// :309 by block_max_candidates_pallas, :262) and the XLA formulation it
// shares its semantics with, biahub_tpu/kernels/peaks.py:54-182
// _block_max_candidates_xla. For a (Z, Y, X) float32 volume it
//
// 1. box-blurs each voxel over its k^3 neighbourhood, k the blur size
//    (the window [i - (k-1)/2, i - (k-1)/2 + k - 1] on each axis, XLA's SAME
//    padding), with the count_include_pad=False divisor ((cz*cy)*cx, the
//    counts of the neighbours inside the volume along each axis), or not
//    at all (blur 0);
// 2. cuts the volume into blocks of torch max_pool3d(stride=b, padding=b/2)
//    geometry: block (kz, ky, kx) covers [k*b - b/2, k*b - b/2 + b) on each
//    axis, oz = (Z + 2*(bz/2) - bz)/bz + 1 blocks along z (likewise y, x);
//    cells outside the volume never win, and tail voxels past the last
//    block belong to none;
// 3. writes each block's maximum of the blurred values and the smallest
//    flat C-order index (z*Y + y)*X + x among its cells equal to it (int32).
//
// The TPU kernel's z chunks, thin halo refs, straddle ownership and lane
// epilogue exist for its VMEM tiling and are not carried over: one CUDA
// block owns one output block and walks it in sub-tiles of (tz, ty, tx)
// cells. For a blur of k (k >= 1) it stages each sub-tile with a halo of
// lo = (k-1)/2 cells below and k-1-lo above on each axis in shared memory
// (zeros outside the volume, the blur's zero padding); each cell then sums
// its 27 neighbours from there for k = 3 (the beads' and estimate-psf's
// blur), or, for any other k, the block sums the k neighbours along z into
// a second buffer, along y back into the first, and along x per cell (3k
// adds a cell, not k^3). Each thread keeps a (max, min index); a
// warp-shuffle and shared-memory reduction with the same rule finishes the
// block. Any block size works (the estimate-psf geometry (64, 64, 32) as
// well as beads' (8, 8, 8)), and any shape. The sub-tile is the host's
// (kernels/peaks_cuda.py blur_plan): (8, 8, 32), shrunk until its halo and
// z sums fit shared memory; blur sizes up to 38 fit in one (1, 1, 1) cell.
//
// Sums run z, then y, then x, ((a + b) + c) ... along each axis, as the
// XLA formulation's separable passes (and box_blur_plain) do, each divided
// by the count_include_pad=False divisor (cz*cy)*cx; on integer-valued
// volumes every order gives the same float32 sums, so values and indices
// equal the reference's exactly (the reference's own two routes agree only
// there, pallas_peaks.py:22-31).
//
// Bound on one H100 SXM (3.35 TB/s): bytes. The volume is read once and
// the candidates are written once: (86, 1024, 484) float32 is 170.5 MB,
// 0.051 ms. 3k shared-memory reads and adds per voxel are far under the
// card's rates at k = 3; the halo re-reads ((10*10*10)/512 = 1.95x for
// (8, 8, 8) blocks, (10*10*34)/2048 = 1.66x for (8, 8, 32) sub-tiles at
// k = 3) mostly hit L2.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;

struct Best {
  float v;
  int i;
};

// The reduction's rule: the larger value, the smaller index among equals.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// Neighbours inside [0, n-1] of the k-window [i - lo, i - lo + k - 1]: the
// blur's divisor along one axis (count_include_pad=False).
__device__ __forceinline__ float count_k(int i, int n, int k, int lo) {
  return static_cast<float>(min(i - lo + k - 1, n - 1) - max(i - lo, 0) + 1);
}

// blur: the box size k (0: none). tz, ty, tx: the sub-tile; the dynamic
// shared memory holds (tz+k-1)(ty+k-1)(tx+k-1) floats, and tz(ty+k-1)(tx+k-1)
// more but for k = 3. kBlur: 0 or 3 (the sub-tile (8, 8, 32), compiled in),
// or -1 (blur and the sub-tile from the arguments).
template <int kBlur>
__global__ void __launch_bounds__(kThreads)
block_max_argmin_kernel(const float* __restrict__ in, float* __restrict__ vals,
                        int* __restrict__ idx, int Z, int Y, int X, int bz, int by,
                        int bx, int oy, int ox, int blur_arg, int tz_arg, int ty_arg,
                        int tx_arg) {
  const int blur = kBlur >= 0 ? kBlur : blur_arg;
  const int tz = kBlur >= 0 ? 8 : tz_arg, ty = kBlur >= 0 ? 8 : ty_arg;
  const int tx = kBlur >= 0 ? 32 : tx_arg;
  extern __shared__ float smem[];
  __shared__ Best warp_best[kThreads / 32];
  const int k = blur, lo = blur > 0 ? (blur - 1) / 2 : 0, h = blur > 0 ? blur - 1 : 0;
  // halo: the staged cells, then the y sums; zsum: the z sums.
  float* halo = smem;
  float* zsum = smem + (tz + h) * (ty + h) * (tx + h);
  const long long blk = blockIdx.x;
  const int kx = static_cast<int>(blk % ox);
  const int ky = static_cast<int>((blk / ox) % oy);
  const int kz = static_cast<int>(blk / (static_cast<long long>(ox) * oy));
  // The block's cells, clipped to the volume.
  const int z0 = max(kz * bz - bz / 2, 0), z1 = min(kz * bz - bz / 2 + bz, Z);
  const int y0 = max(ky * by - by / 2, 0), y1 = min(ky * by - by / 2 + by, Y);
  const int x0 = max(kx * bx - bx / 2, 0), x1 = min(kx * bx - bx / 2 + bx, X);
  Best best{-INFINITY, INT_MAX};
  for (int sz = z0; sz < z1; sz += tz) {
    const int nz = min(tz, z1 - sz);
    for (int sy = y0; sy < y1; sy += ty) {
      const int ny = min(ty, y1 - sy);
      for (int sx = x0; sx < x1; sx += tx) {
        const int nx = min(tx, x1 - sx);
        const int hy = ny + h, hx = nx + h;
        if (blur) {
          const int nh = (nz + h) * hy * hx;
          // Blur 3 sums each cell's 27 neighbours from the staged halo.
          const bool sums = blur != 3;
          for (int i = threadIdx.x; i < nh; i += kThreads) {
            const int z = sz - lo + i / (hy * hx);
            const int y = sy - lo + (i / hx) % hy;
            const int x = sx - lo + i % hx;
            const bool ok = z >= 0 && z < Z && y >= 0 && y < Y && x >= 0 && x < X;
            halo[i] = ok ? __ldg(in + (static_cast<long long>(z) * Y + y) * X + x) : 0.f;
          }
          __syncthreads();
          // z sums of every (y, x) of the halo, for the sub-tile's z.
          const int plane = hy * hx;
          for (int i = threadIdx.x; sums && i < nz * plane; i += kThreads) {
            const float* t = halo + (i / plane) * plane + i % plane;
            float s = t[0];
            for (int e = 1; e < k; ++e) s = __fadd_rn(s, t[e * plane]);
            zsum[i] = s;
          }
          if (sums) __syncthreads();
          // y sums of the z sums, for the sub-tile's (z, y), into halo.
          for (int i = threadIdx.x; sums && i < nz * ny * hx; i += kThreads) {
            const int dz = i / (ny * hx), dy = (i / hx) % ny, dx = i % hx;
            const float* t = zsum + (dz * hy + dy) * hx + dx;
            float s = t[0];
            for (int e = 1; e < k; ++e) s = __fadd_rn(s, t[e * hx]);
            halo[i] = s;
          }
          if (sums) __syncthreads();
        }
        const int n = nz * ny * nx;
        for (int i = threadIdx.x; i < n; i += kThreads) {
          const int dz = i / (ny * nx), dy = (i / nx) % ny, dx = i % nx;
          const int z = sz + dz, y = sy + dy, x = sx + dx;
          const int flat = (z * Y + y) * X + x;
          float v;
          if (blur == 3) {
            // z sums, then y, then x, from the halo.
            float sx_ = 0.f;
#pragma unroll
            for (int ex = 0; ex < 3; ++ex) {
              float sy_ = 0.f;
#pragma unroll
              for (int ey = 0; ey < 3; ++ey) {
                const float* t = halo + (dz * hy + dy + ey) * hx + dx + ex;
                const float sz_ = __fadd_rn(__fadd_rn(t[0], t[hy * hx]), t[2 * hy * hx]);
                sy_ = ey == 0 ? sz_ : __fadd_rn(sy_, sz_);
              }
              sx_ = ex == 0 ? sy_ : __fadd_rn(sx_, sy_);
            }
            const float div = __fmul_rn(__fmul_rn(count_k(z, Z, 3, 1), count_k(y, Y, 3, 1)),
                                        count_k(x, X, 3, 1));
            v = __fdiv_rn(sx_, div);
          } else if (blur) {
            // x sums of the y sums, then the divisor.
            const float* t = halo + (dz * ny + dy) * hx + dx;
            float s = t[0];
            for (int e = 1; e < k; ++e) s = __fadd_rn(s, t[e]);
            const float div = __fmul_rn(__fmul_rn(count_k(z, Z, k, lo), count_k(y, Y, k, lo)),
                                        count_k(x, X, k, lo));
            v = __fdiv_rn(s, div);
          } else {
            v = __ldg(in + flat);
          }
          best = better(best, Best{v, flat});
        }
        if (blur) __syncthreads();
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Best o{__shfl_down_sync(0xffffffffu, best.v, off),
                 __shfl_down_sync(0xffffffffu, best.i, off)};
    best = better(best, o);
  }
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    Best b = warp_best[0];
    for (int w = 1; w < kThreads / 32; ++w) b = better(b, warp_best[w]);
    vals[blk] = b.v;
    idx[blk] = b.i;
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// in: (Z, Y, X) float32; vals: (oz*oy*ox,) float32; idx: (oz*oy*ox,) int32,
// block (kz, ky, kx) at kz*oy*ox + ky*ox + kx. blur: the box size (0:
// none); tz, ty, tx and smem_bytes: the sub-tile and its shared memory
// (kernels/peaks_cuda.py blur_plan).
int block_max_argmin(const void* in, void* vals, void* idx, int Z, int Y, int X, int bz,
                     int by, int bx, int oz, int oy, int ox, int blur, int tz, int ty, int tx,
                     int smem_bytes, void* stream) {
  const auto kernel = blur == 0   ? block_max_argmin_kernel<0>
                      : blur == 3 ? block_max_argmin_kernel<3>
                                  : block_max_argmin_kernel<-1>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(oz) * oy * ox;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(vals), static_cast<int*>(idx), Z, Y, X,
      bz, by, bx, oy, ox, blur, tz, ty, tx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
