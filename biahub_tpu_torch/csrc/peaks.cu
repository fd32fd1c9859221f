// Bead-peak candidates on Hopper: kernel G (block_max_argmin).
//
// Replaces biahub_tpu/kernels/pallas_peaks.py:125 _peaks_kernel (launched at
// :309 by block_max_candidates_pallas, :262) and the XLA formulation it
// shares its semantics with, biahub_tpu/kernels/peaks.py:54-182
// _block_max_candidates_xla. For a (Z, Y, X) float32 volume it
//
// 1. box-blurs each voxel over its 3^3 neighbourhood with the
//    count_include_pad=False divisor ((cz*cy)*cx, the counts of the
//    neighbours inside the volume along each axis), or not at all (blur 0);
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
// block owns one output block, walks it in sub-tiles of (8, 8, 32) cells,
// stages each sub-tile with a one-voxel halo in shared memory (zeros outside
// the volume, the blur's zero padding), sums the 27 neighbours of each cell
// from there, and keeps a per-thread (max, min index); a warp-shuffle and
// shared-memory reduction with the same rule finishes the block. Any block
// size works (the estimate-psf geometry (64, 64, 32) as well as beads'
// (8, 8, 8)), and any shape.
//
// Sums run z, then y, then x, ((a + b) + c) along each axis, as the XLA
// formulation's separable passes do; on integer-valued volumes every order
// gives the same float32 sums, so values and indices equal the reference's
// exactly (the reference's own two routes agree only there,
// pallas_peaks.py:22-31).
//
// Bound on one H100 SXM (3.35 TB/s): bytes. The volume is read once and
// the candidates are written once: (86, 1024, 484) float32 is 170.5 MB,
// 0.051 ms. 27 shared-memory reads and adds per voxel are far under the
// card's rates; the halo re-reads ((10*10*10)/512 = 1.95x for (8, 8, 8)
// blocks, (10*10*34)/2048 = 1.66x for (8, 8, 32) sub-tiles) mostly hit L2.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kTZ = 8, kTY = 8, kTX = 32;
constexpr int kHalo = (kTZ + 2) * (kTY + 2) * (kTX + 2);

struct Best {
  float v;
  int i;
};

// The reduction's rule: the larger value, the smaller index among equals.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// Neighbours inside [0, n-1] of a 3-window centred at i: the blur's divisor
// along one axis (count_include_pad=False).
__device__ __forceinline__ float count3(int i, int n) {
  return static_cast<float>(min(i + 1, n - 1) - max(i - 1, 0) + 1);
}

__global__ void __launch_bounds__(kThreads)
block_max_argmin_kernel(const float* __restrict__ in, float* __restrict__ vals,
                        int* __restrict__ idx, int Z, int Y, int X, int bz, int by,
                        int bx, int oy, int ox, int blur) {
  __shared__ float tile[kHalo];
  __shared__ Best warp_best[kThreads / 32];
  const long long blk = blockIdx.x;
  const int kx = static_cast<int>(blk % ox);
  const int ky = static_cast<int>((blk / ox) % oy);
  const int kz = static_cast<int>(blk / (static_cast<long long>(ox) * oy));
  // The block's cells, clipped to the volume.
  const int z0 = max(kz * bz - bz / 2, 0), z1 = min(kz * bz - bz / 2 + bz, Z);
  const int y0 = max(ky * by - by / 2, 0), y1 = min(ky * by - by / 2 + by, Y);
  const int x0 = max(kx * bx - bx / 2, 0), x1 = min(kx * bx - bx / 2 + bx, X);
  Best best{-INFINITY, INT_MAX};
  for (int sz = z0; sz < z1; sz += kTZ) {
    const int nz = min(kTZ, z1 - sz);
    for (int sy = y0; sy < y1; sy += kTY) {
      const int ny = min(kTY, y1 - sy);
      for (int sx = x0; sx < x1; sx += kTX) {
        const int nx = min(kTX, x1 - sx);
        const int hy = ny + 2, hx = nx + 2;
        if (blur) {
          const int nh = (nz + 2) * hy * hx;
          for (int i = threadIdx.x; i < nh; i += kThreads) {
            const int z = sz - 1 + i / (hy * hx);
            const int y = sy - 1 + (i / hx) % hy;
            const int x = sx - 1 + i % hx;
            const bool ok = z >= 0 && z < Z && y >= 0 && y < Y && x >= 0 && x < X;
            tile[i] = ok ? __ldg(in + (static_cast<long long>(z) * Y + y) * X + x) : 0.f;
          }
          __syncthreads();
        }
        const int n = nz * ny * nx;
        for (int i = threadIdx.x; i < n; i += kThreads) {
          const int dz = i / (ny * nx), dy = (i / nx) % ny, dx = i % nx;
          const int z = sz + dz, y = sy + dy, x = sx + dx;
          const int flat = (z * Y + y) * X + x;
          float v;
          if (blur) {
            // Separable order: z sums, then y, then x.
            float sx_ = 0.f;
#pragma unroll
            for (int ex = 0; ex < 3; ++ex) {
              float sy_ = 0.f;
#pragma unroll
              for (int ey = 0; ey < 3; ++ey) {
                const float* t = tile + (dz * hy + dy + ey) * hx + dx + ex;
                const float sz_ = __fadd_rn(__fadd_rn(t[0], t[hy * hx]), t[2 * hy * hx]);
                sy_ = ey == 0 ? sz_ : __fadd_rn(sy_, sz_);
              }
              sx_ = ex == 0 ? sy_ : __fadd_rn(sx_, sy_);
            }
            const float div = __fmul_rn(__fmul_rn(count3(z, Z), count3(y, Y)), count3(x, X));
            v = __fdiv_rn(sx_, div);
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
// block (kz, ky, kx) at kz*oy*ox + ky*ox + kx. blur: 0 or 3.
int block_max_argmin(const void* in, void* vals, void* idx, int Z, int Y, int X, int bz,
                     int by, int bx, int oz, int oy, int ox, int blur, void* stream) {
  const long long blocks = static_cast<long long>(oz) * oy * ox;
  block_max_argmin_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(vals), static_cast<int*>(idx), Z,
      Y, X, bz, by, bx, oy, ox, blur);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
