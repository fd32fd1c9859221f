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
// Sums run z, then y, then x, ((a + b) + c) ... along each axis over the
// zero-padded window, as the XLA formulation's separable passes (and
// box_blur_plain) do, each divided by the divisor (cz*cy)*cx; every route
// below keeps that order, so the result has the same bits on any float32
// data (on integer-valued volumes every order gives the same sums, so
// values and indices equal the reference's exactly; the reference's own
// two routes agree only there, pallas_peaks.py:22-31).
//
// The TPU kernel's z chunks, thin halo refs, straddle ownership and lane
// epilogue exist for its VMEM tiling and are not carried over. Here a CUDA
// block owns a tile of cells: tx along X (128, 64 or 32: a warp reads 128-
// byte runs of a row), ty rows along Y, and tz planes along Z that it walks
// plane by plane; tiles start on output-block boundaries (in the shifted
// coordinate x + bx/2), so a tile holds whole output blocks where they are
// no larger than it. Each thread owns one column x and ty / (256/tx) rows
// of the tile and keeps, per row, the best (value, index) of its cells
// since the last output-block boundary along z: walking z upward, a later
// cell wins only with a strictly larger value, which is the reduction's
// rule (the larger value, the smaller index among equals). At the last
// plane of an output block along z the thread's rows of one output block
// merge, the lanes of one output block merge by shuffles, and one lane
// writes the merge with a 64-bit atomicMax on an order-preserving key
// (block_key: the value's bits mapped to an ordered unsigned word, -0.0
// as +0.0, above 0x7fffffff - index and the sign of a zero), so output
// blocks larger than a tile (estimate-psf's (64, 64, 32)) combine the
// partials of several tiles and walks, in any order, to the same result;
// a last small kernel decodes the keys.
//
// The blur (kernels/peaks_cuda.py g_plan chooses the route and the tile):
// - blur 0 or 1 (and the last route below): the walk loads each cell from
//   device memory, kAhead planes' loads in flight before it folds one, no
//   halo;
// - k = 3 and other small k: each input plane of the tile with its halo
//   (lo = (k-1)/2 cells below, k-1-lo above on y and x; zeros outside the
//   volume, the blur's padding) arrives by cp.async into a ring of k + 1
//   planes, the next plane in flight while this one is summed: the z sums
//   of the halo'd plane from the ring, the y sums from those, each cell's
//   x sum from those (at k = 3 each thread sums its cells' 3 x 3 z sums, y
//   then x, itself: one barrier fewer a plane); the read amplification is
//   (ty+k-1)/ty * (tx+k-1)/tx * (tz+k-1)/tz (1.29 at k = 3 for (16, 128,
//   16) tiles, against 1.95 for the previous one-block-per-output-block
//   kernel);
// - larger k: where that moves fewer bytes, or where the ring would not
//   fit shared memory, the sums along z (then y, then x) run first as
//   passes through device memory (axis_sum_kernel, the same order and
//   bits: a window clipped to the volume adds its padding's zeros as one
//   +0.0 on each clipped side, which changes nothing but the sign of a
//   zero, exactly as the padded sum does), and the walk sums the axes
//   left, from a ring of 3 planes. No blur size is refused.
//
// Bound on one H100 SXM (3.35 TB/s): bytes. The volume is read once and
// the candidates are written once: (86, 1024, 484) float32 is 170.5 MB,
// 0.051 ms; the blur's 3k adds a voxel are far under the card's rates at
// k = 3.

#include <cuda_runtime.h>

#include <algorithm>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;  // rows of a tile a thread owns
constexpr int kAhead = 2;    // planes an unstaged walk keeps in flight

// The walk's plan (kernels/peaks_cuda.py GPlan): cells of a tile along x,
// y and z, the window summed in the walk along each axis (k, or 1 where a
// pass summed that axis first), the lanes that share an output block (bx
// when it divides 32 and tx, else 1), and the blur's k for the divisor
// (0: no blur, no divisor).
struct GPlan {
  int tx, ty, tz, hz, hy, hx, seg, k;
};

struct Geometry {
  int Z, Y, X, bz, by, bx, oz, oy, ox;
};

// The order-preserving key of a candidate: larger values above smaller,
// among equal values (+0.0 and -0.0 equal) the smaller index above; the
// lowest bit keeps a -0.0's sign for the decode. 0 is below every key.
__device__ __forceinline__ unsigned long long block_key(float v, int i) {
  unsigned b = __float_as_uint(v);
  const unsigned negzero = b == 0x80000000u;
  if (negzero) b = 0u;
  const unsigned ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) |
         (static_cast<unsigned>(0x7fffffff - i) << 1) | negzero;
}

// Neighbours inside [0, n-1] of the k-window [i - lo, i - lo + k - 1]: the
// blur's divisor along one axis (count_include_pad=False).
__device__ __forceinline__ float count_k(int i, int n, int k, int lo) {
  return static_cast<float>(min(i - lo + k - 1, n - 1) - max(i - lo, 0) + 1);
}

// The k-window sums along the middle axis of in, viewed as (outer, n,
// inner), into out: the window clipped to [0, n), a leading 0.0f added
// first where it starts below 0 and a trailing 0.0f where it ends past n -
// 1, which gives the zero-padded sum's bits.
__global__ void __launch_bounds__(kThreads)
axis_sum_kernel(const float* __restrict__ in, float* __restrict__ out, int total, int n,
                int inner, int k) {
  const int lo = (k - 1) / 2;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int e = static_cast<int>(i);
    const int c = e % inner, oj = e / inner, j = oj % n;
    const float* col = in + static_cast<size_t>(oj - j) * inner + c;
    const int a = max(j - lo, 0), b = min(j - lo + k - 1, n - 1);
    float s = __ldg(col + static_cast<size_t>(a) * inner);
    if (j - lo < 0) s = __fadd_rn(0.f, s);
    for (int t = a + 1; t <= b; ++t) s = __fadd_rn(s, __ldg(col + static_cast<size_t>(t) * inner));
    if (j - lo + k - 1 > n - 1) s = __fadd_rn(s, 0.f);
    out[e] = s;
  }
}

// Sum of h terms p[0], p[d], ... in order (kH: h at compile time, or -1).
template <int kH>
__device__ __forceinline__ float window_sum(const float* p, int d, int h) {
  if constexpr (kH > 0) h = kH;
  float s = p[0];
#pragma unroll
  for (int e = 1; e < (kH > 0 ? kH : 1); ++e) s = __fadd_rn(s, p[e * d]);
  if constexpr (kH < 0) {
    for (int e = 1; e < h; ++e) s = __fadd_rn(s, p[e * d]);
  }
  return s;
}

// Shared-memory floats of a staged walk (0 for an unstaged one): a ring
// of hz + 1 planes (3 when hz = 1, so the next plane is staged at the top
// of a step) of (ty + hy - 1) x (tx + hx - 1) cells, the z sums' plane
// when hz > 1, the y sums' ty rows when hy > 1 but at k = 3 (where each
// cell sums its 3 x 3 z sums itself).
__host__ __device__ inline long long walk_floats(const GPlan& p) {
  if (p.hz == 1 && p.hy == 1 && p.hx == 1) return 0;
  const long long pitch = p.tx + p.hx - 1, plane = (p.ty + p.hy - 1) * pitch;
  const bool k3 = p.hz == 3 && p.hy == 3 && p.hx == 3;
  return (p.hz > 1 ? p.hz + 1 : 3) * plane + (p.hz > 1 ? plane : 0) +
         (p.hy > 1 && !k3 ? p.ty * pitch : 0);
}

// kH: 0 (no window: each cell loaded from device memory, kAhead planes at
// a time), 3 (hz = hy = hx = 3 at compile time) or -1 (the plan's windows).
template <int kH>
__global__ void __launch_bounds__(kThreads, 3)
block_walk_kernel(const float* __restrict__ in, unsigned long long* __restrict__ keys,
                  Geometry g, GPlan p, int ntx, int nty) {
  extern __shared__ float smem[];
  const int hz = kH == 3 ? 3 : p.hz, hy = kH == 3 ? 3 : p.hy, hx = kH == 3 ? 3 : p.hx;
  const int tile = blockIdx.x;
  const int u0 = (tile % ntx) * p.tx, v0 = ((tile / ntx) % nty) * p.ty;
  const int w0 = (tile / (ntx * nty)) * p.tz;
  // the tile's first cell (x0, y0, z0) and the output planes it walks
  const int x0 = u0 - g.bx / 2, y0 = v0 - g.by / 2, z0 = w0 - g.bz / 2;
  const int za = max(z0, 0);
  const int zb = min(min(z0 + p.tz, g.Z), g.oz * g.bz - g.bz / 2);
  if (za >= zb) return;  // the whole block: nothing of this tile is in the volume

  // thread: column col of the tile, rows grp, grp + groups, ... (a warp's
  // lanes share their rows)
  const int groups = kThreads / p.tx;
  const int col = threadIdx.x % p.tx, grp = threadIdx.x / p.tx;
  const int rows = p.ty / groups;
  const int x = x0 + col, kx = (u0 + col) / g.bx;
  const bool x_ok = x >= 0 && x < g.X && u0 + col < g.ox * g.bx;
  const int k = p.k, lo = (k - 1) / 2;
  const float cx = count_k(x, g.X, k, lo);
  const int lane = threadIdx.x % 32;
  // per row: whether its cells count, its divisor's y count, and its best
  // (value, index) since the last output-block boundary along z
  unsigned row_ok = 0;
  float cy[kMaxRows], bv[kMaxRows];
  int bi[kMaxRows];
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    const int y = y0 + grp + groups * j;
    if (j < rows && x_ok && y >= 0 && y < g.Y && v0 + grp + groups * j < g.oy * g.by) {
      row_ok |= 1u << j;
    }
    cy[j] = count_k(y, g.Y, k, lo);
    bv[j] = 0.f;
    bi[j] = -1;
  }

  // Plane z's window sums of this thread's cells into their rows' bests;
  // at an output block's last plane along z (or the walk's), the rows of
  // each output block merged, then its lanes, and the key written.
  auto fold = [&](int z, const float (&cell)[kMaxRows]) {
    const float cz = count_k(z, g.Z, k, lo);
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if ((row_ok >> j) & 1u) {
        const float v = k > 0 ? __fdiv_rn(cell[j], __fmul_rn(__fmul_rn(cz, cy[j]), cx))
                              : cell[j];
        if (bi[j] < 0 || v > bv[j]) {
          bv[j] = v;
          bi[j] = (z * g.Y + y0 + grp + groups * j) * g.X + x;
        }
      }
    }
    const int wz = z + g.bz / 2;
    if ((wz + 1) % g.bz != 0 && z != zb - 1) return;
    const size_t plane_base = static_cast<size_t>(wz / g.bz) * g.oy;
    unsigned long long acc = 0;
    int ky = (v0 + grp) / g.by;
#pragma unroll
    for (int j = 0; j <= kMaxRows; ++j) {
      const int kyj = j < rows ? (v0 + grp + groups * j) / g.by : -1;
      if (kyj != ky) {
        // the rows of output-block row ky: merged over the lanes of one
        // output block, then one atomic
        for (int off = p.seg / 2; off > 0; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, acc, off);
          acc = o > acc ? o : acc;
        }
        if (acc != 0 && lane % p.seg == 0) atomicMax(keys + (plane_base + ky) * g.ox + kx, acc);
        acc = 0;
        ky = kyj;
      }
      if (kyj < 0) break;
      if (j < kMaxRows && bi[j] >= 0) {
        const unsigned long long kj = block_key(bv[j], bi[j]);
        acc = kj > acc ? kj : acc;
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) bi[j] = -1;
  };

  if constexpr (kH == 0) {
    // kAhead planes' loads in flight: plane z's registers are refilled with
    // plane z + kAhead's cells as soon as z is folded
    float cell[kAhead][kMaxRows];
    auto load = [&](int z, float (&c)[kMaxRows]) {
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j) {
        c[j] = z < zb && ((row_ok >> j) & 1u)
                   ? __ldg(in + (static_cast<size_t>(z) * g.Y + y0 + grp + groups * j) * g.X + x)
                   : 0.f;
      }
    };
#pragma unroll
    for (int a = 0; a < kAhead; ++a) load(za + a, cell[a]);
    for (int z = za; z < zb; z += kAhead) {
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        if (z + a < zb) {
          fold(z + a, cell[a]);
          load(z + a + kAhead, cell[a]);
        }
      }
    }
    return;
  }

  const int loz = (hz - 1) / 2, loy = (hy - 1) / 2, lox = (hx - 1) / 2;
  const int pitch = p.tx + hx - 1, prow = p.ty + hy - 1, plane = prow * pitch;
  const int slots = hz > 1 ? hz + 1 : 3;
  float* ring = smem;
  float* zsum = ring + slots * plane;
  float* ybuf = hz > 1 ? zsum + plane : zsum;
  const int warp = threadIdx.x / 32;

  // Plane i of the walk (z = za - loz + i) with its halo into its ring
  // slot, one commit group (empty past the last plane the walk needs).
  const int last = zb - za - 1 + hz - 1;
  auto stage = [&](int i) {
    if (i <= last) {
      float* dst = ring + (i % slots) * plane;
      const int z = za - loz + i;
      const bool z_ok = z >= 0 && z < g.Z;
      for (int r = warp; r < prow; r += kThreads / 32) {
        const int y = y0 - loy + r;
        const bool ok_zy = z_ok && y >= 0 && y < g.Y;
        const float* src = in + (static_cast<size_t>(z) * g.Y + y) * g.X;
        for (int c = lane; c < pitch; c += 32) {
          const int xx = x0 - lox + c;
          const bool ok = ok_zy && xx >= 0 && xx < g.X;
          cp_async4(dst + r * pitch + c, ok ? src + xx : in, ok);
        }
      }
    }
    cp_async_commit();
  };

  // planes 0 .. hz - 1 (a window), then the next one in flight
  for (int i = 0; i <= hz; ++i) stage(i);
  for (int z = za; z < zb; ++z) {
    const int i0 = z - za, s0 = i0 % slots;
    cp_async_wait<1>();
    __syncthreads();
    if (hz == 1) stage(i0 + 2);  // into the slot of plane i0 - 1
    const float* zs = ring + s0 * plane;
    if (hz > 1) {
      // z sums of the halo'd plane, planes i0 .. i0 + hz - 1 in order
      for (int r = warp; r < prow; r += kThreads / 32) {
        for (int c = lane; c < pitch; c += 32) {
          const int at = r * pitch + c;
          float s = ring[s0 * plane + at];
          int sl = s0;
#pragma unroll
          for (int e = 1; e < (kH == 3 ? 3 : hz); ++e) {
            sl = sl + 1 == slots ? 0 : sl + 1;
            s = __fadd_rn(s, ring[sl * plane + at]);
          }
          zsum[at] = s;
        }
      }
      __syncthreads();
      stage(i0 + hz + 1);  // into the slot of plane i0
      zs = zsum;
    }
    float cell[kMaxRows];
    if constexpr (kH == 3) {
      // each cell's y sums of the z sums at its 3 columns, then their x sum
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j) {
        const float* t = zs + (grp + groups * j) * pitch + col;
        cell[j] = j < rows ? __fadd_rn(__fadd_rn(window_sum<3>(t, pitch, 3),
                                                 window_sum<3>(t + 1, pitch, 3)),
                                       window_sum<3>(t + 2, pitch, 3))
                           : 0.f;
      }
    } else {
      const float* ys = zs;
      if (hy > 1) {
        // y sums of the z sums, rows 0 .. ty - 1
        for (int r = warp; r < p.ty; r += kThreads / 32) {
          for (int c = lane; c < pitch; c += 32) {
            ybuf[r * pitch + c] = window_sum<-1>(zs + r * pitch + c, pitch, hy);
          }
        }
        __syncthreads();
        ys = ybuf;
      }
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j) {
        cell[j] = j < rows ? window_sum<-1>(ys + (grp + groups * j) * pitch + col, 1, hx) : 0.f;
      }
    }
    fold(z, cell);
  }
  cp_async_wait<0>();
}

// Keys to (value, index); a key of 0 (no cell) cannot occur: every output
// block holds a cell of the volume.
__global__ void __launch_bounds__(kThreads)
decode_kernel(const unsigned long long* __restrict__ keys, float* __restrict__ vals,
              int* __restrict__ idx, int n) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    const unsigned long long key = keys[e];
    const unsigned ord = static_cast<unsigned>(key >> 32);
    unsigned b = (ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord;
    if (b == 0u && (key & 1u)) b = 0x80000000u;
    vals[e] = __uint_as_float(b);
    idx[e] = 0x7fffffff - static_cast<int>((key & 0xffffffffu) >> 1);
  }
}

// Blocks of a grid-stride launch over n elements (at most 4096).
int grid_for(long long n) {
  return static_cast<int>(std::min<long long>((n + kThreads - 1) / kThreads, 4096));
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// in: (Z, Y, X) float32; keys: (oz*oy*ox,) uint64 scratch; vals, idx:
// (oz*oy*ox,) float32 and int32, block (kz, ky, kx) at kz*oy*ox + ky*ox +
// kx; sums: scratch of one volume per axis summed by a pass (hz, hy, hx of
// 1 with blur > 1), at most two. blur: the box size (0: none); tx .. seg
// and smem_bytes: kernels/peaks_cuda.py g_plan's. The walk's grid is
// ceil(ox*bx / tx) * ceil(oy*by / ty) * ceil(oz*bz / tz) tiles.
int block_max_argmin(const void* in, void* sums, void* keys, void* vals, void* idx, int Z, int Y,
                     int X, int bz, int by, int bx, int oz, int oy, int ox, int blur, int tx,
                     int ty, int tz, int hz, int hy, int hx, int seg, int smem_bytes,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k = blur;
  if (tx < 32 || tx > kThreads || kThreads % tx != 0 || ty < 1 || ty % (kThreads / tx) != 0 ||
      ty / (kThreads / tx) > kMaxRows || tz < 1 || seg < 1 || seg > 32 || (seg & (seg - 1)) ||
      hz < 1 || hy < 1 || hx < 1 || (k <= 1 && (hz > 1 || hy > 1 || hx > 1)) ||
      (k > 1 && ((hz != 1 && hz != k) || (hy != 1 && hy != k) || (hx != 1 && hx != k)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = oz * oy * ox, total = Z * Y * X;
  cudaError_t e = cudaMemsetAsync(keys, 0, static_cast<size_t>(n) * 8, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the axes a pass sums first, into the scratch volumes in turn
  const float* src = static_cast<const float*>(in);
  float* scratch[2] = {static_cast<float*>(sums), static_cast<float*>(sums) + total};
  int used = 0;
  const int axis_h[3] = {hz, hy, hx}, axis_n[3] = {Z, Y, X}, axis_inner[3] = {Y * X, X, 1};
  for (int a = 0; a < 3 && k > 1; ++a) {
    if (axis_h[a] != 1) continue;
    float* dst = scratch[used++ % 2];
    axis_sum_kernel<<<grid_for(total), kThreads, 0, st>>>(src, dst, total, axis_n[a],
                                                         axis_inner[a], k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    src = dst;
  }
  const GPlan p{tx, ty, tz, hz, hy, hx, seg, k};
  const Geometry g{Z, Y, X, bz, by, bx, oz, oy, ox};
  if (walk_floats(p) * 4 > smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const int ntx = (ox * bx + tx - 1) / tx, nty = (oy * by + ty - 1) / ty;
  const long long tiles = static_cast<long long>(ntx) * nty * ((oz * bz + tz - 1) / tz);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = walk_floats(p) > 0;
  const auto kernel = !staged                            ? block_walk_kernel<0>
                      : (hz == 3 && hy == 3 && hx == 3) ? block_walk_kernel<3>
                                                         : block_walk_kernel<-1>;
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(tiles), kThreads, staged ? smem_bytes : 0, st>>>(
      src, static_cast<unsigned long long*>(keys), g, p, ntx, nty);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_kernel<<<grid_for(n), kThreads, 0, st>>>(static_cast<const unsigned long long*>(keys),
                                                 static_cast<float*>(vals),
                                                 static_cast<int*>(idx), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
