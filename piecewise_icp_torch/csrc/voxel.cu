// K7: voxel grouping of a cloud on a floor lattice, with one of two
// epilogues a voxel: the centroid (the voxel-grid downsample) or the point
// nearest the voxel's centre (the supervoxel seed choice).
//
// Hand-written; no Pallas counterpart.  It stands for two host numpy
// functions that the JAX package and the port's plain versions run on the
// host: voxel_downsample (ops/preprocess.py; float64 floor, a stable
// argsort, np.unique and np.add.reduceat) and propagate_seeds
// (models/segmentation_device.py; a three-key float64 lexsort: lattice
// cell, squared distance to the cell's centre, index).  The results are
// those functions' bits, so both lean on float64 arithmetic done in the
// same order, with every product and sum rounded on its own (the library is
// built with -fmad=false; the intrinsics below say so at each step).
//
// Three steps, the middle one outside this file:
//  1. pwicp_voxel_keys: the live points' bounds (one pass, an order-keeping
//     encoding of float32 so that atomicMin takes both ends), then a point
//     a thread: its int64 lattice key, and in the seed mode its float64
//     squared distance to its cell's centre.  A point outside the mask gets
//     the key INT64_MAX, so it sorts after every voxel and starts none;
//  2. a stable sort of the keys (torch.sort(stable=True) in the wrapper):
//     the permutation of numpy's stable argsort, so each voxel's points
//     stay in index order;
//  3. pwicp_voxel_segments: a thread a voxel walks its points in sorted
//     order.  Centroid: numpy's reduceat sum, the first value plus numpy's
//     pairwise sum of the rest (loops_utils.h.src: a plain loop below 8
//     values, eight interleaved partial sums up to 128, halves above),
//     divided by the count, rounded to float32.  Nearest: the first minimum
//     of the distance in stable order, i.e. the smallest index among ties,
//     as the lexsort's third key picks it.
//
// Bound on the card: bytes.  The cloud is read once (12 bytes a point) and
// a voxel written once (12 bytes a centroid, 8 a seed); the rest is a few
// dozen float64 operations a point.  At the cells' sizes (98k-175k
// points) the bound is about a microsecond, so launches and the sort in
// between set the time; the design keeps the launches few (two entries,
// three kernels) and the walk coalesced where most voxels hold one or two
// points.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pwicp {

constexpr int kVoxThreads = 256;
constexpr int kVoxBoundBlocks = 264;   // two waves of 132 SMs at most
constexpr int kPwBlock = 128;          // numpy's PW_BLOCKSIZE
constexpr int kPwStack = 64;           // 2 * depth + 1 for 2^31 values
constexpr int kModeCentroid = 0;
constexpr int kModeNearest = 1;
constexpr int64_t kNoKey = INT64_MAX;

// float32 -> uint32 keeping the order (negative values below positive ones)
__device__ __forceinline__ unsigned ord_enc(float f) {
  unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float ord_dec(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// bounds[0..2] = enc(min), bounds[3..5] = ~enc(max) of the live points, so
// both ends are an atomicMin from 0xFFFFFFFF.
__global__ void __launch_bounds__(kVoxThreads)
    voxel_bounds(const float* __restrict__ pts,
                 const uint8_t* __restrict__ mask, int n,
                 unsigned* __restrict__ bounds) {
  unsigned lo[3] = {0xffffffffu, 0xffffffffu, 0xffffffffu};
  unsigned hi[3] = {0xffffffffu, 0xffffffffu, 0xffffffffu};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (mask != nullptr && !mask[i]) continue;
    for (int c = 0; c < 3; ++c) {
      unsigned e = ord_enc(pts[3 * (size_t)i + c]);
      lo[c] = min(lo[c], e);
      hi[c] = min(hi[c], ~e);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    for (int c = 0; c < 3; ++c) {
      lo[c] = min(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], o));
      hi[c] = min(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], o));
    }
  __shared__ unsigned part[6][kVoxThreads / 32];
  int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0)
    for (int c = 0; c < 3; ++c) {
      part[c][warp] = lo[c];
      part[3 + c][warp] = hi[c];
    }
  __syncthreads();
  if (threadIdx.x < 6) {
    unsigned v = part[threadIdx.x][0];
    for (int w = 1; w < kVoxThreads / 32; ++w)
      v = min(v, part[threadIdx.x][w]);
    atomicMin(&bounds[threadIdx.x], v);
  }
}

__device__ __forceinline__ int64_t lattice_key(const int64_t v[3],
                                               const int64_t dims[3]) {
  // numpy's int64 arithmetic, which wraps: unsigned here, where it is defined
  uint64_t k = ((uint64_t)v[0] * (uint64_t)dims[1] + (uint64_t)v[1]) *
                   (uint64_t)dims[2] +
               (uint64_t)v[2];
  return (int64_t)k;
}

// Centroid mode: v = floor(p / leaf) - floor(min / leaf), the minimum over
// the points (floor and a correctly rounded division are monotone, so the
// floor of the minimum is the minimum of the floors), dims = the maximum's
// v + 1.  Nearest mode: mn = the origin if given, else the minimum; dims =
// trunc((max - mn) / res) + 1; cell = trunc(clip((p - mn) / res, 0,
// dims - 1)); centre = mn + (cell + 0.5) * res; d2c = (dx^2 + dy^2) + dz^2.
__global__ void __launch_bounds__(kVoxThreads)
    voxel_keys(const float* __restrict__ pts,
               const uint8_t* __restrict__ mask, int n, int mode, double res,
               int has_origin, double ox, double oy, double oz,
               const unsigned* __restrict__ bounds, int64_t* __restrict__ keys,
               double* __restrict__ d2c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (mask != nullptr && !mask[i]) {
    keys[i] = kNoKey;
    return;
  }
  const double origin[3] = {ox, oy, oz};
  int64_t v[3], dims[3];
  double sq[3];
  for (int c = 0; c < 3; ++c) {
    double p = (double)pts[3 * (size_t)i + c];
    double lo = (double)ord_dec(bounds[c]);
    double hi = (double)ord_dec(~bounds[3 + c]);
    if (mode == kModeCentroid) {
      int64_t vmin = (int64_t)floor(__ddiv_rn(lo, res));
      dims[c] = (int64_t)floor(__ddiv_rn(hi, res)) - vmin + 1;
      v[c] = (int64_t)floor(__ddiv_rn(p, res)) - vmin;
    } else {
      double mn = has_origin ? origin[c] : lo;
      dims[c] = (int64_t)__ddiv_rn(__dsub_rn(hi, mn), res) + 1;
      double x = __ddiv_rn(__dsub_rn(p, mn), res);
      x = fmin(fmax(x, 0.0), (double)(dims[c] - 1));
      v[c] = (int64_t)x;
      double ctr = __dadd_rn(mn, __dmul_rn(__dadd_rn((double)v[c], 0.5), res));
      double d = __dsub_rn(p, ctr);
      sq[c] = __dmul_rn(d, d);
    }
  }
  keys[i] = lattice_key(v, dims);
  if (mode == kModeNearest) d2c[i] = __dadd_rn(__dadd_rn(sq[0], sq[1]), sq[2]);
}

// Coordinate c of the point at sorted position i, widened to float64.
struct Sorted {
  const float* pts;
  const int64_t* perm;
  int c;
  __device__ __forceinline__ double operator()(int64_t i) const {
    return (double)pts[3 * perm[i] + c];
  }
};

// numpy's pairwise_sum of the n <= 128 values from sorted position s on.
__device__ double pw_leaf(const Sorted& x, int64_t s, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; ++i) res = __dadd_rn(res, x(s + i));
    return res;
  }
  double r[8];
  for (int j = 0; j < 8; ++j) r[j] = x(s + j);
  int64_t i = 8;
  for (; i < n - n % 8; i += 8)
    for (int j = 0; j < 8; ++j) r[j] = __dadd_rn(r[j], x(s + i + j));
  double lo = __dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3]));
  double hi = __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7]));
  double res = __dadd_rn(lo, hi);
  for (; i < n; ++i) res = __dadd_rn(res, x(s + i));
  return res;
}

// numpy's pairwise_sum above 128 values: the first n2 = n / 2 rounded down
// to a multiple of 8 and the rest, each summed alike, then added.  An
// explicit post-order walk (a task with n < 0 adds the two values on top).
__device__ __noinline__ double pw_tree(const Sorted& x, int64_t s, int64_t n) {
  int64_t ts[kPwStack], tn[kPwStack];
  double vals[kPwStack];
  int nt = 0, nv = 0;
  ts[nt] = s;
  tn[nt++] = n;
  while (nt > 0) {
    --nt;
    int64_t at = ts[nt], len = tn[nt];
    if (len < 0) {
      double b = vals[--nv];
      double a = vals[--nv];
      vals[nv++] = __dadd_rn(a, b);
    } else if (len <= kPwBlock) {
      vals[nv++] = pw_leaf(x, at, len);
    } else {
      int64_t n2 = len / 2;
      n2 -= n2 % 8;
      ts[nt] = 0;
      tn[nt++] = -1;
      ts[nt] = at + n2;
      tn[nt++] = len - n2;
      ts[nt] = at;
      tn[nt++] = n2;
    }
  }
  return vals[0];
}

__global__ void __launch_bounds__(kVoxThreads)
    voxel_segments(const int64_t* __restrict__ skeys,
                   const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ starts, int m, int n,
                   const float* __restrict__ pts,
                   const double* __restrict__ d2c, int mode,
                   float* __restrict__ centroids,
                   int64_t* __restrict__ winners) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  int64_t s = starts[j];
  int64_t key = skeys[s];
  int64_t e = s + 1;
  while (e < n && skeys[e] == key) ++e;
  if (mode == kModeCentroid) {
    double count = (double)(e - s);
    for (int c = 0; c < 3; ++c) {
      Sorted x{pts, perm, c};
      int64_t rest = e - s - 1;
      // one value: numpy's reduceat copies it (-0.0 stays -0.0)
      double total = x(s);
      if (rest > 0)
        total = __dadd_rn(total, rest <= kPwBlock ? pw_leaf(x, s + 1, rest)
                                                  : pw_tree(x, s + 1, rest));
      centroids[3 * (size_t)j + c] =
          __double2float_rn(__ddiv_rn(total, count));
    }
  } else {
    int64_t best = perm[s];
    double bd = d2c[best];
    for (int64_t i = s + 1; i < e; ++i) {
      int64_t p = perm[i];
      double d = d2c[p];
      if (d < bd) {
        bd = d;
        best = p;
      }
    }
    winners[j] = best;
  }
}

}  // namespace pwicp

// pts [n, 3] float32; mask [n] bytes or nullptr; mode 0 centroid (res =
// leaf), 1 nearest (res = the lattice's cell; the origin if has_origin);
// bounds: 6 words of scratch; keys [n] int64; d2c [n] float64 (mode 1, else
// unused).  Two launches, after one memset.
extern "C" int pwicp_voxel_keys(const float* pts, const uint8_t* mask, int n,
                                int mode, double res, int has_origin,
                                double ox, double oy, double oz,
                                unsigned* bounds, int64_t* keys, double* d2c,
                                void* stream) {
  using namespace pwicp;
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || !(res > 0.0) || mode < kModeCentroid || mode > kModeNearest ||
      (mode == kModeNearest && d2c == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(bounds, 0xFF, 6 * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + kVoxThreads - 1) / kVoxThreads;
  voxel_bounds<<<blocks < kVoxBoundBlocks ? blocks : kVoxBoundBlocks,
                 kVoxThreads, 0, st>>>(pts, mask, n, bounds);
  voxel_keys<<<blocks, kVoxThreads, 0, st>>>(pts, mask, n, mode, res,
                                             has_origin, ox, oy, oz, bounds,
                                             keys, d2c);
  return (int)cudaGetLastError();
}

// skeys [n] the stably sorted keys, perm [n] their source indices, starts
// [m] the sorted positions where the m voxels begin (ascending); pts and
// d2c as given to pwicp_voxel_keys.  Mode 0 writes centroids [m, 3]
// float32, mode 1 winners [m] (the source index of each voxel's seed).
extern "C" int pwicp_voxel_segments(const int64_t* skeys, const int64_t* perm,
                                    const int64_t* starts, int m, int n,
                                    const float* pts, const double* d2c,
                                    int mode, float* centroids,
                                    int64_t* winners, void* stream) {
  using namespace pwicp;
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 0 || n < m || (mode == kModeCentroid && centroids == nullptr) ||
      (mode == kModeNearest && (winners == nullptr || d2c == nullptr)) ||
      mode < kModeCentroid || mode > kModeNearest)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  voxel_segments<<<(m + kVoxThreads - 1) / kVoxThreads, kVoxThreads, 0, st>>>(
      skeys, perm, starts, m, n, pts, d2c, mode, centroids, winners);
  return (int)cudaGetLastError();
}
