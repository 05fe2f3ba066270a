// K5: brute-force exact 1-NN of every query against the whole target cloud.
//
// Replaces piecewise_icp_tpu/ops/nn_pallas.py:_nn1_kernel (reached via
// nn1_pallas from percentile_c2c: auto DT-init once per pair, the stage-1
// exact-percentile fallback, and here also the in-step rescue of the stage-1
// percentile's unresolved queries; also the brute overlap ratio of adaptive
// pair planning when no dense grid fits).  The TPU kernel kept the whole
// target row resident in VMEM and a [256, 2048] running-min scratch per
// query tile.
//
// Bound on the card: FP32 instruction slots.  Every live query meets every target,
// and the distance contract (coordinate differences, separately rounded
// products and sums: no FMA, no matmul identity, so no tensor cores) costs 3
// subtractions, 3 products and 2 sums a pair, plus the comparison.  Memory
// traffic is one read of the targets per block from L2.  The design spends
// as few instruction slots beyond those nine as it can:
//
//  * only live queries work: the kernel reads its queries through a
//    compacted index list (built by the wrapper from q_mask), so no lane
//    idles through the scan for a masked query;
//  * a register tile of kNn1Qpt queries per thread: each target word read
//    from shared memory serves that many pairs;
//  * targets are laid out once per call by a pre-pass as a structure of
//    arrays (masked targets replaced by the 1e30 sentinel, the tail padded
//    with it to whole tiles), so the main loop reads four targets'
//    coordinates with three 16-byte broadcast loads and has no tail case;
//  * the minimum is kept with fminf over a group of four targets, and only
//    the group that last lowered it strictly is remembered: 3/4 of a min and
//    1/4 of a compare-and-select a pair in place of a compare and two
//    selects.  The lowest index inside that group is found once at the end;
//  * the target axis is split over blockIdx.y so that any query count fills
//    the card.  Partial minima are combined exactly: d2 >= 0, so the bits of
//    a float order like an unsigned integer, and a 64-bit
//    atomicMin(d2_bits << 32 | index) is the lexicographic minimum, which is
//    "ties to the lowest index".  A last pass unpacks it;
//  * the next target tile is staged with cp.async (double-buffered) while
//    the current one is scanned.
//
// Contract (ops/nn.py:nn1 and nn1_pallas): ties go to the lowest target
// index: groups are scanned in ascending index with a strict <, the lowest
// equal index of the winning group is taken, and the atomic orders equal
// distances by index.  Masked targets are the 1e30 sentinel, whose squared
// distance overflows to inf and is never accepted; a masked query, or one
// with no finite distance, gives (inf, -1).  -0.0 cannot occur (a sum of
// squares).  A NaN distance (a NaN coordinate) is never accepted: fminf
// drops it and NaN < best is false, as in the plain version's arg-min over
// finite values.
#include <algorithm>

#include "common.cuh"

namespace pwicp {

constexpr int kNn1Threads = 256;
constexpr int kNn1Qpt = 4;      // queries per thread (register tile)
constexpr int kNn1Tile = 1024;  // targets per shared-memory tile (12 KB)
constexpr int kNn1QBlock = kNn1Threads * kNn1Qpt;
constexpr int kNn1Waves = 3;         // blocks wanted per resident block slot
constexpr int kNn1BlocksPerSm = 3;   // matches __launch_bounds__ below
typedef unsigned long long u64;

// Pre-pass: targets as a structure of arrays [3][nt_pad], masked and padding
// entries at the sentinel.
__global__ void nn1_stage_targets(const float* __restrict__ t,
                                  const uint8_t* __restrict__ t_mask, int nt,
                                  int nt_pad, float* __restrict__ soa) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nt_pad) return;
  bool ok = j < nt && (t_mask == nullptr || t_mask[j]);
  soa[j] = ok ? t[3 * (size_t)j] : kBig;
  soa[(size_t)nt_pad + j] = ok ? t[3 * (size_t)j + 1] : kBig;
  soa[2 * (size_t)nt_pad + j] = ok ? t[3 * (size_t)j + 2] : kBig;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kNn1Threads, kNn1BlocksPerSm)
    nn1_brute_kernel(const float* __restrict__ q,
                     const int* __restrict__ live, int nlive,
                     const float* __restrict__ soa, int nt_pad,
                     int tiles_per_split, u64* __restrict__ packed) {
  __shared__ __align__(16) float tile[2][3][kNn1Tile];
  const int tid = threadIdx.x;
  const int n_tiles = nt_pad / kNn1Tile;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  if (t0 >= t1) return;  // block-uniform

  int qi[kNn1Qpt], bj[kNn1Qpt];
  float qx[kNn1Qpt], qy[kNn1Qpt], qz[kNn1Qpt], best[kNn1Qpt];
#pragma unroll
  for (int r = 0; r < kNn1Qpt; ++r) {
    size_t slot = (size_t)blockIdx.x * kNn1QBlock + r * kNn1Threads + tid;
    qi[r] = -1;
    qx[r] = qy[r] = qz[r] = 0.f;
    if (slot < (size_t)nlive) {
      qi[r] = live == nullptr ? (int)slot : live[slot];
      qx[r] = q[3 * (size_t)qi[r]];
      qy[r] = q[3 * (size_t)qi[r] + 1];
      qz[r] = q[3 * (size_t)qi[r] + 2];
    }
    best[r] = INFINITY;
    bj[r] = -1;
  }

  auto stage = [&](int ti, int buf) {
    constexpr int kPieces = kNn1Tile / 4;  // 16-byte pieces per coordinate
    for (int i = tid; i < 3 * kPieces; i += kNn1Threads) {
      int c = i / kPieces, w = i % kPieces;
      cp_async16(&tile[buf][c][4 * w], soa + (size_t)c * nt_pad +
                                           (size_t)ti * kNn1Tile + 4 * w);
    }
    cp_async_commit();
  };

  stage(t0, 0);
  for (int ti = t0; ti < t1; ++ti) {
    const int buf = (ti - t0) & 1;
    if (ti + 1 < t1) {
      stage(ti + 1, buf ^ 1);  // last read before the previous barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's pieces of this tile have landed
    const float4* sx = reinterpret_cast<const float4*>(tile[buf][0]);
    const float4* sy = reinterpret_cast<const float4*>(tile[buf][1]);
    const float4* sz = reinterpret_cast<const float4*>(tile[buf][2]);
    const int jbase = ti * kNn1Tile;
#pragma unroll 2
    for (int g = 0; g < kNn1Tile / 4; ++g) {
      const float4 x = sx[g], y = sy[g], z = sz[g];
#pragma unroll
      for (int r = 0; r < kNn1Qpt; ++r) {
        float d0 = sqdist(qx[r], qy[r], qz[r], x.x, y.x, z.x);
        float d1 = sqdist(qx[r], qy[r], qz[r], x.y, y.y, z.y);
        float d2 = sqdist(qx[r], qy[r], qz[r], x.z, y.z, z.z);
        float d3 = sqdist(qx[r], qy[r], qz[r], x.w, y.w, z.w);
        float m = fminf(fminf(d0, d1), fminf(d2, d3));
        if (m < best[r]) {
          best[r] = m;
          bj[r] = jbase + 4 * g;
        }
      }
    }
    __syncthreads();  // the tile is no longer read: it may be restaged
  }

#pragma unroll
  for (int r = 0; r < kNn1Qpt; ++r) {
    if (qi[r] < 0 || bj[r] < 0) continue;
    // the lowest index of the winning group whose distance is the minimum
    int idx = bj[r];
    for (int u = 3; u >= 0; --u) {
      size_t j = (size_t)bj[r] + u;
      float d = sqdist(qx[r], qy[r], qz[r], soa[j], soa[(size_t)nt_pad + j],
                       soa[2 * (size_t)nt_pad + j]);
      if (d == best[r]) idx = (int)j;
    }
    u64 key = ((u64)__float_as_uint(best[r]) << 32) | (unsigned)idx;
    atomicMin(&packed[qi[r]], key);
  }
}

// Unpack (d2 bits << 32 | index); an untouched slot is (inf, -1).
__global__ void nn1_finalize(const u64* __restrict__ packed, int nq,
                             int* __restrict__ out_idx,
                             float* __restrict__ out_d2) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  u64 key = packed[i];
  bool hit = key != ~0ull;
  out_d2[i] = hit ? __uint_as_float((unsigned)(key >> 32)) : INFINITY;
  out_idx[i] = hit ? (int)(unsigned)(key & 0xffffffffu) : -1;
}

}  // namespace pwicp

// live: the indices of the queries that work (nullptr: all nq, nlive == nq).
// soa [3 * nt_pad] floats and packed [nq] 64-bit words are scratch of this
// call, allocated by the caller; nt_pad is nt rounded up to whole tiles.
extern "C" int pwicp_nn1_tile() { return pwicp::kNn1Tile; }

extern "C" int pwicp_nn1_brute(const float* q, const int* live, int nlive,
                               int nq, const float* t, const uint8_t* t_mask,
                               int nt, int nt_pad, float* soa,
                               unsigned long long* packed, int* out_idx,
                               float* out_d2, void* stream) {
  using namespace pwicp;
  cudaStream_t st = (cudaStream_t)stream;
  if (nt_pad % kNn1Tile != 0 || nt_pad < nt || nlive > nq)
    return (int)cudaErrorInvalidValue;
  if (nq <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(packed, 0xFF, (size_t)nq * sizeof(u64), st);
  if (err != cudaSuccess) return (int)err;
  if (nlive > 0 && nt > 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    nn1_stage_targets<<<(nt_pad + 255) / 256, 256, 0, st>>>(t, t_mask, nt,
                                                           nt_pad, soa);
    // split the target axis until the grid holds a few waves of blocks
    int bx = (nlive + kNn1QBlock - 1) / kNn1QBlock;
    int n_tiles = nt_pad / kNn1Tile;
    int want = sms * kNn1BlocksPerSm * kNn1Waves;
    int splits = std::min(n_tiles, std::max(1, (want + bx - 1) / bx));
    int tiles_per_split = (n_tiles + splits - 1) / splits;
    splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
    nn1_brute_kernel<<<dim3(bx, splits), kNn1Threads, 0, st>>>(
        q, live, nlive, soa, nt_pad, tiles_per_split, packed);
  }
  nn1_finalize<<<(nq + 255) / 256, 256, 0, st>>>(packed, nq, out_idx, out_d2);
  return (int)cudaGetLastError();
}
