// K6: brute-force exact k-NN of every query against the whole target cloud:
// the K smallest squared distances of each query WITH multiplicity,
// ascending, and the caller's epilogue over them in the same launch.
//
// Hand-written; no Pallas counterpart.  It stands for three functions the
// JAX package's TPU branch reaches outside Pallas:
//  * native.sor_mean_dist (piecewise_icp_tpu/native/pwicp_host.cpp:351), the
//    exact k-NN statistic to which the staged SOR hands a cloud with more
//    unresolved queries than its in-program budget
//    (piecewise_icp_tpu/ops/preprocess.py:279-292): both rockfall
//    configurations take that branch;
//  * chunk_means, the in-program XLA rescue of _sor_mask_sorted
//    (piecewise_icp_tpu/ops/preprocess.py:142-167), distinct-value min
//    extraction with multiplicity over [512, N] chunks: the SOR-mean
//    epilogue below does its exact float32 arithmetic;
//  * ops/nn.py:knn, the streaming top-k of resolution estimation and the
//    small-cloud SOR (the distance epilogue).
//
// Bound on the card: FP32 instruction slots, as K5 (nn1_brute.cu).  Every
// query meets every target, and the distance contract (coordinate
// differences, separately rounded products and sums: no FMA, no matmul
// identity, so no tensor cores) costs 3 subtractions, 3 products and 2 sums
// a pair, plus the comparison with the K-th distance so far: 9 a candidate.
// Memory traffic is one read of the targets per block, from L2.  Design:
//
//  * one thread a query, its list of L >= K distances in registers, kept
//    sorted by an unrolled compare-and-swap insertion (templated on L, so no
//    runtime-indexed array spills to local memory); a candidate costs one
//    comparison with the list's last entry unless it enters the list;
//  * targets are laid out once per call by a pre-pass as a structure of
//    arrays, masked targets and the tail padding as NaN (never less than
//    anything, so never a neighbour, whatever the query's coordinates); the
//    main loop reads four targets' coordinates with three 16-byte broadcast
//    loads from shared memory, staged with cp.async (double-buffered);
//  * the target axis is split over blockIdx.y so that a few thousand
//    queries (the SOR rescue of a rockfall cloud) still fill the card.  Each
//    split writes its sorted partial list to scratch; a merge pass per query
//    takes the L smallest of the splits' lists.  The lists hold values only,
//    so the merge is order-free and the bits do not depend on the split;
//  * the merge pass writes the epilogue: the K squared distances, their
//    square roots, or the SOR mean.  Nothing over [Q, K] runs after it.
//
// Contract (the plain version, ops/nn_cuda.py:knn_brute_plain: chunked
// sqdist + torch.topk): the multiset of the K smallest squared distances;
// masked targets and any d2 >= 1e30 (the sentinel's) are not neighbours;
// slots left empty hold +inf.  The list starts at 1e30 and a candidate
// enters only when strictly below its last entry, so a d2 at or above the
// sentinel, or NaN, never enters; an equal value does not change the
// multiset.  sqrtf and the division are IEEE correctly rounded (no
// --use_fast_math), as torch.sqrt and torch.div round on the CPU.
#include <algorithm>

#include "common.cuh"

namespace pwicp {

constexpr int kKnnThreads = 128;    // queries a block, one a thread
constexpr int kKnnTile = 1024;      // targets a shared-memory tile (12 KB)
constexpr int kKnnWantBlocks = 132 * 8;  // a few waves on an H100's 132 SMs
constexpr int kKnnMaxK = 32;

enum KnnOut { kOutD2 = 0, kOutDist = 1, kOutSorMean = 2 };

// The list length that serves K (the smallest instantiated L >= K).
__host__ __device__ inline int knn_list_len(int k) {
  return k <= 2 ? 2 : k <= 15 ? 15 : k <= 16 ? 16 : 32;
}

struct KnnLayout {
  int nt_pad, n_tiles, splits, tiles_per_split, list;
  size_t soa_floats, partial_floats;
};

// Scratch of one call: the targets as a structure of arrays [3][nt_pad],
// then the splits' partial lists [splits][L][nq].  Pure arithmetic, so the
// wrapper's allocation and the launch agree.
inline KnnLayout knn_layout(int nq, int nt, int k) {
  KnnLayout l;
  l.nt_pad = (nt + kKnnTile - 1) / kKnnTile * kKnnTile;
  l.n_tiles = l.nt_pad / kKnnTile;
  l.list = knn_list_len(k);
  int bx = (nq + kKnnThreads - 1) / kKnnThreads;
  int want = std::max(1, (kKnnWantBlocks + bx - 1) / std::max(bx, 1));
  int splits = std::min(l.n_tiles, want);
  l.tiles_per_split = splits > 0 ? (l.n_tiles + splits - 1) / splits : 0;
  l.splits = l.tiles_per_split > 0
                 ? (l.n_tiles + l.tiles_per_split - 1) / l.tiles_per_split
                 : 0;
  l.soa_floats = 3 * (size_t)l.nt_pad;
  l.partial_floats = (size_t)l.splits * l.list * nq;
  return l;
}

// Put d (< best[L-1]) into the ascending list: it replaces the last entry
// and sinks by compare-and-swap; every index is a compile-time constant.
template <int L>
__device__ __forceinline__ void knn_insert(float (&best)[L], float d) {
  best[L - 1] = d;
#pragma unroll
  for (int i = L - 1; i > 0; --i) {
    float a = best[i - 1], b = best[i];
    best[i - 1] = fminf(a, b);
    best[i] = fmaxf(a, b);
  }
}

__global__ void knn_stage_targets(const float* __restrict__ t,
                                  const uint8_t* __restrict__ t_mask, int nt,
                                  int nt_pad, float* __restrict__ soa) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nt_pad) return;
  bool ok = j < nt && (t_mask == nullptr || t_mask[j]);
  const float nan = __int_as_float(0x7fc00000);
  soa[j] = ok ? t[3 * (size_t)j] : nan;
  soa[(size_t)nt_pad + j] = ok ? t[3 * (size_t)j + 1] : nan;
  soa[2 * (size_t)nt_pad + j] = ok ? t[3 * (size_t)j + 2] : nan;
}

__device__ __forceinline__ void knn_cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// One split of the targets (blockIdx.y) against kKnnThreads queries: the
// split's L smallest d2 of each query, ascending, into partial[y][i][q].
template <int L>
__global__ void __launch_bounds__(kKnnThreads)
    knn_brute_kernel(const float* __restrict__ q, int nq,
                     const float* __restrict__ soa, int nt_pad,
                     int tiles_per_split, float* __restrict__ partial) {
  __shared__ __align__(16) float tile[2][3][kKnnTile];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * kKnnThreads + tid;
  const int n_tiles = nt_pad / kKnnTile;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  if (t0 >= t1) return;  // block-uniform

  // a thread past the last query scans too (it stages its share of every
  // tile) and writes nothing
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < nq) {
    qx = q[3 * (size_t)qi];
    qy = q[3 * (size_t)qi + 1];
    qz = q[3 * (size_t)qi + 2];
  }
  float best[L];
#pragma unroll
  for (int i = 0; i < L; ++i) best[i] = kBig;

  auto stage = [&](int ti, int buf) {
    constexpr int kPieces = kKnnTile / 4;  // 16-byte pieces a coordinate
    for (int i = tid; i < 3 * kPieces; i += kKnnThreads) {
      int c = i / kPieces, w = i % kPieces;
      knn_cp_async16(&tile[buf][c][4 * w],
                     soa + (size_t)c * nt_pad + (size_t)ti * kKnnTile + 4 * w);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  stage(t0, 0);
  for (int ti = t0; ti < t1; ++ti) {
    const int buf = (ti - t0) & 1;
    if (ti + 1 < t1) {
      stage(ti + 1, buf ^ 1);  // last read before the previous barrier
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // every thread's pieces of this tile have landed
    const float4* sx = reinterpret_cast<const float4*>(tile[buf][0]);
    const float4* sy = reinterpret_cast<const float4*>(tile[buf][1]);
    const float4* sz = reinterpret_cast<const float4*>(tile[buf][2]);
#pragma unroll 2
    for (int g = 0; g < kKnnTile / 4; ++g) {
      const float4 x = sx[g], y = sy[g], z = sz[g];
      float d;
      d = sqdist(qx, qy, qz, x.x, y.x, z.x);
      if (__builtin_expect(d < best[L - 1], 0)) knn_insert<L>(best, d);
      d = sqdist(qx, qy, qz, x.y, y.y, z.y);
      if (__builtin_expect(d < best[L - 1], 0)) knn_insert<L>(best, d);
      d = sqdist(qx, qy, qz, x.z, y.z, z.z);
      if (__builtin_expect(d < best[L - 1], 0)) knn_insert<L>(best, d);
      d = sqdist(qx, qy, qz, x.w, y.w, z.w);
      if (__builtin_expect(d < best[L - 1], 0)) knn_insert<L>(best, d);
    }
    __syncthreads();  // the tile is no longer read: it may be restaged
  }
  if (qi >= nq) return;
#pragma unroll
  for (int i = 0; i < L; ++i)
    partial[((size_t)blockIdx.y * L + i) * nq + qi] = best[i];
}

// Per query: the L smallest of the splits' sorted lists, then the epilogue
// over the first K.  A value >= 1e30 is an empty slot (+inf out).
//   kOutD2, kOutDist: out[q][i] = d2, or sqrtf(d2), i < K.
//   kOutSorMean: out[q] = the mean distance to the K-1 nearest non-self
//     neighbours (the query itself sits at rank 1, distance 0): for each
//     run of c equal values v, acc = acc + c * sqrtf(v) in ascending order,
//     then acc / max(rank - 1, 1) with rank the number of filled slots; the
//     float32 operations, in their order, of chunk_means.
template <int L>
__global__ void knn_merge(const float* __restrict__ partial, int nq,
                          int splits, int k, int mode,
                          float* __restrict__ out) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float best[L];
#pragma unroll
  for (int i = 0; i < L; ++i) best[i] = kBig;
  for (int s = 0; s < splits; ++s) {
    for (int i = 0; i < L; ++i) {
      float d = partial[((size_t)s * L + i) * nq + qi];
      if (!(d < best[L - 1])) break;  // the split's list is ascending
      knn_insert<L>(best, d);
    }
  }
  if (mode == kOutSorMean) {
    float acc = 0.f, rank = 0.f, run = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (i < k && best[i] < kBig) {
        run = __fadd_rn(run, 1.f);
        bool ends = true;
        if (i + 1 < L) ends = !(i + 1 < k && best[i + 1] == best[i]);
        if (ends) {
          acc = __fadd_rn(acc, __fmul_rn(run, __fsqrt_rn(best[i])));
          rank = __fadd_rn(rank, run);
          run = 0.f;
        }
      }
    }
    out[qi] = __fdiv_rn(acc, fmaxf(__fsub_rn(rank, 1.f), 1.f));
    return;
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (i < k) {
      float v = best[i] < kBig ? best[i] : INFINITY;
      out[(size_t)qi * k + i] = mode == kOutDist ? __fsqrt_rn(v) : v;
    }
  }
}

template <int L>
cudaError_t knn_launch(const float* q, int nq, const KnnLayout& l,
                       const float* soa, float* partial, int k, int mode,
                       float* out, cudaStream_t st) {
  if (l.splits > 0) {
    dim3 grid((nq + kKnnThreads - 1) / kKnnThreads, l.splits);
    knn_brute_kernel<L><<<grid, kKnnThreads, 0, st>>>(
        q, nq, soa, l.nt_pad, l.tiles_per_split, partial);
  }
  knn_merge<L><<<(nq + 255) / 256, 256, 0, st>>>(partial, nq, l.splits, k,
                                                  mode, out);
  return cudaGetLastError();
}

}  // namespace pwicp

// Floats of scratch a call needs (the targets' structure of arrays, then
// the splits' partial lists); -1 for an invalid shape.
extern "C" int pwicp_knn_brute_cap(int nq, int nt, int k) {
  using namespace pwicp;
  if (nq < 0 || nt < 0 || k < 1 || k > kKnnMaxK) return -1;
  KnnLayout l = knn_layout(nq, nt, k);
  size_t total = l.soa_floats + l.partial_floats;
  return total > 0x7fffffff ? -1 : (int)total;
}

// q [nq, 3], t [nt, 3] float32; t_mask [nt] bytes or nullptr; k = K slots
// (1..32); mode 0: out [nq, k] squared distances, 1: out [nq, k]
// distances, 2: out [nq] SOR means.  scratch holds scratch_floats >=
// pwicp_knn_brute_cap(nq, nt, k) floats of this call.
extern "C" int pwicp_knn_brute(const float* q, int nq, const float* t,
                               const uint8_t* t_mask, int nt, int k, int mode,
                               float* scratch, int scratch_floats, float* out,
                               void* stream) {
  using namespace pwicp;
  cudaStream_t st = (cudaStream_t)stream;
  int cap = pwicp_knn_brute_cap(nq, nt, k);
  if (cap < 0 || scratch_floats < cap || mode < kOutD2 || mode > kOutSorMean)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaGetLastError();
  KnnLayout l = knn_layout(nq, nt, k);
  float* soa = scratch;
  float* partial = scratch + l.soa_floats;
  if (l.splits > 0)
    knn_stage_targets<<<(l.nt_pad + 255) / 256, 256, 0, st>>>(t, t_mask, nt,
                                                             l.nt_pad, soa);
  switch (l.list) {
    case 2:
      return (int)knn_launch<2>(q, nq, l, soa, partial, k, mode, out, st);
    case 15:
      return (int)knn_launch<15>(q, nq, l, soa, partial, k, mode, out, st);
    case 16:
      return (int)knn_launch<16>(q, nq, l, soa, partial, k, mode, out, st);
    default:
      return (int)knn_launch<32>(q, nq, l, soa, partial, k, mode, out, st);
  }
}
