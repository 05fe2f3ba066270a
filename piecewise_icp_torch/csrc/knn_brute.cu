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
// What costs more than that is the upkeep of the sorted list.  A list a
// thread (a compare-and-swap pass of 2 L - 1 dependent instructions a
// candidate that enters) costs its warp a pass whenever ONE lane inserts,
// and a list a split of the targets starts empty in every split: the
// rescue's 4,096 queries met 32 splits, each list refilled 32 times, and a
// bound shared between the splits cut the insertions by a third only (each
// split still fills its own K entries).  So the list of a query is kept by
// a warp:
//
//  * a warp serves Q queries; the K smallest distances of each are spread
//    over its lanes, lane i holding the i-th, ascending (K <= 32).  Every
//    lane scans other targets for the same queries and the warp shares one
//    threshold a query, the list's K-th: a candidate is offered only when
//    below it.  A step (four targets a lane) computes every query's
//    distances, tests each group of four with three fminf and one compare,
//    then votes once: the common path has one branch for 4 Q pairs a lane
//    and keeps no distance past it.  When a lane's group passes, the warp
//    computes that step's distances again and takes the lane's candidates
//    (shuffles); one entering shifts the lanes above its place up by one (a
//    shuffle up and two selects).  Insertions are the warp's together,
//    never one lane's, and the list never restarts;
//  * targets are laid out once per call by a pre-pass as a structure of
//    arrays, each tile a strided sample of the whole cloud (tile t holds
//    targets t, t + n_tiles, t + 2 n_tiles, ...) in bit-reversed order: a
//    scan meets the cloud coarse to fine, so the K-th falls fast and later
//    groups rarely pass (in the file's order a scan approaches a query row
//    by row, most groups pass, and the kernel ran 2 to 6 times slower).
//    Masked targets and the tail padding are NaN (never less than
//    anything, so never a neighbour, whatever the query);
//    tiles are staged with cp.async into a ring of kKnnStages in shared
//    memory (one barrier a tile; 2 and 4 stages time within 2% of 3) and
//    shared by every warp of the block;
//  * a warp issues about one instruction in 10 to 12 cycles here, so the
//    kernel's rate follows the warps resident on an SM (4 blocks of 8 at
//    64 registers).  The layout gives a warp Q = kKnnQpw queries where that
//    still makes kKnnWantBlocks blocks (about one wave), else 3, else 2
//    (instantiations of the kernel); where even 2 do not, the warps of a
//    block split each tile into slices (2, 4 ... kKnnBruteWarps) and serve
//    fewer queries, each by a group of warps: the group shares a pruning
//    bound a query in shared memory (every warp atomicMin's its threshold
//    into it after a tile and takes the minimum before the next), and at
//    the end its first warp merges the others' lists, each ascending, so a
//    list is read only while it lowers the K-th.  One launch scans, merges
//    and writes the epilogue; the pre-pass is the other;
//  * the epilogue: the K squared distances, their square roots, or the
//    SOR mean.  Nothing over [Q, K] runs after it.
//
// Why the shared bound keeps the result exact.  Let t* be the query's true
// K-th smallest distance.  Every list holds distances of the query (and the
// sentinel), so every list's K-th, and so the bound, is >= t* at all times:
// every distance below t* passes and enters some list, and it is never
// pushed out of that list's K entries (that would take K smaller
// distances).  Copies of t* itself: if a list's K-th or the bound ever
// equals t*, the list that published it held K values <= t* then and holds
// them at the end; otherwise every copy of t* entered some list.  Either way
// the lists hold every value below t* and enough copies of t*, so the
// merge's K smallest are the true multiset.  The lists hold values only, so
// the merge is order-free and the bits depend neither on the slices, the
// layout nor the order in which lanes are taken.
//
// Contract (the plain version, ops/nn_cuda.py:knn_brute_plain: chunked
// sqdist + torch.topk): the multiset of the K smallest squared distances;
// masked targets and any d2 >= 1e30 (the sentinel's) are not neighbours;
// slots left empty hold +inf.  A list starts at 1e30 and a candidate
// enters only when strictly below its K-th, so a d2 at or above the
// sentinel, or NaN, never enters; an equal value does not change the
// multiset.  sqrtf and the division are IEEE correctly rounded (no
// --use_fast_math), as torch.sqrt and torch.div round on the CPU.
//
// kKnnTally = 1 builds a counting variant (chip_smoke.py --sweep): each
// call prints one line of candidates met (pairs), the queries' steps at
// which a group passed the test, the insertions, the SMs the blocks ran
// on, and the blocks' mean duration beside the kernel's span.
#include <algorithm>
#include <cstdio>

#include "common.cuh"

namespace pwicp {

constexpr int kKnnBruteWarps = 8;   // warps a block
constexpr int kKnnQpw = 4;          // queries a warp, at most (2 to 4)
constexpr int kKnnTile = 1024;      // targets a shared-memory tile (12 KB)
constexpr int kKnnStages = 3;       // tiles in the ring (cp.async ahead)
constexpr int kKnnWantBlocks = 480;  // about a wave: 132 SMs x 4 blocks
constexpr int kKnnTally = 0;        // 1: count, and print a line a call
constexpr int kKnnMaxK = 32;
constexpr int kKnnBruteThreads = kKnnBruteWarps * 32;
constexpr int kKnnMinBlocks = 4;    // blocks an SM (4: <= 64 registers)

constexpr int knn_log2(int v) { return v <= 1 ? 0 : 1 + knn_log2(v / 2); }
constexpr int kKnnTileBits = knn_log2(kKnnTile);
static_assert((kKnnTile & (kKnnTile - 1)) == 0 && kKnnTile >= 128,
              "a tile is a power of two");
static_assert(kKnnQpw >= 2 && kKnnQpw <= 4, "2 to 4 queries a warp");
static_assert((kKnnBruteWarps & (kKnnBruteWarps - 1)) == 0 &&
                  kKnnTile / 4 / kKnnBruteWarps % 32 == 0,
              "a power of two of warps, each slice whole steps of 32 lanes");

enum KnnOut { kOutD2 = 0, kOutDist = 1, kOutSorMean = 2 };

// candidates (pairs), the queries' steps at which a group passed,
// insertions, the blocks' summed duration (ns), the first start and the
// last end (ns); blocks done and blocks an SM (kKnnTally only)
__device__ unsigned long long g_knn_tally[6] = {0, 0, 0, 0, ~0ull, 0};
__device__ unsigned int g_knn_blocks_done;
__device__ unsigned int g_knn_sm_blocks[256];

__device__ __forceinline__ unsigned long long knn_clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct KnnLayout {
  int n_tiles, qpw, slices, block_queries, blocks;
  size_t soa;  // words of scratch
};

// A call's layout: target tiles (at least one, so a call without targets
// scans NaN and writes empty slots); the queries a warp, the most (down to
// 2) that still give kKnnWantBlocks blocks, since a warp issues seldom and
// the card wants its 4 blocks an SM; where even 2 do not, the slices of a
// tile (the warps that share a query: each refills a list); the queries a
// block and the blocks.  The scratch is the targets' structure of arrays
// [3][n_tiles * kKnnTile].  Pure arithmetic, so the wrapper's allocation
// and the launch agree.
inline KnnLayout knn_layout(int nq, int nt) {
  KnnLayout l;
  l.n_tiles = std::max(1, (nt + kKnnTile - 1) / kKnnTile);
  auto blocks = [&](int qpw, int slices) {
    int per = qpw * kKnnBruteWarps / slices;
    return (nq + per - 1) / per;
  };
  l.qpw = kKnnQpw;
  while (l.qpw > 2 && blocks(l.qpw, 1) < kKnnWantBlocks) --l.qpw;
  l.slices = 1;
  while (l.slices < kKnnBruteWarps && blocks(l.qpw, l.slices) < kKnnWantBlocks)
    l.slices *= 2;
  l.block_queries = l.qpw * kKnnBruteWarps / l.slices;
  l.blocks = blocks(l.qpw, l.slices);
  l.soa = 3 * (size_t)l.n_tiles * kKnnTile;
  return l;
}

// Put v (< the K-th) into the warp's ascending list: lane i holds the i-th
// entry; the lanes from v's place up take their lower neighbour's entry.
__device__ __forceinline__ void knn_insert(float& list, float v, int lane) {
  const float below = __shfl_up_sync(kFull, list, 1);
  list = list <= v ? list : (lane == 0 || below <= v ? v : below);
}

// The candidates of the lanes in `hit`, one lane at a time: those below
// the threshold enter the list, and the threshold then follows the list's
// K-th.  A candidate that the ones before it pushed past the K-th lands
// beyond lane K - 1, which nothing reads (with K = 32, nowhere).  The
// distances are computed again here, so that the common path keeps none
// of them past its vote.
__device__ __forceinline__ void knn_take(unsigned hit, float qx, float qy,
                                         float qz, float4 x, float4 y,
                                         float4 z, float& list, float& thr,
                                         int k, int lane,
                                         unsigned long long& ins) {
  const float d[4] = {sqdist(qx, qy, qz, x.x, y.x, z.x),
                      sqdist(qx, qy, qz, x.y, y.y, z.y),
                      sqdist(qx, qy, qz, x.z, y.z, z.z),
                      sqdist(qx, qy, qz, x.w, y.w, z.w)};
  while (hit) {
    const int src = __ffs(hit) - 1;
    hit &= hit - 1;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __shfl_sync(kFull, d[u], src);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (v[u] < thr) {
        knn_insert(list, v[u], lane);
        if (kKnnTally) ++ins;
      }
    }
    thr = fminf(thr, __shfl_sync(kFull, list, k - 1));
  }
}

// Pre-pass: the targets as a structure of arrays, masked and padding
// entries NaN; position i = tile * kKnnTile + s holds target
// rev(s) * n_tiles + tile, a bijection on the padded range.
__global__ void knn_prepare(const float* __restrict__ t,
                            const uint8_t* __restrict__ t_mask, int nt,
                            int n_tiles, float* __restrict__ soa) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nt_pad = n_tiles * kKnnTile;
  if (i >= nt_pad) return;
  const unsigned s = (unsigned)(i % kKnnTile);
  const int j =
      (int)(__brev(s) >> (32 - kKnnTileBits)) * n_tiles + i / kKnnTile;
  const bool ok = j < nt && (t_mask == nullptr || t_mask[j]);
  const float nan = __int_as_float(0x7fc00000);
  soa[i] = ok ? t[3 * (size_t)j] : nan;
  soa[(size_t)nt_pad + i] = ok ? t[3 * (size_t)j + 1] : nan;
  soa[2 * (size_t)nt_pad + i] = ok ? t[3 * (size_t)j + 2] : nan;
}

__device__ __forceinline__ void knn_cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// The epilogue over a warp's list (lane i the i-th of K entries).  A value
// >= 1e30 is an empty slot (+inf out).
//   kOutD2, kOutDist: out[q][i] = d2, or sqrtf(d2), i < K.
//   kOutSorMean: out[q] = the mean distance to the K-1 nearest non-self
//     neighbours (the query itself sits at rank 1, distance 0): for each
//     run of c equal values v, acc = acc + c * sqrtf(v) in ascending order,
//     then acc / max(rank - 1, 1) with rank the number of filled slots; the
//     float32 operations, in their order, of chunk_means.
__device__ __forceinline__ void knn_epilogue(float list, int k, int mode,
                                             int qi, int lane,
                                             float* __restrict__ out) {
  if (mode == kOutSorMean) {
    float acc = 0.f, rank = 0.f, run = 0.f;
    for (int i = 0; i < k; ++i) {  // every lane alike
      const float v = __shfl_sync(kFull, list, i);
      const float next = __shfl_sync(kFull, list, min(i + 1, 31));
      if (v < kBig) {
        run = __fadd_rn(run, 1.f);
        if (i + 1 == k || !(next == v)) {
          acc = __fadd_rn(acc, __fmul_rn(run, __fsqrt_rn(v)));
          rank = __fadd_rn(rank, run);
          run = 0.f;
        }
      }
    }
    if (lane == 0) out[qi] = __fdiv_rn(acc, fmaxf(__fsub_rn(rank, 1.f), 1.f));
    return;
  }
  if (lane < k) {
    const float v = list < kBig ? list : INFINITY;
    out[(size_t)qi * k + lane] = mode == kOutDist ? __fsqrt_rn(v) : v;
  }
}

// A block: kKnnBruteWarps warps, in groups of `slices` warps; a group serves
// Q queries, its warps taking slices of every tile; the group's first warp
// merges the lists and writes the epilogue.
template <int Q>
__global__ void __launch_bounds__(kKnnBruteThreads, kKnnMinBlocks)
    knn_brute_kernel(const float* __restrict__ q, int nq,
                     const float* __restrict__ soa, int n_tiles, int slices,
                     int k, int mode, float* __restrict__ out) {
  extern __shared__ __align__(16) float ring[];  // [kKnnStages][3][tile]
  __shared__ float lists[kKnnBruteWarps][Q][32];  // the merge's input
  __shared__ int bound[kKnnBruteWarps * Q];        // [group][query]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = warp / slices, slice = warp % slices;
  const size_t nt_pad = (size_t)n_tiles * kKnnTile;
  // steps of 32 float4 groups a slice takes in a tile (whole steps: no
  // slice outnumbers kKnnBruteWarps)
  const int steps = kKnnTile / 128 / slices;
  const int f0 = slice * steps * 32 + lane;

  int qi[Q];
  float qx[Q], qy[Q], qz[Q], list[Q], thr[Q];
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    qi[r] = (blockIdx.x * (kKnnBruteWarps / slices) + group) * Q + r;
    const float nan = __int_as_float(0x7fc00000);
    const bool live = qi[r] < nq;  // a dead query has NaN coordinates
    qx[r] = live ? q[3 * (size_t)qi[r]] : nan;
    qy[r] = live ? q[3 * (size_t)qi[r] + 1] : nan;
    qz[r] = live ? q[3 * (size_t)qi[r] + 2] : nan;
    list[r] = kBig;
    thr[r] = kBig;
  }
  if (tid < kKnnBruteWarps * Q) bound[tid] = __float_as_int(kBig);
  unsigned long long n_cand = 0, n_hit = 0, n_ins = 0;
  const unsigned long long t_start = kKnnTally ? knn_clock_ns() : 0;

  // tile ti into its slot of the ring; a group is committed in any case,
  // so that wait_group counts the same at the tail
  auto stage = [&](int ti) {
    constexpr int kPieces = kKnnTile / 4;  // 16-byte pieces a coordinate
    if (ti < n_tiles) {
      float* slot = ring + (ti % kKnnStages) * 3 * kKnnTile;
      for (int i = tid; i < 3 * kPieces; i += kKnnBruteThreads) {
        int c = i / kPieces, w = i % kPieces;
        knn_cp_async16(slot + c * kKnnTile + 4 * w,
                       soa + c * nt_pad + (size_t)ti * kKnnTile + 4 * w);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int ti = 0; ti < kKnnStages - 1; ++ti) stage(ti);
  for (int ti = 0; ti < n_tiles; ++ti) {
    // this thread's pieces of tile ti have landed ...
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kKnnStages - 2)
                 : "memory");
    // ... and everyone's; every warp is done with tile ti - 1, whose slot
    // takes tile ti + kKnnStages - 1; the bound's updates are in
    __syncthreads();
    stage(ti + kKnnStages - 1);
    if (slices > 1) {
#pragma unroll
      for (int r = 0; r < Q; ++r)
        thr[r] = fminf(thr[r], __int_as_float(bound[group * Q + r]));
    }
    const float4* sx =
        reinterpret_cast<const float4*>(ring + (ti % kKnnStages) * 3 *
                                                   kKnnTile) + f0;
    const float4* sy = sx + kKnnTile / 4;
    const float4* sz = sy + kKnnTile / 4;
    // every query's distances of a step before one vote: the common path
    // has one branch for 4 * Q pairs a lane, and its chains
    // interleave
#pragma unroll 2
    for (int st = 0; st < steps; ++st) {
      const float4 x = sx[32 * st], y = sy[32 * st], z = sz[32 * st];
      bool pass[Q], any = false;
#pragma unroll
      for (int r = 0; r < Q; ++r) {
        // NaN drops out of fminf, and NaN < thr is false
        pass[r] = fminf(fminf(sqdist(qx[r], qy[r], qz[r], x.x, y.x, z.x),
                              sqdist(qx[r], qy[r], qz[r], x.y, y.y, z.y)),
                        fminf(sqdist(qx[r], qy[r], qz[r], x.z, y.z, z.z),
                              sqdist(qx[r], qy[r], qz[r], x.w, y.w, z.w))) <
                  thr[r];
        any = any || pass[r];
        if (kKnnTally && qi[r] < nq) n_cand += 128;
      }
      if (__any_sync(kFull, any)) {
#pragma unroll
        for (int r = 0; r < Q; ++r) {
          const unsigned hit = __ballot_sync(kFull, pass[r]);
          if (hit) {
            if (kKnnTally) ++n_hit;
            knn_take(hit, qx[r], qy[r], qz[r], x, y, z, list[r], thr[r], k,
                     lane, n_ins);
          }
        }
      }
    }
    if (slices > 1) {
#pragma unroll
      for (int r = 0; r < Q; ++r)
        if (lane == 0)
          atomicMin(&bound[group * Q + r], __float_as_int(thr[r]));
    }
  }
  __syncthreads();  // the bound's last updates, and the ring, are done

  if (kKnnTally) {
    if (lane == 0) {
      atomicAdd(&g_knn_tally[0], n_cand);
      atomicAdd(&g_knn_tally[1], n_hit);
      atomicAdd(&g_knn_tally[2], n_ins);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const unsigned long long t_end = knn_clock_ns();
      unsigned smid;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
      atomicAdd(&g_knn_sm_blocks[smid & 255], 1u);
      atomicAdd(&g_knn_tally[3], t_end - t_start);
      atomicMin(&g_knn_tally[4], t_start);
      atomicMax(&g_knn_tally[5], t_end);
      __threadfence();
    }
    if (tid == 0 && atomicAdd(&g_knn_blocks_done, 1u) + 1 == gridDim.x) {
      __threadfence();
      unsigned long long n[6];
      for (int i = 0; i < 6; ++i)
        n[i] = atomicExch(&g_knn_tally[i], i == 4 ? ~0ull : 0ull);
      unsigned sms = 0, most = 0;
      for (int i = 0; i < 256; ++i) {
        const unsigned b = atomicExch(&g_knn_sm_blocks[i], 0u);
        sms += b > 0;
        most = max(most, b);
      }
      g_knn_blocks_done = 0;
      printf("knn_tally nq %d n_tiles %d k %d blocks %d slices %d: "
             "candidates %llu hit_steps %llu inserts %llu; SMs %u, blocks "
             "an SM at most %u, mean block %llu ns, span %llu ns\n",
             nq, n_tiles, k, (int)gridDim.x, slices, n[0], n[1], n[2], sms,
             most, n[3] / gridDim.x, n[5] - n[4]);
    }
  }

  if (slices > 1) {
#pragma unroll
    for (int r = 0; r < Q; ++r) lists[warp][r][lane] = list[r];
    __syncthreads();
    if (slice != 0) return;  // warp-uniform; no barrier follows
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      for (int s = 1; s < slices; ++s) {
        for (int i = 0; i < k; ++i) {
          const float v = lists[warp + s][r][i];
          if (!(v < __shfl_sync(kFull, list[r], k - 1))) break;
          knn_insert(list[r], v, lane);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < Q; ++r)
    if (qi[r] < nq) knn_epilogue(list[r], k, mode, qi[r], lane, out);
}

template <int Q>
int knn_launch(const float* q, int nq, const float* soa, const KnnLayout& l,
               int k, int mode, float* out, cudaStream_t st) {
  constexpr int kRingBytes = kKnnStages * 3 * kKnnTile * 4;
  if (kRingBytes > 48 * 1024) {
    // above 48 KB only by this attribute (set for the current device)
    cudaError_t e = cudaFuncSetAttribute(
        knn_brute_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRingBytes);
    if (e != cudaSuccess) return (int)e;
  }
  knn_brute_kernel<Q><<<l.blocks, kKnnBruteThreads, kRingBytes, st>>>(
      q, nq, soa, l.n_tiles, l.slices, k, mode, out);
  return (int)cudaGetLastError();
}

}  // namespace pwicp

// Words of scratch a call needs (see knn_layout); -1 for an invalid shape.
extern "C" int pwicp_knn_brute_cap(int nq, int nt, int k) {
  using namespace pwicp;
  if (nq < 0 || nt < 0 || k < 1 || k > kKnnMaxK) return -1;
  KnnLayout l = knn_layout(nq, nt);
  return l.soa > 0x7fffffff ? -1 : (int)l.soa;
}

// The layout a call of this shape launches (knn_layout): out[0..5] = target
// tiles, queries a warp, warps sharing a query (slices), queries a block,
// blocks, warps a block.  0, or -1 for an invalid shape.
extern "C" int pwicp_knn_brute_layout(int nq, int nt, int k, int* out) {
  using namespace pwicp;
  if (pwicp_knn_brute_cap(nq, nt, k) < 0) return -1;
  KnnLayout l = knn_layout(nq, nt);
  out[0] = l.n_tiles;
  out[1] = l.qpw;
  out[2] = l.slices;
  out[3] = l.block_queries;
  out[4] = l.blocks;
  out[5] = kKnnBruteWarps;
  return 0;
}

// q [nq, 3], t [nt, 3] float32; t_mask [nt] bytes or nullptr; k = K slots
// (1..32); mode 0: out [nq, k] squared distances, 1: out [nq, k]
// distances, 2: out [nq] SOR means.  scratch holds scratch_floats >=
// pwicp_knn_brute_cap(nq, nt, k) 4-byte words of this call.  Two launches:
// the pre-pass, then the scan with its merge and epilogue.
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
  KnnLayout l = knn_layout(nq, nt);
  int nt_pad = l.n_tiles * kKnnTile;
  knn_prepare<<<(nt_pad + 255) / 256, 256, 0, st>>>(t, t_mask, nt, l.n_tiles,
                                                    scratch);
  switch (l.qpw) {
    case 4:
      return knn_launch<4>(q, nq, scratch, l, k, mode, out, st);
    case 3:
      return knn_launch<3>(q, nq, scratch, l, k, mode, out, st);
    default:
      return knn_launch<2>(q, nq, scratch, l, k, mode, out, st);
  }
}
