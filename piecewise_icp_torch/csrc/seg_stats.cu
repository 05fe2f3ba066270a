// K3: per-point neighbourhood statistics of the cell-sorted self-join.
//
// Replaces piecewise_icp_tpu/ops/seg_pallas.py:_seg_stats_kernel (reached
// via seg_stats from the fused device segmentation).  Per query:
//   * the squared adjacency radius t2 of its ~k-th neighbour, found by 3
//     rounds x 8 bins of histogram refinement over [0, h^2] (resolution
//     h^2 / 512; not an exact k-NN).  Bin edges are lo + step * b with
//     step = (hi - lo) / 8, a bin is "d2 <= edge", and when fewer than k
//     candidates lie within h the interval stays [0, h^2];
//   * the count of neighbours with d2 <= t2 and their query-centred sums
//     (sum d, sum d d^T with d = neighbour - query).
// Output row (16 floats): cnt, t2, sdx, sdy, sdz, sxx, syy, szz, sxy, sxz,
// syz, then zeros.  Masked queries get cnt 0, t2 = h^2 and zero sums.
//
// The TPU kernel evaluated a [128, 3072] distance block per tile in VMEM.
//
// Bound on the card: not bytes and not arithmetic (the 1.7 MB cloud of a
// 142k-point epoch lives in L2; a few microseconds of lane arithmetic) but
// the latency of the window walk: nine runs a query, each two dependent reads
// of the CSR array and then the points, repeated for each of the four passes
// (three histogram rounds, one sum pass).  The design reads every point once
// a cell and computes every distance once:
//
//  * a block takes a cell and stages its window's points in shared memory as
//    a structure of arrays (common.cuh, as K2 does); the queries of the cell
//    are served from it, one warp a query;
//  * ONE pass computes the squared distances of a lane's candidates (window
//    positions congruent to its lane index) and keeps them in a row of
//    shared memory of its warp; the three histogram rounds and the sum pass
//    run over the kept values, with the edges and the comparisons of the
//    plain version (no bin index by division: t2 would move at bin edges).  A
//    lane reads only what it wrote, so the row needs no barrier.  (Sixteen
//    unrolled register slots a lane, of which a 159-point window fills
//    five, measured slower than the row and its loop over the window's
//    real length);
//  * the eight counts of a round are reduced by redux.sync, one instruction
//    each; the row leaves as one 64-byte store of 16 lanes;
//  * a window above kSegCap points (a crowded cell, or one that collects
//    points moved to the 1e30 sentinel) is walked from global memory by the
//    same kernel, a walk of the window for each of the four passes.
//
// The window of a query is that of the cell it was binned into (its CSR
// run), not of its current coordinates; the two are one cell for every live
// query, and a point moved to the sentinel in place is a masked query.
//
// Against the plain version: t2 and the counts are equal bit for bit (same
// float32 edges, same comparisons, integer counts).  The moment sums are
// taken in another order (a lane sums its candidates in rising position, the
// lanes meet in a fixed butterfly, so the bits are the same from run to run):
// they agree within 1e-5 of count * h (first moments) and count * h^2
// (second), the rounding of up to a few hundred float32 additions, and the
// normals within |n . n'| >= 1 - 1e-5.
#include "common.cuh"

namespace pwicp {

constexpr int kBins = 8;
constexpr int kRounds = 3;
constexpr int kStats = 16;
constexpr int kSegWarps = 4;  // queries served at a time by a block
constexpr int kSegThreads = kSegWarps * kWarp;
constexpr int kSegCap = 512;  // window points staged per block

// The interval [lo, hi] after one histogram round: the first bin whose
// cumulative warp-wide count reaches k.
__device__ __forceinline__ void refine(const int (&cnt)[kBins],
                                       const float (&edge)[kBins], int k,
                                       float* lo, float* hi) {
  bool found = false;
  float new_lo = *lo, new_hi = *hi, prev = *lo;
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    int c = __reduce_add_sync(kFull, cnt[b]);
    if (!found && c >= k) {
      new_lo = prev;
      new_hi = edge[b];
      found = true;
    }
    prev = edge[b];
  }
  if (found) {
    *lo = new_lo;
    *hi = new_hi;
  }
}

__device__ __forceinline__ void edges_of(float lo, float hi,
                                         float (&edge)[kBins]) {
  float step = __fdiv_rn(__fsub_rn(hi, lo), (float)kBins);
#pragma unroll
  for (int b = 0; b < kBins; ++b)
    edge[b] = __fadd_rn(lo, __fmul_rn(step, (float)(b + 1)));
}

// One neighbour's share of the sums; d = query - neighbour.
__device__ __forceinline__ void add_moments(float (&s)[9], float dx, float dy,
                                            float dz) {
  s[0] = __fsub_rn(s[0], dx);
  s[1] = __fsub_rn(s[1], dy);
  s[2] = __fsub_rn(s[2], dz);
  s[3] = __fadd_rn(s[3], __fmul_rn(dx, dx));
  s[4] = __fadd_rn(s[4], __fmul_rn(dy, dy));
  s[5] = __fadd_rn(s[5], __fmul_rn(dz, dz));
  s[6] = __fadd_rn(s[6], __fmul_rn(dx, dy));
  s[7] = __fadd_rn(s[7], __fmul_rn(dx, dz));
  s[8] = __fadd_rn(s[8], __fmul_rn(dy, dz));
}

// One query from the staged window: t2, the lane's count and sums.  d2row:
// this warp's row of kSegCap floats in shared memory; a lane reads only what
// it wrote there, so no barrier is needed.
__device__ __forceinline__ void stats_staged(const float* sx, const float* sy,
                                             const float* sz, float* d2row,
                                             int wn, float qx, float qy,
                                             float qz, int k, float h2,
                                             int lane, float* t2, int* n_in,
                                             float (&s)[9]) {
  for (int p = lane; p < wn; p += kWarp)
    d2row[p] = sqdist(qx, qy, qz, sx[p], sy[p], sz[p]);
  float lo = 0.0f, hi = h2;
  for (int r = 0; r < kRounds; ++r) {
    float edge[kBins];
    edges_of(lo, hi, edge);
    int cnt[kBins];
#pragma unroll
    for (int b = 0; b < kBins; ++b) cnt[b] = 0;
    for (int p = lane; p < wn; p += kWarp) {
      const float d2 = d2row[p];
#pragma unroll
      for (int b = 0; b < kBins; ++b) cnt[b] += d2 <= edge[b];
    }
    refine(cnt, edge, k, &lo, &hi);
  }
  *t2 = hi;
  int n = 0;
  for (int p = lane; p < wn; p += kWarp) {
    if (d2row[p] <= hi) {
      ++n;
      add_moments(s, __fsub_rn(qx, sx[p]), __fsub_rn(qy, sy[p]),
                  __fsub_rn(qz, sz[p]));
    }
  }
  *n_in = n;
}

// The same from global memory, a walk of the window for each pass.
__device__ __forceinline__ void stats_walked(const Runs& runs, int n_runs,
                                             const float* __restrict__ pts,
                                             float qx, float qy, float qz,
                                             int k, float h2, int lane,
                                             float* t2, int* n_in,
                                             float (&s)[9]) {
  float lo = 0.0f, hi = h2;
  for (int r = 0; r < kRounds; ++r) {
    float edge[kBins];
    edges_of(lo, hi, edge);
    int cnt[kBins];
#pragma unroll
    for (int b = 0; b < kBins; ++b) cnt[b] = 0;
    for_each_walked(runs, n_runs, lane, [&](int j) {
      float d2 = sqdist(qx, qy, qz, pts + 3 * (size_t)j);
#pragma unroll
      for (int b = 0; b < kBins; ++b) cnt[b] += d2 <= edge[b];
    });
    refine(cnt, edge, k, &lo, &hi);
  }
  *t2 = hi;
  int n = 0;
  for_each_walked(runs, n_runs, lane, [&](int j) {
    float dx, dy, dz;
    float d2 = sqdist(qx, qy, qz, pts + 3 * (size_t)j, &dx, &dy, &dz);
    if (d2 <= hi) {
      ++n;
      add_moments(s, dx, dy, dz);
    }
  });
  *n_in = n;
}

__global__ void __launch_bounds__(kSegThreads)
    seg_stats_kernel(Grid g, const uint8_t* __restrict__ q_mask, int k,
                     float h2, int* __restrict__ counter,
                     float* __restrict__ out) {
  __shared__ float sx[kSegCap], sy[kSegCap], sz[kSegCap];
  __shared__ float d2rows[kSegWarps][kSegCap];
  __shared__ CellFeed feed;
  const Runs& runs = feed.runs;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  CellCursor cur;
  int c;
  while (next_cell(g, counter, feed, cur, &c)) {
    const int qs = g.starts[c], qe = g.starts[c + 1];
    const int n_runs = cell_runs(g, c, feed.runs);
    const int wn = runs.off[n_runs];
    const bool staged = wn <= kSegCap;
    if (staged)
      for_each_staged(runs, n_runs, [&](int p, int j) {
        const float* t = g.pts + 3 * (size_t)j;
        sx[p] = t[0];
        sy[p] = t[1];
        sz[p] = t[2];
      });
    __syncthreads();

    for (int qi = qs + warp; qi < qe; qi += kSegWarps) {
      float t2 = h2;
      int n_in = 0;
      float s[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) s[i] = 0.0f;
      if (q_mask[qi]) {
        const float* qp = g.pts + 3 * (size_t)qi;
        const float qx = qp[0], qy = qp[1], qz = qp[2];
        if (staged)
          stats_staged(sx, sy, sz, d2rows[warp], wn, qx, qy, qz, k, h2, lane,
                       &t2, &n_in, s);
        else
          stats_walked(runs, n_runs, g.pts, qx, qy, qz, k, h2, lane, &t2,
                       &n_in, s);
      }
      n_in = __reduce_add_sync(kFull, n_in);
      float v = 0.0f;  // lane l ends with field l of the row
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        float t = warp_sum(s[i]);
        if (lane == i + 2) v = t;
      }
      if (lane == 0) v = (float)n_in;
      if (lane == 1) v = t2;
      if (lane < kStats) out[(size_t)qi * kStats + lane] = v;
    }
    __syncthreads();  // the window and the run table are no longer read
  }
}

}  // namespace pwicp

// The most window points a block stages in shared memory.
extern "C" int pwicp_seg_cap() { return pwicp::kSegCap; }

// counter: one int of scratch of this call (the cell hand-out), zeroed here.
extern "C" int pwicp_seg_stats(const uint8_t* q_mask, int k, float h2,
                               const float* pts, const int* starts,
                               int n_cells, float ox, float oy, float oz,
                               float h, int dx, int dy, int dz, int* counter,
                               float* out, void* stream) {
  using namespace pwicp;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_cells <= 0) return (int)cudaGetLastError();
  int blocks = 0;
  cudaError_t err =
      cell_blocks(seg_stats_kernel, kSegThreads, 0, n_cells, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  Grid g = make_grid(pts, starts, n_cells, ox, oy, oz, h, dx, dy, dz);
  seg_stats_kernel<<<blocks, kSegThreads, 0, st>>>(g, q_mask, k, h2, counter,
                                                   out);
  return (int)cudaGetLastError();
}
