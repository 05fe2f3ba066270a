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
// The TPU kernel evaluated a [128, 3072] distance block per tile in VMEM;
// here a warp re-walks its query's window four times (3 histogram rounds,
// 1 sum pass), each lane holding 8 bin counters in registers, and reduces
// with warp shuffles.
//
// Bound on the card: the four window walks, served from L2 (the 1.7 MB
// cloud of a 142k-point epoch stays resident in the 50 MB L2).
#include "common.cuh"

namespace pwicp {

constexpr int kBins = 8;
constexpr int kRounds = 3;
constexpr int kStats = 16;

__global__ void seg_stats_kernel(Grid g, const uint8_t* __restrict__ q_mask,
                                 int nq, int k, float h2,
                                 float* __restrict__ out) {
  int qi = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  int lane = threadIdx.x % kWarp;
  if (qi >= nq) return;  // warp-uniform
  float* row = out + (size_t)qi * kStats;
  if (!q_mask[qi]) {
    if (lane < kStats) row[lane] = lane == 1 ? h2 : 0.0f;
    return;
  }
  const float* qp = g.pts + 3 * qi;
  float qx = qp[0], qy = qp[1], qz = qp[2];
  Window w = window_of(g, qx, qy, qz);

  float lo = 0.0f, hi = h2;
  for (int r = 0; r < kRounds; ++r) {
    float step = __fdiv_rn(__fsub_rn(hi, lo), (float)kBins);
    float edge[kBins];
#pragma unroll
    for (int b = 0; b < kBins; ++b)
      edge[b] = __fadd_rn(lo, __fmul_rn(step, (float)(b + 1)));
    int cnt[kBins];
#pragma unroll
    for (int b = 0; b < kBins; ++b) cnt[b] = 0;
    for_each_candidate(g, w, lane, [&](int j) {
      float d2 = sqdist(qx, qy, qz, g.pts + 3 * j);
#pragma unroll
      for (int b = 0; b < kBins; ++b) cnt[b] += d2 <= edge[b];
    });
    bool found = false;
    float new_lo = lo, new_hi = hi, prev = lo;
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      int c = warp_sum(cnt[b]);
      if (!found && c >= k) {
        new_lo = prev;
        new_hi = edge[b];
        found = true;
      }
      prev = edge[b];
    }
    if (found) {
      lo = new_lo;
      hi = new_hi;
    }
  }

  float t2 = hi;
  float s[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) s[i] = 0.0f;
  for_each_candidate(g, w, lane, [&](int j) {
    float dx, dy, dz;
    float d2 = sqdist(qx, qy, qz, g.pts + 3 * j, &dx, &dy, &dz);
    if (d2 <= t2) {
      s[0] = __fadd_rn(s[0], 1.0f);
      s[1] = __fsub_rn(s[1], dx);
      s[2] = __fsub_rn(s[2], dy);
      s[3] = __fsub_rn(s[3], dz);
      s[4] = __fadd_rn(s[4], __fmul_rn(dx, dx));
      s[5] = __fadd_rn(s[5], __fmul_rn(dy, dy));
      s[6] = __fadd_rn(s[6], __fmul_rn(dz, dz));
      s[7] = __fadd_rn(s[7], __fmul_rn(dx, dy));
      s[8] = __fadd_rn(s[8], __fmul_rn(dx, dz));
      s[9] = __fadd_rn(s[9], __fmul_rn(dy, dz));
    }
  });
#pragma unroll
  for (int i = 0; i < 10; ++i) s[i] = warp_sum(s[i]);
  if (lane == 0) {
    row[0] = s[0];
    row[1] = t2;
#pragma unroll
    for (int i = 1; i < 10; ++i) row[i + 1] = s[i];
#pragma unroll
    for (int i = 11; i < kStats; ++i) row[i] = 0.0f;
  }
}

}  // namespace pwicp

extern "C" int pwicp_seg_stats(const uint8_t* q_mask, int n, int k, float h2,
                               const float* pts, const int* starts,
                               int n_cells, float ox, float oy, float oz,
                               float h, int dx, int dy, int dz, float* out,
                               void* stream) {
  using namespace pwicp;
  if (n > 0) {
    Grid g = make_grid(pts, starts, n_cells, ox, oy, oz, h, dx, dy, dz);
    seg_stats_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        g, q_mask, n, k, h2, out);
  }
  return (int)cudaGetLastError();
}
