// K2: exact k nearest neighbours (k <= 32) within the 27-cell window,
// ascending squared distance, ties to the lowest sorted index.
//
// Replaces piecewise_icp_tpu/ops/nn_pallas.py:_knn3_kernel (reached via
// grid_knn_sorted from the SOR statistic, ops/preprocess.py:
// _sor_mask_sorted, k + 1 = 15 on the main path).  The TPU kernel DMA'd
// three x-slab ranges per 128-query tile and peeled the k nearest off a
// [128, 3072] distance block by k min-extraction passes; here one warp
// serves one query and runs k rounds of a warp arg-min over its window,
// each round taking the lexicographically smallest (d2, index) above the
// previous round's pick.  Empty slots get d2 = inf and index -1; targets at
// the 1e30 sentinel (d2 = inf) are never candidates.
//
// Bound on the card: the k re-walks of the window.  Each round re-reads the
// query's ~300 candidates (3.6 KB) from L1/L2 rather than device memory; the
// 142k-point cloud (1.7 MB) stays resident in the 50 MB L2.  Caching the
// candidates' distances in shared memory is later work.
#include "common.cuh"

namespace pwicp {

__global__ void knn_sorted_kernel(Grid g, const float* __restrict__ q,
                                  const uint8_t* __restrict__ q_mask, int nq,
                                  int k, int* __restrict__ out_idx,
                                  float* __restrict__ out_d2) {
  int qi = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  int lane = threadIdx.x % kWarp;
  if (qi >= nq) return;  // warp-uniform
  bool active = q_mask[qi] != 0;
  float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  Window w = window_of(g, qx, qy, qz);
  float pd = -INFINITY;
  int pi = -1;
  for (int r = 0; r < k; ++r) {
    float bd = INFINITY;
    int bi = kIMax;
    if (active && pi != kIMax) {
      for_each_candidate(g, w, lane, [&](int j) {
        float d2 = sqdist(qx, qy, qz, g.pts + 3 * j);
        bool after = d2 > pd || (d2 == pd && j > pi);
        if (d2 < INFINITY && after && (d2 < bd || (d2 == bd && j < bi))) {
          bd = d2;
          bi = j;
        }
      });
    }
    warp_argmin(bd, bi);
    if (lane == 0) {
      out_d2[(size_t)qi * k + r] = bd;
      out_idx[(size_t)qi * k + r] = bi == kIMax ? -1 : bi;
    }
    pd = bd;
    pi = bi;
  }
}

}  // namespace pwicp

extern "C" int pwicp_knn_sorted(const float* q, const uint8_t* q_mask, int nq,
                                int k, const float* pts, const int* starts,
                                int n_cells, float ox, float oy, float oz,
                                float h, int dx, int dy, int dz, int* out_idx,
                                float* out_d2, void* stream) {
  using namespace pwicp;
  if (nq > 0) {
    Grid g = make_grid(pts, starts, n_cells, ox, oy, oz, h, dx, dy, dz);
    knn_sorted_kernel<<<n_blocks(nq), kThreads, 0, (cudaStream_t)stream>>>(
        g, q, q_mask, nq, k, out_idx, out_d2);
  }
  return (int)cudaGetLastError();
}
