// K1: exact 1-NN of moving queries among cell-sorted targets, within the
// 27-cell window.
//
// Replaces piecewise_icp_tpu/ops/nn_pallas.py:_range_nn_kernel (reached via
// grid_range_query / grid_query_1nn from the stage-1 percentile of every
// Piecewise-ICP iteration).  The TPU kernel DMA'd one <= 8192-point slab per
// 256-query tile into VMEM and reported tiles whose window union overflowed
// the slab as uncovered; here each query walks its own window, so every
// query is covered and the result is exact (`strict` is always true).
//
// Bound on the card: gathers from device memory through L2.  A 142k-point
// target cloud is 1.7 MB and sits in the 50 MB L2 after the first touch;
// a query reads ~9 short runs of ~30 points.  Lanes stride over each run so
// a warp's loads of one run coalesce; the arithmetic (8 flops a candidate)
// is negligible.
#include "common.cuh"

namespace pwicp {

__global__ void range_nn1_kernel(Grid g, const float* __restrict__ q,
                                 const uint8_t* __restrict__ q_mask, int nq,
                                 int* __restrict__ out_idx,
                                 float* __restrict__ out_d2) {
  int qi = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  int lane = threadIdx.x % kWarp;
  if (qi >= nq) return;  // warp-uniform
  float best = INFINITY;
  int bi = kIMax;
  if (q_mask[qi]) {
    float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
    Window w = window_of(g, qx, qy, qz);
    for_each_candidate(g, w, lane, [&](int j) {
      float d2 = sqdist(qx, qy, qz, g.pts + 3 * j);
      if (d2 < best) {  // per lane j increases: first occurrence kept
        best = d2;
        bi = j;
      }
    });
  }
  warp_argmin(best, bi);
  if (lane == 0) {
    out_d2[qi] = best;
    out_idx[qi] = bi == kIMax ? -1 : bi;
  }
}

}  // namespace pwicp

extern "C" int pwicp_range_nn1(const float* q, const uint8_t* q_mask, int nq,
                               const float* pts, const int* starts,
                               int n_cells, float ox, float oy, float oz,
                               float h, int dx, int dy, int dz, int* out_idx,
                               float* out_d2, void* stream) {
  using namespace pwicp;
  if (nq > 0) {
    Grid g = make_grid(pts, starts, n_cells, ox, oy, oz, h, dx, dy, dz);
    range_nn1_kernel<<<n_blocks(nq), kThreads, 0, (cudaStream_t)stream>>>(
        g, q, q_mask, nq, out_idx, out_d2);
  }
  return (int)cudaGetLastError();
}
