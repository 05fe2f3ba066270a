// K4: one synchronous (Jacobi) round of seeded label propagation.
//
// Replaces piecewise_icp_tpu/ops/seg_pallas.py:_prop_round_kernel (reached
// via _prop_round / _propagate_all / propagate_rounds from the fused device
// segmentation).  Per query, among labelled candidates of its window:
//   * propagation mode: candidates with d2 <= the query's own t2, scored by
//     the VCCS metric m = 1 - |n_q . n_s| + ds * inv_res_04 with n_s and
//     ds the candidate's SEED normal and the distance to that seed;
//   * adopt mode (orphan sweep): candidates with d2 <= h^2, scored by
//     Euclidean distance; only unlabelled queries take the winner.
// The winner is the lexicographic arg-min of (m, label, index); its state
// row (seed xyz, seed normal) and label are copied.  A query without a
// winner writes zero seed fields and keeps its label.  Reads come from
// state_in only and writes go to state_out, so a round is Jacobi, like the
// reference; `changed` gains the number of queries whose label moved (one
// atomicAdd per block).  Labels ride as float32 (exact below 2^24).
//
// Bound on the card: gathers of candidate points (12 B) and state rows
// (32 B) through L2; a 142k-point cloud carries 1.7 MB of points and
// 4.5 MB of state, both resident in the 50 MB L2.  The <= 256-round loop
// runs on the host with one scalar read per round; a device-side loop or a
// CUDA graph is later work.
#include "common.cuh"

namespace pwicp {

__global__ void prop_round_kernel(Grid g, const float* __restrict__ qall,
                                  const uint8_t* __restrict__ q_mask, int nq,
                                  const float* __restrict__ state_in,
                                  float inv_res_04, float h2, int adopt,
                                  float* __restrict__ state_out,
                                  int* __restrict__ changed) {
  __shared__ int block_changed;
  if (threadIdx.x == 0) block_changed = 0;
  __syncthreads();

  int qi = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  int lane = threadIdx.x % kWarp;
  if (qi < nq) {  // warp-uniform
    float lab_own = state_in[(size_t)qi * 8 + 6];
    float bm = kBig, bl = kBig;
    int bj = kIMax;
    if (q_mask[qi]) {
      const float* qa = qall + (size_t)qi * 8;
      float qx = qa[0], qy = qa[1], qz = qa[2];
      float nx = qa[3], ny = qa[4], nz = qa[5], r2 = qa[6];
      Window w = window_of(g, qx, qy, qz);
      for_each_candidate(g, w, lane, [&](int j) {
        const float* st = state_in + (size_t)j * 8;
        float lab = st[6];
        if (!(lab >= 0.0f)) return;
        float d2 = sqdist(qx, qy, qz, g.pts + 3 * j);
        float m;
        if (adopt) {
          if (!(d2 <= h2)) return;
          m = __fsqrt_rn(d2);
        } else {
          if (!(d2 <= r2)) return;
          float dxs = __fsub_rn(qx, st[0]);
          float dys = __fsub_rn(qy, st[1]);
          float dzs = __fsub_rn(qz, st[2]);
          float ds = __fsqrt_rn(__fadd_rn(
              __fadd_rn(__fmul_rn(dxs, dxs), __fmul_rn(dys, dys)),
              __fmul_rn(dzs, dzs)));
          float dot = __fadd_rn(
              __fadd_rn(__fmul_rn(nx, st[3]), __fmul_rn(ny, st[4])),
              __fmul_rn(nz, st[5]));
          m = __fadd_rn(__fsub_rn(1.0f, fabsf(dot)), __fmul_rn(ds, inv_res_04));
        }
        if (m < bm || (m == bm && lab < bl)) {  // j increases per lane
          bm = m;
          bl = lab;
          bj = j;
        }
      });
    }
    // lexicographic (m, label, index) warp arg-min
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      float m2 = __shfl_xor_sync(kFull, bm, o);
      float l2 = __shfl_xor_sync(kFull, bl, o);
      int j2 = __shfl_xor_sync(kFull, bj, o);
      if (m2 < bm || (m2 == bm && (l2 < bl || (l2 == bl && j2 < bj)))) {
        bm = m2;
        bl = l2;
        bj = j2;
      }
    }
    bool upd = bm < kBig && (!adopt || lab_own < 0.0f);
    float new_lab = upd ? bl : lab_own;
    if (lane < 8) {
      float v;
      if (lane < 6)
        v = upd ? state_in[(size_t)bj * 8 + lane] : 0.0f;
      else if (lane == 6)
        v = new_lab;
      else
        v = 0.0f;
      state_out[(size_t)qi * 8 + lane] = v;
    }
    if (lane == 0 && new_lab != lab_own) atomicAdd(&block_changed, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_changed) atomicAdd(changed, block_changed);
}

}  // namespace pwicp

extern "C" int pwicp_prop_round(const float* qall, const uint8_t* q_mask,
                                int n, const float* state_in,
                                float inv_res_04, float h2, int adopt,
                                const float* pts, const int* starts,
                                int n_cells, float ox, float oy, float oz,
                                float h, int dx, int dy, int dz,
                                float* state_out, int* changed,
                                void* stream) {
  using namespace pwicp;
  if (n > 0) {
    Grid g = make_grid(pts, starts, n_cells, ox, oy, oz, h, dx, dy, dz);
    prop_round_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        g, qall, q_mask, n, state_in, inv_res_04, h2, adopt, state_out,
        changed);
  }
  return (int)cudaGetLastError();
}
