// K5: brute-force exact 1-NN of every query against the whole target cloud.
//
// Replaces piecewise_icp_tpu/ops/nn_pallas.py:_nn1_kernel (reached via
// nn1_pallas from percentile_c2c: auto DT-init once per pair, and the
// stage-1 exact-percentile fallback; also the brute overlap ratio of
// adaptive pair planning when no dense grid fits).  The TPU kernel kept the
// whole target row resident in VMEM and a [256, 2048] running-min scratch
// per query tile; here one thread owns one query and keeps its running
// minimum in registers, while the block stages the targets through shared
// memory one tile at a time.
//
// Bound on the card: FP32 ALU work.  Every query meets every target
// (2.0e10 distance evaluations at 142,884 x 142,884), about ten ALU
// instructions each; memory traffic is one read of the targets per block,
// and all threads of a block read the same shared-memory word at the same
// time (a broadcast, no bank conflicts).  The matmul identity would put the
// work on the tensor cores but loses ~1e-4 absolute at metre scale, so
// distances stay coordinate differences.
//
// Contract (ops/nn.py:nn1 and nn1_pallas): each thread scans the targets in
// ascending index with a strict <, so ties go to the lowest index.  Masked
// targets are loaded as the 1e30 sentinel, whose squared distance overflows
// to inf and is never accepted; a masked query, or one with no finite
// distance, gives (inf, -1).
#include "common.cuh"

namespace pwicp {

constexpr int kNn1Threads = 256;
constexpr int kNn1Tile = 2048;  // targets per shared-memory tile (24 KB)

__global__ void __launch_bounds__(kNn1Threads)
    nn1_brute_kernel(const float* __restrict__ q,
                     const uint8_t* __restrict__ q_mask, int nq,
                     const float* __restrict__ t,
                     const uint8_t* __restrict__ t_mask, int nt,
                     int* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ float sx[kNn1Tile];
  __shared__ float sy[kNn1Tile];
  __shared__ float sz[kNn1Tile];
  int qi = blockIdx.x * kNn1Threads + threadIdx.x;
  bool active = qi < nq && (q_mask == nullptr || q_mask[qi]);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  float best = INFINITY;
  int bi = -1;
  for (int base = 0; base < nt; base += kNn1Tile) {
    int cnt = min(kNn1Tile, nt - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < cnt; j += kNn1Threads) {
      int g = base + j;
      bool ok = t_mask == nullptr || t_mask[g];
      sx[j] = ok ? t[3 * g] : kBig;
      sy[j] = ok ? t[3 * g + 1] : kBig;
      sz[j] = ok ? t[3 * g + 2] : kBig;
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < cnt; ++j) {
        float d2 = sqdist(qx, qy, qz, sx[j], sy[j], sz[j]);
        if (d2 < best) {
          best = d2;
          bi = base + j;
        }
      }
    }
  }
  if (qi < nq) {
    out_d2[qi] = best;
    out_idx[qi] = bi;
  }
}

}  // namespace pwicp

extern "C" int pwicp_nn1_brute(const float* q, const uint8_t* q_mask, int nq,
                               const float* t, const uint8_t* t_mask, int nt,
                               int* out_idx, float* out_d2, void* stream) {
  using namespace pwicp;
  if (nq > 0) {
    int blocks = (nq + kNn1Threads - 1) / kNn1Threads;
    nn1_brute_kernel<<<blocks, kNn1Threads, 0, (cudaStream_t)stream>>>(
        q, q_mask, nq, t, t_mask, nt, out_idx, out_d2);
  }
  return (int)cudaGetLastError();
}
