// K1: exact 1-NN of moving queries among cell-sorted targets, within the
// 27-cell window, with the epilogue its callers need.
//
// Replaces piecewise_icp_tpu/ops/nn_pallas.py:_range_nn_kernel (reached via
// grid_range_query / grid_query_1nn from the stage-1 percentile of every
// Piecewise-ICP iteration and from adaptive planning).  The TPU kernel DMA'd
// one <= 8192-point slab per 256-query tile into VMEM and reported tiles
// whose window union overflowed the slab as uncovered; here each query meets
// its own window, so every query is covered and the result is exact
// (`strict` is always true).
//
// Bound on the card: neither bytes (a 142k-point target cloud is 1.7 MB and
// sits in L1/L2 after the first touch) nor arithmetic (9 lane instructions a
// candidate), but the latency of dependent loads and the instructions spent
// around each candidate.  The design:
//  * a sub-warp of kRangeLanes lanes a query.  A stage-1 window holds about
//    120 candidates: with 4 lanes a query a warp serves eight queries at
//    once, a window is a few full batches a lane and no lane idles in its
//    tail.  Measured on an H100 at 1 to 32 lanes, 4 is the fastest at both
//    of the main path's shapes (about 120 and 750 candidates a window);
//  * the window flattened.  Every lane reads all 18 run bounds of its query
//    in one round of independent loads (the addresses are the same across a
//    sub-warp: one transaction each), prefix-sums the run lengths in
//    registers, and the sub-warp leaves a 9-entry table (end position of
//    the run, sorted index minus window position) in shared memory.  The
//    lanes then stride over window POSITIONS 0..total-1; a lane's position
//    only rises, so it finds its run with a cursor into the table that only
//    moves forward.  kRangeBatch candidates are addressed first, loaded
//    next and compared last: the loads of a batch are independent of each
//    other and of any comparison;
//  * window positions rise with the sorted index, so "first occurrence
//    kept" in a lane plus the (d, i) arg-min across the sub-warp keeps the
//    tie rule (lowest sorted index);
//  * the epilogue in the kernel: the distance (IEEE square root), the
//    resolved flag, the clamped int64 index and ONE count of unresolved live
//    queries a launch (a ballot a warp, one atomic where it is not zero), so
//    that no elementwise pass rebuilds them and the caller learns from one
//    integer whether anything is left to rescue.
// A window of any size takes the same path: nothing is staged or unrolled
// by window size, so a crowded cell needs no second branch.
#include "common.cuh"

namespace pwicp {

// lanes a query: a power of two, at most a warp
constexpr int kRangeLanes = 4;
// candidates a lane has in flight
constexpr int kRangeBatch = 4;
// 1: a batch that lies within one run skips the per-candidate run search
constexpr int kRangeFast = 1;
// 0 builds the floor of this launch: queries read, run bounds read and
// scanned, outputs written, no candidate met
constexpr int kRangeWalk = 1;

static_assert(kRangeLanes >= 1 && kRangeLanes <= kWarp
                  && (kRangeLanes & (kRangeLanes - 1)) == 0,
              "a sub-warp is a power-of-two share of a warp");

constexpr int kRangeSlots = kThreads / kRangeLanes;  // queries a block

__global__ void __launch_bounds__(kThreads)
range_nn1_kernel(Grid g, const float* __restrict__ q,
                 const uint8_t* __restrict__ q_mask, int nq,
                 long long* __restrict__ out_idx, float* __restrict__ out_d,
                 uint8_t* __restrict__ out_resolved,
                 int* __restrict__ unresolved) {
  constexpr int L = kRangeLanes;
  // run u of a query's window: .x = window position one past its last
  // point, .y = sorted index minus window position of its points
  __shared__ int2 tab[kRangeSlots][9];
  const int slot = threadIdx.x / L, sl = threadIdx.x % L;
  const int qi = blockIdx.x * kRangeSlots + slot;
  const bool in = qi < nq;
  const bool live = in && (q_mask == nullptr || q_mask[qi]);

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  int total = 0;
  if (live) {
    qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
    const Window w = window_of(g, qx, qy, qz);
    // all 18 bounds first (clamped to a valid column, so unconditional),
    // then the scan: the loads do not wait for one another
    int s[9], len[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int x = w.x0 + k / 3, y = w.y0 + k % 3;
      const int base = (min(x, w.x1) * g.dy + min(y, w.y1)) * g.dz;
      s[k] = g.starts[min(base + w.z0, g.n_cells)];
      const int e = g.starts[min(base + w.z1 + 1, g.n_cells)];
      // clipping never repeats a column: one beyond the window is empty
      len[k] = (x <= w.x1 && y <= w.y1) ? e - s[k] : 0;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (sl == k % L) tab[slot][k] = make_int2(total + len[k], s[k] - total);
      total += len[k];
    }
  }
  __syncwarp();

  float best = INFINITY;
  int bi = kIMax;
  if (kRangeWalk) {
    if (total > 0) {
      int u = 0;
      int2 run = tab[slot][0];
      for (int p = sl; p < total; p += kRangeBatch * L) {
        int j[kRangeBatch];
        if (kRangeFast && p + (kRangeBatch - 1) * L < run.x) {
          // the whole batch lies in the run in hand (a long run: the rule
          // on a coarse grid)
#pragma unroll
          for (int i = 0; i < kRangeBatch; ++i) j[i] = p + i * L + run.y;
        } else {
#pragma unroll
          for (int i = 0; i < kRangeBatch; ++i) {
            const int pp = p + i * L;
            j[i] = -1;
            if (pp < total) {
              // ends: the last entry's .x is `total`
              while (pp >= run.x) run = tab[slot][++u];
              j[i] = pp + run.y;
            }
          }
        }
        float tx[kRangeBatch], ty[kRangeBatch], tz[kRangeBatch];
#pragma unroll
        for (int i = 0; i < kRangeBatch; ++i) {
          if (j[i] >= 0) {
            const float* t = g.pts + 3 * (size_t)j[i];
            tx[i] = t[0], ty[i] = t[1], tz[i] = t[2];
          }
        }
#pragma unroll
        for (int i = 0; i < kRangeBatch; ++i) {
          if (j[i] >= 0) {
            const float d2 = sqdist(qx, qy, qz, tx[i], ty[i], tz[i]);
            if (d2 < best) {  // per lane j increases: first occurrence kept
              best = d2;
              bi = j[i];
            }
          }
        }
      }
    }
  } else if (sl == 0 && total > 0) {
    best = (float)total;  // keeps the bounds and the table alive
    bi = tab[slot][0].y;
  }

  // lexicographic arg-min of (d, i) across the sub-warp (the xor offsets
  // stay inside it); every lane of the warp takes part
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    const float d2 = __shfl_xor_sync(kFull, best, o);
    const int i2 = __shfl_xor_sync(kFull, bi, o);
    if (d2 < best || (d2 == best && i2 < bi)) {
      best = d2;
      bi = i2;
    }
  }

  // a masked query or an empty window kept best = inf: (0, inf); masked
  // queries count as resolved
  const float d = __fsqrt_rn(fmaxf(best, 0.0f));
  const bool resolved = !live || (d < INFINITY && d <= g.h);
  if (sl == 0 && in) {
    out_idx[qi] = bi == kIMax ? 0 : bi;
    out_d[qi] = d;
    out_resolved[qi] = resolved ? 1 : 0;
  }
  const unsigned left = __ballot_sync(kFull, sl == 0 && in && !resolved);
  if (left && threadIdx.x % kWarp == 0) atomicAdd(unresolved, __popc(left));
}

}  // namespace pwicp

// `q_mask` may be null (every query live).  `unresolved` (one int) is zeroed
// here, on the stream, and holds the number of live queries whose nearest
// target lies beyond h (or whose window is empty) when the kernel ends.
extern "C" int pwicp_range_nn1(const float* q, const uint8_t* q_mask, int nq,
                               const float* pts, const int* starts,
                               int n_cells, float ox, float oy, float oz,
                               float h, int dx, int dy, int dz,
                               long long* out_idx, float* out_d,
                               uint8_t* out_resolved, int* unresolved,
                               void* stream) {
  using namespace pwicp;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(unresolved, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (nq > 0) {
    Grid g = make_grid(pts, starts, n_cells, ox, oy, oz, h, dx, dy, dz);
    const int blocks = (nq + kRangeSlots - 1) / kRangeSlots;
    range_nn1_kernel<<<blocks, kThreads, 0, st>>>(
        g, q, q_mask, nq, out_idx, out_d, out_resolved, unresolved);
  }
  return (int)cudaGetLastError();
}
