// K2: exact k nearest neighbours (k <= 32) of the grid's own points within
// their 27-cell windows (a self-join), ascending squared distance, ties to
// the lowest sorted index.
//
// Replaces piecewise_icp_tpu/ops/nn_pallas.py:_knn3_kernel (reached via
// grid_knn_sorted from the SOR statistic, ops/preprocess.py:
// _sor_mask_sorted, k + 1 = 15 on the main path).  The TPU kernel DMA'd
// three x-slab ranges per 128-query tile and peeled the k nearest off a
// [128, 3072] distance block by k min-extraction passes.
//
// Bound on the card: instruction slots of the selection, not memory (the cloud,
// 1.7 MB at 142k points, lives in L2; the output is 8 bytes a slot).  The
// design computes every distance once, reads every point once per cell and
// makes a pick cost a few instructions:
//
//  * the queries are the grid's own sorted points, so the queries of one
//    cell are contiguous and share one window.  A block takes a cell, stages
//    the window's points (at most nine contiguous CSR runs, ascending in
//    sorted index) into shared memory as a structure of arrays, and serves
//    every query of the cell from it, one warp a query;
//  * one walk: a lane computes the distances of its candidates (window
//    positions congruent to its lane index) once and inserts each into its
//    own list in shared memory, kept sorted by (d2, position) and cut at the
//    k smallest.  Distances are kept as the bits of the float: d2 >= 0, so
//    they order like unsigned integers; inf and NaN are never inserted;
//  * a pick is then two warp-wide redux.sync minima over the heads of the 32
//    lists (value, then lowest position among equal values: an equal value
//    deeper in a list has a higher position than its head) and one step of
//    the winning lane's list.  A lane touches only its own list, so no
//    barrier is needed between picks;
//  * cells are handed out in chunks of 32 through an atomic counter (empty
//    cells cost one coalesced read of the CSR array per chunk), so the
//    blocks stay busy whatever the occupancy pattern of the grid (the
//    hand-out, the run table and the staging copy are common.cuh's, shared
//    with K3 and K4);
//  * a window too large for the staged tile (kKnnCap points: a crowded
//    cell, or a cell that collects points moved to the 1e30 sentinel) is
//    walked from global memory by the same kernel, k rounds of a
//    lexicographic (d2, index) arg-min.  One block serves such a cell, so a
//    single crowded cell costs milliseconds; a voxel-downsampled surface
//    keeps its windows under 300 points.
//
// The window of a query is that of the cell it was binned into (its CSR
// run), not of its current coordinates: a point moved to the sentinel in
// place keeps its cell, as in the plain version.  Empty slots get d2 = inf
// and index -1; targets at the sentinel (d2 = inf) are never candidates;
// masked queries get (inf, -1) in every slot.
#include "common.cuh"

namespace pwicp {

constexpr int kKnnWarps = 4;     // queries served at a time by a block
constexpr int kKnnThreads = kKnnWarps * kWarp;
constexpr int kKnnCap = 512;     // window points staged per block
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kNoPos = 0xffffffffu;
// staged window (x, y, z, sorted index) and a list of (d2 bits, 16-bit
// position) per warp
constexpr size_t kKnnSmem = (size_t)kKnnCap * (16 + 6 * kKnnWarps);
static_assert(kKnnCap <= 65536, "window positions are kept in 16 bits");
// A lane's list holds kKnnCap / kWarp entries.  It never holds more than
// min(k, candidates the lane sees), and a lane sees at most
// ceil(kKnnCap / kWarp) of a staged window, so the list cannot run into the
// next warp's for any k the entry point accepts (k <= kWarp).
constexpr int kKnnLaneList = kKnnCap / kWarp;
static_assert(kKnnLaneList * kWarp == kKnnCap,
              "a lane's list is exactly its share of the staged window");

// One query from the staged window.  rv/rp point at this lane's first list
// entry; entry i lies at [kWarp * i].
__device__ __forceinline__ void knn_staged(const float* sx, const float* sy,
                                           const float* sz, const int* sj,
                                           unsigned* rv, unsigned short* rp,
                                           int wn, float qx, float qy,
                                           float qz, int k, int lane,
                                           float* my_d, int* my_j) {
  int cnt = 0;
  for (int p = lane; p < wn; p += kWarp) {
    float d = sqdist(qx, qy, qz, sx[p], sy[p], sz[p]);
    if (!(d < INFINITY)) continue;
    unsigned v = __float_as_uint(d);
    if (cnt == k) {  // only the lane's k smallest can be picked
      if (v >= rv[kWarp * (k - 1)]) continue;
      cnt = k - 1;
    }
    int i = cnt;
    while (i > 0) {  // positions rise, so an equal value stays in front
      unsigned w = rv[kWarp * (i - 1)];
      if (w <= v) break;
      rv[kWarp * i] = w;
      rp[kWarp * i] = rp[kWarp * (i - 1)];
      --i;
    }
    rv[kWarp * i] = v;
    rp[kWarp * i] = (unsigned short)p;
    ++cnt;
  }
  int head = 0;
  unsigned hv = cnt > 0 ? rv[0] : kInfBits;
  unsigned hp = cnt > 0 ? (unsigned)rp[0] : kNoPos;
  for (int r = 0; r < k; ++r) {
    unsigned m = __reduce_min_sync(kFull, hv);
    if (m == kInfBits) break;  // warp-uniform: every list is used up
    unsigned pm = __reduce_min_sync(kFull, hv == m ? hp : kNoPos);
    if (lane == r) {
      *my_d = __uint_as_float(m);
      *my_j = sj[pm];
    }
    if (hp == pm) {
      ++head;
      bool more = head < cnt;
      hv = more ? rv[kWarp * head] : kInfBits;
      hp = more ? (unsigned)rp[kWarp * head] : kNoPos;
    }
  }
}

// One query from global memory: k rounds over the window, each taking the
// lexicographically smallest (d2, index) above the previous round's pick.
__device__ __forceinline__ void knn_walked(const Runs& runs, int n_runs,
                                           const float* __restrict__ pts,
                                           float qx, float qy, float qz, int k,
                                           int lane, float* my_d, int* my_j) {
  float pd = -INFINITY;
  int pi = -1;
  for (int r = 0; r < k; ++r) {
    float bd = INFINITY;
    int bi = kIMax;
    for_each_walked(runs, n_runs, lane, [&](int j) {
      float d2 = sqdist(qx, qy, qz, pts + 3 * (size_t)j);
      bool after = d2 > pd || (d2 == pd && j > pi);
      if (d2 < INFINITY && after && (d2 < bd || (d2 == bd && j < bi))) {
        bd = d2;
        bi = j;
      }
    });
    warp_argmin(bd, bi);
    if (bi == kIMax) break;  // warp-uniform
    if (lane == r) {
      *my_d = bd;
      *my_j = bi;
    }
    pd = bd;
    pi = bi;
  }
}

__global__ void __launch_bounds__(kKnnThreads)
    knn_sorted_kernel(Grid g, const uint8_t* __restrict__ q_mask, int k,
                      int* __restrict__ counter, int* __restrict__ out_idx,
                      float* __restrict__ out_d2) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;
  float* sy = sx + kKnnCap;
  float* sz = sy + kKnnCap;
  int* sj = reinterpret_cast<int*>(sz + kKnnCap);
  unsigned* rv_all = reinterpret_cast<unsigned*>(sj + kKnnCap);
  unsigned short* rp_all =
      reinterpret_cast<unsigned short*>(rv_all + (size_t)kKnnWarps * kKnnCap);
  __shared__ CellFeed feed;
  const Runs& runs = feed.runs;

  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  unsigned* rv = rv_all + (size_t)warp * kKnnCap + lane;
  unsigned short* rp = rp_all + (size_t)warp * kKnnCap + lane;

  CellCursor cur;
  int c;
  while (next_cell(g, counter, feed, cur, &c)) {
    const int qs = g.starts[c], qe = g.starts[c + 1];
    const int n_runs = cell_runs(g, c, feed.runs);
    const int wn = runs.off[n_runs];
    const bool staged = wn <= kKnnCap;
    if (staged)
      for_each_staged(runs, n_runs, [&](int p, int j) {
        const float* t = g.pts + 3 * (size_t)j;
        sx[p] = t[0];
        sy[p] = t[1];
        sz[p] = t[2];
        sj[p] = j;
      });
    __syncthreads();

    for (int qi = qs + warp; qi < qe; qi += kKnnWarps) {
      float my_d = INFINITY;  // lane r holds the r-th nearest
      int my_j = -1;
      if (q_mask[qi]) {
        const float* qp = g.pts + 3 * (size_t)qi;
        const float qx = qp[0], qy = qp[1], qz = qp[2];
        if (staged)
          knn_staged(sx, sy, sz, sj, rv, rp, wn, qx, qy, qz, k, lane, &my_d,
                     &my_j);
        else
          knn_walked(runs, n_runs, g.pts, qx, qy, qz, k, lane, &my_d, &my_j);
      }
      if (lane < k) {
        out_d2[(size_t)qi * k + lane] = my_d;
        out_idx[(size_t)qi * k + lane] = my_j;
      }
    }
    __syncthreads();  // the window and the run table are no longer read
  }
}

}  // namespace pwicp

// The most window points a block stages in shared memory.
extern "C" int pwicp_knn_cap() { return pwicp::kKnnCap; }

// counter: one int of scratch of this call (the cell hand-out), zeroed here.
extern "C" int pwicp_knn_sorted(const uint8_t* q_mask, int k,
                                const float* pts, const int* starts,
                                int n_cells, float ox, float oy, float oz,
                                float h, int dx, int dy, int dz, int* counter,
                                int* out_idx, float* out_d2, void* stream) {
  using namespace pwicp;
  cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > kWarp) return (int)cudaErrorInvalidValue;
  if (n_cells <= 0) return (int)cudaGetLastError();
  int blocks = 0;
  cudaError_t err = cell_blocks(knn_sorted_kernel, kKnnThreads, kKnnSmem,
                                n_cells, &blocks);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  Grid g = make_grid(pts, starts, n_cells, ox, oy, oz, h, dx, dy, dz);
  knn_sorted_kernel<<<blocks, kKnnThreads, kKnnSmem, st>>>(g, q_mask, k,
                                                           counter, out_idx,
                                                           out_d2);
  return (int)cudaGetLastError();
}
