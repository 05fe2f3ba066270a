// K4: seeded label propagation over the cell-sorted self-join: one
// synchronous (Jacobi) round, and the whole loop of rounds in one launch.
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
// atomicAdd per block).  Labels ride as float32 (exact below 2^24); -1 is
// "none", and a NaN label never wins.
//
// Bound on the card: neither bytes nor arithmetic (1.7 MB of points and
// 4.5 MB of state of a 142k-point cloud live in L2; a few microseconds of
// lane arithmetic) but latency, in the kernel and around it: a query's
// nine runs each cost two dependent reads of the CSR array, then the point,
// then a 32-byte state row read as scalars 32 bytes apart; and a loop of
// rounds driven from the host pays a launch, two allocations and a
// device-to-host read that drains the stream, every round.  The design:
//
//  * a block takes a cell and stages its window once in shared memory as a
//    structure of arrays (common.cuh, as K2 and K3 do): the points and,
//    beside them, the state (seed xyz, seed normal, label: seven floats a
//    candidate), read as two 16-byte loads a row, neighbouring threads on
//    neighbouring rows.  Each warp serves one query of the cell from it,
//    lanes over window positions, no run boundaries left inside the loop.
//    Window positions rise with the sorted index, so the tie rule "lowest
//    index" is "lowest position" and the result does not depend on the order
//    of the walk: equal to the plain version bit for bit;
//  * a window above kPropCap points (a crowded cell, or one that collects
//    points moved to the 1e30 sentinel) is walked from global memory by the
//    same kernel;
//  * the loop runs on the card: propagate_kernel is launched once,
//    cooperatively, with as many blocks as fit on the card at once, and runs
//    the rounds to convergence (at most max_rounds) and then the orphan sweep
//    (at most max_rounds) between two state buffers.  A grid-wide barrier
//    separates the rounds, so every block has finished round r before any
//    starts round r + 1.  Each round has its own change count and its own
//    cell hand-out counter in `ctrl`; every block reads the same count after
//    the barrier and so takes the same decision.  The same launch lays out
//    the query rows and the seed state before the first round and turns the
//    final state into labels after the last, so the wrapper enqueues nothing
//    else and the host reads one integer, at the end: the propagation rounds.
//
// State and query rows written in one phase are read in the next by other
// blocks of the same launch, so they are read with ld.global.cg (L2, never
// the non-coherent path or a stale L1 line).
//
// The window of a query is that of the cell it was binned into (its CSR
// run), not of its current coordinates; the two are one cell for every live
// query, and a point moved to the sentinel in place is a masked query.
#include <cooperative_groups.h>

#include "common.cuh"

namespace pwicp {

namespace cg = cooperative_groups;

constexpr int kPropWarps = 4;  // queries served at a time by a block
constexpr int kPropThreads = kPropWarps * kWarp;
// Window points staged per block.  40 bytes a point: at 512 points the
// eleven blocks an SM holds take all 227 KB of its shared memory and leave no
// L1 for the gathers; 384 measured 5-10% faster (as 256 and 320 did) and is
// still over twice the widest window of a 5 mm terrain epoch (173 points).
constexpr int kPropCap = 384;
constexpr int kCtrlHead = 2;   // propagation rounds, all rounds
using i64 = long long;

struct PropArgs {
  Grid g;
  const float* qall;      // [n, 8] query xyz, normal, t2, pad
  const uint8_t* q_mask;  // [n]
  float inv_res_04, h2;
};

// What a block keeps in shared memory: the staged window (points, then the
// state as seed xyz, seed normal, label) and its walk over the cells.
struct PropShared {
  float x[kPropCap], y[kPropCap], z[kPropCap];
  float st[7][kPropCap];
  CellFeed feed;
  int changed;
};

struct Best {
  float m, lab;
  int at;  // window position (staged) or sorted index (walked)
};

// One candidate against the lane's best so far; candidates come in rising
// position, so an equal (m, label) keeps the earlier one.
__device__ __forceinline__ void consider(Best& b, int at, float d2, float lab,
                                         float sx, float sy, float sz,
                                         float snx, float sny, float snz,
                                         const float4& qa, const float4& qb,
                                         float inv_res_04, float h2,
                                         int adopt) {
  float m;
  if (adopt) {
    if (!(d2 <= h2)) return;
    m = __fsqrt_rn(d2);
  } else {
    if (!(d2 <= qb.z)) return;
    float dxs = __fsub_rn(qa.x, sx);
    float dys = __fsub_rn(qa.y, sy);
    float dzs = __fsub_rn(qa.z, sz);
    float ds = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(dxs, dxs), __fmul_rn(dys, dys)),
                  __fmul_rn(dzs, dzs)));
    float dot = __fadd_rn(
        __fadd_rn(__fmul_rn(qa.w, snx), __fmul_rn(qb.x, sny)),
        __fmul_rn(qb.y, snz));
    m = __fadd_rn(__fsub_rn(1.0f, fabsf(dot)), __fmul_rn(ds, inv_res_04));
  }
  if (m < b.m || (m == b.m && lab < b.lab)) {
    b.m = m;
    b.lab = lab;
    b.at = at;
  }
}

// One round over every cell of the grid.
__device__ __forceinline__ void prop_round_body(
    const PropArgs& a, const float* state_in, float* state_out, int adopt,
    int* counter, int* changed, PropShared& sh) {
  const Grid& g = a.g;
  CellFeed& feed = sh.feed;
  const Runs& runs = feed.runs;
  float* sx = sh.x;
  float* sy = sh.y;
  float* sz = sh.z;
  float(*st)[kPropCap] = sh.st;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const float4* rows_in = reinterpret_cast<const float4*>(state_in);
  if (threadIdx.x == 0) sh.changed = 0;
  int n_changed = 0;  // of this warp's queries, kept by lane 0

  CellCursor cur;
  int c;
  while (next_cell(g, counter, feed, cur, &c)) {
    const int qs = g.starts[c], qe = g.starts[c + 1];
    const int n_runs = cell_runs(g, c, feed.runs);
    const int wn = runs.off[n_runs];
    const bool staged = wn <= kPropCap;
    if (staged)
      for_each_staged(runs, n_runs, [&](int p, int j) {
        const float* t = g.pts + 3 * (size_t)j;
        sx[p] = t[0];
        sy[p] = t[1];
        sz[p] = t[2];
        const float4 r0 = __ldcg(rows_in + 2 * (size_t)j);
        const float4 r1 = __ldcg(rows_in + 2 * (size_t)j + 1);
        st[0][p] = r0.x;
        st[1][p] = r0.y;
        st[2][p] = r0.z;
        st[3][p] = r0.w;
        st[4][p] = r1.x;
        st[5][p] = r1.y;
        st[6][p] = r1.z;
      });
    __syncthreads();

    for (int qi = qs + warp; qi < qe; qi += kPropWarps) {
      const float lab_own = __ldcg(state_in + (size_t)qi * 8 + 6);
      Best b = {kBig, kBig, kIMax};
      // the orphan sweep updates unlabelled queries only: a labelled one
      // needs no walk
      if (a.q_mask[qi] && !(adopt && lab_own >= 0.0f)) {
        const float4* qrow =
            reinterpret_cast<const float4*>(a.qall) + 2 * (size_t)qi;
        const float4 qa = __ldcg(qrow), qb = __ldcg(qrow + 1);
        if (staged) {
          for (int p = lane; p < wn; p += kWarp) {
            const float lab = st[6][p];
            if (!(lab >= 0.0f)) continue;
            const float d2 = sqdist(qa.x, qa.y, qa.z, sx[p], sy[p], sz[p]);
            consider(b, p, d2, lab, st[0][p], st[1][p], st[2][p], st[3][p],
                     st[4][p], st[5][p], qa, qb, a.inv_res_04, a.h2, adopt);
          }
        } else {
          for_each_walked(runs, n_runs, lane, [&](int j) {
            const float4 r1 = __ldcg(rows_in + 2 * (size_t)j + 1);
            if (!(r1.z >= 0.0f)) return;
            const float4 r0 = __ldcg(rows_in + 2 * (size_t)j);
            const float d2 =
                sqdist(qa.x, qa.y, qa.z, g.pts + 3 * (size_t)j);
            consider(b, j, d2, r1.z, r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, qa,
                     qb, a.inv_res_04, a.h2, adopt);
          });
        }
      }
      // lexicographic (m, label, position) warp arg-min
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        const float m2 = __shfl_xor_sync(kFull, b.m, o);
        const float l2 = __shfl_xor_sync(kFull, b.lab, o);
        const int a2 = __shfl_xor_sync(kFull, b.at, o);
        if (m2 < b.m ||
            (m2 == b.m && (l2 < b.lab || (l2 == b.lab && a2 < b.at)))) {
          b.m = m2;
          b.lab = l2;
          b.at = a2;
        }
      }
      const bool upd = b.m < kBig && (!adopt || lab_own < 0.0f);
      const float new_lab = upd ? b.lab : lab_own;
      if (lane < 8) {
        float v = 0.0f;
        if (lane < 6) {
          if (upd)
            v = staged ? st[lane][b.at]
                       : __ldcg(state_in + (size_t)b.at * 8 + lane);
        } else if (lane == 6) {
          v = new_lab;
        }
        state_out[(size_t)qi * 8 + lane] = v;
      }
      if (lane == 0 && new_lab != lab_own) ++n_changed;
    }
    __syncthreads();  // the window and the run table are no longer read
  }
  // sh.changed was zeroed before the first barrier of next_cell
  if (lane == 0 && n_changed) atomicAdd(&sh.changed, n_changed);
  __syncthreads();
  if (threadIdx.x == 0 && sh.changed) atomicAdd(changed, sh.changed);
}

__global__ void __launch_bounds__(kPropThreads)
    prop_round_kernel(PropArgs a, const float* state_in, float* state_out,
                      int adopt, int* counter, int* changed) {
  __shared__ PropShared sh;
  prop_round_body(a, state_in, state_out, adopt, counter, changed, sh);
}

// What the whole loop is given beside PropArgs (whose qall it fills itself).
struct LoopArgs {
  const float* normals;  // [n, 3]
  const float* r2;       // [n], r2_stride elements apart
  const i64* seeds;      // [n_seeds] sorted indices of the seeds
  int r2_stride, n_seeds, n, max_rounds;
  float* qall;           // [n, 8] scratch: the query rows
  float *state0, *state1;  // [n, 8] scratch each
  i64* labels;           // [n] out: seed slot ids, -1 none or masked
  int* ctrl;
};

// The whole loop.  ctrl: kCtrlHead integers of results, then a change count
// for each of the up to 2 * max_rounds rounds, then a hand-out counter for
// each; all zero at launch.
__global__ void __launch_bounds__(kPropThreads)
    propagate_kernel(PropArgs a, LoopArgs l) {
  __shared__ PropShared sh;
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsize = gridDim.x * blockDim.x;

  // query rows (xyz, normal, t2, 0); every state row -1; then the seeds:
  // their own position, normal and slot id
  float4* q4 = reinterpret_cast<float4*>(l.qall);
  float4* s4 = reinterpret_cast<float4*>(l.state0);
  for (int i = gtid; i < l.n; i += gsize) {
    const float* p = a.g.pts + 3 * (size_t)i;
    const float* nn = l.normals + 3 * (size_t)i;
    q4[2 * (size_t)i] = make_float4(p[0], p[1], p[2], nn[0]);
    q4[2 * (size_t)i + 1] =
        make_float4(nn[1], nn[2], l.r2[(size_t)i * l.r2_stride], 0.0f);
    s4[2 * (size_t)i] = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    s4[2 * (size_t)i + 1] = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
  }
  grid.sync();
  for (int k = gtid; k < l.n_seeds; k += gsize) {
    const size_t j = (size_t)l.seeds[k];
    const float* p = a.g.pts + 3 * j;
    const float* nn = l.normals + 3 * j;
    s4[2 * j] = make_float4(p[0], p[1], p[2], nn[0]);
    s4[2 * j + 1] = make_float4(nn[1], nn[2], (float)k, -1.0f);
  }
  grid.sync();

  int* changed = l.ctrl + kCtrlHead;
  int* counter = changed + 2 * l.max_rounds;
  int step = 0, cur = 0, rounds = 0;
  for (int adopt = 0; adopt < 2; ++adopt) {
    int it = 0, chg = 1;
    while (chg > 0 && it < l.max_rounds) {  // grid-uniform
      prop_round_body(a, cur ? l.state1 : l.state0,
                      cur ? l.state0 : l.state1, adopt, counter + step,
                      changed + step, sh);
      grid.sync();
      chg = __ldcg(changed + step);
      cur ^= 1;
      ++it;
      ++step;
    }
    if (!adopt) rounds = it;
  }

  const float* fin = cur ? l.state1 : l.state0;
  for (int i = gtid; i < l.n; i += gsize) {
    const float lab = __ldcg(fin + (size_t)i * 8 + 6);
    const bool ok = a.q_mask[i] && lab >= 0.0f && lab < INFINITY;
    l.labels[i] = ok ? (i64)lab : -1;
  }
  if (gtid == 0) {
    l.ctrl[0] = rounds;
    l.ctrl[1] = step;
  }
}

}  // namespace pwicp

// The most window points a block stages in shared memory.
extern "C" int pwicp_prop_cap() { return pwicp::kPropCap; }

// One round.  scratch: two ints of this call, zeroed here: the cell hand-out
// counter, then the count of labels that changed (the result).
extern "C" int pwicp_prop_round(const float* qall, const uint8_t* q_mask,
                                const float* state_in, float inv_res_04,
                                float h2, int adopt, const float* pts,
                                const int* starts, int n_cells, float ox,
                                float oy, float oz, float h, int dx, int dy,
                                int dz, float* state_out, int* scratch,
                                void* stream) {
  using namespace pwicp;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess || n_cells <= 0) return (int)err;
  int blocks = 0;
  err = cell_blocks(prop_round_kernel, kPropThreads, 0, n_cells, &blocks);
  if (err != cudaSuccess) return (int)err;
  PropArgs a = {make_grid(pts, starts, n_cells, ox, oy, oz, h, dx, dy, dz),
                qall, q_mask, inv_res_04, h2};
  prop_round_kernel<<<blocks, kPropThreads, 0, st>>>(
      a, state_in, state_out, adopt, scratch, scratch + 1);
  return (int)cudaGetLastError();
}

// The number of integers of scratch the whole loop needs for max_rounds.
extern "C" int pwicp_propagate_ctrl(int max_rounds) {
  return pwicp::kCtrlHead + 4 * (max_rounds > 0 ? max_rounds : 0);
}

// The whole loop in one cooperative launch: the query rows and the seed
// state are laid out, the rounds run to convergence (at most max_rounds),
// then the orphan sweep (at most max_rounds), ping-pong between state0 and
// state1, and the final labels are written.  normals [n, 3]; r2 [n] with
// r2_stride elements between entries; seeds [n_seeds] sorted indices (int64);
// qall, state0, state1: [n, 8] floats of scratch each; labels [n] int64 out;
// ctrl: pwicp_propagate_ctrl(max_rounds) ints of scratch of this call, zeroed
// here; at the end ctrl[0] = propagation rounds, ctrl[1] = all rounds, and
// the change count of each round follows.  Returns the launch call's own
// error (a grid that cannot be resident at once is refused there).
extern "C" int pwicp_propagate(const float* normals, const float* r2,
                               int r2_stride, const uint8_t* q_mask,
                               const long long* seeds, int n_seeds, int n,
                               float inv_res_04, float h2, int max_rounds,
                               const float* pts, const int* starts,
                               int n_cells, float ox, float oy, float oz,
                               float h, int dx, int dy, int dz, float* qall,
                               float* state0, float* state1,
                               long long* labels, int* ctrl, void* stream) {
  using namespace pwicp;
  cudaStream_t st = (cudaStream_t)stream;
  if (max_rounds < 0 || n <= 0 || n_cells <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      ctrl, 0, sizeof(int) * pwicp_propagate_ctrl(max_rounds), st);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cell_blocks(propagate_kernel, kPropThreads, 0, n_cells, &blocks);
  if (err != cudaSuccess) return (int)err;
  PropArgs a = {make_grid(pts, starts, n_cells, ox, oy, oz, h, dx, dy, dz),
                qall, q_mask, inv_res_04, h2};
  LoopArgs l = {normals, r2,   seeds,  r2_stride, n_seeds, n,
                max_rounds, qall, state0, state1,   labels,  ctrl};
  void* args[] = {&a, &l};
  err = cudaLaunchCooperativeKernel((void*)propagate_kernel, dim3(blocks),
                                    dim3(kPropThreads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
