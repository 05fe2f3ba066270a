// Shared device helpers of the fixed-radius neighbourhood kernels.
//
// Every kernel of this library answers a question about the points within
// radius h of a query, over targets that build_grid (ops/grid_nn.py) sorted
// by linearised cell id (x-major, z fastest) with cell size h.  Any target
// within h of a query lies in the query's 27-cell window, and with z fastest
// that window is at most nine contiguous runs of the sorted array, read off
// the dense CSR array `starts`.  One warp serves one query.  K1 (moved
// queries) walks each query's own runs from global memory.  The self-join
// kernels (K2, K3, K4) ask from the grid's own points, so the queries of one
// cell are contiguous and share one window: a block takes a cell, stages the
// window once in shared memory as a structure of arrays and serves every
// query of the cell from it (the helpers from `Runs` down).  There the window
// of a query is that of the cell it was binned into (its CSR run), not of its
// current coordinates: a point moved to the 1e30 sentinel in place keeps its
// cell, is a masked query, and is answered before any window is read.
//
// Arithmetic is kept bit-compatible with the plain PyTorch versions and the
// JAX reference: coordinate differences first (never |q|^2 + |t|^2 - 2 q.t),
// products and sums rounded separately (the library is also built with
// -fmad=false), IEEE division and square root.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pwicp {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr float kBig = 1e30f;
constexpr int kIMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct Grid {
  const float* pts;    // [n, 3] cell-sorted targets
  const int* starts;   // CSR offsets, at least n_cells + 1 entries
  int n_cells;         // dx * dy * dz
  float ox, oy, oz, h;
  int dx, dy, dz;
};

struct Window {
  int x0, x1, y0, y1, z0, z1;
};

// Cell coordinate of q along one axis, exactly as the reference computes it:
// floor((q - o) / h) in float32, then clipped to [0, dim - 1].  The value is
// clamped before the conversion so that the 1e30 sentinel cannot overflow.
__device__ __forceinline__ int cell_coord(float q, float o, float h, int dim) {
  float f = __fdiv_rn(__fsub_rn(q, o), h);
  f = fminf(fmaxf(f, -1.0f), (float)dim);
  int c = (int)floorf(f);
  return min(max(c, 0), dim - 1);
}

// The 27-cell window of a query, clipped to the grid.  Clipping never
// repeats a column, so no candidate is visited twice.
__device__ __forceinline__ Window window_of(const Grid& g, float qx, float qy,
                                            float qz) {
  int cx = cell_coord(qx, g.ox, g.h, g.dx);
  int cy = cell_coord(qy, g.oy, g.h, g.dy);
  int cz = cell_coord(qz, g.oz, g.h, g.dz);
  Window w;
  w.x0 = max(cx - 1, 0);
  w.x1 = min(cx + 1, g.dx - 1);
  w.y0 = max(cy - 1, 0);
  w.y1 = min(cy + 1, g.dy - 1);
  w.z0 = max(cz - 1, 0);
  w.z1 = min(cz + 1, g.dz - 1);
  return w;
}

// Calls f(j) for every target j of the window, lane-strided; each lane sees
// its candidates in increasing j.
template <class F>
__device__ __forceinline__ void for_each_candidate(const Grid& g,
                                                   const Window& w, int lane,
                                                   F f) {
  for (int x = w.x0; x <= w.x1; ++x) {
    for (int y = w.y0; y <= w.y1; ++y) {
      int base = (x * g.dy + y) * g.dz;
      int s = g.starts[min(base + w.z0, g.n_cells)];
      int e = g.starts[min(base + w.z1 + 1, g.n_cells)];
      for (int j = s + lane; j < e; j += kWarp) f(j);
    }
  }
}

// ((dx*dx + dy*dy) + dz*dz) with d = q - t, no contraction.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        const float* t, float* dx, float* dy,
                                        float* dz) {
  *dx = __fsub_rn(qx, t[0]);
  *dy = __fsub_rn(qy, t[1]);
  *dz = __fsub_rn(qz, t[2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(*dx, *dx), __fmul_rn(*dy, *dy)),
                   __fmul_rn(*dz, *dz));
}

__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        const float* t) {
  float dx, dy, dz;
  return sqdist(qx, qy, qz, t, &dx, &dy, &dz);
}

// The same from separate target coordinates (structure-of-arrays tiles).
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float tx, float ty, float tz) {
  float dx = __fsub_rn(qx, tx), dy = __fsub_rn(qy, ty),
        dz = __fsub_rn(qz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Warp-wide lexicographic arg-min of (d, i); every lane ends with the result.
__device__ __forceinline__ void warp_argmin(float& d, int& i) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    float d2 = __shfl_xor_sync(kFull, d, o);
    int i2 = __shfl_xor_sync(kFull, i, o);
    if (d2 < d || (d2 == d && i2 < i)) {
      d = d2;
      i = i2;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// A block a cell: the staged window of the self-join kernels.
// ---------------------------------------------------------------------------

constexpr int kCellChunk = kWarp;  // cells handed out per atomic
// one ballot of the first warp finds a chunk's occupied cells
static_assert(kCellChunk == kWarp, "a chunk is one mask of 32 cells");

// The window of a cell: at most nine contiguous runs of the sorted array in
// (x, y) order, ascending in sorted index; off[u] is the window position of
// run u's first point, off[n_runs] the window's size.  Window positions rise
// with the sorted index, so "lowest position" is "lowest index".
struct Runs {
  int s[9], e[9], off[10];
};

// What a block keeps in shared memory to walk over cells.
struct CellFeed {
  Runs runs;
  int base;
  unsigned cells;
};

// Where a thread stands in its block's walk (the same in every thread): the
// first cell of the chunk in hand and its occupied cells not yet served.
struct CellCursor {
  int c0 = 0;
  unsigned mask = 0;
};

// The block's next occupied cell in *c; false when every cell is handed out.
// Cells come in chunks of kCellChunk from the atomic hand-out `counter`
// (zeroed before the launch), the occupied ones of a chunk as a bit mask:
// empty cells cost one coalesced read of the CSR array per chunk, so the
// blocks stay busy whatever the occupancy pattern of the grid.  (On the
// 142k-point terrain grid larger chunks and a fixed strided assignment
// without the atomic both measured slower: balance across the blocks is
// worth more than the atomic costs.)  Block-uniform; holds block barriers.
__device__ __forceinline__ bool next_cell(const Grid& g, int* counter,
                                          CellFeed& feed, CellCursor& cur,
                                          int* c) {
  const int tid = threadIdx.x;
  while (!cur.mask) {
    if (tid == 0) feed.base = atomicAdd(counter, kCellChunk);
    __syncthreads();
    cur.c0 = feed.base;
    if (cur.c0 >= g.n_cells) return false;
    if (tid < kWarp) {
      int cc = cur.c0 + tid;
      bool full = cc < g.n_cells && g.starts[cc + 1] > g.starts[cc];
      unsigned m = __ballot_sync(kFull, full);
      if (tid == 0) feed.cells = m;
    }
    __syncthreads();
    cur.mask = feed.cells;
  }
  *c = cur.c0 + __ffs(cur.mask) - 1;
  cur.mask &= cur.mask - 1;
  return true;
}

// Fills `runs` with the window of cell c (the first warp does; ends in a
// block barrier) and returns the number of runs.
__device__ __forceinline__ int cell_runs(const Grid& g, int c, Runs& runs) {
  const int cz = c % g.dz, cy = (c / g.dz) % g.dy, cx = c / (g.dz * g.dy);
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, g.dx - 1);
  const int y0 = max(cy - 1, 0), y1 = min(cy + 1, g.dy - 1);
  const int z0 = max(cz - 1, 0), z1 = min(cz + 1, g.dz - 1);
  const int ny = y1 - y0 + 1, n_runs = (x1 - x0 + 1) * ny;
  const int lane = threadIdx.x;
  if (lane < kWarp) {
    // offsets in the window by an inclusive scan over the first 16 lanes
    int rs = 0, re = 0;
    if (lane < n_runs) {
      int base = ((x0 + lane / ny) * g.dy + (y0 + lane % ny)) * g.dz;
      rs = g.starts[min(base + z0, g.n_cells)];
      re = g.starts[min(base + z1 + 1, g.n_cells)];
    }
    int off = re - rs;
    for (int o = 1; o < 16; o <<= 1) {
      int v = __shfl_up_sync(kFull, off, o);
      if (lane >= o) off += v;
    }
    if (lane < n_runs) {
      runs.s[lane] = rs;
      runs.e[lane] = re;
      runs.off[lane + 1] = off;
    }
    if (lane == 0) runs.off[0] = 0;
  }
  __syncthreads();
  return n_runs;
}

// Calls f(window position, sorted index) for every point of the window, the
// block's threads on neighbouring points of a run: the coalesced copy into
// the staged arrays.
template <class F>
__device__ __forceinline__ void for_each_staged(const Runs& runs, int n_runs,
                                                F f) {
  for (int u = 0; u < n_runs; ++u) {
    const int s = runs.s[u], len = runs.e[u] - s, o = runs.off[u];
    for (int i = threadIdx.x; i < len; i += blockDim.x) f(o + i, s + i);
  }
}

// Calls f(j) for every point of the window, lane-strided within each run:
// the walk from global memory of a window too large to stage.  Each lane sees
// its candidates in increasing j.
template <class F>
__device__ __forceinline__ void for_each_walked(const Runs& runs, int n_runs,
                                                int lane, F f) {
  for (int u = 0; u < n_runs; ++u)
    for (int j = runs.s[u] + lane; j < runs.e[u]; j += kWarp) f(j);
}

// The grid of a kernel that hands out cells: a block for every chunk, but no
// more than fit on the card at once (`smem` bytes of dynamic shared memory a
// block, raised above the 48 KB default where needed).
template <class K>
inline cudaError_t cell_blocks(K kernel, int threads, size_t smem,
                               int n_cells, int* blocks) {
  cudaError_t err = cudaSuccess;
  if (smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorLaunchOutOfResources;
  if (err != cudaSuccess) return err;
  int chunks = (n_cells + kCellChunk - 1) / kCellChunk;
  *blocks = chunks < sms * per_sm ? chunks : sms * per_sm;
  return cudaSuccess;
}

inline Grid make_grid(const float* pts, const int* starts, int n_cells,
                      float ox, float oy, float oz, float h, int dx, int dy,
                      int dz) {
  Grid g;
  g.pts = pts;
  g.starts = starts;
  g.n_cells = n_cells;
  g.ox = ox;
  g.oy = oy;
  g.oz = oz;
  g.h = h;
  g.dx = dx;
  g.dy = dy;
  g.dz = dz;
  return g;
}

inline int n_blocks(int n_queries) {
  return (n_queries + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace pwicp
