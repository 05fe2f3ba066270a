// Shared device helpers of the fixed-radius neighbourhood kernels.
//
// Every kernel of this library answers a question about the points within
// radius h of a query, over targets that build_grid (ops/grid_nn.py) sorted
// by linearised cell id (x-major, z fastest) with cell size h.  Any target
// within h of a query lies in the query's 27-cell window, and with z fastest
// that window is at most nine contiguous runs of the sorted array, read off
// the dense CSR array `starts`.  One warp serves one query: its lanes stride
// over the runs, so neighbouring lanes read neighbouring points.
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

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
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
