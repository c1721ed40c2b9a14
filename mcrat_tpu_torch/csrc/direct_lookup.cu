// The rectilinear direct lookup on NVIDIA Hopper (sm_90a): grid.find_cell_direct
// on CUDA tensors as one launch, and, in a second entry, the fused-round
// kernel's lane inputs of the direct branch from the same launch.
//
// Replaces no TPU kernel.  The JAX package's lookup is jnp ops that XLA fuses
// (mcrat_tpu/grid.py find_cell_direct).  Its plain PyTorch version,
// mcrat_tpu_torch/grid.py find_cell_direct_reference, runs ~34 eager
// elementwise ops over every lane (the hydro coordinates, the strict domain
// test, RectilinearIndex.find's two or three axis indices, edge test and flat
// index); before every fused-round call the glue adds the clamp to a valid
// cell and transport.lane_flags' casts, products and sums, ~44 launches a
// call in all.  On the uniform-grid frames the host's time queueing those
// launches, not their work, sets the frame.  This kernel computes the same
// values, bit for bit: every formula below keeps the plain version's
// operation order in its dtypes (round-to-nearest intrinsics, the CUDA math
// library's sqrt, acos, atan2 and fmod as torch's CUDA ops call them, and the
// build turns off FMA contraction).
//
// For each lane (one thread), in the lanes' dtype T:
//   1. the hydro coordinates (geometry.mcrat_to_hydro; hydro_coords.cuh) of
//      the MCRaT position (x, y, z), read through a lane stride and an axis
//      stride, so that the kernel's (16, Npad) state planes and an (N, 3)
//      position tensor both go in without a copy;
//   2. the strict domain test (grid._hydro_inside) against the frame's
//      bounds rounded to T, on axis 2 too in 3-D;
//   3. RectilinearIndex.find: along each axis floor((x - lo) * inv_d)
//      converted to int32 on a uniform axis, else the last edge <= x
//      (searchsorted(right=True) - 1, compared in TE, the promotion of T and
//      the index's dtype), clamped to [0, n - 1]; the closed edge test
//      against the outer edges rounded to T; the C-order flat index
//      (i * n1 + j) * n2 + k, or i * n1 + j in 2-D, in wrapping int32;
//   4. cell = the flat index where both tests pass, else -1; in_grid =
//      cell >= 0 there.
// The second entry reads the lane's alive and pool masks too and writes
// safe = clamp(cell, 0, n_cell - 1) and the FLAG_* word
// alive * flag_alive + pool * flag_pool + in_grid * flag_ingrid
// (transport.lane_flags) in place of in_grid.
//
// Bound on this card: HBM bytes, and at the shapes of the main path hardly
// that: 12 bytes of position (24 in float64) and 2 of masks in, 12 out a
// lane, ~27 MB a 1M-lane call, ~8 us at 3.35 TB/s; the arithmetic is a few
// dozen instructions a lane (acos and atan2 on the spherical and polar grids
// only).  The design answers the cost it replaces, launches and the
// temporaries between them: one thread a lane, one launch, no temporaries,
// no host synchronisation, the outputs allocated by the caller on the
// caller's stream.  The frame's bounds and the index's lo, inv_d and outer
// edges come from a small table the wrapper keeps in T for the frame; the
// edges of a non-uniform axis (a few hundred values) stay in L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hydro_coords.cuh"

namespace {

constexpr int THREADS = 256;

// the table's entries (the wrapper's RectilinearIndex.lookup_tables):
// domain (lo, hi) per axis, lo and inv_d per axis, outer edges per axis
enum Param { P_DOM = 0, P_LO = 6, P_INV = 9, P_EDGE = 12, N_PARAM = 18 };

// RectilinearIndex.axis_index: clamped to [0, n - 1]
template <typename T, typename TE>
__device__ __forceinline__ int axis_index(T x, bool uniform, T lo, T inv,
                                          const TE* __restrict__ edges, int n) {
  int i;
  if (uniform) {
    i = (int)floor_(mul_rn(sub_rn(x, lo), inv));
  } else {
    // searchsorted(edges, x, right=True) - 1 over the n + 1 edges, compared
    // in TE; a NaN lane ends past the last edge, as torch's
    const TE v = (TE)x;
    int a = 0, b = n + 1;
    while (a < b) {
      const int mid = a + ((b - a) >> 1);
      if (!(__ldg(edges + mid) > v))
        a = mid + 1;
      else
        b = mid;
    }
    i = a - 1;
  }
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

template <typename T, typename TE>
struct Args {
  const T* pos;
  int64_t s_lane, s_axis, n;
  const T* params;  // (N_PARAM,)
  const TE* e0;
  const TE* e1;
  const TE* e2;
  int n0, n1, n2;
  int uniform;  // bit a: axis a is uniform
  int three_d;  // the index has a third axis
  int* cell;
  uint8_t* in_grid;  // or NULL (the second entry)
  const uint8_t* alive;  // the second entry: masks in, safe and flags out
  const uint8_t* pool;
  int* safe;
  int* flags;
  int n_cell, flag_alive, flag_pool, flag_ingrid;
};

template <typename T, typename TE, int G>
__global__ void __launch_bounds__(THREADS) direct_lookup_kernel(const Args<T, TE> a) {
  constexpr bool D3 = G == CART3 || G == SPH3 || G == POL3;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const T* p = a.pos + i * a.s_lane;
  T r0, r1, r2;
  to_hydro<T, G>(p[0], p[a.s_axis], p[2 * a.s_axis], r0, r1, r2);
  const T* q = a.params;
  const bool inside = in_domain<T, D3>(r0, r1, r2, q + P_DOM);
  const int ii = axis_index(r0, a.uniform & 1, __ldg(q + P_LO), __ldg(q + P_INV), a.e0, a.n0);
  const int jj = axis_index(r1, (a.uniform >> 1) & 1, __ldg(q + P_LO + 1), __ldg(q + P_INV + 1),
                            a.e1, a.n1);
  bool on_grid = r0 >= __ldg(q + P_EDGE) && r0 <= __ldg(q + P_EDGE + 1) &&
                 r1 >= __ldg(q + P_EDGE + 2) && r1 <= __ldg(q + P_EDGE + 3);
  // int32 arithmetic that wraps, as torch's
  uint32_t idx = (uint32_t)ii * (uint32_t)a.n1 + (uint32_t)jj;
  if (a.three_d) {
    const int kk = axis_index(r2, (a.uniform >> 2) & 1, __ldg(q + P_LO + 2), __ldg(q + P_INV + 2),
                              a.e2, a.n2);
    on_grid = on_grid && r2 >= __ldg(q + P_EDGE + 4) && r2 <= __ldg(q + P_EDGE + 5);
    idx = idx * (uint32_t)a.n2 + (uint32_t)kk;
  }
  const int cell = inside && on_grid ? (int)idx : -1;
  const bool in_grid = inside && cell >= 0;
  a.cell[i] = cell;
  if (a.in_grid != nullptr) {
    a.in_grid[i] = in_grid;
  } else {
    a.safe[i] = cell < 0 ? 0 : (cell > a.n_cell - 1 ? a.n_cell - 1 : cell);
    a.flags[i] = (int)a.alive[i] * a.flag_alive + (int)a.pool[i] * a.flag_pool +
                 (int)in_grid * a.flag_ingrid;
  }
}

template <typename T, typename TE>
int launch(int geometry, const Args<T, TE>& a, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.n + THREADS - 1) / THREADS);
  switch (geometry) {
    case CYL2: direct_lookup_kernel<T, TE, CYL2><<<blocks, THREADS, 0, s>>>(a); break;
    case SPH2: direct_lookup_kernel<T, TE, SPH2><<<blocks, THREADS, 0, s>>>(a); break;
    case CART3: direct_lookup_kernel<T, TE, CART3><<<blocks, THREADS, 0, s>>>(a); break;
    case SPH3: direct_lookup_kernel<T, TE, SPH3><<<blocks, THREADS, 0, s>>>(a); break;
    case POL3: direct_lookup_kernel<T, TE, POL3><<<blocks, THREADS, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename TE>
int run(int geometry, const void* pos, int64_t s_lane, int64_t s_axis, int64_t n,
        const void* params, const void* e0, const void* e1, const void* e2, int n0, int n1,
        int n2, int uniform, int three_d, int* cell, uint8_t* in_grid, const uint8_t* alive,
        const uint8_t* pool, int* safe, int* flags, int n_cell, int flag_alive, int flag_pool,
        int flag_ingrid, cudaStream_t s) {
  const Args<T, TE> a{(const T*)pos, s_lane, s_axis, n, (const T*)params, (const TE*)e0,
                      (const TE*)e1, (const TE*)e2, n0, n1, n2, uniform, three_d, cell, in_grid,
                      alive, pool, safe, flags, n_cell, flag_alive, flag_pool, flag_ingrid};
  return launch<T, TE>(geometry, a, s);
}

}  // namespace

extern "C" {

// The containing cell (int32, -1 outside the grid) of n MCRaT positions,
// lane i's x, y, z at pos[i * s_lane + {0, 1, 2} * s_axis], into cell, and
// either in_grid (one byte a lane), or, where in_grid is NULL, safe and the
// FLAG_* word from the alive and pool masks (one byte a lane each).
// geometry: one of Geo; lane_double and edge_double give the dtypes T (pos,
// params) and TE (e0, e1, e2): float/float, float/double or double/double.
// params: the (18,) table of Param in T.  e0, e1, e2: the n0 + 1, n1 + 1,
// n2 + 1 edges of each axis (read only on a non-uniform axis).  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for another
// geometry or dtype pair, an axis without a cell or no cell to clamp to, and
// 0 without a launch for n <= 0.
int mcrat_direct_lookup(int geometry, int lane_double, int edge_double, const void* pos,
                        int64_t s_lane, int64_t s_axis, int64_t n, const void* params,
                        const void* e0, const void* e1, const void* e2, int n0, int n1, int n2,
                        int uniform, int three_d, int* cell, uint8_t* in_grid,
                        const uint8_t* alive, const uint8_t* pool, int* safe, int* flags,
                        int n_cell, int flag_alive, int flag_pool, int flag_ingrid,
                        void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || (in_grid == nullptr && n_cell < 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define MCRAT_RUN(T, TE)                                                                        \
  run<T, TE>(geometry, pos, s_lane, s_axis, n, params, e0, e1, e2, n0, n1, n2, uniform, three_d, \
             cell, in_grid, alive, pool, safe, flags, n_cell, flag_alive, flag_pool,             \
             flag_ingrid, s)
  if (!lane_double && !edge_double) return MCRAT_RUN(float, float);
  if (!lane_double && edge_double) return MCRAT_RUN(float, double);
  if (lane_double && edge_double) return MCRAT_RUN(double, double);
#undef MCRAT_RUN
  return (int)cudaErrorInvalidValue;
}

const char* mcrat_direct_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
