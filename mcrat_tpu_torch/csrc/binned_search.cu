// The carried AMR lookup on NVIDIA Hopper (sm_90a): grid.find_cell_rows,
// the cached-cell pin with the search of the lanes that left their cell, as
// one launch (mcrat_carried_lookup), with the clamp and the lane flags of a
// fused-round call on the carried branch.
//
// Replaces no TPU kernel.  The JAX package's lookup is jnp ops that XLA
// fuses (mcrat_tpu/grid.py:415 BinnedIndex.find, find_cell_rows).  The plain
// PyTorch version, mcrat_tpu_torch/grid.py find_cell_rows_reference with
// BinnedIndex.find (_find_chunk), runs ~40 eager ops for each of
// the 9 (27 in 3-D) neighbour bins of a lane chunk, and around the search
// ~55 more a lookup (hydro coordinates, domain test, the pin's six gathers
// and tests, a torch.nonzero of the missed lanes, one host sync, their
// gathers and the scatter back, the clamp and transport.lane_flags): on an
// AMR frame the launches of those ops, not the work, set the frame.  This
// kernel computes the same values, bit for bit: every formula below keeps
// the plain version's operation order in its dtypes (round-to-nearest
// intrinsics, and the build turns off FMA contraction).
//
// The search, for each lane that left its cell:
//   1. the bin along each axis, f = (x - grid_min) * inv_bin in the lane's
//      dtype TB, NaN -> 0, clamped to [-1, d], truncated toward zero,
//      clamped to [0, d - 1];
//   2. the neighbour bins in the plain version's order: dz outer (only where
//      the index has more than one bin along axis 2), then dy, then dx, each
//      over -1, 0, +1, every bin coordinate clamped to the grid;
//   3. within a bin, candidates s = 0 .. min(bin_count, max_slab) - 1 in
//      order (max_slab is the fullest bin's count for an index that
//      build_binned_index makes, so every cell of a bin), each through the
//      AABB test 2 |r - c| - size <= 0 on each axis used, in the test dtype
//      TG (the promotion of the lane's and the frame's dtypes);
//   4. the first hit's cell, or -1 where no bin holds the point (NaN
//      coordinates give -1 too).
// The carried lookup, for each lane:
//   1. the hydro coordinates of the MCRaT position, read through a lane
//      stride and an axis stride (the (16, Npad) state planes or an (N, 3)
//      tensor), and the strict domain test (hydro_coords.cuh);
//   2. the pin: cached >= 0 and geometry.in_block against the cached cell's
//      (clamped to the grid) centre and size, read from the frame's own
//      columns, in TG, on axis 2 in 3-D;
//   3. cell = -1 outside the domain, else the cached cell where the pin
//      holds, else the search's cell; in_grid = inside and cell >= 0;
//   4. either in_grid (one byte), or safe = clamp(cell, 0, n_cell - 1) and
//      the FLAG_* word alive * flag_alive + pool * flag_pool + in_grid *
//      flag_ingrid (transport.lane_flags).
//
// Bound on this card: the search's dependent gathers from L2, not HBM
// bandwidth and not arithmetic.  The tables (bin_start, bin_count, cell_ids
// and the geometry, ~4 MB for 167,936 cells in float32) stay resident in the
// 50 MB L2; a searched lane reads up to 9 (27) bin headers and one geometry
// row per candidate until its first hit, each load waiting on the one before
// it for its address or its exit.  A pinned lane reads its position, cached
// cell, masks and one cell's geometry and writes 12 bytes: ~30 bytes of HBM.
// The design answers with:
//   * one thread a lane and an early exit at the first hit, so a lane reads
//     only the candidates before its cell;
//   * a bin-ordered copy of the geometry columns (grid.BinnedIndex builds it
//     once for an index and a frame): a candidate is one 16-byte load at
//     bin_start + s (two in 3-D float32), where the plain version gathers
//     cell_ids and then each column; cell_ids is read on a hit alone;
//   * in the carried lookup, the block's missed lanes (about a fifth of a
//     frame's lanes, spread over nearly every warp) compacted into shared
//     memory by a warp ballot and a block prefix, and searched by the
//     block's first threads, so the searching lanes share warps and the
//     pinned lanes' warps retire instead of idling through the candidates;
//     each result goes to its lane's own slot, so the order of the lanes is
//     the plain version's by construction; one atomicAdd a block counts the
//     lanes searched into the caller's device counter;
//   * no temporaries and no host synchronisation: the outputs are tensors
//     the caller allocates, on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hydro_coords.cuh"

namespace {

constexpr int THREADS = 256;

// the search's lane table (the wrapper's BinnedIndex.search_tables), in TB:
// the frame's domain (lo, hi) per axis, grid_min per axis, 1 / bin size per
// axis
enum Param { P_DOM = 0, P_LO = 6, P_INV = 9, N_PARAM = 12 };

// the bin along one axis (grid.BinnedIndex._bin): the float is clamped
// before the conversion, so no value can overflow it
template <typename T>
__device__ __forceinline__ int bin_of(T x, T lo, T inv, int d) {
  T f = mul_rn(sub_rn(x, lo), inv);
  if (f != f) f = T(0);
  f = f < T(-1) ? T(-1) : (f > T(d) ? T(d) : f);
  const long long b = (long long)f;
  return (int)(b < 0 ? 0 : (b > d - 1 ? d - 1 : b));
}

__device__ __forceinline__ int clamp_bin(int b, int d) { return b < 0 ? 0 : (b > d - 1 ? d - 1 : b); }

// one axis of geometry.in_block: 2 |r - c| - size <= 0
template <typename T>
__device__ __forceinline__ bool on_axis(T r, T c, T size) {
  return sub_rn(mul_rn(T(2), fabs(sub_rn(r, c))), size) <= T(0);
}

// the geometry row of bin slot p: W values of T, [c0, c1, s0, s1] in 2-D,
// [c0, c1, s0, s1, c2, s2, 0, 0] in 3-D, read as 16-byte vectors
__device__ __forceinline__ void unpack(const float4& v, float* g) {
  g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* g) { g[0] = v.x; g[1] = v.y; }

template <typename T> struct Vec16;
template <> struct Vec16<float> { typedef float4 type; };
template <> struct Vec16<double> { typedef double2 type; };

// the test dtype: torch's promotion of the lanes' and the frame's dtypes
template <typename TB, typename TF> struct Promote { typedef double type; };
template <> struct Promote<float, float> { typedef float type; };

template <typename T, int W>
__device__ __forceinline__ void load_row(const T* __restrict__ geo, int64_t p, T* g) {
  typedef typename Vec16<T>::type V;
  constexpr int PER = 16 / sizeof(T);
  const V* src = reinterpret_cast<const V*>(geo + p * W);
#pragma unroll
  for (int q = 0; q < W / PER; ++q) unpack(__ldg(src + q), g + q * PER);
}

// the index and its bin-ordered geometry rows (in TG)
template <typename TG>
struct Index {
  const int* cell_ids;
  const int* bin_start;
  const int* bin_count;
  const TG* geo;
  int d0, d1, d2, max_slab;
};

// BinnedIndex.find of one point: its cell, or -1
template <typename TB, typename TG, bool D3>
__device__ __forceinline__ int search_cell(TB x0, TB x1, TB x2, const TB* __restrict__ params,
                                           const Index<TG>& a) {
  constexpr int W = D3 ? 8 : 4;
  const int b0 = bin_of(x0, __ldg(params + P_LO), __ldg(params + P_INV), a.d0);
  const int b1 = bin_of(x1, __ldg(params + P_LO + 1), __ldg(params + P_INV + 1), a.d1);
  const int b2 = D3 ? bin_of(x2, __ldg(params + P_LO + 2), __ldg(params + P_INV + 2), a.d2) : 0;
  const TG p0 = (TG)x0, p1 = (TG)x1, p2 = (TG)x2;
  for (int dz = D3 ? -1 : 0; dz <= (D3 ? 1 : 0); ++dz) {
    const int kk = clamp_bin(b2 + dz, a.d2);
    for (int dy = -1; dy <= 1; ++dy) {
      const int jj = clamp_bin(b1 + dy, a.d1);
      for (int dx = -1; dx <= 1; ++dx) {
        const int ii = clamp_bin(b0 + dx, a.d0);
        const int64_t flat = ((int64_t)kk * a.d1 + jj) * a.d0 + ii;
        const int64_t start = __ldg(a.bin_start + flat);
        const int count = min(__ldg(a.bin_count + flat), a.max_slab);
        for (int s = 0; s < count; ++s) {
          TG g[W];
          load_row<TG, W>(a.geo, start + s, g);
          if (on_axis(p0, g[0], g[2]) && on_axis(p1, g[1], g[3]) &&
              (!D3 || on_axis(p2, g[4], g[5])))
            return __ldg(a.cell_ids + start + s);
        }
      }
    }
  }
  return -1;
}

template <typename TB, typename TF>
struct CarriedArgs {
  const TB* pos;
  int64_t s_lane, s_axis, n;
  const int* cached;
  const TF* col[6];  // the frame's r0, r1, r2, dr0, dr1, dr2
  int n_cell;
  const TB* params;  // (N_PARAM,)
  Index<typename Promote<TB, TF>::type> index;
  int* cell;
  uint8_t* in_grid;  // or NULL: then safe and flags from the masks
  const uint8_t* alive;
  const uint8_t* pool;
  int* safe;
  int* flags;
  int flag_alive, flag_pool, flag_ingrid;
  unsigned long long* searched;  // or NULL
};

template <typename TB, typename TF>
__device__ __forceinline__ void put(const CarriedArgs<TB, TF>& a, int64_t i, int cell, bool inside) {
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

// G: the geometry of the hydro coordinates (hydro_coords.cuh's Geo); SD3:
// the index has more than one bin along axis 2
template <typename TB, typename TF, int G, bool SD3>
__global__ void __launch_bounds__(THREADS) carried_lookup_kernel(const CarriedArgs<TB, TF> a) {
  typedef typename Promote<TB, TF>::type TG;
  constexpr bool D3 = G == CART3 || G == SPH3 || G == POL3;
  constexpr int WARPS = THREADS / 32;
  __shared__ TB miss_r[3][THREADS];  // the missed lanes' coordinates, compacted
  __shared__ int miss_t[THREADS];  // and their threads
  __shared__ int warp_base[WARPS + 1];
  const int t = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.x * THREADS;
  const int64_t i = i0 + t;
  TB r0 = TB(0), r1 = TB(0), r2 = TB(0);
  bool miss = false;
  if (i < a.n) {
    const TB* p = a.pos + i * a.s_lane;
    to_hydro<TB, G>(p[0], p[a.s_axis], p[2 * a.s_axis], r0, r1, r2);
    const bool inside = in_domain<TB, D3>(r0, r1, r2, a.params + P_DOM);
    const int cached = a.cached[i];
    bool pinned = false;
    if (cached >= 0) {
      const int c = cached > a.n_cell - 1 ? a.n_cell - 1 : cached;
      pinned = on_axis((TG)r0, (TG)__ldg(a.col[0] + c), (TG)__ldg(a.col[3] + c)) &&
               on_axis((TG)r1, (TG)__ldg(a.col[1] + c), (TG)__ldg(a.col[4] + c)) &&
               (!D3 || on_axis((TG)r2, (TG)__ldg(a.col[2] + c), (TG)__ldg(a.col[5] + c)));
    }
    miss = inside && !pinned;
    if (!miss) put(a, i, inside ? cached : -1, inside);
  }
  // compact the missed lanes: a ballot a warp, a prefix over the warps
  const unsigned ballot = __ballot_sync(0xffffffffu, miss);
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) warp_base[warp + 1] = __popc(ballot);
  __syncthreads();
  if (t == 0) {
    warp_base[0] = 0;
    for (int w = 1; w <= WARPS; ++w) warp_base[w] += warp_base[w - 1];
    if (a.searched != nullptr && warp_base[WARPS] > 0)
      atomicAdd(a.searched, (unsigned long long)warp_base[WARPS]);
  }
  __syncthreads();
  if (miss) {
    const int slot = warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
    miss_r[0][slot] = r0;
    miss_r[1][slot] = r1;
    miss_r[2][slot] = r2;
    miss_t[slot] = t;
  }
  __syncthreads();
  // the block's first threads search the missed lanes
  if (t < warp_base[WARPS]) {
    const int cell = search_cell<TB, TG, SD3>(miss_r[0][t], miss_r[1][t], miss_r[2][t],
                                              a.params, a.index);
    put(a, i0 + miss_t[t], cell, true);
  }
}

template <typename TB, typename TF>
int launch_carried(int geometry, int three_d, const CarriedArgs<TB, TF>& a, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.n + THREADS - 1) / THREADS);
#define MCRAT_CARRIED(G, SD3) carried_lookup_kernel<TB, TF, G, SD3><<<blocks, THREADS, 0, s>>>(a)
  switch (geometry * 2 + (three_d ? 1 : 0)) {
    case CYL2 * 2: MCRAT_CARRIED(CYL2, false); break;
    case SPH2 * 2: MCRAT_CARRIED(SPH2, false); break;
    case CART3 * 2: MCRAT_CARRIED(CART3, false); break;
    case CART3 * 2 + 1: MCRAT_CARRIED(CART3, true); break;
    case SPH3 * 2: MCRAT_CARRIED(SPH3, false); break;
    case SPH3 * 2 + 1: MCRAT_CARRIED(SPH3, true); break;
    case POL3 * 2: MCRAT_CARRIED(POL3, false); break;
    case POL3 * 2 + 1: MCRAT_CARRIED(POL3, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MCRAT_CARRIED
  return (int)cudaGetLastError();
}

template <typename TB, typename TF>
int run_carried(int geometry, int three_d, const void* pos, int64_t s_lane, int64_t s_axis,
                int64_t n, const int* cached, const void* const* cols, int n_cell,
                const void* params, const int* cell_ids, const int* bin_start,
                const int* bin_count, const void* geo, int d0, int d1, int d2, int max_slab,
                int* cell, uint8_t* in_grid, const uint8_t* alive, const uint8_t* pool, int* safe,
                int* flags, int flag_alive, int flag_pool, int flag_ingrid, void* searched,
                cudaStream_t s) {
  typedef typename Promote<TB, TF>::type TG;
  CarriedArgs<TB, TF> a{(const TB*)pos, s_lane, s_axis, n, cached, {}, n_cell,
                        (const TB*)params,
                        Index<TG>{cell_ids, bin_start, bin_count, (const TG*)geo, d0, d1, d2,
                                  max_slab},
                        cell, in_grid, alive, pool, safe, flags, flag_alive, flag_pool,
                        flag_ingrid, (unsigned long long*)searched};
  for (int q = 0; q < 6; ++q) a.col[q] = (const TF*)cols[q];
  return launch_carried<TB, TF>(geometry, three_d, a, s);
}

}  // namespace

extern "C" {

// grid.find_cell_rows of n MCRaT positions, lane i's x, y, z at
// pos[i * s_lane + {0, 1, 2} * s_axis], behind the cached cells cached[i]
// (int32): the cell into cell and either in_grid (one byte a lane), or,
// where in_grid is NULL, safe and the FLAG_* word from the alive and pool
// masks (one byte a lane each).  geometry: one of Geo; lane_double and
// frame_double give the dtypes TB (pos, params) and TF (cols, the frame's
// r0, r1, r2, dr0, dr1, dr2 of n_cell cells); geo, the bin-ordered rows, is
// in their promotion.  three_d: the index has more than one bin along axis
// 2 (a 3-D geometry only).  searched: NULL, or an int64 on the device that
// gains the lanes searched.  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for another geometry, a grid with no bin or no cell,
// and 0 without a launch for n <= 0.
int mcrat_carried_lookup(int geometry, int lane_double, int frame_double, int three_d,
                         const void* pos, int64_t s_lane, int64_t s_axis, int64_t n,
                         const int* cached, const void* r0, const void* r1, const void* r2,
                         const void* dr0, const void* dr1, const void* dr2, int n_cell,
                         const void* params, const int* cell_ids, const int* bin_start,
                         const int* bin_count, const void* geo, int d0, int d1, int d2,
                         int max_slab, int* cell, uint8_t* in_grid, const uint8_t* alive,
                         const uint8_t* pool, int* safe, int* flags, int flag_alive,
                         int flag_pool, int flag_ingrid, void* searched, void* stream) {
  if (d0 < 1 || d1 < 1 || d2 < 1 || n_cell < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const void* cols[6] = {r0, r1, r2, dr0, dr1, dr2};
  cudaStream_t s = (cudaStream_t)stream;
#define MCRAT_RUN(TB, TF)                                                                        \
  run_carried<TB, TF>(geometry, three_d, pos, s_lane, s_axis, n, cached, cols, n_cell, params,    \
                      cell_ids, bin_start, bin_count, geo, d0, d1, d2, max_slab, cell, in_grid,  \
                      alive, pool, safe, flags, flag_alive, flag_pool, flag_ingrid, searched, s)
  if (!lane_double && !frame_double) return MCRAT_RUN(float, float);
  if (!lane_double && frame_double) return MCRAT_RUN(float, double);
  if (lane_double && !frame_double) return MCRAT_RUN(double, float);
  return MCRAT_RUN(double, double);
#undef MCRAT_RUN
}

const char* mcrat_binned_search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
