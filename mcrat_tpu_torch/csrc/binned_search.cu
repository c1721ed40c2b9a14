// The carried AMR search on NVIDIA Hopper (sm_90a): grid.BinnedIndex.find
// on CUDA tensors as one launch.
//
// Replaces no TPU kernel.  The JAX package's search is jnp ops that XLA
// fuses (mcrat_tpu/grid.py:415, BinnedIndex.find).  Its plain PyTorch
// version, mcrat_tpu_torch/grid.py BinnedIndex.find_reference (_find_chunk),
// runs ~40 eager ops for each of the 9 (27 in 3-D) neighbour bins of a lane
// chunk, over (lanes, max_slab) candidate slabs: on an AMR frame the launches
// of those ops, not the work, set the frame.  This kernel computes the same
// cells, bit for bit: every formula below keeps the plain version's
// operation order in its dtypes (round-to-nearest intrinsics, and the build
// turns off FMA contraction).
//
// For each lane (one thread):
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
//
// Bound on this card: dependent gathers from L2, not HBM bandwidth and not
// arithmetic.  The tables (bin_start, bin_count, cell_ids and the geometry,
// ~4 MB for 167,936 cells in float32) stay resident in the 50 MB L2; a lane
// reads up to 9 (27) bin headers and one geometry row per candidate until
// its first hit, each load waiting on the one before it for its address or
// its exit.  The design answers with:
//   * one thread a lane and an early exit at the first hit, so a lane reads
//     only the candidates before its cell;
//   * a bin-ordered copy of the geometry columns (grid.BinnedIndex builds it
//     once for an index and a frame): a candidate is one 16-byte load at
//     bin_start + s (two in 3-D float32), where the plain version gathers
//     cell_ids and then each column; cell_ids is read on a hit alone;
//   * no temporaries and no host synchronisation: the output is an int32
//     tensor the caller allocates, on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

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

template <typename T, int W>
__device__ __forceinline__ void load_row(const T* __restrict__ geo, int64_t p, T* g) {
  typedef typename Vec16<T>::type V;
  constexpr int PER = 16 / sizeof(T);
  const V* src = reinterpret_cast<const V*>(geo + p * W);
#pragma unroll
  for (int q = 0; q < W / PER; ++q) unpack(__ldg(src + q), g + q * PER);
}

template <typename TB, typename TG>
struct Args {
  const TB* r0;
  const TB* r1;
  const TB* r2;
  int64_t n;
  const int* cell_ids;
  const int* bin_start;
  const int* bin_count;
  const TG* geo;
  const TB* lo;   // (3,) grid_min in TB
  const TB* inv;  // (3,) 1 / bin size in TB
  int d0, d1, d2, max_slab;
  int* out;
};

template <typename TB, typename TG, bool D3>
__global__ void __launch_bounds__(THREADS) binned_search_kernel(const Args<TB, TG> a) {
  constexpr int W = D3 ? 8 : 4;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const TB x0 = a.r0[i], x1 = a.r1[i];
  const TB x2 = D3 ? a.r2[i] : TB(0);
  const int b0 = bin_of(x0, __ldg(a.lo), __ldg(a.inv), a.d0);
  const int b1 = bin_of(x1, __ldg(a.lo + 1), __ldg(a.inv + 1), a.d1);
  const int b2 = D3 ? bin_of(x2, __ldg(a.lo + 2), __ldg(a.inv + 2), a.d2) : 0;
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
              (!D3 || on_axis(p2, g[4], g[5]))) {
            a.out[i] = __ldg(a.cell_ids + start + s);
            return;
          }
        }
      }
    }
  }
  a.out[i] = -1;
}

template <typename TB, typename TG>
int launch(const void* r0, const void* r1, const void* r2, int64_t n, const int* cell_ids,
           const int* bin_start, const int* bin_count, const void* geo, const void* lo,
           const void* inv, int d0, int d1, int d2, int max_slab, int three_d, int* out,
           cudaStream_t s) {
  const Args<TB, TG> a{(const TB*)r0, (const TB*)r1, (const TB*)r2, n, cell_ids, bin_start,
                       bin_count, (const TG*)geo, (const TB*)lo, (const TB*)inv, d0, d1, d2,
                       max_slab, out};
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  if (three_d)
    binned_search_kernel<TB, TG, true><<<blocks, THREADS, 0, s>>>(a);
  else
    binned_search_kernel<TB, TG, false><<<blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The containing cell (int32, -1 for none) of n lanes into out.  lane_double
// and test_double give the dtypes TB (r0, r1, r2, lo, inv) and TG (geo):
// float/float, double/double or float/double.  three_d: the index has more
// than one bin along axis 2 (geo rows of 8, else 4).  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for another
// dtype pair or a grid with no bin, and 0 without a launch for n <= 0.
int mcrat_binned_search(int lane_double, int test_double, int three_d, const void* r0,
                        const void* r1, const void* r2, int64_t n, const int* cell_ids,
                        const int* bin_start, const int* bin_count, const void* geo,
                        const void* lo, const void* inv, int d0, int d1, int d2, int max_slab,
                        int* out, void* stream) {
  if (d0 < 1 || d1 < 1 || d2 < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!lane_double && !test_double)
    return launch<float, float>(r0, r1, r2, n, cell_ids, bin_start, bin_count, geo, lo, inv,
                                d0, d1, d2, max_slab, three_d, out, s);
  if (lane_double && test_double)
    return launch<double, double>(r0, r1, r2, n, cell_ids, bin_start, bin_count, geo, lo, inv,
                                  d0, d1, d2, max_slab, three_d, out, s);
  if (!lane_double && test_double)
    return launch<float, double>(r0, r1, r2, n, cell_ids, bin_start, bin_count, geo, lo, inv,
                                 d0, d1, d2, max_slab, three_d, out, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcrat_binned_search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
