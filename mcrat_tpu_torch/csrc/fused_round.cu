// Fused Monte Carlo transport rounds on NVIDIA Hopper (sm_90a).
//
// Replaces mcrat_tpu/ops/pallas_round.py::fused_rounds (the pallas_call at
// :1185, kernel body _make_kernel :574-1111) with DIRECT Thomson or TABLE
// (hot cross-section) optical depth, thermal electrons and, in TABLE mode on
// the packed variants, nonthermal (broken) power-law electrons, Stokes on or
// off, for every (dims x geometry) frame on a rectilinear grid or an AMR cell
// list (the carried path, TABLE through per-lane aux planes).  Its plain
// PyTorch twin is mcrat_tpu_torch/ops/fused_round.py::fused_rounds_reference;
// the two are held against each other lane for lane, so every formula below
// keeps the twin's operation order (and the build turns off FMA contraction).
//
// Each photon lane runs `inner_rounds` complete rounds:
//   comoving boost -> tau-rate -> free path -> move -> electron draw
//   -> polarized Klein-Nishina scatter attempt -> Stokes -> cell membership.
// A lane that leaves its cell stalls until the caller re-resolves its cell.
// A CUDA block of THREADS lanes (256 or 512 by instantiation) runs its rounds
// together (fused_rounds_kernel below): each lane's own work on its thread,
// the accepted scatters packed onto the block's threads.
//
// Optical-depth families (template parameter TAU; the C entry point
// dispatches on a family code and a variant code):
//   0 DIRECT   sigma_hat = 1 (pallas_round.py:957-958)
//   1 CHEB     TABLE: sigma_hat from the cell's 16 Chebyshev rows at
//              cheb_base (ops/hot_xsec.thermal_cheb_cells), evaluated by a
//              branch-select Clenshaw recurrence at the CURRENT comoving
//              energy every round, after the comoving boost
//              (pallas_round.py:890-931,968-985); the 11 variants
//   2 CHEB_NT  CHEB + nonthermal electrons (pallas_round.py:318-406,933-944,
//              972-983,1019-1035): biased total rate tau0 + N_GAMMA tau_norm,
//              population draw and subgroup inverse-CDF gamma from a runtime
//              constant struct (NtConsts); the 7 packed variants
//   3 AUX      TABLE on the carried AMR path (pallas_round.py:71-75,784-788,
//              879-888,1072-1080): n_sigma (the biased total tau coefficient
//              before the fluid factor) read per lane from aux plane 0 in
//              place of n_e sigma_T, rate = n_sigma (1 - beta cos); a lane
//              that scatters with time left also stalls, since its plane is
//              then stale; the 7 packed variants
//   4 AUX_NT   AUX + nonthermal electrons: the thermal probability p_th from
//              aux plane 1 feeds CHEB_NT's population draw and subgroup
//              sampler (the same 117-draw layout); the 7 packed variants
// 86 instantiations in all (22 + 22 + 14 + 14 + 14, each with Stokes on and
// off).
//
// Variants (template parameters; the C entry point dispatches on an int code,
// the same codes as fused_round.VARIANTS); one call's time on an H100, kernel
// vs plain twin, for each instantiation is in PERF.md section 6:
//   code  name          cell table (rows)        replaces (pallas_round.py)
//   0     ultra_cyl2    physics (4), centre i,j  :606-617,846-850,744-757
//   1     ultra_sph2    physics (4), centre i,j  :606-617,836-844,758-779
//                       + sin/cos theta centre
//   2     ultra_cart3   physics (5), i,j,k       :618-620,851-861,682-697
//   3     slim_cyl2     PCOL_SLIM (8)            :621-627,744-757
//   4     packed_cyl2   PCOL (16)                :629-647,744-757,875-878
//   5     packed_cyl25  PCOL (16), phi-hat v2    :636-647,744-757,875-878
//   6     packed_sph2   PCOL (16)                :648-655,758-779,875-878
//   7     packed_sph25  PCOL (16), phi-hat v2    :636-655,758-779,875-878
//   8     packed_cart3  PCOL (16)                :634-635,682-697,875-878
//   9     packed_sph3   PCOL (24)                :634-635,698-723,875-878
//   10    packed_pol3   PCOL (16)                :634-635,724-742,875-878
// Each exists with Stokes on and off.  The variants differ only in where the
// cell's values come from (the Cell struct below) and in the geometry of the
// fluid velocity and of the membership test; the round body is shared.
//
// What bounds it on this card.  A running lane reads 64 B of state (16 f32
// planes), 8 B of flags and cell index, the rows of its cell that Cell::load
// reads (4-16 words, + 16 Chebyshev rows in CHEB families), 4-8 B of aux
// planes in the AUX families, and writes 64 B + 4 B of out-flags per call.
// Against that it does ~115 uniforms (a murmur3 finalizer each, 12 integer
// operations) and ~40 math calls per round: sqrt, rsqrt, division and exp
// take one MUFU (SFU) instruction each and 2-10 FP32 operations; log, sin
// and cos are FP32 polynomials (27, 20, 33 for sin and cos of one argument,
// tools/sass_counts.py); and a double Klein-Nishina form per attempt.  The
// least time of a call on any one pipe (chip_smoke.bound: bytes over HBM,
// FP32, INT32, SFU, FP64) is ~0.01 ms at 245k lanes, set by the bytes or
// the FP32 operations; the calls take many times that.  What the pipes do
// not see sets the time: divergence (a warp runs a branch when any of its 32
// lanes takes it; in the nonthermal frames 3 of 4 attempts are null
// collisions, so the long accepted-scatter branch ran at ~1/3 of a warp's
// lanes), rejection loops that run to the warp's longest trial, and the
// latency of dependent SFU, integer and FP64 chains at the occupancy 77-116
// registers a thread left (one thread a lane, all state in registers,
// 128-thread blocks).  The design follows from that (PERF.md section 6):
//   * block-synchronous rounds: a block of THREADS lanes runs each round in
//     two phases between barriers.  Phase A is the lane's own work up to the
//     KN acceptance draw; an accepted lane leaves the scatter's inputs in its
//     shared-memory column and appends its slot to a block queue (a ballot
//     and one shared atomic a warp).  Phase B packs the queue onto the
//     block's threads: angles, outgoing photon, Fano matrix, rotations and
//     de-boosts run at full warps.  Draw numbers are static and keyed by the
//     owner lane (k = round * per_round + offset, base from pid and the lane
//     in its logical block), so the thread that runs an entry does not change
//     a random number, and every lane stays bit-identical to the twin;
//   * lane state and the cell's per-lane quantities live in shared memory
//     for the call (structure of arrays, field f of thread t at
//     f * THREADS + t: a warp's accesses hit 32 banks), 28-56 floats a lane
//     by variant and family (Layout), so registers hold one phase's
//     temporaries: __launch_bounds__ holds them to 64 (1,024 resident
//     threads an SM; a few bytes spill in some Stokes instantiations, and 72
//     registers without spills measured slower).  The block follows the
//     instantiation (block_threads): 512 threads with Stokes, where the
//     scatter is long and a larger queue packs more of it (the lead
//     instantiations ran 7-9 % faster than at 256 on an H100), as long as
//     two blocks fit an SM's shared memory; 256 without Stokes, where a short scatter
//     packs little and a smaller block waits less at its barriers, and for
//     the one layout too large for two 512-thread blocks (packed_sph3
//     CHEB_NT, 56 floats a lane) (PERF.md section 6).  The scatter's
//     inputs reuse the owner's momentum and Stokes planes (phase B
//     overwrites them), so the exchange adds 3 floats a lane.  State is read
//     from and written to device memory once a call, coalesced; the lane
//     reads its own cell's rows by index once a call (not coalesced, a few
//     words a lane; the largest table, 17 MB, stays in the 50 MB L2);
//   * idle lanes (past n, idle logical block, dead, out of time, stalled)
//     take part in the barriers and nothing else; a block with no running
//     lane returns at once, and a block whose lanes all stop leaves the round
//     loop together.  A logical block (block_lanes, 16,384 on the main path)
//     need not be a multiple of THREADS: each lane finds its own;
//   * the electron samplers stay in phase A: the attempt branch runs at
//     1.25-2x its packed warp count on the lead frames (the twin's warp
//     tally), and only the Maxwell-Juttner trials are sparser, which a queue
//     packed once at the attempt would not repack trial by trial.
//   * no TMA or wgmma: there is no matrix product and no tile stream.
// Transcendentals (logf, expf, sinf/cosf, log1p) are the functions PyTorch's
// CUDA torch.log/exp/sin/cos/log1p call, so kernel and twin agree to the bit.
// The Klein-Nishina closed form runs in double (fault F6: in float32 its
// ~2/e^2 terms cancel to ~1 and lose up to 0.25 just above e = 1e-3), one
// evaluation per scatter attempt.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

#define F32(x) ((float)(x))

constexpr int SP_P0 = 0, SP_P1 = 1, SP_P2 = 2, SP_P3 = 3;
constexpr int SP_X = 4, SP_Y = 5, SP_Z = 6;
constexpr int SP_Q = 7, SP_U = 8, SP_V = 9;
constexpr int SP_TREM = 10, SP_NS = 11;
constexpr int SP_C0 = 12, SP_C1 = 13, SP_C2 = 14, SP_C3 = 15;

constexpr int FLAG_ALIVE = 1, FLAG_POOL = 2, FLAG_INGRID = 4;
constexpr int OUT_STALLED = 1, OUT_PROMOTED = 2;

// cell-table rows: packed (grid.PCOL) and slim (grid.PCOL_SLIM)
constexpr int P_R0 = 0, P_R1 = 1, P_R2 = 2, P_DR0 = 3, P_DR1 = 4, P_DR2 = 5;
constexpr int P_V0 = 6, P_V1 = 7, P_V2 = 8, P_GAMMA = 9, P_DENS = 10, P_TEMP = 11;
constexpr int P_SIN1 = 13, P_COS1 = 14, P_SIN2 = 16, P_COS2 = 17;
constexpr int S_R0 = 0, S_R1 = 1, S_DR0 = 2, S_DR1 = 3, S_V0 = 4, S_V1 = 5, S_NE = 6,
              S_TEMP = 7;

// membership geometry and cell-table source of a variant
enum Geo { CYL2 = 0, SPH2 = 1, CART3 = 2, SPH3 = 3, POL3 = 4 };
enum Src { ULTRA = 0, SLIM = 1, PACKED = 2 };

struct Grid {
  // strict domain: r0 in (dom0, dom1), r1 in (dom2, dom3), r2 in (dom4, dom5)
  float dom0, dom1, dom2, dom3, dom4, dom5;
  float lo0, d0, lo1, d1, lo2, d2;  // uniform cell geometry (ultra)
  int n1, n2;                       // cells along axes 1 and 2
};

struct Consts {
  float kb_over_mec2, thom, c_light, inv_c, inv_mp;  // from mcrat_tpu.constants
};

enum Tau { DIRECT = 0, CHEB = 1, CHEB_NT = 2, AUX = 3, AUX_NT = 4 };
constexpr int CHEB_DLO = 5, CHEB_DHI = 8;  // ops/hot_xsec.py CHEB_*
constexpr int P_NTDENS = 12;

// nonthermal constants, float32 values formed on the host as the JAX kernel
// forms them (fused_round.NtConstants, the same field order); flags are 0/1
struct NtConsts {
  float broken, p_is_1, p2_is_1;
  float n_gamma, inv_n_gamma, n_gamma_m1;
  float thom_f1, invk1, span1;  // subgroup-1 fit (ops/hot_xsec._sub1_cheb_static)
  float c1_lo[CHEB_DLO + 1], c1_hi[CHEB_DHI + 1];
  float lg_min, dg, ln10, ln10_dg;
  float q, inv_q;  // power law
  float gmin, gbrk, a_norm, a_cont, f_break, om_p1, om_p2, gmin_pow, gbrk_pow;  // broken
};
static_assert(sizeof(NtConsts) == 39 * sizeof(float), "NtConsts must match NtConstants");

// ---------------------------------------------------------------------------
// counter-based uniforms (ops/rng.py)

__device__ __forceinline__ float uniform(uint32_t base, uint32_t k) {
  uint32_t x = base + k * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return __uint_as_float((x >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float uniform_pos(uint32_t base, uint32_t k) {
  return fmaxf(uniform(base, k), F32(1e-37));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// ---------------------------------------------------------------------------
// component-form device functions (pallas_round.py names)

// photon Lorentz boost by (bx, by, bz) + zero_norm
__device__ __forceinline__ void boost(float bx, float by, float bz, float p0,
                                      float p1, float p2, float p3, float& o0,
                                      float& o1, float& o2, float& o3) {
  const float b2 = bx * bx + by * by + bz * bz;
  const bool pos = b2 > 0.0f;
  const float safe_b2 = pos ? b2 : 1.0f;
  const float gam = rsqrtf(fmaxf(1.0f - b2, F32(1e-30)));
  const float bdotp = bx * p1 + by * p2 + bz * p3;
  float p0n = gam * (p0 - bdotp);
  const float coef = (gam - 1.0f) * bdotp / safe_b2 - gam * p0;
  const float q1 = pos ? p1 + coef * bx : p1;
  const float q2 = pos ? p2 + coef * by : p2;
  const float q3 = pos ? p3 + coef * bz : p3;
  p0n = pos ? p0n : p0;
  const float n = sqrtf(q1 * q1 + q2 * q2 + q3 * q3);
  const float scale = n > 0.0f ? p0n / fmaxf(n, F32(1e-37)) : 1.0f;
  o0 = p0n;
  o1 = q1 * scale;
  o2 = q2 * scale;
  o3 = q3 * scale;
}

// Stokes (q, u) rotation between the (v_old, ref_old) and (v_new, ref_new)
// bases
__device__ __forceinline__ void rotate_basis(float vox, float voy, float voz,
                                             float rox, float roy, float roz,
                                             float vnx, float vny, float vnz,
                                             float rnx, float rny, float rnz,
                                             float& q, float& u) {
  const float ax = roy * voz - roz * voy;
  const float ay = roz * vox - rox * voz;
  const float az = rox * voy - roy * vox;
  const float bx = rny * vnz - rnz * vny;
  const float by = rnz * vnx - rnx * vnz;
  const float bz = rnx * vny - rny * vnx;
  const float dot_ab = ax * bx + ay * by + az * bz;
  const float n2 = (ax * ax + ay * ay + az * az) * (bx * bx + by * by + bz * bz);
  float d = clampf(dot_ab * rsqrtf(fmaxf(n2, F32(1e-37))), -1.0f, 1.0f);
  d = n2 > 0.0f ? d : 0.0f;
  const float cx = ay * voz - az * voy;
  const float cy = az * vox - ax * voz;
  const float cz = ax * voy - ay * vox;
  const float f = signf(cx * bx + cy * by + cz * bz);
  const float c2 = f == 0.0f ? 1.0f : 2.0f * d * d - 1.0f;
  const float s2 = -f * 2.0f * d * sqrtf(fmaxf(1.0f - d * d, 0.0f));
  const float qn = c2 * q - s2 * u;
  const float un = s2 * q + c2 * u;
  q = qn;
  u = un;
}

// sigma_KN / sigma_T; the closed form in double, rounded once (F6 repair)
__device__ __forceinline__ float kn_cross_section(float e) {
  if (!(e >= F32(1e-3))) return 1.0f - 2.0f * e;
  const double se = fmax((double)e, 1e-10);
  const double t = 1.0 + 2.0 * se;
  return (float)(0.75 * (2.0 / (se * se) +
                         (1.0 / (2.0 * se) - (1.0 + se) / (se * (se * se))) * log1p(2.0 * se) +
                         (1.0 + se) / (t * t)));
}

// branch-select Clenshaw of a two-interval Chebyshev fit of log10 sigma:
// linear x below the KN knee (x < 1), log space above it; coefficient k at
// c_lo[k * STRIDE] (a lane's column in shared memory, or a plain array)
template <int STRIDE>
__device__ __forceinline__ float cheb_eval(float x, float span_inv, const float* c_lo,
                                           const float* c_hi) {
  const bool lo = x < 1.0f;
  float t;
  if (lo) {
    t = 2.0f * x - 1.0f;
  } else {
    const float lgx = logf(fmaxf(x, F32(1e-37))) * F32(0.4342944819032518);
    t = clampf(2.0f * lgx * span_inv - 1.0f, -1.0f, 1.0f);
  }
  float bk1 = 0.0f, bk2 = 0.0f;
#pragma unroll
  for (int k = CHEB_DHI; k > 0; --k) {
    const float ck = lo ? (k <= CHEB_DLO ? c_lo[k * STRIDE] : 0.0f) : c_hi[k * STRIDE];
    const float bk0 = ck + 2.0f * t * bk1 - bk2;
    bk2 = bk1;
    bk1 = bk0;
  }
  const float f = (lo ? c_lo[0] : c_hi[0]) + t * bk1 - bk2;
  return expf(f * F32(2.302585092994046));
}

// broken power law: integrals of g^-p1 from gamma_min, of g^-p2 from
// gamma_break, and the CDF
__device__ __forceinline__ float bpl_seg1(float hi, const NtConsts& c) {
  if (c.p_is_1 != 0.0f) return logf(hi / c.gmin);
  return (expf(c.om_p1 * logf(hi)) - c.gmin_pow) / c.om_p1;
}

__device__ __forceinline__ float bpl_seg2(float hi, const NtConsts& c) {
  if (c.p2_is_1 != 0.0f) return logf(hi / c.gbrk);
  return (expf(c.om_p2 * logf(hi)) - c.gbrk_pow) / c.om_p2;
}

__device__ __forceinline__ float bpl_cdf(float g, const NtConsts& c) {
  const float below = c.a_norm * bpl_seg1(fminf(g, c.gbrk), c);
  const float above = c.f_break + c.a_cont * bpl_seg2(fmaxf(g, c.gbrk), c);
  return g <= c.gbrk ? below : above;
}

// inverse-CDF gamma of the (broken) power law restricted to subgroup sub_f
__device__ __forceinline__ float nonthermal_gamma(float u, float sub_f, const NtConsts& c) {
  if (c.broken == 0.0f) {
    const float ln_lo = c.ln10 * (c.lg_min + sub_f * c.dg);
    const float ln_hi = ln_lo + c.ln10_dg;
    if (c.p_is_1 != 0.0f) return expf(ln_lo + u * (ln_hi - ln_lo));
    const float a = expf(c.q * ln_lo);
    const float b = expf(c.q * ln_hi);
    return expf(c.inv_q * logf(fmaxf(a + u * (b - a), F32(1e-37))));
  }
  const float g_lo = expf(c.ln10 * (c.lg_min + sub_f * c.dg));
  const float g_hi = expf(c.ln10 * (c.lg_min + (sub_f + 1.0f) * c.dg));
  const float f_lo = bpl_cdf(g_lo, c);
  const float f_hi = bpl_cdf(g_hi, c);
  const float x = f_lo + u * (f_hi - f_lo);
  float lo, hi;
  if (c.p_is_1 != 0.0f) {
    lo = c.gmin * expf(x / c.a_norm);
  } else {
    const float arg = c.gmin_pow + (c.om_p1 * x) / c.a_norm;
    lo = expf(logf(fmaxf(arg, F32(1e-37))) / c.om_p1);
  }
  const float x2 = (x - c.f_break) / c.a_cont;
  if (c.p2_is_1 != 0.0f) {
    hi = c.gbrk * expf(x2);
  } else {
    const float arg2 = c.gbrk_pow + c.om_p2 * x2;
    hi = expf(logf(fmaxf(arg2, F32(1e-37))) / c.om_p2);
  }
  return x <= c.f_break ? lo : hi;
}

struct Offsets {
  uint32_t free_, mb, mj, pop, el, acc, theta, phi, per_round;
};

// static draw numbers within a round; nonthermal electrons add the
// population draw and the sampler's uniform after the thermal trials
__device__ __forceinline__ Offsets draw_offsets(int el_iters, int kn_iters, bool nt) {
  Offsets o;
  o.free_ = 1;
  o.mb = 2;
  o.mj = 5;
  o.pop = o.mj + 5u * el_iters;
  o.el = o.pop + (nt ? 2u : 0u);
  o.acc = o.el + 2u;
  o.theta = o.el + 3u;
  o.phi = o.theta + 2u * kn_iters;
  o.per_round = o.phi + 2u * kn_iters - 1u;
  return o;
}

// thermal (gamma, gamma beta): Maxwell-Boltzmann chi2_3 speed draw below the
// 1e7 K switch, Maxwell-Juttner Gamma-mixture rejection above it
__device__ __forceinline__ void thermal_gamma_beta(uint32_t base, uint32_t k0,
                                                   const Offsets& off, float temp,
                                                   int el_iters, const Consts& cst,
                                                   float& gamma, float& gb) {
  const float theta = fmaxf(temp * cst.kb_over_mec2, F32(1e-37));
  if (theta < F32(1.6863699656e-3)) {
    const float u1 = uniform_pos(base, k0 + off.mb);
    const float u2 = uniform_pos(base, k0 + off.mb + 1u);
    const float u3 = uniform(base, k0 + off.mb + 2u);
    const float cosb = cosf(F32(2.0 * 3.14159265358979323846) * u3);
    const float chi2_3 = -2.0f * logf(u1) - 2.0f * logf(u2) * (cosb * cosb);
    const float b2 = fminf(theta * chi2_3, F32(0.999999));
    gamma = rsqrtf(1.0f - b2);
    gb = gamma * sqrtf(b2);
    return;
  }
  const float sqrt_theta = sqrtf(theta);
  const float m3 = 2.0f * theta * sqrt_theta;
  const float inv_mass = 1.0f / (1.0f + m3);
  const float cum1 = 0.5f * inv_mass;
  const float cum2 = inv_mass;
  float xi = 1.5f;
  for (int t = 0; t < el_iters; ++t) {
    const uint32_t k = k0 + off.mj + 5u * t;
    const float v0 = uniform_pos(base, k);
    const float v1 = uniform_pos(base, k + 1u);
    const float v2 = uniform_pos(base, k + 2u);
    const float um = uniform(base, k + 3u);
    const float ua = uniform(base, k + 4u);
    const float p2 = v0 * v1;
    const float prod = um < cum1 ? v0 : (um < cum2 ? p2 : p2 * v2);
    const float cand = -logf(prod);
    const float a = theta * cand;
    const float target = (1.0f + a) * sqrtf(fmaxf(a * (2.0f + a), 0.0f));
    const float envelope = sqrt_theta * (1.0f + cand) + 2.0f * (theta * theta) * (cand * cand);
    if (ua * envelope <= target) {
      xi = cand;
      break;
    }
  }
  const float a = theta * xi;
  gamma = 1.0f + a;
  gb = sqrtf(fmaxf(a * (2.0f + a), 0.0f));
}

// relative-angle draw + rotation into the photon's axes; returns the
// electron four-velocity (g0, ex, ey, ez)
__device__ __forceinline__ void electron_from_gamma(uint32_t base, uint32_t k0,
                                                    const Offsets& off, float gamma,
                                                    float gb, float c1, float c2,
                                                    float c3, float& ex, float& ey,
                                                    float& ez) {
  const float beta = gb / gamma;
  const float uu = uniform(base, k0 + off.el);
  const float safe_beta = fmaxf(beta, F32(1e-8));
  const float arg = 1.0f + safe_beta * safe_beta + 2.0f * safe_beta - 4.0f * safe_beta * uu;
  float cos_t = (1.0f - sqrtf(fmaxf(arg, 0.0f))) / safe_beta;
  cos_t = beta < F32(1e-6) ? 2.0f * uu - 1.0f : cos_t;
  cos_t = clampf(cos_t, -1.0f, 1.0f);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const float phi = uniform(base, k0 + off.el + 1u) * F32(2.0 * 3.14159265358979323846);
  const float sp = sinf(phi), cp = cosf(phi);
  const float e1 = gb * cos_t;
  const float e2 = gb * sin_t * sp;
  const float e3 = gb * sin_t * cp;
  const float rho2 = c2 * c2 + c3 * c3;
  const float rho = sqrtf(rho2);
  const float norm = sqrtf(rho2 + c1 * c1);
  const float inv_norm = 1.0f / fmaxf(norm, F32(1e-37));
  const float c_th = c1 * inv_norm;
  const float s_th = rho * inv_norm;
  const float safe_rho = fmaxf(rho, F32(1e-37));
  const bool has = rho > 0.0f;
  const float c_ph = has ? c3 / safe_rho : 1.0f;
  const float s_ph = has ? c2 / safe_rho : 0.0f;
  const float vx = c_th * e1 - s_th * e3;
  const float vy = e2;
  const float vz = s_th * e1 + c_th * e3;
  ex = vx;
  ey = c_ph * vy + s_ph * vz;
  ez = -s_ph * vy + c_ph * vz;
}

// KN theta rejection + (polarized) phi disk-point rejection
template <bool STOKES>
__device__ __forceinline__ void sample_kn_angles(uint32_t base, uint32_t k0,
                                                 const Offsets& off, float e0,
                                                 float q, float u, int kn_iters,
                                                 float& ct, float& st,
                                                 float& c_phi, float& s_phi) {
  float cos_theta = 0.0f;
  for (int t = 0; t < kn_iters; ++t) {
    const uint32_t k = k0 + off.theta + 2u * t;
    const float c = 2.0f * uniform(base, k) - 1.0f;
    const float y = 2.0f * uniform(base, k + 1u);
    const float m = 1.0f + e0 * (1.0f - c);
    const float f = (e0 * (1.0f - c) + 1.0f / m + c * c) / (m * m);
    if (y < f) {
      cos_theta = c;
      break;
    }
  }
  cos_theta = clampf(cos_theta, -1.0f, 1.0f);
  const float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
  float f_theta = 0.0f, pol_amp = 0.0f, safe_norm = 1.0f;
  bool unpolarized = true;
  if (STOKES) {
    const float mu = 1.0f + e0 * (1.0f - cos_theta);
    const float inv_mu = 1.0f / mu;
    const float inv_mu3 = inv_mu * (inv_mu * inv_mu);
    f_theta = (inv_mu + inv_mu3 - (sin_theta * sin_theta) * inv_mu * inv_mu) * sin_theta;
    pol_amp = sin_theta * (sin_theta * sin_theta) * inv_mu * inv_mu;
    const float safe_qu = fmaxf(sqrtf(q * q + u * u), F32(1e-37));
    const float cos2pm = q / safe_qu;
    const float sin2pm = fabsf(u) / safe_qu;
    const float norm = f_theta + pol_amp * (q * cos2pm - u * sin2pm);
    unpolarized = (q == 0.0f) && (u == 0.0f);
    safe_norm = norm != 0.0f ? norm : 1.0f;
  }
  float x_acc = 1.0f, y_acc = 0.0f;
  for (int t = 0; t < kn_iters; ++t) {
    const uint32_t k = k0 + off.phi + 2u * t;
    const float x = 2.0f * uniform(base, k) - 1.0f;
    const float y = 2.0f * uniform(base, k + 1u) - 1.0f;
    const float r2 = x * x + y * y;
    bool ok = (r2 <= 1.0f) && (r2 > F32(1e-37));
    if (STOKES && ok && !unpolarized) {
      const float safe_r2 = fmaxf(r2, F32(1e-37));
      const float c2 = (x * x - y * y) / safe_r2;
      const float s2 = (2.0f * x * y) / safe_r2;
      const float f = (f_theta + pol_amp * (q * c2 - u * s2)) / safe_norm;
      ok = r2 < f;
    }
    if (ok) {
      x_acc = x;
      y_acc = y;
      break;
    }
  }
  const float inv_r = rsqrtf(fmaxf(x_acc * x_acc + y_acc * y_acc, F32(1e-37)));
  ct = cos_theta;
  st = sin_theta;
  c_phi = x_acc * inv_r;
  s_phi = y_acc * inv_r;
}

__device__ __forceinline__ void phi_components(float px, float py, float& c, float& s) {
  const float rho = sqrtf(px * px + py * py);
  const bool has = rho > 0.0f;
  const float safe = has ? rho : 1.0f;
  c = has ? px / safe : 1.0f;
  s = has ? py / safe : 0.0f;
}

__device__ __forceinline__ bool in_axis(float h, float c, float d) {
  return 2.0f * fabsf(h - c) - d <= 0.0f;
}

// ---------------------------------------------------------------------------
// the block's shared memory: one column of floats per thread (structure of
// arrays, field f of thread t at f * THREADS + t, so a warp's accesses fall
// in 32 different banks); the 16 state planes first, then the variant's
// per-lane cell quantities, then the fluid velocity a scatter entry needs

constexpr int N_STATE = 16;
constexpr int SM_SMEM = 228 * 1024;  // shared memory of an SM
constexpr int BLOCK_SMEM_EXTRA = 4096;  // a block's static arrays and the runtime's 1 KB, with room

// threads of an instantiation's CUDA block (fused_round.cuda_block): 512
// with Stokes, where the scatter is long and a larger queue packs more of
// it, as long as two such blocks fit an SM's shared memory; else 256 (a
// short scatter packs little and a smaller block waits less at its
// barriers).  Resident threads are held to 1,024 an SM, so <= 64 registers.
template <bool STOKES, int COUNT>
constexpr int block_threads() {
  return STOKES && 2 * (COUNT * 512 * (int)sizeof(float) + BLOCK_SMEM_EXTRA) <= SM_SMEM ? 512
                                                                                        : 256;
}
constexpr int RESIDENT_THREADS = 1024;

template <int GEO, int SRC, bool V2, int TAU>
struct Layout {
  static constexpr bool D3 = GEO == CART3 || GEO == SPH3 || GEO == POL3;
  static constexpr bool ANG1 = GEO == SPH2 || GEO == SPH3 || GEO == POL3;
  static constexpr bool ANG2 = GEO == SPH3;
  static constexpr bool CHEBF = TAU == CHEB || TAU == CHEB_NT;
  static constexpr int V0 = N_STATE, V1 = V0 + 1, BETA = V0 + 2, NSIG = V0 + 3, TEMP = V0 + 4;
  static constexpr int CTR0 = V0 + 5, CTR1 = V0 + 6, SIZE0 = V0 + 7, SIZE1 = V0 + 8;
  static constexpr int BX = V0 + 9, BY = V0 + 10, BZ = V0 + 11;  // phase A -> phase B
  static constexpr int VV2 = V0 + 12;                             // if V2 or 3-D
  static constexpr int CTR2 = VV2 + ((V2 || D3) ? 1 : 0);         // 3-D: + CTR2, SIZE2
  static constexpr int SIZE2 = CTR2 + 1;
  static constexpr int S1 = CTR2 + (D3 ? 2 : 0);                  // + S1, C1, COSH1
  static constexpr int C1 = S1 + 1, COSH1 = S1 + 2;
  static constexpr int S2 = S1 + (ANG1 ? 3 : 0);                  // SPH3: + S2, C2, COSH2
  static constexpr int C2 = S2 + 1, COSH2 = S2 + 2;
  static constexpr int NE = S2 + (ANG2 ? 3 : 0);                  // CHEB_NT: + NE, NT1
  static constexpr int NT1 = NE + 1;
  static constexpr int PTH = NE + (TAU == CHEB_NT ? 2 : 0);       // AUX_NT: + PTH
  static constexpr int KNEE = PTH + (TAU == AUX_NT ? 1 : 0);      // CHEB: + 17 rows
  static constexpr int SPAN = KNEE + 1, CLO = KNEE + 2, CHI = CLO + CHEB_DLO + 1;
  static constexpr int COUNT = KNEE + (CHEBF ? 4 + CHEB_DLO + CHEB_DHI : 0);
};

// block-uniform grid cosines (spherical theta domain, azimuth domain)
enum { G_COS_DOM2 = 0, G_COS_DOM3, G_COS_MID, G_SIN_MID, G_COS_HALF_DOM, N_GCOS };

// ---------------------------------------------------------------------------
// per-lane cell quantities of a variant (pallas_round._kernel_body before
// round_body), its fluid velocity (fluid_beta) and membership test
// (in_cell_and_domain); fixed for the call, kept in the lane's column

template <int GEO, int SRC, bool V2, int TAU, int THREADS>
struct Cell {
  using L = Layout<GEO, SRC, V2, TAU>;
  float* s;          // the lane's column: field f at s[f * THREADS]
  const float* gc;   // block-uniform grid cosines

  __device__ __forceinline__ float& at(int f) const { return s[f * THREADS]; }

  // reads the rows chip_smoke.table_rows_read counts for the bound
  __device__ __forceinline__ void load(const float* __restrict__ t, int64_t ncell, int cl,
                                       const Grid& g, const Consts& cst, int cheb_base,
                                       const NtConsts& ntc) const {
    // the AUX families take n_sigma from their plane, not from the density
    constexpr bool AUXF = TAU == AUX || TAU == AUX_NT;
    const float* row = t + cl;
#define AT(r) row[(int64_t)(r) * ncell]
    if (L::CHEBF) {
      const float inv_knee = AT(cheb_base);
      at(L::KNEE) = inv_knee;
#pragma unroll
      for (int k = 0; k <= CHEB_DLO; ++k) at(L::CLO + k) = AT(cheb_base + 1 + k);
#pragma unroll
      for (int k = 0; k <= CHEB_DHI; ++k) at(L::CHI + k) = AT(cheb_base + 2 + CHEB_DLO + k);
      const float lg_invk = logf(fmaxf(inv_knee, F32(1e-37))) * F32(0.4342944819032518);
      at(L::SPAN) = 1.0f / (F32(6.0) + lg_invk);
    }
    float n_e;
    if (SRC == PACKED) {
      const float gam = AT(P_GAMMA);
      at(L::BETA) = sqrtf(fmaxf(1.0f - 1.0f / (gam * gam), 0.0f));
      n_e = AUXF ? 0.0f : AT(P_DENS) * cst.inv_mp;
      at(L::TEMP) = AT(P_TEMP);
      at(L::V0) = AT(P_V0);
      at(L::V1) = AT(P_V1);
      if (V2 || L::D3) at(L::VV2) = AT(P_V2);
      if (TAU == CHEB_NT) at(L::NT1) = AT(P_NTDENS) * gam * ntc.thom_f1;
    } else {
      // slim rows 4:8, ultra 2-D [v0, v1, ne_lab, temp], ultra 3-D [v0, v1, v2, ne_lab, temp]
      const int rv = SRC == SLIM ? S_V0 : 0;
      const int rne = SRC == SLIM ? S_NE : (GEO == CART3 ? 3 : 2);
      const float v0 = AT(rv), v1 = AT(rv + 1);
      at(L::V0) = v0;
      at(L::V1) = v1;
      float beta2 = v0 * v0 + v1 * v1;
      if (GEO == CART3) {
        const float v2 = AT(2);
        at(L::VV2) = v2;
        beta2 = beta2 + v2 * v2;
      }
      at(L::BETA) = sqrtf(beta2);
      n_e = AT(rne);
      at(L::TEMP) = AT(rne + 1);
    }
    if (!AUXF) at(L::NSIG) = n_e * cst.thom;  // the AUX families load it from their plane
    if (TAU == CHEB_NT) at(L::NE) = n_e;
    if (SRC == ULTRA) {
      if (GEO == CART3) {
        const int n12 = g.n1 * g.n2;
        const int i = cl / n12;
        const int rem = cl - i * n12;
        const int j = rem / g.n2;
        const int k = rem - j * g.n2;
        at(L::CTR0) = g.lo0 + ((float)i + 0.5f) * g.d0;
        at(L::CTR1) = g.lo1 + ((float)j + 0.5f) * g.d1;
        at(L::CTR2) = g.lo2 + ((float)k + 0.5f) * g.d2;
        at(L::SIZE2) = g.d2;
      } else {
        const int i = cl / g.n1;
        const int j = cl - i * g.n1;
        at(L::CTR0) = g.lo0 + ((float)i + 0.5f) * g.d0;
        at(L::CTR1) = g.lo1 + ((float)j + 0.5f) * g.d1;
      }
      at(L::SIZE0) = g.d0;
      at(L::SIZE1) = g.d1;
    } else if (SRC == SLIM) {
      at(L::CTR0) = AT(S_R0);
      at(L::CTR1) = AT(S_R1);
      at(L::SIZE0) = AT(S_DR0);
      at(L::SIZE1) = AT(S_DR1);
    } else {
      at(L::CTR0) = AT(P_R0);
      at(L::CTR1) = AT(P_R1);
      at(L::SIZE0) = AT(P_DR0);
      at(L::SIZE1) = AT(P_DR1);
      if (L::D3) {
        at(L::CTR2) = AT(P_R2);
        at(L::SIZE2) = AT(P_DR2);
      }
    }
    if (GEO == SPH2 && SRC == ULTRA) {
      const float ctr1 = at(L::CTR1);
      at(L::S1) = sinf(ctr1);
      at(L::C1) = cosf(ctr1);
      at(L::COSH1) = cosf(0.5f * g.d1);
    } else if (L::ANG1) {
      at(L::S1) = AT(P_SIN1);
      at(L::C1) = AT(P_COS1);
      at(L::COSH1) = cosf(0.5f * AT(P_DR1));
    }
    if (L::ANG2) {
      at(L::S2) = AT(P_SIN2);
      at(L::C2) = AT(P_COS2);
      at(L::COSH2) = cosf(0.5f * AT(P_DR2));
    }
#undef AT
  }

  // fluid 3-velocity in MCRaT Cartesian at the photon position
  __device__ __forceinline__ void fluid_beta(float px, float py, float& bx, float& by,
                                             float& bz) const {
    if (L::D3) {
      bx = at(L::V0);
      by = at(L::V1);
      bz = at(L::VV2);
      return;
    }
    float cphi, sphi;
    phi_components(px, py, cphi, sphi);
    const float v0 = at(L::V0), v1 = at(L::V1);
    float vr = v0, vz = v1;
    if (GEO == SPH2) {
      const float s1 = at(L::S1), c1 = at(L::C1);
      vr = v0 * s1 + v1 * c1;
      vz = v0 * c1 - v1 * s1;
    }
    if (V2) {
      const float v2 = at(L::VV2);
      bx = vr * cphi - v2 * sphi;
      by = vr * sphi + v2 * cphi;
    } else {
      bx = vr * cphi;
      by = vr * sphi;
    }
    bz = vz;
  }

  // post-move membership: the lane's cell and the strict domain, angular
  // coordinates in cosine space
  __device__ __forceinline__ bool contains(float px, float py, float pz, const Grid& g) const {
    if (GEO == CYL2) {
      const float h0 = sqrtf(px * px + py * py);
      return in_axis(h0, at(L::CTR0), at(L::SIZE0)) && in_axis(pz, at(L::CTR1), at(L::SIZE1)) &&
             (h0 > g.dom0) && (h0 < g.dom1) && (pz > g.dom2) && (pz < g.dom3);
    }
    if (GEO == CART3) {
      return in_axis(px, at(L::CTR0), at(L::SIZE0)) && in_axis(py, at(L::CTR1), at(L::SIZE1)) &&
             in_axis(pz, at(L::CTR2), at(L::SIZE2)) && (px > g.dom0) && (px < g.dom1) &&
             (py > g.dom2) && (py < g.dom3) && (pz > g.dom4) && (pz < g.dom5);
    }
    if (GEO == POL3) {
      const float rho = sqrtf(px * px + py * py);
      float cphi, sphi;
      phi_components(px, py, cphi, sphi);
      const bool in_phi = cphi * at(L::C1) + sphi * at(L::S1) >= at(L::COSH1);
      const bool in_phi_dom =
          cphi * gc[G_COS_MID] + sphi * gc[G_SIN_MID] >= gc[G_COS_HALF_DOM];
      return in_axis(rho, at(L::CTR0), at(L::SIZE0)) && in_phi && in_phi_dom &&
             in_axis(pz, at(L::CTR2), at(L::SIZE2)) && (rho > g.dom0) && (rho < g.dom1) &&
             (pz > g.dom4) && (pz < g.dom5);
    }
    // spherical (2-D, 2.5-D, 3-D)
    const float rho = sqrtf(px * px + py * py);
    const float r = sqrtf(rho * rho + pz * pz);
    const float inv_r = 1.0f / fmaxf(r, F32(1e-37));
    const float cos_th = clampf(pz * inv_r, -1.0f, 1.0f);
    const float sin_th = rho * inv_r;
    const bool in_theta = cos_th * at(L::C1) + sin_th * at(L::S1) >= at(L::COSH1);
    const bool in_theta_dom = (cos_th < gc[G_COS_DOM2]) && (cos_th > gc[G_COS_DOM3]);
    bool ok = in_axis(r, at(L::CTR0), at(L::SIZE0)) && in_theta && in_theta_dom &&
              (r > g.dom0) && (r < g.dom1);
    if (GEO == SPH3) {
      float cphi, sphi;
      phi_components(px, py, cphi, sphi);
      const bool in_phi = cphi * at(L::C2) + sphi * at(L::S2) >= at(L::COSH2);
      const bool in_phi_dom =
          cphi * gc[G_COS_MID] + sphi * gc[G_SIN_MID] >= gc[G_COS_HALF_DOM];
      ok = ok && in_phi && in_phi_dom;
    }
    return ok;
  }
};

// the counter stream's per-lane base (ops/rng.lane_base)
__device__ __forceinline__ uint32_t lane_base(int64_t lane, int block_lanes, int seed) {
  const int64_t pid = lane / block_lanes;
  const uint32_t lane_in = (uint32_t)(lane - pid * block_lanes);
  return (uint32_t)seed + (uint32_t)pid * 1442695041u + lane_in * 0x9E3779B9u;
}

// ---------------------------------------------------------------------------
// phase B: one accepted Klein-Nishina scatter, for the lane in column `slot`.
// Phase A left the scatter's inputs in that column: the rest-frame photon
// r0..r3 in the comoving planes, the electron's gamma and four-velocity
// g0, ex, ey, ez in the lab planes, the fluid-frame Stokes qc, uc in q, u and
// the round's fluid velocity in BX..BZ; the entry overwrites the lab and
// comoving planes (and q, u, v) with the outgoing photon.  Its random numbers
// are the owner lane's, so it does not matter which thread runs it.

template <bool STOKES, typename L, int THREADS>
__device__ __forceinline__ void scatter_entry(float* __restrict__ sm, int slot, int64_t lane,
                                              int block_lanes, int seed, uint32_t k0,
                                              const Offsets& off, int kn_iters) {
  float* t = sm + slot;
#define T(f) t[(f) * THREADS]
  const float g0 = T(SP_P0), ex = T(SP_P1), ey = T(SP_P2), ez = T(SP_P3);
  const float r0 = T(SP_C0), r1 = T(SP_C1), r2 = T(SP_C2), r3 = T(SP_C3);
  const float bx = T(L::BX), by = T(L::BY), bz = T(L::BZ);
  const float qc = T(SP_Q), uc = T(SP_U), v = T(SP_V);
  const uint32_t base = lane_base(lane, block_lanes, seed);
  // F1 repair: z-hat replaces the degenerate -beta_f reference vector
  const bool flow = sqrtf(bx * bx + by * by + bz * bz) > 0.0f;
  const float mfx = flow ? -bx : 0.0f, mfy = flow ? -by : 0.0f, mfz = flow ? -bz : 1.0f;
  const float inv_g = 1.0f / g0;
  const float ebx = ex * inv_g, eby = ey * inv_g, ebz = ez * inv_g;
  const float e0 = r0;
  const float rho0 = sqrtf(r1 * r1 + r2 * r2);
  const bool has_xy = rho0 > 0.0f;
  const float safe_rho0 = fmaxf(rho0, F32(1e-37));
  const float a_c0 = has_xy ? r1 / safe_rho0 : 1.0f;
  const float a_s0 = has_xy ? r2 / safe_rho0 : 0.0f;
  const bool e_pos = e0 > 0.0f;
  const float inv_e0 = e_pos ? 1.0f / fmaxf(e0, F32(1e-37)) : 0.0f;
  const float a_c1 = e_pos ? rho0 * inv_e0 : 1.0f;
  const float a_s1 = r3 * inv_e0;
  float ct, st, c_phi, s_phi;
  sample_kn_angles<STOKES>(base, k0, off, e0, qc, uc, kn_iters, ct, st, c_phi, s_phi);
  const float e1 = e0 / (1.0f + e0 * (1.0f - ct));
  const float sx = e1 * ct;
  const float sy = e1 * st * s_phi;
  const float sz = e1 * st * c_phi;
  const float tx = a_c1 * sx - a_s1 * sz;
  const float tz = a_s1 * sx + a_c1 * sz;
  const float nx = a_c0 * tx - a_s0 * sy;
  const float ny = a_s0 * tx + a_c0 * sy;
  const float nz = tz;
  float q2 = qc, u2 = uc, v2 = v;
  if (STOKES) {
    rotate_basis(r1, r2, r3, 0.0f, 0.0f, 1.0f, nx, ny, nz, r1, r2, r3, q2, u2);
    float cos_sc = (r1 * nx + r2 * ny + r3 * nz) / fmaxf(e0 * e1, F32(1e-37));
    cos_sc = clampf(cos_sc, -1.0f, 1.0f);
    // Fano matrix (ops.stokes.fano_scatter_stokes)
    const float st2 = fmaxf(1.0f - cos_sc * cos_sc, 0.0f);
    const float de = e0 - e1;
    const float m00 = 1.0f + cos_sc * cos_sc + (1.0f - cos_sc) * de;
    const float m11 = 1.0f + cos_sc * cos_sc;
    const float m22 = 2.0f * cos_sc;
    const float m33 = 2.0f * cos_sc + cos_sc * (1.0f - cos_sc) * de;
    const float fi = m00 + st2 * q2;
    const float fq = st2 + m11 * q2;
    const float fu = m22 * u2;
    const float fv = m33 * v;
    // F13 repair: normalize in double, the degree of polarization held to 1
    // (ops.stokes.fano_normalized); in float fi rounds to 0 near 90 degrees
    const double inv_i = 1.0 / fmax((double)fi, 1e-300);
    double dq = (double)fq * inv_i, du = (double)fu * inv_i, dv = (double)fv * inv_i;
    const double deg2 = dq * dq + du * du + dv * dv;
    if (deg2 > 1.0) {
      const double scale = 1.0 / sqrt(deg2);
      dq = dq * scale;
      du = du * scale;
      dv = dv * scale;
    }
    q2 = (float)dq;
    u2 = (float)du;
    v2 = (float)dv;
    rotate_basis(nx, ny, nz, r1, r2, r3, nx, ny, nz, -ebx, -eby, -ebz, q2, u2);
  }
  // de-boost to the comoving frame, then to the lab
  float o0, o1, o2, o3, l0, l1, l2, l3;
  boost(-ebx, -eby, -ebz, e1, nx, ny, nz, o0, o1, o2, o3);
  boost(-bx, -by, -bz, o0, o1, o2, o3, l0, l1, l2, l3);
  if (STOKES) {
    const float inv_ge = 1.0f / g0;
    rotate_basis(o1, o2, o3, -ex * inv_ge, -ey * inv_ge, -ez * inv_ge, o1, o2, o3, mfx, mfy,
                 mfz, q2, u2);
    rotate_basis(l1, l2, l3, mfx, mfy, mfz, l1, l2, l3, 0.0f, 0.0f, 1.0f, q2, u2);
    T(SP_Q) = q2;
    T(SP_U) = u2;
    T(SP_V) = v2;
  }
  T(SP_P0) = l0;
  T(SP_P1) = l1;
  T(SP_P2) = l2;
  T(SP_P3) = l3;
  T(SP_C0) = o0;
  T(SP_C1) = o1;
  T(SP_C2) = o2;
  T(SP_C3) = o3;
#undef T
}

// ---------------------------------------------------------------------------
// One CUDA block of THREADS lanes (block_threads) runs its rounds together.
// Each round:
//   phase A  every running lane on its own thread: fluid beta, comoving
//            boost, tau rate, free path, move and, on lanes that will
//            scatter, the electron draw, the rest-frame boost and the KN
//            acceptance draw; the membership and stall tests.  An accepted
//            lane leaves the scatter's inputs in its column and appends its
//            slot to the block's queue (one ballot and one shared atomic a
//            warp);
//   barrier  (it also tells every thread whether any lane runs next round)
//   phase B  the block's threads take the queue in strides of THREADS:
//            angles, outgoing photon, Stokes chain, de-boosts, written back
//            to the owner's column;
//   barrier.
// Idle lanes (past n, idle logical block, dead, out of time, stalled) take
// part in the barriers and in nothing else.

template <bool STOKES, int GEO, int SRC, bool V2, int TAU, int THREADS>
__global__ void __launch_bounds__(THREADS, RESIDENT_THREADS / THREADS)
fused_rounds_kernel(float* __restrict__ state, int64_t n, const int* __restrict__ cell,
                    const int* __restrict__ flags, const float* __restrict__ table,
                    int64_t ncell, const int* __restrict__ block_act,
                    int* __restrict__ out_flags, int seed, Grid g, Consts cst,
                    int inner_rounds, int el_iters, int kn_iters, int block_lanes,
                    int cheb_base, NtConsts ntc, const float* __restrict__ aux) {
  using L = Layout<GEO, SRC, V2, TAU>;
  constexpr bool IS_AUX = TAU == AUX || TAU == AUX_NT;
  constexpr bool NT = TAU == CHEB_NT || TAU == AUX_NT;
  extern __shared__ float sm[];
  __shared__ unsigned short queue[THREADS];
  __shared__ int qcount[2];
  __shared__ float gcos[N_GCOS];
  const int tid = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * THREADS + tid;

  // the lanes a round can touch: alive with time left, in an active block
  int fl = 0;
  bool live = false;
  if (lane < n && block_act[lane / block_lanes] != 0) {
    fl = flags[lane];
    live = (fl & FLAG_ALIVE) != 0 && state[SP_TREM * n + lane] > 0.0f;
  }
  if (tid == 0) {
    qcount[0] = 0;
    qcount[1] = 0;
    if (GEO == SPH2 || GEO == SPH3) {
      gcos[G_COS_DOM2] = cosf(g.dom2);
      gcos[G_COS_DOM3] = cosf(g.dom3);
    }
    if (GEO == SPH3 || GEO == POL3) {
      const float lo = GEO == SPH3 ? g.dom4 : g.dom2;
      const float hi = GEO == SPH3 ? g.dom5 : g.dom3;
      const float mid = 0.5f * (lo + hi);
      gcos[G_COS_MID] = cosf(mid);
      gcos[G_SIN_MID] = sinf(mid);
      gcos[G_COS_HALF_DOM] = cosf(0.5f * (hi - lo));
    }
  }
  if (!__syncthreads_or(live)) {  // no lane of this block runs
    if (lane < n) out_flags[lane] = 0;
    return;
  }

  float* s = sm + tid;
#define S(f) s[(f) * THREADS]
  const bool ran = live;  // the lanes whose state is loaded and written back
  const bool is_pool = (fl & FLAG_POOL) != 0;
  const bool in_grid = (fl & FLAG_INGRID) != 0;
  const Cell<GEO, SRC, V2, TAU, THREADS> cc{s, gcos};
  if (ran) {
#pragma unroll
    for (int p = 0; p < N_STATE; ++p) S(p) = state[p * n + lane];
    int cl = cell[lane];
    cl = cl < 0 ? 0 : (cl >= ncell ? (int)(ncell - 1) : cl);
    cc.load(table, ncell, cl, g, cst, cheb_base, ntc);
    // AUX: the biased total tau coefficient and the thermal probability,
    // fixed for the call (the lane stalls once they go stale)
    if (IS_AUX) S(L::NSIG) = aux[lane];
    if (TAU == AUX_NT) S(L::PTH) = aux[n + lane];
  }
  const uint32_t base = lane_base(lane, block_lanes, seed);
  const Offsets off = draw_offsets(el_iters, kn_iters, NT);
  bool stalled = false, promoted = false;

  for (int r = 0; r < inner_rounds; ++r) {
    const uint32_t k0 = (uint32_t)r * off.per_round;
    bool accepted = false;
    if (live) {
      // ---- phase A
      const float p0 = S(SP_P0), p1 = S(SP_P1), p2 = S(SP_P2), p3 = S(SP_P3);
      float px = S(SP_X), py = S(SP_Y), pz = S(SP_Z);
      float t_rem = S(SP_TREM);

      // 1. fluid beta at the photon position
      float bx, by, bz;
      cc.fluid_beta(px, py, bx, by, bz);
      const float fl_norm = sqrtf(bx * bx + by * by + bz * bz);
      const float ph_norm = sqrtf(p1 * p1 + p2 * p2 + p3 * p3);
      const float denom = fmaxf(fl_norm * ph_norm, F32(1e-37));
      const float cos_ang = (bx * p1 + by * p2 + bz * p3) / denom;

      // 2. comoving four-momentum
      float c0 = S(SP_C0), c1 = S(SP_C1), c2 = S(SP_C2), c3 = S(SP_C3);
      if (in_grid) {
        boost(bx, by, bz, p0, p1, p2, p3, c0, c1, c2, c3);
        S(SP_C0) = c0;
        S(SP_C1) = c1;
        S(SP_C2) = c2;
        S(SP_C3) = c3;
      }

      // tau rate.  TABLE: sigma_hat at the CURRENT comoving energy, after the
      // boost (a lane outside the grid keeps its c0; its rate is unused).
      // Nonthermal: the biased total tau0 + N_GAMMA tau_norm, tau_norm = tau0
      // in thermal cells, else subgroup 1's (Src/optical_depth.c:60-112)
      const float n_sigma = S(L::NSIG);
      const float fluid = 1.0f - S(L::BETA) * cos_ang;
      float rate, p_th = TAU == AUX_NT ? S(L::PTH) : 1.0f;
      if (TAU == DIRECT || IS_AUX) {
        rate = n_sigma * fluid;
      } else {
        const float nsig_th =
            n_sigma * cheb_eval<THREADS>(c0 * S(L::KNEE), S(L::SPAN), &S(L::CLO), &S(L::CHI));
        if (TAU == CHEB_NT) {
          const float nsig_nt1 = S(L::NT1) * cheb_eval<1>(c0 * ntc.invk1, ntc.span1, ntc.c1_lo,
                                                          ntc.c1_hi);
          const float taunorm = S(L::NE) > 0.0f ? nsig_th : nsig_nt1;
          const float total = nsig_th + ntc.n_gamma * taunorm;
          rate = total * fluid;
          p_th = nsig_th / fmaxf(total, F32(1e-37));
        } else {
          rate = nsig_th * fluid;
        }
      }

      // 3. free path -> candidate step
      const float u1 = uniform_pos(base, k0 + off.free_);
      const float mfp =
          (in_grid && rate > 0.0f) ? -logf(u1) / fmaxf(rate, F32(1e-37)) : F32(1e12);
      const float dt_scatt = mfp * cst.inv_c;
      const bool will = in_grid && (dt_scatt < t_rem);
      const float dt = will ? dt_scatt : t_rem;

      // 4. advance along the lab direction at c (pool photons stay)
      const float inv_p0 = 1.0f / fmaxf(p0, F32(1e-37));
      const float step = is_pool ? 0.0f : cst.c_light * dt * inv_p0;
      px = px + step * p1;
      py = py + step * p2;
      pz = pz + step * p3;
      t_rem = t_rem - dt;
      S(SP_X) = px;
      S(SP_Y) = py;
      S(SP_Z) = pz;
      S(SP_TREM) = t_rem;

      // 5. scatter attempt up to the KN acceptance (null collision on reject)
      if (will) {
        // F1 repair: z-hat replaces the degenerate +-beta_f reference vector
        const bool flow = fl_norm > 0.0f;
        const float frx = flow ? bx : 0.0f, fry = flow ? by : 0.0f, frz = flow ? bz : 1.0f;
        float qc = S(SP_Q), uc = S(SP_U);
        if (STOKES) rotate_basis(p1, p2, p3, 0.0f, 0.0f, 1.0f, p1, p2, p3, frx, fry, frz, qc, uc);
        float g_e, gb_e;
        if (NT) {
          // scattering population: thermal w.p. p_th, else the subgroups in
          // equal slices of the rest, inverse-CDF gamma within the subgroup
          const float u_pop = uniform(base, k0 + off.pop);
          if (u_pop <= p_th) {
            thermal_gamma_beta(base, k0, off, S(L::TEMP), el_iters, cst, g_e, gb_e);
          } else {
            const float slice_w = fmaxf((1.0f - p_th) * ntc.inv_n_gamma, F32(1e-37));
            const float sub_f = clampf(floorf((u_pop - p_th) / slice_w), 0.0f, ntc.n_gamma_m1);
            g_e = nonthermal_gamma(uniform(base, k0 + off.pop + 1u), sub_f, ntc);
            gb_e = sqrtf(fmaxf(g_e * g_e - 1.0f, 0.0f));
          }
        } else {
          thermal_gamma_beta(base, k0, off, S(L::TEMP), el_iters, cst, g_e, gb_e);
        }
        float ex, ey, ez;
        electron_from_gamma(base, k0, off, g_e, gb_e, c1, c2, c3, ex, ey, ez);
        const float g0 = g_e;

        // the photon in the electron rest frame, and the acceptance draw
        const float inv_g = 1.0f / g0;
        const float ebx = ex * inv_g, eby = ey * inv_g, ebz = ez * inv_g;
        float r0, r1, r2, r3;
        boost(ebx, eby, ebz, c0, c1, c2, c3, r0, r1, r2, r3);
        if (STOKES) {
          rotate_basis(c1, c2, c3, frx, fry, frz, c1, c2, c3, ebx, eby, ebz, qc, uc);
          rotate_basis(r1, r2, r3, ebx, eby, ebz, r1, r2, r3, 0.0f, 0.0f, 1.0f, qc, uc);
        }
        accepted = uniform(base, k0 + off.acc) <= kn_cross_section(r0);
        if (accepted) {  // the scatter's inputs, for phase B
          S(SP_P0) = g0;
          S(SP_P1) = ex;
          S(SP_P2) = ey;
          S(SP_P3) = ez;
          S(SP_C0) = r0;
          S(SP_C1) = r1;
          S(SP_C2) = r2;
          S(SP_C3) = r3;
          S(SP_Q) = qc;
          S(SP_U) = uc;
          S(L::BX) = bx;
          S(L::BY) = by;
          S(L::BZ) = bz;
          S(SP_NS) = S(SP_NS) + 1.0f;
          promoted = promoted || is_pool;
        }
      }

      // 6. post-move cell/domain membership: stall lanes that left; AUX also
      // stalls lanes that scattered.  A lane that stalls or runs out of
      // frame time stays idle.
      if (in_grid && !cc.contains(px, py, pz, g) && t_rem > 0.0f) stalled = true;
      if (IS_AUX && accepted && t_rem > 0.0f) stalled = true;
      live = !stalled && t_rem > 0.0f;
    }

    // the queue of accepted lanes: a warp's lanes take consecutive entries
    const unsigned acc_mask = __ballot_sync(0xffffffffu, accepted);
    if (acc_mask != 0u) {
      const int wl = tid & 31;
      const int leader = __ffs(acc_mask) - 1;
      int at = 0;
      if (wl == leader) at = atomicAdd(&qcount[r & 1], __popc(acc_mask));
      at = __shfl_sync(0xffffffffu, at, leader);
      if (accepted) queue[at + __popc(acc_mask & ((1u << wl) - 1u))] = (unsigned short)tid;
    }
    const int more = __syncthreads_or(live);

    // ---- phase B
    const int nq = qcount[r & 1];
    for (int i = tid; i < nq; i += THREADS) {
      const int slot = queue[i];
      scatter_entry<STOKES, L, THREADS>(sm, slot, (int64_t)blockIdx.x * THREADS + slot,
                                        block_lanes, seed, k0, off, kn_iters);
    }
    if (tid == 0) qcount[(r + 1) & 1] = 0;
    __syncthreads();
    if (!more) break;
  }

  if (ran) {
#pragma unroll
    for (int p = 0; p < N_STATE; ++p) state[p * n + lane] = S(p);
  }
  if (lane < n) out_flags[lane] = (stalled ? OUT_STALLED : 0) | (promoted ? OUT_PROMOTED : 0);
#undef S
}

struct Launch {
  float* state;
  int64_t n;
  const int* cell;
  const int* flags;
  const float* table;
  int64_t ncell;
  const int* block_act;
  int* out_flags;
  int seed;
  Grid g;
  Consts cst;
  int inner_rounds, el_iters, kn_iters, block_lanes, cheb_base;
  NtConsts ntc;
  const float* aux;
};

// an instantiation's launch shape and what the CUDA runtime reports of it
// (mcrat_fused_rounds_attrs)
struct Attrs {
  int threads, dyn_smem, registers, local_bytes, static_smem;
};

// one instantiation: its launch on a Launch, else (a null Launch) its Attrs
// into q; cudaSuccess or the runtime's error
template <bool STOKES, int TAU, int GEO, int SRC, bool V2>
int launch_one(const Launch* a, Attrs* q, cudaStream_t s) {
  constexpr int COUNT = Layout<GEO, SRC, V2, TAU>::COUNT;
  constexpr int THREADS = block_threads<STOKES, COUNT>();
  constexpr int smem = COUNT * THREADS * (int)sizeof(float);
  auto kern = fused_rounds_kernel<STOKES, GEO, SRC, V2, TAU, THREADS>;
  if (a == nullptr) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    *q = Attrs{THREADS, smem, fa.numRegs, (int)fa.localSizeBytes, (int)fa.sharedSizeBytes};
    return 0;
  }
  // dynamic shared memory above 48 KB needs the opt-in, which holds for the
  // current device only: made at every launch (a host-side attribute write)
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((a->n + THREADS - 1) / THREADS);
  kern<<<blocks, THREADS, smem, s>>>(a->state, a->n, a->cell, a->flags, a->table, a->ncell,
                                     a->block_act, a->out_flags, a->seed, a->g, a->cst,
                                     a->inner_rounds, a->el_iters, a->kn_iters, a->block_lanes,
                                     a->cheb_base, a->ntc, a->aux);
  return 0;
}

template <int TAU, int GEO, int SRC, bool V2>
int launch(const Launch* a, Attrs* q, bool stokes, cudaStream_t s) {
  return stokes ? launch_one<true, TAU, GEO, SRC, V2>(a, q, s)
                : launch_one<false, TAU, GEO, SRC, V2>(a, q, s);
}

// one family's instantiation of a variant code (launch's result), or -1 for
// an unknown code or an ultra/slim variant in a family of the packed
// variants only
template <int TAU>
int launch_variant(int variant, const Launch* a, Attrs* q, bool st, cudaStream_t s) {
  if constexpr (TAU == DIRECT || TAU == CHEB) {  // the others: packed variants only
    switch (variant) {
      case 0: return launch<TAU, CYL2, ULTRA, false>(a, q, st, s);
      case 1: return launch<TAU, SPH2, ULTRA, false>(a, q, st, s);
      case 2: return launch<TAU, CART3, ULTRA, false>(a, q, st, s);
      case 3: return launch<TAU, CYL2, SLIM, false>(a, q, st, s);
    }
  }
  switch (variant) {
    case 4: return launch<TAU, CYL2, PACKED, false>(a, q, st, s);
    case 5: return launch<TAU, CYL2, PACKED, true>(a, q, st, s);
    case 6: return launch<TAU, SPH2, PACKED, false>(a, q, st, s);
    case 7: return launch<TAU, SPH2, PACKED, true>(a, q, st, s);
    case 8: return launch<TAU, CART3, PACKED, false>(a, q, st, s);
    case 9: return launch<TAU, SPH3, PACKED, false>(a, q, st, s);
    case 10: return launch<TAU, POL3, PACKED, false>(a, q, st, s);
  }
  return -1;
}

// the kernel's Klein-Nishina cross section on its own, for checks
__global__ void kn_cross_section_kernel(const float* __restrict__ e, float* __restrict__ out,
                                        int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = kn_cross_section(e[i]);
}

}  // namespace

// The build (mcrat_tpu_torch/_build.py) compiles this source once for each
// optical-depth family, with -DMCRAT_FAMILY=<Tau code>: that family's
// instantiations behind one C launcher, mcrat_launch_family_<code>; and
// once without it: the C entry points.  The six nvcc processes run side by
// side, and their objects link into one library.
#define MCRAT_CAT2(a, b) a##b
#define MCRAT_CAT(a, b) MCRAT_CAT2(a, b)

#ifdef MCRAT_FAMILY

// a launch of the family's instantiation of a variant code (the Launch and
// Attrs structs of the entry points' translation unit: the same source); a
// null launch writes the instantiation's Attrs
extern "C" int MCRAT_CAT(mcrat_launch_family_, MCRAT_FAMILY)(int variant, const void* a,
                                                              void* q, int stokes_on,
                                                              void* stream) {
  return launch_variant<MCRAT_FAMILY>(variant, (const Launch*)a, (Attrs*)q, stokes_on != 0,
                                      (cudaStream_t)stream);
}

#else

extern "C" {
int mcrat_launch_family_0(int, const void*, void*, int, void*);
int mcrat_launch_family_1(int, const void*, void*, int, void*);
int mcrat_launch_family_2(int, const void*, void*, int, void*);
int mcrat_launch_family_3(int, const void*, void*, int, void*);
int mcrat_launch_family_4(int, const void*, void*, int, void*);
}

namespace {

int dispatch(int variant, int tau, const Launch* a, Attrs* q, int stokes_on, void* s) {
  switch (tau) {
    case DIRECT: return mcrat_launch_family_0(variant, a, q, stokes_on, s);
    case CHEB: return mcrat_launch_family_1(variant, a, q, stokes_on, s);
    case CHEB_NT: return mcrat_launch_family_2(variant, a, q, stokes_on, s);
    case AUX: return mcrat_launch_family_3(variant, a, q, stokes_on, s);
    case AUX_NT: return mcrat_launch_family_4(variant, a, q, stokes_on, s);
  }
  return -1;
}

}  // namespace

// sigma_KN / sigma_T of n float32 energies through the kernel's device
// function; returns cudaGetLastError() after the launch
extern "C" int mcrat_kn_cross_section(const float* e, float* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  kn_cross_section_kernel<<<blocks, threads, 0, s>>>(e, out, n);
  return (int)cudaGetLastError();
}

// variant codes as in mcrat_tpu_torch/ops/fused_round.py::VARIANTS, tau the
// optical-depth family (fused_round.TAU_*), nt the host array of the n_nt
// NtConsts floats, aux the (2, n) device planes of the AUX families (else
// unused); returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown code or family, an NtConsts of
// another size, an ultra/slim variant in a packed-only family, or an AUX
// family without aux planes)
extern "C" int mcrat_fused_rounds(int variant, int tau, float* state, int64_t n,
                                  const int* cell, const int* flags, const float* table,
                                  int64_t ncell, const int* block_act, int* out_flags,
                                  int seed, float dom0, float dom1, float dom2, float dom3,
                                  float dom4, float dom5, float lo0, float d0, float lo1,
                                  float d1, float lo2, float d2, int n1, int n2,
                                  int stokes_on, int inner_rounds, int el_iters, int kn_iters,
                                  int block_lanes, float kb_over_mec2, float thom,
                                  float c_light, float inv_c, float inv_mp, int cheb_base,
                                  const float* nt, int n_nt, const float* aux, void* stream) {
  if (n_nt * sizeof(float) != sizeof(NtConsts) || nt == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((tau == AUX || tau == AUX_NT) && aux == nullptr) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Launch a{state, n, cell, flags, table, ncell, block_act, out_flags, seed,
           Grid{dom0, dom1, dom2, dom3, dom4, dom5, lo0, d0, lo1, d1, lo2, d2, n1, n2},
           Consts{kb_over_mec2, thom, c_light, inv_c, inv_mp},
           inner_rounds, el_iters, kn_iters, block_lanes, cheb_base, NtConsts{}, aux};
  memcpy(&a.ntc, nt, sizeof(NtConsts));
  const int rc = dispatch(variant, tau, &a, nullptr, stokes_on, stream);
  if (rc < 0) return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// one instantiation's launch shape and resources into out[5]: threads a
// block (fused_round.cuda_block), dynamic shared memory (bytes), and as
// cudaFuncGetAttributes reports them for this library, registers a thread,
// local memory a thread (bytes: spills and stack) and static shared memory
// (bytes); cudaSuccess, the runtime's error, or cudaErrorInvalidValue for an
// unknown code or family
extern "C" int mcrat_fused_rounds_attrs(int variant, int tau, int stokes_on, int* out) {
  Attrs q{};
  const int rc = dispatch(variant, tau, nullptr, &q, stokes_on, nullptr);
  if (rc < 0) return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  const int v[5] = {q.threads, q.dyn_smem, q.registers, q.local_bytes, q.static_smem};
  memcpy(out, v, sizeof(v));
  return 0;
}

extern "C" const char* mcrat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  // MCRAT_FAMILY
