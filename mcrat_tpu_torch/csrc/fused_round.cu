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
// One thread owns one photon lane and runs `inner_rounds` complete rounds:
//   comoving boost -> tau-rate -> free path -> move -> electron draw
//   -> polarized Klein-Nishina scatter attempt -> Stokes -> cell membership.
// A lane that leaves its cell stalls until the caller re-resolves its cell.
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
// planes), 8 B of flags and cell index and its cell's row, 16-96 B (+64 B of
// Chebyshev rows in TABLE mode, or 8 B of aux planes in the AUX families),
// and writes 64 B + 4 B of out-flags per call.  Against that it does ~115
// uniforms (a murmur3 finalizer each, integer work) and ~40 transcendentals
// (log, sin/cos, sqrt, rsqrt, divisions) per round.  The least time of a
// call (PERF.md section 6: its bytes over the HBM rate against its float
// operations over the float32 rate) is mostly set by the bytes, but the
// calls take many times that bound: what the float count leaves out, the
// integer hashing, the SFU, divergent rejection loops and 80-116 registers
// a thread, sets the time -- the kernel is ALU/SFU and register bound, not
// memory bound.  K5 (AUX, AUX_NT) adds 8 B a lane and no float work (its
// per-round work is DIRECT's, plus the sampler in AUX_NT), so it stays so.
// The design follows from that:
//   * no shared memory, TMA or wgmma: state is streamed once, coalesced
//     (planes are structure-of-arrays, neighbouring lanes at neighbouring
//     addresses), and kept in registers across all rounds;
//   * the lane reads its own cell's rows from the (W, Ncell) table by its
//     int32 cell index, once per call (no host-side row gather, no index bit
//     packing).  The reads are not coalesced (neighbouring lanes hold
//     neighbouring photons, not cells), but they are a few words per lane
//     per call and the largest table, 262,144 cells x 16 rows x 4 B = 17 MB
//     on the 3-D grid, stays in the 50 MB L2;
//   * per-lane cell quantities (velocity, |beta|, n_e, cell box, the
//     cosines of half widths and of the domain bounds) are computed once per
//     call, not per round;
//   * only the electron-sampler branch a lane needs (Maxwell-Boltzmann below
//     1e7 K, Maxwell-Juttner above, decided per lane) and only lanes that will
//     attempt a scatter run the sampler; rejection loops exit at acceptance.
//     Draw numbers are static (k = round * per_round + offset), so skipping
//     work never shifts a random number;
//   * lanes of idle logical blocks (block_act == 0) and finished lanes return
//     at once; the state is updated in place, so their state is untouched.
// Transcendentals (logf, expf, sinf/cosf, log1p) are the functions PyTorch's
// CUDA torch.log/exp/sin/cos/log1p call, so kernel and twin agree to the bit.
// The Klein-Nishina closed form runs in double (fault F6: in float32 its
// ~2/e^2 terms cancel to ~1 and lose up to 0.25 just above e = 1e-3), one
// evaluation per scatter attempt.
// Register pressure and occupancy are not tuned yet (later work).

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
// linear x below the KN knee (x < 1), log space above it
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
    const float ck = lo ? (k <= CHEB_DLO ? c_lo[k] : 0.0f) : c_hi[k];
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
// per-lane cell quantities of a variant (pallas_round._kernel_body before
// round_body), its fluid velocity (fluid_beta) and membership test
// (in_cell_and_domain); fixed for the call

template <int GEO, int SRC, bool V2, int TAU>
struct Cell {
  float v0, v1, v2;            // hydro basis in 2-D, MCRaT Cartesian in 3-D
  float beta_mag, n_e, temp;
  float gam, nt_dens;          // nonthermal: packed gamma and nonthermal density
  // TABLE: inverse knee, 1 / (LOG_PH_E_MAX - s), Chebyshev coefficients
  float inv_knee, span_inv, c_lo[CHEB_DLO + 1], c_hi[CHEB_DHI + 1];
  float ctr0, ctr1, ctr2, size0, size1, size2;  // cell box in hydro coordinates
  float s1, c1, cos_half1;     // sin/cos of the theta (polar: phi) centre, cos of half width
  float cos_dom2, cos_dom3;    // spherical theta domain
  float s2, c2, cos_half2;     // 3-D spherical phi centre and half width
  float cos_mid, sin_mid, cos_half_dom;  // azimuth domain, about its midpoint

  __device__ __forceinline__ void load(const float* __restrict__ t, int64_t ncell, int cl,
                                       const Grid& g, const Consts& cst, int cheb_base) {
    const float* row = t + cl;
#define AT(r) row[(int64_t)(r) * ncell]
    if (TAU == CHEB || TAU == CHEB_NT) {
      inv_knee = AT(cheb_base);
#pragma unroll
      for (int k = 0; k <= CHEB_DLO; ++k) c_lo[k] = AT(cheb_base + 1 + k);
#pragma unroll
      for (int k = 0; k <= CHEB_DHI; ++k) c_hi[k] = AT(cheb_base + 2 + CHEB_DLO + k);
      const float lg_invk = logf(fmaxf(inv_knee, F32(1e-37))) * F32(0.4342944819032518);
      span_inv = 1.0f / (F32(6.0) + lg_invk);
    }
    if (TAU == CHEB_NT) nt_dens = AT(P_NTDENS);
    if (SRC == PACKED) {
      gam = AT(P_GAMMA);
      beta_mag = sqrtf(fmaxf(1.0f - 1.0f / (gam * gam), 0.0f));
      n_e = AT(P_DENS) * cst.inv_mp;
      temp = AT(P_TEMP);
      v0 = AT(P_V0);
      v1 = AT(P_V1);
      v2 = (V2 || GEO == CART3 || GEO == SPH3 || GEO == POL3) ? AT(P_V2) : 0.0f;
    } else {
      // slim rows 4:8, ultra 2-D [v0, v1, ne_lab, temp], ultra 3-D [v0, v1, v2, ne_lab, temp]
      const int rv = SRC == SLIM ? S_V0 : 0;
      const int rne = SRC == SLIM ? S_NE : (GEO == CART3 ? 3 : 2);
      v0 = AT(rv);
      v1 = AT(rv + 1);
      float beta2 = v0 * v0 + v1 * v1;
      v2 = 0.0f;
      if (GEO == CART3) {
        v2 = AT(2);
        beta2 = beta2 + v2 * v2;
      }
      beta_mag = sqrtf(beta2);
      n_e = AT(rne);
      temp = AT(rne + 1);
    }
    if (SRC == ULTRA) {
      if (GEO == CART3) {
        const int n12 = g.n1 * g.n2;
        const int i = cl / n12;
        const int rem = cl - i * n12;
        const int j = rem / g.n2;
        const int k = rem - j * g.n2;
        ctr0 = g.lo0 + ((float)i + 0.5f) * g.d0;
        ctr1 = g.lo1 + ((float)j + 0.5f) * g.d1;
        ctr2 = g.lo2 + ((float)k + 0.5f) * g.d2;
      } else {
        const int i = cl / g.n1;
        const int j = cl - i * g.n1;
        ctr0 = g.lo0 + ((float)i + 0.5f) * g.d0;
        ctr1 = g.lo1 + ((float)j + 0.5f) * g.d1;
      }
      size0 = g.d0;
      size1 = g.d1;
      size2 = g.d2;
    } else if (SRC == SLIM) {
      ctr0 = AT(S_R0);
      ctr1 = AT(S_R1);
      size0 = AT(S_DR0);
      size1 = AT(S_DR1);
    } else {
      ctr0 = AT(P_R0);
      ctr1 = AT(P_R1);
      size0 = AT(P_DR0);
      size1 = AT(P_DR1);
      if (GEO == CART3 || GEO == SPH3 || GEO == POL3) {
        ctr2 = AT(P_R2);
        size2 = AT(P_DR2);
      }
    }
    if (GEO == SPH2 && SRC == ULTRA) {
      s1 = sinf(ctr1);
      c1 = cosf(ctr1);
      cos_half1 = cosf(0.5f * g.d1);
    } else if (GEO == SPH2 || GEO == SPH3 || GEO == POL3) {
      s1 = AT(P_SIN1);
      c1 = AT(P_COS1);
      cos_half1 = cosf(0.5f * AT(P_DR1));
    }
    if (GEO == SPH2 || GEO == SPH3) {
      cos_dom2 = cosf(g.dom2);
      cos_dom3 = cosf(g.dom3);
    }
    if (GEO == SPH3) {
      s2 = AT(P_SIN2);
      c2 = AT(P_COS2);
      cos_half2 = cosf(0.5f * AT(P_DR2));
    }
    if (GEO == SPH3 || GEO == POL3) {
      const float lo = GEO == SPH3 ? g.dom4 : g.dom2;
      const float hi = GEO == SPH3 ? g.dom5 : g.dom3;
      const float mid = 0.5f * (lo + hi);
      cos_mid = cosf(mid);
      sin_mid = sinf(mid);
      cos_half_dom = cosf(0.5f * (hi - lo));
    }
#undef AT
  }

  // fluid 3-velocity in MCRaT Cartesian at the photon position
  __device__ __forceinline__ void fluid_beta(float px, float py, float& bx, float& by,
                                             float& bz) const {
    if (GEO == CART3 || GEO == SPH3 || GEO == POL3) {
      bx = v0;
      by = v1;
      bz = v2;
      return;
    }
    float cphi, sphi;
    phi_components(px, py, cphi, sphi);
    float vr = v0, vz = v1;
    if (GEO == SPH2) {
      vr = v0 * s1 + v1 * c1;
      vz = v0 * c1 - v1 * s1;
    }
    if (V2) {
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
      return in_axis(h0, ctr0, size0) && in_axis(pz, ctr1, size1) && (h0 > g.dom0) &&
             (h0 < g.dom1) && (pz > g.dom2) && (pz < g.dom3);
    }
    if (GEO == CART3) {
      return in_axis(px, ctr0, size0) && in_axis(py, ctr1, size1) && in_axis(pz, ctr2, size2) &&
             (px > g.dom0) && (px < g.dom1) && (py > g.dom2) && (py < g.dom3) &&
             (pz > g.dom4) && (pz < g.dom5);
    }
    if (GEO == POL3) {
      const float rho = sqrtf(px * px + py * py);
      float cphi, sphi;
      phi_components(px, py, cphi, sphi);
      const bool in_phi = cphi * c1 + sphi * s1 >= cos_half1;
      const bool in_phi_dom = cphi * cos_mid + sphi * sin_mid >= cos_half_dom;
      return in_axis(rho, ctr0, size0) && in_phi && in_phi_dom && in_axis(pz, ctr2, size2) &&
             (rho > g.dom0) && (rho < g.dom1) && (pz > g.dom4) && (pz < g.dom5);
    }
    // spherical (2-D, 2.5-D, 3-D)
    const float rho = sqrtf(px * px + py * py);
    const float r = sqrtf(rho * rho + pz * pz);
    const float inv_r = 1.0f / fmaxf(r, F32(1e-37));
    const float cos_th = clampf(pz * inv_r, -1.0f, 1.0f);
    const float sin_th = rho * inv_r;
    const bool in_theta = cos_th * c1 + sin_th * s1 >= cos_half1;
    const bool in_theta_dom = (cos_th < cos_dom2) && (cos_th > cos_dom3);
    bool ok = in_axis(r, ctr0, size0) && in_theta && in_theta_dom && (r > g.dom0) &&
              (r < g.dom1);
    if (GEO == SPH3) {
      float cphi, sphi;
      phi_components(px, py, cphi, sphi);
      const bool in_phi = cphi * c2 + sphi * s2 >= cos_half2;
      const bool in_phi_dom = cphi * cos_mid + sphi * sin_mid >= cos_half_dom;
      ok = ok && in_phi && in_phi_dom;
    }
    return ok;
  }
};

// ---------------------------------------------------------------------------

template <bool STOKES, int GEO, int SRC, bool V2, int TAU>
__global__ void __launch_bounds__(128)
fused_rounds_kernel(float* __restrict__ state, int64_t n, const int* __restrict__ cell,
                    const int* __restrict__ flags, const float* __restrict__ table,
                    int64_t ncell, const int* __restrict__ block_act,
                    int* __restrict__ out_flags, int seed, Grid g, Consts cst,
                    int inner_rounds, int el_iters, int kn_iters, int block_lanes,
                    int cheb_base, NtConsts ntc, const float* __restrict__ aux) {
  constexpr bool IS_AUX = TAU == AUX || TAU == AUX_NT;
  constexpr bool NT = TAU == CHEB_NT || TAU == AUX_NT;
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int64_t pid = lane / block_lanes;
  if (block_act[pid] == 0) {
    out_flags[lane] = 0;
    return;
  }
  const int fl = flags[lane];
  const bool alive = (fl & FLAG_ALIVE) != 0;
  const bool is_pool = (fl & FLAG_POOL) != 0;
  const bool in_grid = (fl & FLAG_INGRID) != 0;
  float t_rem = state[SP_TREM * n + lane];
  if (!(alive && t_rem > 0.0f)) {  // no round can touch this lane
    out_flags[lane] = 0;
    return;
  }
  float p0 = state[SP_P0 * n + lane], p1 = state[SP_P1 * n + lane];
  float p2 = state[SP_P2 * n + lane], p3 = state[SP_P3 * n + lane];
  float px = state[SP_X * n + lane], py = state[SP_Y * n + lane];
  float pz = state[SP_Z * n + lane];
  float q = state[SP_Q * n + lane], u = state[SP_U * n + lane];
  float v = state[SP_V * n + lane];
  float ns = state[SP_NS * n + lane];
  float c0 = state[SP_C0 * n + lane], c1 = state[SP_C1 * n + lane];
  float c2 = state[SP_C2 * n + lane], c3 = state[SP_C3 * n + lane];

  int cl = cell[lane];
  cl = cl < 0 ? 0 : (cl >= ncell ? (int)(ncell - 1) : cl);
  Cell<GEO, SRC, V2, TAU> cc;
  cc.load(table, ncell, cl, g, cst, cheb_base);

  const uint32_t lane_in = (uint32_t)(lane - pid * block_lanes);
  const uint32_t base =
      (uint32_t)seed + (uint32_t)pid * 1442695041u + lane_in * 0x9E3779B9u;
  const Offsets off = draw_offsets(el_iters, kn_iters, NT);
  // AUX: the biased total tau coefficient and the thermal probability, fixed
  // for the call (the lane stalls once they go stale)
  const float n_sigma = IS_AUX ? aux[lane] : cc.n_e * cst.thom;
  const float p_th_aux = TAU == AUX_NT ? aux[n + lane] : 1.0f;
  bool stalled = false, promoted = false;

  for (int r = 0; r < inner_rounds; ++r) {
    // a lane that stalls or runs out of frame time stays idle
    if (stalled || !(t_rem > 0.0f)) break;
    const uint32_t k0 = (uint32_t)r * off.per_round;

    // 1. fluid beta at the photon position
    float bx, by, bz;
    cc.fluid_beta(px, py, bx, by, bz);
    const float fl_norm = sqrtf(bx * bx + by * by + bz * bz);
    const float ph_norm = sqrtf(p1 * p1 + p2 * p2 + p3 * p3);
    const float denom = fmaxf(fl_norm * ph_norm, F32(1e-37));
    const float cos_ang = (bx * p1 + by * p2 + bz * p3) / denom;

    // 2. comoving four-momentum
    if (in_grid) boost(bx, by, bz, p0, p1, p2, p3, c0, c1, c2, c3);

    // tau rate.  TABLE: sigma_hat at the CURRENT comoving energy, after the
    // boost (a lane outside the grid keeps its c0; its rate is unused).
    // Nonthermal: the biased total tau0 + N_GAMMA tau_norm, tau_norm = tau0
    // in thermal cells, else subgroup 1's (Src/optical_depth.c:60-112)
    float rate, p_th = p_th_aux;
    if (TAU == DIRECT || IS_AUX) {
      rate = n_sigma * (1.0f - cc.beta_mag * cos_ang);
    } else {
      const float nsig_th = n_sigma * cheb_eval(c0 * cc.inv_knee, cc.span_inv, cc.c_lo, cc.c_hi);
      if (TAU == CHEB_NT) {
        const float nsig_nt1 = (cc.nt_dens * cc.gam * ntc.thom_f1) *
                               cheb_eval(c0 * ntc.invk1, ntc.span1, ntc.c1_lo, ntc.c1_hi);
        const float taunorm = cc.n_e > 0.0f ? nsig_th : nsig_nt1;
        const float total = nsig_th + ntc.n_gamma * taunorm;
        rate = total * (1.0f - cc.beta_mag * cos_ang);
        p_th = nsig_th / fmaxf(total, F32(1e-37));
      } else {
        rate = nsig_th * (1.0f - cc.beta_mag * cos_ang);
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

    // 5. scatter attempt (null collision on KN reject)
    bool scattered = false;
    if (will) {
      // F1 repair: z-hat replaces the degenerate +-beta_f reference vector
      const bool flow = fl_norm > 0.0f;
      const float frx = flow ? bx : 0.0f, fry = flow ? by : 0.0f, frz = flow ? bz : 1.0f;
      const float mfx = flow ? -bx : 0.0f, mfy = flow ? -by : 0.0f, mfz = flow ? -bz : 1.0f;
      float qc = q, uc = u;
      if (STOKES) rotate_basis(p1, p2, p3, 0.0f, 0.0f, 1.0f, p1, p2, p3, frx, fry, frz, qc, uc);
      float g_e, gb_e;
      if (NT) {
        // scattering population: thermal w.p. p_th, else the subgroups in
        // equal slices of the rest, inverse-CDF gamma within the subgroup
        const float u_pop = uniform(base, k0 + off.pop);
        if (u_pop <= p_th) {
          thermal_gamma_beta(base, k0, off, cc.temp, el_iters, cst, g_e, gb_e);
        } else {
          const float slice_w = fmaxf((1.0f - p_th) * ntc.inv_n_gamma, F32(1e-37));
          const float sub_f = clampf(floorf((u_pop - p_th) / slice_w), 0.0f, ntc.n_gamma_m1);
          g_e = nonthermal_gamma(uniform(base, k0 + off.pop + 1u), sub_f, ntc);
          gb_e = sqrtf(fmaxf(g_e * g_e - 1.0f, 0.0f));
        }
      } else {
        thermal_gamma_beta(base, k0, off, cc.temp, el_iters, cst, g_e, gb_e);
      }
      float ex, ey, ez;
      electron_from_gamma(base, k0, off, g_e, gb_e, c1, c2, c3, ex, ey, ez);
      const float g0 = g_e;

      // single scatter in the electron rest frame
      const float inv_g = 1.0f / g0;
      const float ebx = ex * inv_g, eby = ey * inv_g, ebz = ez * inv_g;
      float r0, r1, r2, r3;
      boost(ebx, eby, ebz, c0, c1, c2, c3, r0, r1, r2, r3);
      if (STOKES) {
        rotate_basis(c1, c2, c3, frx, fry, frz, c1, c2, c3, ebx, eby, ebz, qc, uc);
        rotate_basis(r1, r2, r3, ebx, eby, ebz, r1, r2, r3, 0.0f, 0.0f, 1.0f, qc, uc);
      }
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
      const bool sc = uniform(base, k0 + off.acc) <= kn_cross_section(e0);
      if (sc) {
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
          const float inv_i = 1.0f / fi;
          q2 = fq * inv_i;
          u2 = fu * inv_i;
          v2 = fv * inv_i;
          rotate_basis(nx, ny, nz, r1, r2, r3, nx, ny, nz, -ebx, -eby, -ebz, q2, u2);
        }
        // de-boost to the comoving frame, then to the lab
        float o0, o1, o2, o3, l0, l1, l2, l3;
        boost(-ebx, -eby, -ebz, e1, nx, ny, nz, o0, o1, o2, o3);
        boost(-bx, -by, -bz, o0, o1, o2, o3, l0, l1, l2, l3);
        if (STOKES) {
          const float inv_ge = 1.0f / g0;
          rotate_basis(o1, o2, o3, -ex * inv_ge, -ey * inv_ge, -ez * inv_ge, o1, o2, o3,
                       mfx, mfy, mfz, q2, u2);
          rotate_basis(l1, l2, l3, mfx, mfy, mfz, l1, l2, l3, 0.0f, 0.0f, 1.0f, q2, u2);
          q = q2;
          u = u2;
          v = v2;
        }
        p0 = l0;
        p1 = l1;
        p2 = l2;
        p3 = l3;
        c0 = o0;
        c1 = o1;
        c2 = o2;
        c3 = o3;
        ns = ns + 1.0f;
        promoted = promoted || is_pool;
        scattered = true;
      }
    }

    // 6. post-move cell/domain membership: stall lanes that left; AUX also
    // stalls lanes that scattered
    if (in_grid && !cc.contains(px, py, pz, g) && t_rem > 0.0f) stalled = true;
    if (IS_AUX && scattered && t_rem > 0.0f) stalled = true;
  }

  state[SP_P0 * n + lane] = p0;
  state[SP_P1 * n + lane] = p1;
  state[SP_P2 * n + lane] = p2;
  state[SP_P3 * n + lane] = p3;
  state[SP_X * n + lane] = px;
  state[SP_Y * n + lane] = py;
  state[SP_Z * n + lane] = pz;
  state[SP_Q * n + lane] = q;
  state[SP_U * n + lane] = u;
  state[SP_V * n + lane] = v;
  state[SP_TREM * n + lane] = t_rem;
  state[SP_NS * n + lane] = ns;
  state[SP_C0 * n + lane] = c0;
  state[SP_C1 * n + lane] = c1;
  state[SP_C2 * n + lane] = c2;
  state[SP_C3 * n + lane] = c3;
  out_flags[lane] = (stalled ? OUT_STALLED : 0) | (promoted ? OUT_PROMOTED : 0);
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

template <int TAU, int GEO, int SRC, bool V2>
void launch(const Launch& a, bool stokes, cudaStream_t s) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((a.n + threads - 1) / threads);
  if (stokes) {
    fused_rounds_kernel<true, GEO, SRC, V2, TAU><<<blocks, threads, 0, s>>>(
        a.state, a.n, a.cell, a.flags, a.table, a.ncell, a.block_act, a.out_flags, a.seed,
        a.g, a.cst, a.inner_rounds, a.el_iters, a.kn_iters, a.block_lanes, a.cheb_base,
        a.ntc, a.aux);
  } else {
    fused_rounds_kernel<false, GEO, SRC, V2, TAU><<<blocks, threads, 0, s>>>(
        a.state, a.n, a.cell, a.flags, a.table, a.ncell, a.block_act, a.out_flags, a.seed,
        a.g, a.cst, a.inner_rounds, a.el_iters, a.kn_iters, a.block_lanes, a.cheb_base,
        a.ntc, a.aux);
  }
}

// the kernel's Klein-Nishina cross section on its own, for checks
__global__ void kn_cross_section_kernel(const float* __restrict__ e, float* __restrict__ out,
                                        int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = kn_cross_section(e[i]);
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

namespace {

// one family's instantiations, by variant code; false for an unknown code
// or an ultra/slim variant in a family of the packed variants only
template <int TAU>
bool launch_variant(int variant, const Launch& a, bool st, cudaStream_t s) {
  if constexpr (TAU == DIRECT || TAU == CHEB) {  // the others: packed variants only
    switch (variant) {
      case 0: launch<TAU, CYL2, ULTRA, false>(a, st, s); return true;
      case 1: launch<TAU, SPH2, ULTRA, false>(a, st, s); return true;
      case 2: launch<TAU, CART3, ULTRA, false>(a, st, s); return true;
      case 3: launch<TAU, CYL2, SLIM, false>(a, st, s); return true;
    }
  }
  switch (variant) {
    case 4: launch<TAU, CYL2, PACKED, false>(a, st, s); return true;
    case 5: launch<TAU, CYL2, PACKED, true>(a, st, s); return true;
    case 6: launch<TAU, SPH2, PACKED, false>(a, st, s); return true;
    case 7: launch<TAU, SPH2, PACKED, true>(a, st, s); return true;
    case 8: launch<TAU, CART3, PACKED, false>(a, st, s); return true;
    case 9: launch<TAU, SPH3, PACKED, false>(a, st, s); return true;
    case 10: launch<TAU, POL3, PACKED, false>(a, st, s); return true;
  }
  return false;
}

}  // namespace

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
  const bool st = stokes_on != 0;
  cudaStream_t s = (cudaStream_t)stream;
  bool ok = false;
  switch (tau) {
    case DIRECT: ok = launch_variant<DIRECT>(variant, a, st, s); break;
    case CHEB: ok = launch_variant<CHEB>(variant, a, st, s); break;
    case CHEB_NT: ok = launch_variant<CHEB_NT>(variant, a, st, s); break;
    case AUX: ok = launch_variant<AUX>(variant, a, st, s); break;
    case AUX_NT: ok = launch_variant<AUX_NT>(variant, a, st, s); break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* mcrat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
