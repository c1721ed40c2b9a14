// Fused Monte Carlo transport rounds on NVIDIA Hopper (sm_90a).
//
// Replaces mcrat_tpu/ops/pallas_round.py::fused_rounds, "ultra" 2-D
// cartesian/cylindrical variant (DIRECT Thomson optical depth, thermal
// electrons, Stokes on or off).  Its plain PyTorch twin is
// mcrat_tpu_torch/ops/fused_round.py::fused_rounds_reference; the two are
// held against each other lane for lane, so every formula below keeps the
// twin's operation order (and the build turns off FMA contraction).
//
// One thread owns one photon lane and runs `inner_rounds` complete rounds:
//   tau-rate -> comoving boost -> free path -> move -> thermal electron draw
//   -> polarized Klein-Nishina scatter attempt -> Stokes -> cell membership.
// A lane that leaves its cell stalls until the caller re-resolves its cell.
//
// What bounds it on this card: arithmetic, not memory.  A lane reads 128 B
// of state (16 f32 planes) + 24 B of flags/cell/physics and writes 128 B per
// call, against ~115 uniforms (murmur3 finalizer each) and ~40
// transcendentals (log, sin/cos, sqrt, rsqrt, divisions) per round -- the
// kernel is ALU/SFU and register bound.  The design follows from that:
//   * no shared memory, TMA or wgmma: state is streamed once, coalesced
//     (planes are structure-of-arrays, neighbouring lanes at neighbouring
//     addresses), and kept in registers across all rounds;
//   * the lane gathers its own 4 physics values from the (4, Ncell) table by
//     its int32 cell index, and computes the cell centre in f32 -- no host
//     side row gather, no index bit packing;
//   * only the electron-sampler branch a lane needs (Maxwell-Boltzmann below
//     1e7 K, Maxwell-Juttner above, decided per lane) and only lanes that will
//     attempt a scatter run the sampler; rejection loops exit at acceptance.
//     Draw numbers are static (k = round * per_round + offset), so skipping
//     work never shifts a random number;
//   * lanes of idle logical blocks (block_act == 0) and finished lanes return
//     at once; the state is updated in place, so their state is untouched.
// Register pressure and occupancy are not tuned yet (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#define F32(x) ((float)(x))

constexpr int SP_P0 = 0, SP_P1 = 1, SP_P2 = 2, SP_P3 = 3;
constexpr int SP_X = 4, SP_Y = 5, SP_Z = 6;
constexpr int SP_Q = 7, SP_U = 8, SP_V = 9;
constexpr int SP_TREM = 10, SP_NS = 11;
constexpr int SP_C0 = 12, SP_C1 = 13, SP_C2 = 14, SP_C3 = 15;

constexpr int FLAG_ALIVE = 1, FLAG_POOL = 2, FLAG_INGRID = 4;
constexpr int OUT_STALLED = 1, OUT_PROMOTED = 2;

struct Grid {
  float dom0, dom1, dom2, dom3;  // strict domain: r0 in (dom0, dom1), r1 in (dom2, dom3)
  float lo0, d0, lo1, d1;        // uniform cell geometry
  int n1;                        // cells along axis 1
};

struct Consts {
  float kb_over_mec2, thom, c_light, inv_c;  // from mcrat_tpu.constants
};

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

__device__ __forceinline__ float kn_cross_section(float e) {
  if (!(e >= F32(1e-3))) return 1.0f - 2.0f * e;
  const float se = fmaxf(e, F32(1e-10));
  const float t = 1.0f + 2.0f * se;
  return 0.75f * (2.0f / (se * se) +
                  (1.0f / (2.0f * se) - (1.0f + se) / (se * (se * se))) * log1pf(2.0f * se) +
                  (1.0f + se) / (t * t));
}

struct Offsets {
  uint32_t free_, mb, mj, el, acc, theta, phi, per_round;
};

__device__ __forceinline__ Offsets draw_offsets(int el_iters, int kn_iters) {
  Offsets o;
  o.free_ = 1;
  o.mb = 2;
  o.mj = 5;
  o.el = o.mj + 5u * el_iters;
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

// ---------------------------------------------------------------------------

template <bool STOKES>
__global__ void __launch_bounds__(128)
fused_rounds_kernel(float* __restrict__ state, int64_t n, const int* __restrict__ cell,
                    const int* __restrict__ flags, const float* __restrict__ phys,
                    int64_t ncell, const int* __restrict__ block_act,
                    int* __restrict__ out_flags, int seed, Grid g, Consts cst,
                    int inner_rounds, int el_iters, int kn_iters, int block_lanes) {
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
  const float v0s = phys[cl];
  const float v1s = phys[ncell + cl];
  const float n_e = phys[2 * ncell + cl];
  const float temp = phys[3 * ncell + cl];
  const int ii = cl / g.n1;
  const int jj = cl - ii * g.n1;
  const float c0u = g.lo0 + ((float)ii + 0.5f) * g.d0;
  const float c1u = g.lo1 + ((float)jj + 0.5f) * g.d1;

  const uint32_t lane_in = (uint32_t)(lane - pid * block_lanes);
  const uint32_t base =
      (uint32_t)seed + (uint32_t)pid * 1442695041u + lane_in * 0x9E3779B9u;
  const Offsets off = draw_offsets(el_iters, kn_iters);
  const float beta_mag = sqrtf(v0s * v0s + v1s * v1s);
  const float n_sigma = n_e * cst.thom;
  bool stalled = false, promoted = false;

  for (int r = 0; r < inner_rounds; ++r) {
    // a lane that stalls or runs out of frame time stays idle
    if (stalled || !(t_rem > 0.0f)) break;
    const uint32_t k0 = (uint32_t)r * off.per_round;

    // 1. tau rate: fluid beta at the photon azimuth
    const float rho = sqrtf(px * px + py * py);
    const bool has = rho > 0.0f;
    const float safe = has ? rho : 1.0f;
    const float bx = v0s * (has ? px / safe : 1.0f);
    const float by = v0s * (has ? py / safe : 0.0f);
    const float bz = v1s;
    const float fl_norm = sqrtf(bx * bx + by * by + bz * bz);
    const float ph_norm = sqrtf(p1 * p1 + p2 * p2 + p3 * p3);
    const float denom = fmaxf(fl_norm * ph_norm, F32(1e-37));
    const float cos_ang = (bx * p1 + by * p2 + bz * p3) / denom;
    const float rate = n_sigma * (1.0f - beta_mag * cos_ang);

    // 2. comoving four-momentum
    if (in_grid) boost(bx, by, bz, p0, p1, p2, p3, c0, c1, c2, c3);

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
    if (will) {
      // F1 repair: z-hat replaces the degenerate +-beta_f reference vector
      const bool flow = fl_norm > 0.0f;
      const float frx = flow ? bx : 0.0f, fry = flow ? by : 0.0f, frz = flow ? bz : 1.0f;
      const float mfx = flow ? -bx : 0.0f, mfy = flow ? -by : 0.0f, mfz = flow ? -bz : 1.0f;
      float qc = q, uc = u;
      if (STOKES) rotate_basis(p1, p2, p3, 0.0f, 0.0f, 1.0f, p1, p2, p3, frx, fry, frz, qc, uc);
      float g_e, gb_e;
      thermal_gamma_beta(base, k0, off, temp, el_iters, cst, g_e, gb_e);
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
      }
    }

    // 6. post-move cell/domain membership: stall lanes that left
    const float h0 = sqrtf(px * px + py * py);
    const bool in_cell = (2.0f * fabsf(h0 - c0u) - g.d0 <= 0.0f) &&
                         (2.0f * fabsf(pz - c1u) - g.d1 <= 0.0f) && (h0 > g.dom0) &&
                         (h0 < g.dom1) && (pz > g.dom2) && (pz < g.dom3);
    if (in_grid && !in_cell && t_rem > 0.0f) stalled = true;
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

}  // namespace

extern "C" int mcrat_fused_rounds(float* state, int64_t n, const int* cell, const int* flags,
                                  const float* phys, int64_t ncell, const int* block_act,
                                  int* out_flags, int seed, float dom0, float dom1,
                                  float dom2, float dom3, float lo0, float d0, float lo1,
                                  float d1, int n1, int stokes_on, int inner_rounds,
                                  int el_iters, int kn_iters, int block_lanes,
                                  float kb_over_mec2, float thom, float c_light,
                                  float inv_c, void* stream) {
  if (n <= 0) return 0;
  const Grid g{dom0, dom1, dom2, dom3, lo0, d0, lo1, d1, n1};
  const Consts cst{kb_over_mec2, thom, c_light, inv_c};
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (stokes_on) {
    fused_rounds_kernel<true><<<blocks, threads, 0, s>>>(
        state, n, cell, flags, phys, ncell, block_act, out_flags, seed, g, cst,
        inner_rounds, el_iters, kn_iters, block_lanes);
  } else {
    fused_rounds_kernel<false><<<blocks, threads, 0, s>>>(
        state, n, cell, flags, phys, ncell, block_act, out_flags, seed, g, cst,
        inner_rounds, el_iters, kn_iters, block_lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mcrat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
