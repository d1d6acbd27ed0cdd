// The env step's per-drone arithmetic (env/env.py step_plain, observe_plain,
// reset_where_plain) as passes in which one thread owns one (lane, drone)
// row and keeps the row's values in registers; the all-pairs VO stays the
// vo_pairs kernel, launched between them. A step is
//   pre   : states12 of the pre-step state (drone_states_12)
//   (VO reward_info)
//   mid   : rvo_reward's per-drone part, kinematic_step and the freeze of
//           arrived or collided drones, the control noise, integration, the
//           route length, the waypoint advance and extra length, states12 of
//           the post-step state with both max_deviation updates, the arrive
//           and destination flags, obs_self, and mov_reward's terms but the
//           collision's
//   (VO observe)
//   post  : collision | out_of_map, the collision's share of mov_reward,
//           reward = rvo + mov, done, and obs_nbr's 2-decimal rounding (of
//           the slots obs_mask lists: the others hold +0.0)
// observe is `obs` (states12, obs_self, max_deviation, the zero action),
// VO observe, then `post` in its observe mode (zero reward and done, the
// rounding); reset_where is one `reset` pass over every drone field.
//
// Each value is the plain path's on the card, operation by operation: + - *
// / and sqrt are ieee.cuh's round-to-nearest intrinsics, so nothing is
// contracted into an FMA; atan2, cos, sin, exp, log, pow, acos, fmod and
// nearbyint are the CUDA math library's, which PyTorch's CUDA kernels call;
// a sum over 3 coordinates is ieee.cuh's sum3 (PyTorch's CUDA reduction
// order); a division by a Python number is a multiplication by its
// reciprocal in the tensor's type and `c / x` is reciprocal(x) * c, as
// PyTorch's CUDA kernels compute them; Python numbers take the type of the
// tensor they meet, and a float32 action's own arithmetic stays in float32
// beside float64 states, as type promotion keeps it.
//
// Replaces no TPU kernel: the JAX package leaves these ops to XLA, which
// fuses them. Plain PyTorch runs them as ~390 kernels of 2-5 us a step
// (step 295, observe 62, reset_where 32), each a round trip through device
// memory; here a row's ~1.2 KB of traffic is read and written once a pass.
//
// Lane worlds (worlds/multi.py) are read in place: lane l of the fleet reads
// leaf X of world lane l % w_lanes at X + (l % w_lanes) * x_lane, with
// x_lane 0 for a leaf that all lanes share.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ieee.cuh"

// Outside the anonymous namespace: the extern "C" launcher takes it.
struct DroneParams {
  // the fleet state in, [L, N, ...] contiguous (T; wp int32; flags bytes)
  const void* pos;
  const void* vel;
  const void* yaw;
  const void* pitch;
  const int* wp;
  const unsigned char* arrive;
  const unsigned char* dest;
  const unsigned char* coll;
  const void* rrl;
  const void* extra;
  const void* maxdev;
  const void* prev;
  // the fleet state out (mid, reset; obs writes maxdev_o)
  void* pos_o;
  void* vel_o;
  void* yaw_o;
  void* pitch_o;
  int* wp_o;
  unsigned char* arrive_o;
  unsigned char* dest_o;
  unsigned char* coll_o;
  void* rrl_o;
  void* extra_o;
  void* maxdev_o;
  void* prev_o;
  // the world (T; n_points int32), lane strides in elements
  const void* wps;              // [N, W, 3]
  const int* n_points;          // [N]
  const void* route_len;        // [N]
  const void* map_size;         // [3]
  const void* radius;           // [N]
  const void* priority;         // [N]
  const void* vel_max;          // [N, 3]
  // a step's inputs
  const void* actions;          // mid: [L, N, 3] (TA)
  const void* noise;            // mid: [L, N, 3] (float32 or float64: noise_f64)
  const void* s12_in;           // mid: the pre-step states [L, N, 12]
  const unsigned char* vo_flag; // mid: the reward pass's any-flagged [L, N]
  const void* min_exp;          // mid: its min expected time [L, N]
  const unsigned char* vo_coll; // post: the observe pass's collision [L, N]
  const unsigned char* mask;    // reset: row (l, i) at l * mask_lane + i * mask_row
  // outputs
  void* s12;                    // pre, mid, obs: states [L, N, 12]
  void* obs_self;               // mid, obs: rounded states [L, N, 12] (parity)
  void* act0;                   // obs: the zero action [L, N, 3]
  void* reward;                 // mid: the rvo reward; post: the reward [L, N]
  unsigned char* done;          // post: [L, N]
  void* scratch;                // mid -> post: mov_reward but the collision's,
                                // then the progress term [2, L * N]
  void* obs_nbr;                // post: [L, N, nm, 9], rounded in place (parity)
  const unsigned char* obs_mask;  // post: [L, N, nm], the VO kernel's slots
  int64_t wps_lane, np_lane, rl_lane, ms_lane, rad_lane, pri_lane, vm_lane;
  int64_t mask_lane, mask_row;
  int64_t rows;                 // L * N
  double goal_threshold, dt, max_acc, max_angle_change, control_std;
  double rvo_p_base, rvo_p_urgent, mov_p_way, mov_p_dest, mov_p_exlen;
  double mov_collision, mov_p_progress;
  int N, W, nm, w_lanes;
  int parity, safe_rewards, noise_on, noise_f64, progress_on;
};

namespace {

constexpr int THREADS = 256;
enum Mode { PRE = 0, MID = 1, POST = 2, OBS = 3, POST_OBS = 4, RESET = 5 };

// the CUDA math library's functions that PyTorch's CUDA kernels call
template <typename T> struct Fn;

template <> struct Fn<float> {
  static __device__ __forceinline__ float atan2(float y, float x) { return atan2f(y, x); }
  static __device__ __forceinline__ float cos(float a) { return cosf(a); }
  static __device__ __forceinline__ float sin(float a) { return sinf(a); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ float log(float a) { return logf(a); }
  static __device__ __forceinline__ float pow(float a, float b) { return powf(a, b); }
  static __device__ __forceinline__ float fmod(float a, float b) { return fmodf(a, b); }
  // geometry.rnd for float32: round(x * 10^d) * float32(1 / 10^d)
  static __device__ __forceinline__ float rnd(float x, int d) {
    using A = Ar<float>;
    return d == 2 ? A::mul(nearbyintf(A::mul(x, 100.0f)), (float)(1.0 / 100.0))
                  : A::mul(nearbyintf(A::mul(x, 1000.0f)), (float)(1.0 / 1000.0));
  }
};

template <> struct Fn<double> {
  static __device__ __forceinline__ double atan2(double y, double x) { return ::atan2(y, x); }
  static __device__ __forceinline__ double cos(double a) { return ::cos(a); }
  static __device__ __forceinline__ double sin(double a) { return ::sin(a); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double log(double a) { return ::log(a); }
  static __device__ __forceinline__ double pow(double a, double b) { return ::pow(a, b); }
  static __device__ __forceinline__ double fmod(double a, double b) { return ::fmod(a, b); }
  // torch.round(x, decimals=d): nearbyint(x * 10^d) / 10^d
  static __device__ __forceinline__ double rnd(double x, int d) {
    using A = Ar<double>;
    const double s = d == 2 ? 100.0 : 1000.0;
    return A::div(nearbyint(A::mul(x, s)), s);
  }
};

template <typename T>
__device__ __forceinline__ T rnd(T x, int d, bool on) {
  return on ? Fn<T>::rnd(x, d) : x;
}

template <typename T>
__device__ __forceinline__ T norm3(T x0, T x1, T x2) {
  return Ar<T>::sqrt(dot3(x0, x1, x2, x0, x1, x2));
}

template <typename T>
__device__ __forceinline__ T dist3(const T* a, const T* b) {
  using A = Ar<T>;
  return norm3(A::sub(a[0], b[0]), A::sub(a[1], b[1]), A::sub(a[2], b[2]));
}

// x / s for a Python number s: x * (1 / s), the reciprocal in T
template <typename T>
__device__ __forceinline__ T div_by(T x, double s) {
  using A = Ar<T>;
  return A::mul(x, A::div(T(1), (T)s));
}

// torch.maximum: NaN propagates
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}

// torch.remainder of floats: fmod, moved to the divisor's sign
template <typename T>
__device__ __forceinline__ T remainder(T a, T b) {
  T mod = Fn<T>::fmod(a, b);
  if (mod != T(0) && ((b < T(0)) != (mod < T(0)))) mod = Ar<T>::add(mod, b);
  return mod;
}

// reward.angle_bucket_bonus
template <typename T>
__device__ __forceinline__ T angle_bucket(T a) {
  T out = T(-4);
  out = a < (T)(M_PI / 2) ? T(0) : out;
  out = a < (T)(M_PI / 3) ? T(0.5) : out;
  out = a < (T)(M_PI / 6) ? T(1) : out;
  return a < (T)(M_PI / 18) ? T(3) : out;
}

// lane l's drone i in the world's leaves
template <typename T>
struct World {
  const T* wps;       // [W, 3] of drone i
  int np;
  T route_len, radius, priority, vel_max[3];
  const T* map_size;  // [3]
};

template <typename T>
__device__ __forceinline__ World<T> world_row(const DroneParams& p, int64_t r) {
  const int l = (int)r / p.N, i = (int)r - l * p.N, wl = l % p.w_lanes;
  World<T> w;
  w.wps = static_cast<const T*>(p.wps) + wl * p.wps_lane + i * p.W * 3;
  w.np = p.n_points[wl * p.np_lane + i];
  w.route_len = static_cast<const T*>(p.route_len)[wl * p.rl_lane + i];
  w.radius = static_cast<const T*>(p.radius)[wl * p.rad_lane + i];
  w.priority = static_cast<const T*>(p.priority)[wl * p.pri_lane + i];
  const T* vm = static_cast<const T*>(p.vel_max) + wl * p.vm_lane + i * 3;
  for (int k = 0; k < 3; ++k) w.vel_max[k] = vm[k];
  w.map_size = static_cast<const T*>(p.map_size) + wl * p.ms_lane;
  return w;
}

template <typename T>
__device__ __forceinline__ void load3(const void* base, int64_t r, T out[3]) {
  const T* x = static_cast<const T*>(base) + r * 3;
  for (int k = 0; k < 3; ++k) out[k] = x[k];
}

template <typename T>
__device__ __forceinline__ void store3(void* base, int64_t r, const T v[3]) {
  T* x = static_cast<T*>(base) + r * 3;
  for (int k = 0; k < 3; ++k) x[k] = v[k];
}

template <typename T>
__device__ __forceinline__ T at(const void* base, int64_t r) {
  return static_cast<const T*>(base)[r];
}

// env.drone_states_12 at (pos, vel, waypoint index wp): [pos, vel, radius,
// priority, des_vel, deviation] (geometry.desired_velocity and
// geometry.point_line_deviation)
template <typename T>
__device__ __forceinline__ void states12(const DroneParams& p, const World<T>& w,
                                         const T pos[3], const T vel[3], int wp, T s[12]) {
  using A = Ar<T>;
  using F = Fn<T>;
  const T* cur = w.wps + (int64_t)wp * 3;
  const T* prev = w.wps + (int64_t)max(wp - 1, 0) * 3;
  for (int k = 0; k < 3; ++k) {
    s[k] = pos[k];
    s[3 + k] = vel[k];
  }
  s[6] = w.radius;
  s[7] = w.priority;

  // desired_velocity(pos, cur, vel_max, goal_threshold)
  T dif[3];
  for (int k = 0; k < 3; ++k) dif[k] = A::sub(cur[k], pos[k]);
  const T dis = norm3(dif[0], dif[1], dif[2]);
  const T az = F::atan2(dif[1], dif[0]);
  const T horiz = A::sqrt(A::add(A::mul(dif[0], dif[0]), A::mul(dif[1], dif[1])));
  const T el = F::atan2(dif[2], horiz);
  const T cel = F::cos(el);
  const T dir[3] = {A::mul(F::cos(az), cel), A::mul(F::sin(az), cel), F::sin(el)};
  const bool away = dis > (T)p.goal_threshold;
  for (int k = 0; k < 3; ++k)
    s[8 + k] = away ? rnd(A::mul(w.vel_max[k], dir[k]), 3, p.parity) : T(0);

  // point_line_deviation(prev, cur, pos)
  T d[3], ps[3];
  for (int k = 0; k < 3; ++k) {
    d[k] = A::sub(cur[k], prev[k]);
    ps[k] = A::sub(pos[k], prev[k]);
  }
  const T mag = norm3(d[0], d[1], d[2]);
  const T safe = mag != T(0) ? mag : T(1);
  T dh[3];
  for (int k = 0; k < 3; ++k) dh[k] = A::div(d[k], safe);
  const T t = dot3(ps[0], ps[1], ps[2], dh[0], dh[1], dh[2]);
  T pq[3];
  for (int k = 0; k < 3; ++k) pq[k] = A::sub(pos[k], A::add(prev[k], A::mul(t, dh[k])));
  s[11] = mag == T(0) ? T(0) : norm3(pq[0], pq[1], pq[2]);
}

// a row of 12 values (48 or 96 bytes, 16-byte aligned) in 16-byte stores,
// so a warp's stores cover whole sectors
__device__ __forceinline__ void store12(float* out, const float s[12]) {
  float4* o = reinterpret_cast<float4*>(out);
  for (int k = 0; k < 3; ++k) o[k] = make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
}

__device__ __forceinline__ void store12(double* out, const double s[12]) {
  double2* o = reinterpret_cast<double2*>(out);
  for (int k = 0; k < 6; ++k) o[k] = make_double2(s[2 * k], s[2 * k + 1]);
}

// 4 values from a 16-byte aligned address, in 16-byte loads
__device__ __forceinline__ void load4(const float* x, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(x);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

__device__ __forceinline__ void load4(const double* x, double out[4]) {
  const double2 a = reinterpret_cast<const double2*>(x)[0];
  const double2 b = reinterpret_cast<const double2*>(x)[1];
  out[0] = a.x, out[1] = a.y, out[2] = b.x, out[3] = b.y;
}

template <typename T>
__device__ __forceinline__ void store_states(const DroneParams& p, int64_t r, const T s[12]) {
  store12(static_cast<T*>(p.s12) + r * 12, s);
  if (p.parity) {
    T o[12];
    for (int k = 0; k < 12; ++k) o[k] = Fn<T>::rnd(s[k], 2);
    store12(static_cast<T*>(p.obs_self) + r * 12, o);
  }
}

template <typename T>
__device__ __forceinline__ void pre_row(const DroneParams& p, int64_t r) {
  const World<T> w = world_row<T>(p, r);
  T pos[3], vel[3], s[12];
  load3(p.pos, r, pos);
  load3(p.vel, r, vel);
  states12(p, w, pos, vel, p.wp[r], s);
  store12(static_cast<T*>(p.s12) + r * 12, s);
}

template <typename T>
__device__ __forceinline__ void obs_row(const DroneParams& p, int64_t r) {
  const World<T> w = world_row<T>(p, r);
  T pos[3], vel[3], s[12];
  load3(p.pos, r, pos);
  load3(p.vel, r, vel);
  states12(p, w, pos, vel, p.wp[r], s);
  store_states(p, r, s);
  static_cast<T*>(p.maxdev_o)[r] = maximum(at<T>(p.maxdev, r), s[11]);
  const T zero[3] = {T(0), T(0), T(0)};
  store3(p.act0, r, zero);
}

template <typename T, typename TA>
__device__ __forceinline__ void mid_row(const DroneParams& p, int64_t r) {
  using A = Ar<T>;
  using B = Ar<TA>;
  using F = Fn<T>;
  const World<T> w = world_row<T>(p, r);
  const bool parity = p.parity;
  T pos[3], vel[3];
  load3(p.pos, r, pos);
  load3(p.vel, r, vel);
  const TA* ap = static_cast<const TA*>(p.actions) + r * 3;
  const TA act[3] = {ap[0], ap[1], ap[2]};
  T s_pre[4];   // the pre-step states' des_vel and deviation
  load4(static_cast<const T*>(p.s12_in) + r * 12 + 8, s_pre);

  // ---- reward.rvo_reward on the pre-step states
  T dv[3];
  for (int k = 0; k < 3; ++k) dv[k] = rnd(s_pre[k], 3, parity);
  const T denom = norm3(dv[0], dv[1], dv[2]);
  const T num = (T)B::mul((TA)0.2, norm3(act[0], act[1], act[2]));
  T vel_pen;
  if (p.safe_rewards)
    vel_pen = denom > T(0) ? A::div(num, clamp_min(denom, (T)1e-6)) : T(0);
  else
    vel_pen = A::div(num, denom);
  // geometry.angle_between_eps(des_vel, action)
  const T mag_a = A::sqrt(A::add(dot3(dv[0], dv[1], dv[2], dv[0], dv[1], dv[2]), (T)1e-8));
  const TA mag_b = B::sqrt(B::add(dot3(act[0], act[1], act[2], act[0], act[1], act[2]),
                                  (TA)1e-8));
  const T dab = dot3(dv[0], dv[1], dv[2], (T)act[0], (T)act[1], (T)act[2]);
  const T cosv = clamp(A::div(dab, A::mul(mag_a, (T)mag_b)), (T)(-1.0 + 1e-8),
                       (T)(1.0 - 1e-8));
  const T ang = (mag_a < (T)1e-6 || mag_b < (TA)1e-6) ? T(0) : Ar<T>::acos(cosv);
  const T t = at<T>(p.min_exp, r);
  const T urgency = t < T(2) ? A::mul((T)p.rvo_p_urgent, F::exp(div_by(-t, 0.5))) : T(0);
  const T safety = p.vo_flag[r] ? A::add(urgency, (T)p.rvo_p_base) : T(0);
  T total = A::add(A::add(angle_bucket(ang), vel_pen), safety);
  if (p.safe_rewards) total = clamp(total, T(-100), T(100));
  static_cast<T*>(p.reward)[r] = rnd(total, 3, parity);

  // ---- geometry.kinematic_step; arrived or collided drones hold position
  const T speed = norm3(vel[0], vel[1], vel[2]);
  const TA mac = (TA)p.max_angle_change;
  const TA acc_d = clamp(B::mul(act[0], (TA)p.max_acc), (TA)(-p.max_acc), (TA)p.max_acc);
  const TA yaw_d = clamp(B::mul(act[1], mac), (TA)(-p.max_angle_change), mac);
  const TA pitch_d = clamp(B::mul(act[2], mac), (TA)(-p.max_angle_change), mac);
  const T new_speed = clamp_min(A::add(speed, (T)B::mul(acc_d, TA(1))), T(0));
  const T new_yaw = remainder(A::add(at<T>(p.yaw, r), (T)yaw_d), T(360));
  const T new_pitch = clamp(A::add(at<T>(p.pitch, r), (T)pitch_d), T(-90), T(90));
  // torch.deg2rad: a multiplication by pi / 180
  const T deg = (T)0.017453292519943295769236907684886127134428718885417;
  const T yr = A::mul(new_yaw, deg), pr = A::mul(new_pitch, deg);
  const T cp = F::cos(pr);
  const bool frozen = p.dest[r] || p.coll[r];
  T nv[3] = {A::mul(A::mul(new_speed, cp), F::cos(yr)),
             A::mul(A::mul(new_speed, cp), F::sin(yr)), A::mul(new_speed, F::sin(pr))};
  if (frozen) nv[0] = nv[1] = nv[2] = T(0);

  // ---- control noise, integration, route length, waypoint advance
  T new_pos[3];
  for (int k = 0; k < 3; ++k) {
    T v = nv[k];
    if (p.noise_on) {
      const T z = p.noise_f64 ? (T) static_cast<const double*>(p.noise)[r * 3 + k]
                              : (T) static_cast<const float*>(p.noise)[r * 3 + k];
      v = Fn<T>::rnd(A::add(v, A::mul(z, (T)p.control_std)), 2);
    }
    new_pos[k] = A::add(pos[k], A::mul(v, (T)p.dt));
  }
  const T rrl = A::add(at<T>(p.rrl, r), dist3(new_pos, pos));
  const int wp = p.wp[r];
  const T* cur = w.wps + (int64_t)wp * 3;
  const T gt = (T)p.goal_threshold;
  const bool arrived_wp = dist3(new_pos, cur) <= gt;
  const bool at_dest = dist3(new_pos, w.wps + (int64_t)(w.np - 1) * 3) <= gt;
  T extra = arrived_wp && at_dest ? A::sub(rrl, w.route_len) : at<T>(p.extra, r);
  const bool advance = arrived_wp && !at_dest && wp < w.np - 1;
  const int new_wp = advance ? wp + 1 : wp;
  bool arrive = p.arrive[r] && !advance;

  // ---- post-step states, flags
  T s[12];
  states12(p, w, new_pos, nv, new_wp, s);
  const bool arrived_now = dist3(new_pos, w.wps + (int64_t)new_wp * 3) <= gt;
  const bool arrive_reward = arrived_now && !arrive;
  arrive = arrive || arrived_now;
  const bool dest_now = arrive && at_dest;
  const bool dest_reward = dest_now && !p.dest[r];
  extra = dest_now ? A::sub(rrl, w.route_len) : extra;

  // ---- reward.mov_reward but the collision's select, and the progress term
  const T way = arrive_reward
      ? A::mul((T)p.mov_p_way, F::pow((T)0.95, (T)(w.np - 1 - new_wp))) : T(0);
  const T dest_r = dest_reward ? (T)p.mov_p_dest : T(0);
  // geometry.deviation_penalty: -1.5 * (2 / (1 + exp(-(10 d - 5) / 0.3)))
  const T e = F::exp(div_by(-A::sub(A::mul(s[11], T(10)), T(5)), 0.3));
  const T dev_pen = A::mul(A::mul(A::div(T(1), A::add(e, T(1))), T(2)), T(-1.5));
  const T exlen = A::add(A::sub(rrl, w.route_len), T(4));
  T ex_raw = A::mul((T)p.mov_p_exlen, F::log(A::add(A::add(exlen, T(1)), (T)1e-6)));
  ex_raw = (ex_raw < T(-6) || ex_raw != ex_raw) ? T(-6) : ex_raw;
  const T ex_pen = exlen > T(0) ? ex_raw : T(0);
  T* scratch = static_cast<T*>(p.scratch);
  scratch[r] = rnd(A::add(A::add(A::add(way, dest_r), dev_pen), ex_pen), 3, parity);
  if (p.progress_on)
    scratch[p.rows + r] = A::mul((T)p.mov_p_progress,
                                 A::sub(dist3(pos, cur), dist3(new_pos, cur)));

  store3(p.pos_o, r, new_pos);
  store3(p.vel_o, r, nv);
  static_cast<T*>(p.yaw_o)[r] = new_yaw;
  static_cast<T*>(p.pitch_o)[r] = new_pitch;
  p.wp_o[r] = new_wp;
  p.arrive_o[r] = arrive;
  p.dest_o[r] = p.dest[r] || dest_now;
  static_cast<T*>(p.rrl_o)[r] = rrl;
  static_cast<T*>(p.extra_o)[r] = extra;
  static_cast<T*>(p.maxdev_o)[r] =
      maximum(maximum(at<T>(p.maxdev, r), s_pre[3]), s[11]);
  store_states(p, r, s);
}

template <typename T>
__device__ __forceinline__ void post_row(const DroneParams& p, int64_t r) {
  using A = Ar<T>;
  T pos[3];
  load3(p.pos, r, pos);
  const T* ms = static_cast<const T*>(p.map_size) + (int64_t)((int)r / p.N % p.w_lanes) * p.ms_lane;
  const bool out = pos[0] < T(0) || pos[1] < T(0) || pos[2] < T(0) ||
                   pos[0] > ms[0] || pos[1] > ms[1] || pos[2] > ms[2];
  const bool col = p.vo_coll[r] || out;
  const T* scratch = static_cast<const T*>(p.scratch);
  T mov = col ? (T)p.mov_collision : scratch[r];
  if (p.progress_on) mov = A::add(mov, col ? T(0) : scratch[p.rows + r]);
  T* reward = static_cast<T*>(p.reward);
  reward[r] = A::add(reward[r], mov);
  p.done[r] = col;
}

template <typename T>
__device__ __forceinline__ void reset_row(const DroneParams& p, int64_t r) {
  const int l = (int)r / p.N, i = (int)r - l * p.N;
  const bool m = p.mask[l * p.mask_lane + i * p.mask_row];
  const T* start = static_cast<const T*>(p.wps) + (l % p.w_lanes) * p.wps_lane +
                   (int64_t)i * p.W * 3;
  T pos[3], vel[3], prev[3];
  load3(p.pos, r, pos);
  load3(p.vel, r, vel);
  load3(p.prev, r, prev);
  for (int k = 0; k < 3; ++k) {
    pos[k] = m ? start[k] : pos[k];
    vel[k] = m ? T(0) : vel[k];
    prev[k] = m ? start[k] : prev[k];
  }
  store3(p.pos_o, r, pos);
  store3(p.vel_o, r, vel);
  store3(p.prev_o, r, prev);
  static_cast<T*>(p.yaw_o)[r] = m ? T(0) : at<T>(p.yaw, r);
  static_cast<T*>(p.pitch_o)[r] = m ? T(0) : at<T>(p.pitch, r);
  p.wp_o[r] = m ? 1 : p.wp[r];
  p.arrive_o[r] = m ? 0 : p.arrive[r];
  p.dest_o[r] = m ? 0 : p.dest[r];
  p.coll_o[r] = m ? 0 : p.coll[r];
  static_cast<T*>(p.rrl_o)[r] = m ? T(0) : at<T>(p.rrl, r);
  static_cast<T*>(p.extra_o)[r] = m ? T(0) : at<T>(p.extra, r);
  static_cast<T*>(p.maxdev_o)[r] = m ? T(0) : at<T>(p.maxdev, r);
}

template <typename T, typename TA, int MODE>
__global__ void __launch_bounds__(THREADS) env_drones_kernel(const DroneParams p) {
  const int64_t first = (int64_t)blockIdx.x * THREADS;
  const int64_t r = first + threadIdx.x;
  if (r < p.rows) {
    if constexpr (MODE == PRE) pre_row<T>(p, r);
    if constexpr (MODE == MID) mid_row<T, TA>(p, r);
    if constexpr (MODE == POST) post_row<T>(p, r);
    if constexpr (MODE == OBS) obs_row<T>(p, r);
    if constexpr (MODE == POST_OBS) {
      static_cast<T*>(p.reward)[r] = T(0);
      p.done[r] = 0;
    }
    if constexpr (MODE == RESET) reset_row<T>(p, r);
  }
  // obs_nbr's 2-decimal rounding, over the block's rows' slots, so a warp
  // reads consecutive mask bytes. The VO kernel writes +0.0 to every slot
  // outside obs_mask, which the rounding keeps, so only the masked slots'
  // values are read and written.
  if constexpr (MODE == POST || MODE == POST_OBS) {
    if (!p.parity) return;
    const int slots = (int)((first + THREADS < p.rows ? THREADS : p.rows - first) * p.nm);
    const unsigned char* mask = p.obs_mask + first * p.nm;
    T* nbr = static_cast<T*>(p.obs_nbr) + first * p.nm * 9;
    for (int s = threadIdx.x; s < slots; s += THREADS)
      if (mask[s])
        for (int k = 0; k < 9; ++k) nbr[s * 9 + k] = Fn<T>::rnd(nbr[s * 9 + k], 2);
  }
}

template <typename T, typename TA>
int launch_typed(const DroneParams* p, int mode, int blocks, cudaStream_t s) {
  switch (mode) {
    case PRE: env_drones_kernel<T, TA, PRE><<<blocks, THREADS, 0, s>>>(*p); break;
    case MID: env_drones_kernel<T, TA, MID><<<blocks, THREADS, 0, s>>>(*p); break;
    case POST: env_drones_kernel<T, TA, POST><<<blocks, THREADS, 0, s>>>(*p); break;
    case OBS: env_drones_kernel<T, TA, OBS><<<blocks, THREADS, 0, s>>>(*p); break;
    case POST_OBS: env_drones_kernel<T, TA, POST_OBS><<<blocks, THREADS, 0, s>>>(*p); break;
    case RESET: env_drones_kernel<T, TA, RESET><<<blocks, THREADS, 0, s>>>(*p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch `blocks` blocks of 256 threads, one row each, of pass `mode` (0 pre,
// 1 mid, 2 post, 3 obs, 4 post in observe's mode, 5 reset) on `stream`
// (asynchronous). dtype 0: float32 states and actions; 1: float64 states and
// actions; 2: float64 states, float32 actions. The caller checks shapes; the
// launcher refuses what the kernel cannot take. Returns a cudaError_t
// (0 = success).
int env_drones_launch(const DroneParams* p, int mode, int dtype, int blocks, void* stream) {
  if (p->rows < 1 || p->rows > INT32_MAX / 16 || p->N < 1 || p->W < 1 || p->w_lanes < 1 ||
      p->nm < 0 || p->nm > 64 || blocks < 1 || (int64_t)blocks * THREADS < p->rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_typed<float, float>(p, mode, blocks, s);
    case 1: return launch_typed<double, double>(p, mode, blocks, s);
    case 2: return launch_typed<double, float>(p, mode, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
