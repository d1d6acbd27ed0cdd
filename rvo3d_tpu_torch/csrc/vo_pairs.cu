// All-pairs reciprocal velocity obstacles of one env step, consumed where
// they are computed. Each (lane, drone i) row meets its M candidates
// (the drones of its lane, then any sphere obstacles) and reduces them at
// once; no [E, N, M] tensor goes to device memory. Two modes:
//   reward  : (any flagged, min expected time over flagged, min of the
//             5th return slot of config_vo_circle2 over valid) [L, N]
//             -- env/rvo.py vo_reward_info_plain
//   observe : obs_nbr [L, N, nm, 9] and obs_mask [L, N, nm] (the nm most
//             urgent flagged candidates in the last slots, the rest zero),
//             any flagged, min expected time, and collision (a valid pair
//             in the collision branch, or a building cylinder hit)
//             -- env/rvo.py vo_observe_plain
// The per-pair arithmetic is env/rvo.py pairwise_vo and env/geometry.py's
// cone_alpha, reciprocal_apex, vo_cone_outside and vo_expected_time, in
// their operation order: every + - * / and sqrt is an IEEE-rounded
// intrinsic (__fadd_rn ... __dsqrt_rn), which nvcc never contracts into an
// FMA, so the shared NVCC_FLAGS (-fmad on) stay; asin, acos and nearbyint
// are the CUDA math library's, which PyTorch's CUDA ops call too. A sum over
// the 3 coordinates is ((0 + x0) + (0 + x2)) + (0 + x1), the order of
// PyTorch's CUDA reduction over a contiguous last axis of 3 (two threads:
// one takes elements 0 and 2, the other 1). So the kernel gives the plain
// PyTorch path's bits on the card, in float32 and float64.
//
// The selection is that of lexsort_rows plus the tail gather: the total
// order (sort_t ascending, sort_d descending, candidate index ascending)
// with sort_t = 1/(exp_time + 0.2) and sort_d = dis - r_j where flagged,
// -inf and 0 elsewhere; a comparison sees -0.0 equal to +0.0, as the sort
// of `-sort_d + 0.0` does. Nothing is sorted: a flagged candidate's rank is
// the count of candidates before it in that order, and it fills slot
// rank - M + nm when rank >= M - min(nm, M). Only flagged candidates are
// ever selected and written (they rank above every unflagged one), and they
// are all in the cone's normal branch, so a written block is always
// [apex, rel, alpha, dis - r_j, 1/(exp_time + 0.2)].
//
// Replaces no TPU kernel: the JAX package leaves env/rvo.py's pair tensors
// to XLA, which fuses them. It was added because the plain PyTorch version
// writes every [E, N, M] and [E, N, M, 9] intermediate to device memory in
// a kernel of its own (~150 kernels a pass, three passes an env step), so
// on the H100 the env step was bound by those round trips and launches.
// Bound: at 1024 lanes x 32 drones, an observe pass reads 2.0 MB (states,
// actions) and writes 12.3 MB (obs_nbr is dense), 4.3 us at 3.35 TB/s,
// and computes 1.05 M pairs of 108 IEEE operations (0.11 GFLOP, 1.7 us at
// 67 TFLOP/s float32): bytes bound it (chip_smoke.py `vo_bound`).
//
// Design: G = the next power of 2 of M, at most 32, threads own a row, one
// candidate each (M > 32 loops in chunks of 32), so rows of 8 drones pack
// four to a warp. The row's any / min are ballots and xor shuffles within
// the group. A group keeps its candidates' keys and flags in shared memory
// (2M values and M bytes) for the ranks; a selected candidate recomputes its
// pair (at most nm of the group's threads) to write its block. The slots
// before the flagged ones are zeroed by the group, so every output element
// is written once. Buildings (B of a few dozen, shared or one set per lane
// with a mask) are split over the group's threads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Outside the anonymous namespace: the extern "C" launcher takes it.
struct VoParams {
  const void* states;           // [L, N, 12] (T), contiguous
  const void* actions;          // [L, N, 3] (TA), contiguous
  const void* others;           // candidate j of lane l at l*o_lane + j*o_row (T)
  const void* buildings;        // lane l's [B, 4] at (l % b_lanes) * b_lane (T)
  const unsigned char* bmask;   // lane l's [B] at (l % m_lanes) * m_lane
  void* obs_nbr;                // observe: [L, N, nm, 9] (T)
  unsigned char* obs_mask;      // observe: [L, N, nm]
  unsigned char* any_flag;      // [L, N]
  void* min_exp;                // [L, N] (T)
  void* min_dis;                // reward: [L, N] (T)
  unsigned char* collision;     // observe: [L, N]
  int64_t o_lane, o_row, b_lane, m_lane;  // element strides
  int64_t rows;                 // L * N
  double drone_range, exp_radius, delta_t, ctime_threshold;
  double building_range, building_z_slack;
  int N, M, nm, B, b_lanes, m_lanes;
  int group;                    // G: threads a row, a power of 2 <= 32
  int env_train, parity;
};

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct Ar;

template <> struct Ar<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float asin(float a) { return asinf(a); }
  static __device__ __forceinline__ float acos(float a) { return acosf(a); }
  static __device__ __forceinline__ float fmin(float a, float b) { return fminf(a, b); }
  // geometry.rnd for float32: round(x * 100) * float32(1 / 100)
  static __device__ __forceinline__ float rnd2(float x) {
    return mul(nearbyintf(mul(x, 100.0f)), (float)(1.0 / 100.0));
  }
};

template <> struct Ar<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double asin(double a) { return ::asin(a); }
  static __device__ __forceinline__ double acos(double a) { return ::acos(a); }
  static __device__ __forceinline__ double fmin(double a, double b) { return ::fmin(a, b); }
  // torch.round(x, decimals=2): nearbyint(x * 100) / 100
  static __device__ __forceinline__ double rnd2(double x) {
    return div(nearbyint(mul(x, 100.0)), 100.0);
  }
};

template <typename T>
__device__ __forceinline__ T inf() { return (T)INFINITY; }

// torch.sum over a contiguous last axis of 3 on CUDA (see the note above)
template <typename T>
__device__ __forceinline__ T sum3(T x0, T x1, T x2) {
  using A = Ar<T>;
  return A::add(A::add(A::add(T(0), x0), A::add(T(0), x2)), A::add(T(0), x1));
}

template <typename T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, T b0, T b1, T b2) {
  using A = Ar<T>;
  return sum3(A::mul(a0, b0), A::mul(a1, b1), A::mul(a2, b2));
}

// torch.clamp: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return x != x ? x : fmin(fmax(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x != x ? x : fmax(x, lo);
}

// geometry.wraptopi
template <typename T>
__device__ __forceinline__ T wraptopi(T th) {
  using A = Ar<T>;
  const T pi = (T)M_PI, two_pi = (T)(2.0 * M_PI);
  th = th > pi ? A::sub(th, two_pi) : th;
  return th < -pi ? A::add(th, two_pi) : th;
}

template <typename T>
__device__ __forceinline__ T round2(T x, bool parity) {
  return parity ? Ar<T>::rnd2(x) : x;
}

// torch.amin's step: NaN propagates
template <typename T>
__device__ __forceinline__ T min_nan(T m, T v) {
  return (v != v || v < m) ? v : m;
}

// drone i, the self side of its pairs
template <typename T>
struct Self {
  T p[3], v[3], r, pr;
  T act2[3];   // 2 * act (exact in the action's type)
  T act2dt[3]; // (2 * act) * delta_t, rounded in the action's type
};

template <typename T>
struct Pair {
  bool valid, collision, backoff, flagged;
  T exp_time;   // t_raw where in the VO (vo_flag), else inf
  T min_dis4;   // collision: r_sum; back-off: dis; normal: dis - r_j
  T paa[3], rel[3], alpha, md, iet;  // md = dis - r_j, iet = 1/(exp_time+0.2)
};

template <typename T, typename TA>
__device__ __forceinline__ Self<T> load_self(const VoParams& p, int64_t row) {
  using A = Ar<TA>;
  const T* s = static_cast<const T*>(p.states) + row * 12;
  const TA* a = static_cast<const TA*>(p.actions) + row * 3;
  Self<T> me;
  for (int k = 0; k < 3; ++k) {
    me.p[k] = s[k];
    me.v[k] = s[3 + k];
  }
  me.r = s[6];
  me.pr = s[7];
  TA act[3] = {a[0], a[1], a[2]};
  // the reference zeroes near-zero actions (rvo_inter.py:118-119)
  const TA an = A::sqrt(dot3(act[0], act[1], act[2], act[0], act[1], act[2]));
  const bool zero = an < (TA)1e-5;
  for (int k = 0; k < 3; ++k) {
    const TA ak = zero ? TA(0) : act[k];
    const TA two_a = A::mul(TA(2), ak);
    me.act2[k] = (T)two_a;
    me.act2dt[k] = (T)A::mul(two_a, (TA)p.delta_t);
  }
  return me;
}

// env/rvo.py pairwise_vo for one (i, j)
template <typename T>
__device__ __forceinline__ Pair<T> pair_vo(const VoParams& p, const Self<T>& me,
                                           const T* o) {
  using A = Ar<T>;
  Pair<T> q;
  T ov[3];
  for (int k = 0; k < 3; ++k) {
    q.rel[k] = A::sub(o[k], me.p[k]);
    ov[k] = o[3 + k];
  }
  const T o_r = o[6], o_pr = o[7];
  const T dis2 = dot3(q.rel[0], q.rel[1], q.rel[2], q.rel[0], q.rel[1], q.rel[2]);
  const T dis = A::sqrt(dis2);
  const T r_sum = A::add(me.r, o_r);
  const bool pos_equal = me.p[0] == o[0] && me.p[1] == o[1] && me.p[2] == o[2];
  q.valid = !pos_equal && dis <= (T)p.drone_range;
  q.collision = p.env_train ? dis <= r_sum
                            : dis <= A::add(A::sub(me.r, (T)p.exp_radius), o_r);
  const T dot = dot3(me.v[0], me.v[1], me.v[2], q.rel[0], q.rel[1], q.rel[2]);
  q.backoff = !q.collision && dot <= T(0);
  const bool normal = !q.collision && !q.backoff;
  const bool parity = p.parity;

  // geometry.cone_alpha
  const T ratio = clamp(A::div(r_sum, clamp_min(dis, (T)1e-30)), T(-1), T(1));
  q.alpha = round2(wraptopi(A::asin(ratio)), parity);

  // geometry.reciprocal_apex: pr * (2 pa + (va + vb))
  const T pr = A::div(me.pr, A::add(me.pr, o_pr));
  T bvec[3], rv[3];
  for (int k = 0; k < 3; ++k) {
    q.paa[k] = A::mul(pr, A::add(A::mul(T(2), me.p[k]), A::add(me.v[k], ov[k])));
    // geometry.vo_cone_outside: panew - paa, panew = pa + 2 act dt
    bvec[k] = A::sub(A::add(me.p[k], me.act2dt[k]), q.paa[k]);
    // geometry.vo_expected_time's rel_v = -((2 act - v_b) - v_a)
    rv[k] = -A::sub(A::sub(me.act2[k], ov[k]), me.v[k]);
  }

  // geometry.angle_between(rel, panew - paa)
  const T dab = dot3(q.rel[0], q.rel[1], q.rel[2], bvec[0], bvec[1], bvec[2]);
  const T mag = A::mul(dis, A::sqrt(dot3(bvec[0], bvec[1], bvec[2],
                                         bvec[0], bvec[1], bvec[2])));
  const T cosv = clamp(mag != T(0) ? A::div(dab, mag) : T(0), T(-1), T(1));
  const T beta = round2(wraptopi(A::acos(cosv)), parity);
  const bool outside = !(q.alpha > beta);

  // geometry.vo_expected_time(rel, rel_v_origin, r_sum)
  const T a = dot3(rv[0], rv[1], rv[2], rv[0], rv[1], rv[2]);
  const T b = A::mul(T(2), dot3(q.rel[0], q.rel[1], q.rel[2], rv[0], rv[1], rv[2]));
  const T c = A::sub(dis2, A::mul(r_sum, r_sum));
  const T disc = A::sub(A::mul(b, b), A::mul(A::mul(T(4), a), c));
  const T den = A::mul(T(2), a != T(0) ? a : T(1));
  const T sq = A::sqrt(clamp_min(disc, T(0)));
  const T t1 = A::div(A::add(-b, sq), den);
  const T t2 = A::div(A::sub(-b, sq), den);
  const bool both_neg = t1 < T(0) && t2 < T(0);
  const T t_pos = A::fmin(t1 >= T(0) ? t1 : inf<T>(), t2 >= T(0) ? t2 : inf<T>());
  T t = disc <= T(0) ? inf<T>() : (both_neg ? T(-1) : t_pos);
  t = c <= T(0) ? T(0) : t;

  const bool vo_flag = normal && !outside && t < (T)p.ctime_threshold;
  q.exp_time = vo_flag ? t : inf<T>();
  q.iet = A::div(T(1), A::add(q.exp_time, (T)0.2));   // reciprocal() * 1.0
  q.md = A::sub(dis, o_r);
  q.min_dis4 = q.collision ? r_sum : (q.backoff ? dis : q.md);
  q.flagged = vo_flag && q.valid;
  return q;
}

// env/rvo.py building_collision for one drone and building b
template <typename T>
__device__ __forceinline__ bool building_hit(const VoParams& p, const Self<T>& me,
                                             const T* bld) {
  using A = Ar<T>;
  const T dx = A::sub(me.p[0], bld[0]);
  const T dy = A::sub(me.p[1], bld[1]);
  const T d2 = A::sqrt(A::add(A::mul(dx, dx), A::mul(dy, dy)));
  const T z = me.p[2], bh = bld[2];
  const bool in_range = bh > A::sub(z, (T)p.building_z_slack) &&
                        d2 <= (T)p.building_range;
  const bool hit = z <= bh && d2 <= A::add(me.r, bld[3]);
  return in_range && hit;
}

// true where the candidate (t2, d2, j2) comes before (t, d, j)
template <typename T>
__device__ __forceinline__ bool before(T t2, T d2, int j2, T t, T d, int j) {
  return t2 < t || (t2 == t && (d2 > d || (d2 == d && j2 < j)));
}

template <typename T, typename TA, bool OBSERVE>
__global__ void __launch_bounds__(THREADS) vo_pairs_kernel(const VoParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.group, M = p.M;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int grp = threadIdx.x / G;                      // group in the block
  const unsigned gbits = G == 32 ? FULL : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int64_t row_raw = (int64_t)blockIdx.x * (THREADS / G) + grp;
  const bool live = row_raw < p.rows;
  const int64_t row = live ? row_raw : p.rows - 1;      // past the end: compute, store nothing
  const int64_t lane_l = row / p.N;

  // keys of this group's candidates: t [M], d [M] (T), then flags [M]
  T* kt = reinterpret_cast<T*>(smem) + (int64_t)grp * 2 * M;
  T* kd = kt + M;
  unsigned char* kf = smem + (int64_t)(THREADS / G) * 2 * M * sizeof(T) + (int64_t)grp * M;

  const Self<T> me = load_self<T, TA>(p, row);
  const T* others = static_cast<const T*>(p.others) + lane_l * p.o_lane;

  bool any_f = false, pcol = false;
  int nflag = 0;
  T min_exp = inf<T>(), min_dis = inf<T>();
  for (int c = 0; c < M; c += G) {
    const int j = c + g;
    bool fl = false;
    if (j < M) {
      const Pair<T> q = pair_vo(p, me, others + j * p.o_row);
      fl = q.flagged;
      if (fl) min_exp = min_nan(min_exp, q.exp_time);
      if (OBSERVE) {
        pcol |= q.collision && q.valid;
        kt[j] = fl ? q.iet : -inf<T>();
        kd[j] = fl ? q.md : T(0);
        kf[j] = fl;
      } else if (q.valid) {
        min_dis = min_nan(min_dis, q.min_dis4);
      }
    }
    any_f |= fl;
    nflag += __popc(__ballot_sync(FULL, fl) & gbits);
  }
  for (int off = G / 2; off > 0; off >>= 1) {
    min_exp = min_nan(min_exp, __shfl_xor_sync(FULL, min_exp, off));
    if (!OBSERVE) min_dis = min_nan(min_dis, __shfl_xor_sync(FULL, min_dis, off));
  }
  any_f = (__ballot_sync(FULL, any_f) & gbits) != 0;

  if (!OBSERVE) {
    if (live && g == 0) {
      p.any_flag[row] = any_f;
      static_cast<T*>(p.min_exp)[row] = min_exp;
      static_cast<T*>(p.min_dis)[row] = min_dis;
    }
    return;
  }

  // building cylinders, split over the group
  bool bcol = false;
  if (p.B > 0) {
    const T* bld = static_cast<const T*>(p.buildings) + (lane_l % p.b_lanes) * p.b_lane;
    const unsigned char* bm = p.bmask + (lane_l % p.m_lanes) * p.m_lane;
    for (int b = g; b < p.B; b += G)
      bcol |= bm[b] && building_hit(p, me, bld + 4 * b);
  }
  const bool collision = (__ballot_sync(FULL, pcol || bcol) & gbits) != 0;
  __syncwarp();   // the group's keys are in shared memory

  const int nm = p.nm;
  const int k = min(nm, M);
  const int written = min(nflag, k);            // flagged blocks, in the last slots
  T* obs = static_cast<T*>(p.obs_nbr) + row * nm * 9;
  unsigned char* mask = p.obs_mask + row * nm;
  if (live) {
    for (int e = g; e < (nm - written) * 9; e += G) obs[e] = T(0);
    for (int s = g; s < nm - written; s += G) mask[s] = 0;
  }
  for (int c = 0; c < M; c += G) {
    const int j = c + g;
    if (!live || j >= M || !kf[j]) continue;
    const T tj = kt[j], dj = kd[j];
    int rank = 0;
    for (int j2 = 0; j2 < M; ++j2) rank += before(kt[j2], kd[j2], j2, tj, dj, j);
    if (rank < M - k) continue;
    const Pair<T> q = pair_vo(p, me, others + j * p.o_row);
    T* blk = obs + (rank - M + nm) * 9;
    for (int e = 0; e < 3; ++e) {
      blk[e] = q.paa[e];
      blk[3 + e] = q.rel[e];
    }
    blk[6] = q.alpha;
    blk[7] = q.md;
    blk[8] = q.iet;
    mask[rank - M + nm] = 1;
  }
  if (live && g == 0) {
    p.any_flag[row] = any_f;
    static_cast<T*>(p.min_exp)[row] = min_exp;
    p.collision[row] = collision;
  }
}

template <typename T, typename TA>
int launch_typed(const VoParams* p, int observe, int blocks, int smem, cudaStream_t stream) {
  if (observe)
    vo_pairs_kernel<T, TA, true><<<blocks, THREADS, smem, stream>>>(*p);
  else
    vo_pairs_kernel<T, TA, false><<<blocks, THREADS, smem, stream>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch `blocks` blocks of 256 threads (THREADS / group rows each) on
// `stream` (asynchronous). dtype 0: float32 states and actions; 1: float64
// states and actions; 2: float64 states, float32 actions. The caller checks
// shapes and computes the geometry; the launcher refuses what the kernel
// cannot take. Returns a cudaError_t (0 = success).
int vo_pairs_launch(const VoParams* p, int observe, int dtype, int blocks, int smem,
                    void* stream) {
  const int G = p->group;
  if (G < 1 || G > 32 || (G & (G - 1)) || p->M < 1 || p->N < 1 || p->nm < 1 ||
      p->rows < 1 || blocks < 1 || smem < 0 || smem > 48 * 1024 || p->B < 0 ||
      p->b_lanes < 1 || p->m_lanes < 1 || (G < 32 && G < p->M))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_typed<float, float>(p, observe, blocks, smem, s);
    case 1: return launch_typed<double, double>(p, observe, blocks, smem, s);
    case 2: return launch_typed<double, float>(p, observe, blocks, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
