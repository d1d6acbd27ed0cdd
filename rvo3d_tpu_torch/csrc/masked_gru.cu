// Masked GRU scan: the final hidden state of a GRU in torch gate order
// (r, z, n) over S slots, where the carry advances only where mask > 0 and
// h0 = 0:
//   r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
//   z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
//   n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
//   h' = mask > 0 ? (1 - z) * n + z * h : h
// One launch runs one direction, or both directions of a biGRU and sums
// their final states into `out`.
//
// Replaces the Pallas TPU kernel rvo3d_tpu/ops/pallas_gru.py
// (_pallas_forward -> _kernel, pl.pallas_call at :106).
//
// Bound on the H100: per direction the work is 2*B*S*(IN+H)*3H FLOP
// (counting only active (slot, row) pairs: at B=4096, S=10, IN=9, H=256 and
// ~60 % active slots, 10.07 GFLOP). Held to f32 accuracy, the card's
// fastest route is 3xTF32 on the tensor cores, 495/3 = 165 TFLOP/s:
// ~0.061 ms, against ~6.6 MB of traffic (~2 us at 3.35 TB/s). So it is
// bound by operations.
//
// Design: the persistent-RNN scheme (Diamos et al., ICML 2016), with
// Hopper's distributed shared memory in place of global barriers. What it
// does about each limit of the one-block-per-tile kernel it replaces:
//   1. W_hh streamed from L2 by every block at every step: a cluster of
//      CLUSTER (8) CTAs splits the (padded) hidden units. CTA q owns
//      U = Hp/8 units, that is 3U gate columns of W_hh and W_ih, laid out
//      per group of 8 units as [r(8) | z(8) | n(8)] and stored transposed.
//      Each CTA copies its slices into shared memory once per launch with
//      cp.async (zero-filled past H and IN, so padding never changes a
//      result) and keeps them while the cluster walks its row tiles.
//   2. Rows as the only parallel axis: the parallel axes are row tiles x 8
//      CTAs x directions, and the cluster loop is persistent (grid = the
//      clusters the card holds at once, each taking a contiguous share of
//      the work), so a small B still spreads over the card. 12 warps each
//      own one (16-row tile, 8-unit group) item: a tile has R = 48 rows at
//      H = 256 (fewer where IN leaves no room). Each CTA holds the tile's
//      full carry h [R, Hp] twice (a step reads one and writes the other);
//      at each step it computes its gate columns for all R rows, stores its
//      new [R, U] slice locally and copies it in 16-byte chunks into the
//      other 7 CTAs (map_shared_rank). One split cluster barrier a step
//      (arrive.release; the next active step's x tile is fetched; then
//      wait.acquire) orders the exchange.
//   3. Only the f32 CUDA cores: [x | h] . [W_ih ; W_hh] runs on the tensor
//      cores with mma.sync m16n8k8 TF32 at f32 accuracy (3xTF32: a_hi*b_hi,
//      a_hi*b_lo and a_lo*b_hi in separate f32 accumulators, so the three
//      are independent chains; each product is within ~3 * 2^-20 of f32).
//      ldmatrix brings the fragments one k-step ahead and the split happens
//      in registers, so only f32 sits in shared memory. Each thread's
//      accumulators hold r, z and n of the same two units, so the gate
//      epilogue needs no exchange; n keeps W_in x apart from W_hn h. The x
//      tile is read through the caller's strides, so the encoder's
//      [B, nm, 9] view needs no [S, B, IN] copy, and the backward direction
//      walks the slots in reverse instead of copying xs[::-1].
//   4. Two launches per biGRU: both directions run in one launch. The
//      direction is part of the cluster's work item, and the two final
//      states are added into `out` (zeroed by the caller) with atomics;
//      0 + a + b is exact in either order, so the sum is deterministic.
// A step where no row of the tile is active is skipped by the whole cluster
// without a load or a barrier: at a tile's start (and every 64 steps) the
// CTAs read which steps are active from the mask, all alike. The tile,
// cluster and shared-memory geometry is computed by the caller
// (launch_geometry in rvo3d_tpu_torch/ops/masked_gru.py) and passed in
// GruParams.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Outside the anonymous namespace: the extern "C" launcher takes it, and a
// type of internal linkage would hide the launcher's symbol.
struct GruParams {
  const float* xs;
  const float* mask;
  const float* w_ih[2];  // [IN, 3H] per direction
  const float* w_hh[2];  // [H, 3H]
  const float* b_ih[2];  // [3H]
  const float* b_hh[2];  // [3H]
  float* out;            // [B, H]
  int64_t xs_s, xs_b, xs_i, m_s, m_b;  // element strides
  int S, B, IN, H;
  int Hp;       // H padded to a multiple of 8 * CLUSTER
  int rows;     // R, rows per tile: 16, 32 or 48 (R/16 * Hp/64 <= 12)
  int ndirs;    // 1, or 2 for a biGRU (direction 1 runs in reverse)
  int reverse;  // the direction of a one-direction launch
  int ntiles;   // ceil(B / rows)
};
// Work item w in [0, ntiles * ndirs) is tile w % ntiles of direction
// w / ntiles; cluster c of n runs the items [c*W/n, (c+1)*W/n), so it
// changes direction, and reloads its weights, at most once.

namespace {

constexpr int CLUSTER = 8;    // CTAs per cluster (the portable maximum)
constexpr int THREADS = 384;  // 12 warps; each owns one (16-row tile, unit group)
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;
// accumulator tiles: r (x and h), z (x and h), W_hn h, W_in x
constexpr int T_R = 0, T_Z = 1, T_NH = 2, T_NX = 3;

// Gates from the fast exponential: absolute error ~1e-7, far inside the
// kernel's tolerance.
__device__ __forceinline__ float sigmoidf_(float x) {
  return __frcp_rn(1.0f + __expf(-x));
}
__device__ __forceinline__ float tanhf_(float x) {
  return 2.0f * sigmoidf_(2.0f * x) - 1.0f;
}

// Swizzled shared layout of the carry h [R][Hp] and of the transposed
// weight slices W^T [3U][Hp] and [3U][KX]: element (row, k) of a matrix with
// row stride ld (a multiple of 32). The 16-byte chunks of 8 consecutive rows
// land in 8 different bank groups, so ldmatrix reads them without conflict.
// The x tile [R][INp + 4] needs no swizzle (INp + 4 is an odd number of
// chunks).
__device__ __forceinline__ int sw_at(int row, int k, int ld) {
  return row * ld + (k ^ ((row & 7) << 2));
}

__device__ __forceinline__ unsigned smem_u32(const float* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

constexpr int TERMS = 3;  // hi*hi, hi*lo, lo*hi

// x = hi + lo exactly: hi keeps the sign, exponent and top 10 mantissa bits
// (a TF32 value), lo = x - hi (|lo| < 2^-10 |x|) goes to the tensor core as
// it is, which reads its top 10 mantissa bits (error < 2^-20 |x|). Two
// instructions a value, against three for rounding both parts.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// acc[t][*] += A[m0 + grp (+8), :nk] . W[:nk, g*24 + q*8 + grp] for the
// gates q = r, z, n (n into tile TN), as m16n8 accumulator fragments, with
// W read from its transpose Wt (row stride ldw). A is the carry (IS_X
// false, swizzled) or the x tile (row stride lda). One ldmatrix.x4 brings
// the A fragment (matrices: rows +0/+8 x k +0/+4), one x4 and one x2 the B
// fragments of the three gates (matrices: 8 gate columns x k +0/+4).
template <bool IS_X>
__device__ __forceinline__ void products(const float* __restrict__ A, int lda,
                                         const float* __restrict__ Wt, int ldw,
                                         int nk, int m0, int g, int lane,
                                         float (&acc)[4][TERMS][4]) {
  constexpr int TN = IS_X ? T_NX : T_NH;
  const int j = lane >> 3, rr = lane & 7;
  const int arow = m0 + rr + (j & 1) * 8, akoff = (j >> 1) * 4;
  const int brz = g * 24 + (j >> 1) * 8 + rr, bn = g * 24 + 16 + rr;
  const int bkoff = (j & 1) * 4;
  auto a_addr = [&](int k0) {
    const int k = k0 + akoff;
    return smem_u32(A + (IS_X ? arow * lda + k : sw_at(arow, k, lda)));
  };
  auto load = [&](int k0, uint32_t (&a_)[4], uint32_t (&b_)[3][2]) {
    ldmatrix_x4(a_addr(k0), a_);
    uint32_t rz[4];
    ldmatrix_x4(smem_u32(Wt + sw_at(brz, k0 + bkoff, ldw)), rz);
    ldmatrix_x2(smem_u32(Wt + sw_at(bn, k0 + bkoff, ldw)), b_[2]);
    b_[0][0] = rz[0], b_[0][1] = rz[1], b_[1][0] = rz[2], b_[1][1] = rz[3];
  };
  uint32_t a[4], b[3][2];
  load(0, a, b);
#pragma unroll 2
  for (int k0 = 0; k0 < nk; k0 += 8) {
    uint32_t an[4], bnx[3][2];
    load(k0 + 8 < nk ? k0 + 8 : k0, an, bnx);  // the next k-step, ahead
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ahi[e], alo[e]);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int t = q == 0 ? T_R : q == 1 ? T_Z : TN;
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(__uint_as_float(b[q][0]), b0h, b0l);
      split_tf32(__uint_as_float(b[q][1]), b1h, b1l);
      mma_tf32(acc[t][0], ahi, b0h, b1h);
      mma_tf32(acc[t][1], ahi, b0l, b1l);
      mma_tf32(acc[t][2], alo, b0h, b1h);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = an[e];
#pragma unroll
    for (int q = 0; q < 3; ++q) b[q][0] = bnx[q][0], b[q][1] = bnx[q][1];
  }
}

__device__ __forceinline__ float acc_sum(const float (&a)[TERMS][4], int e) {
  return a[0][e] + (a[1][e] + a[2][e]);
}

__global__ void __launch_bounds__(THREADS, 1)
masked_gru_cluster_kernel(const GruParams p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CLUSTER, ncl = gridDim.x / CLUSTER;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;

  const int H = p.H, Hp = p.Hp, IN = p.IN, R = p.rows, S = p.S;
  const int INp = (IN + 7) & ~7, XS = INp + 4;
  const int U = Hp / CLUSTER, G = U / 8, N3 = 3 * U;
  const int KX = (INp + 31) & ~31;
  const int unit0 = rank * U;

  float* ws_ = smem;                  // [N3][Hp]  this CTA's W_hh^T slice
  float* wx_ = ws_ + N3 * Hp;         // [N3][KX]  this CTA's W_ih^T slice
  float* hbuf = wx_ + N3 * KX;        // [2][R][Hp] the tile's carry
  float* bi = hbuf + 2 * R * Hp;      // [N3]
  float* bh = bi + N3;                // [N3]
  float* xt = bh + N3;                // [R][XS]   the step's x tile
  float* mt = xt + R * XS;            // [R]       the step's mask
  // which of 64 steps have an active row in the tile
  unsigned long long* act_bits = reinterpret_cast<unsigned long long*>(mt + R);

  // this warp's (m16 tile, unit group); warps past the last item only help
  // with loads and copies
  const bool has_item = warp < (R / 16) * G;
  const int m0 = (warp / G) * 16, g = warp % G;
  const int nwork = p.ntiles * p.ndirs;
  const int w_begin = (int)((int64_t)cid * nwork / ncl);
  const int w_end = (int)((int64_t)(cid + 1) * nwork / ncl);
  int loaded = -1;  // direction whose weights are in shared memory

  // x tile and mask of slot s for rows b0.., zero past B and IN
  auto load_step = [&](int s, int b0) {
    for (int idx = tid; idx < R * INp; idx += THREADS) {
      const int b = idx / INp, i = idx - b * INp;
      const int gb = b0 + b;
      xt[b * XS + i] = gb < p.B && i < IN
                           ? p.xs[s * p.xs_s + gb * p.xs_b + i * p.xs_i]
                           : 0.0f;
    }
    for (int b = tid; b < R; b += THREADS) {
      const int gb = b0 + b;
      mt[b] = gb < p.B ? p.mask[s * p.m_s + gb * p.m_b] : 0.0f;
    }
  };
  // bit j: step t0 + j has an active row among rows b0.. (j < 64); the
  // same in every CTA of the cluster, since all read the same mask
  auto step_bits = [&](int t0, int b0, int reverse) {
    __syncthreads();  // every thread has read the last word
    if (tid == 0) *act_bits = 0ull;
    __syncthreads();
    const int n = S - t0 < 64 ? S - t0 : 64;
    unsigned long long mine = 0ull;
    for (int idx = tid; idx < n * R; idx += THREADS) {
      const int j = idx / R, b = idx - j * R;
      const int gb = b0 + b, s = reverse ? S - 1 - (t0 + j) : t0 + j;
      if (gb < p.B && p.mask[s * p.m_s + gb * p.m_b] > 0.0f) mine |= 1ull << j;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mine |= __shfl_xor_sync(0xffffffffu, mine, o);
    if (lane == 0 && mine) atomicOr(act_bits, mine);
    __syncthreads();
    return *act_bits;
  };

  // every CTA of the cluster runs before any writes into another's memory
  cluster.sync();
  for (int w = w_begin; w < w_end; ++w) {
    const int dir = w / p.ntiles, tile = w - dir * p.ntiles;
    const int reverse = p.ndirs == 2 ? dir : p.reverse;
    const int b0 = tile * R;
    if (dir != loaded) {
      // W_hh, W_ih and bias slices of this direction, zero past H and IN
      const float* whh = p.w_hh[dir];
      const float* wih = p.w_ih[dir];
      for (int idx = tid; idx < (Hp + KX) * N3; idx += THREADS) {
        const int k = idx / N3, c = idx - k * N3;
        const int q = (c % 24) >> 3, u = unit0 + (c / 24) * 8 + (c & 7);
        if (k < Hp) {
          const bool ok = k < H && u < H;
          cp_async4(ws_ + sw_at(c, k, Hp),
                    ok ? whh + (int64_t)k * 3 * H + q * H + u : whh, ok);
        } else {
          const int i = k - Hp;
          const bool ok = i < IN && u < H;
          cp_async4(wx_ + sw_at(c, i, KX),
                    ok ? wih + (int64_t)i * 3 * H + q * H + u : wih, ok);
        }
      }
      for (int c = tid; c < N3; c += THREADS) {
        const int q = (c % 24) >> 3, u = unit0 + (c / 24) * 8 + (c & 7);
        const bool ok = u < H;
        cp_async4(bi + c, ok ? p.b_ih[dir] + q * H + u : p.b_ih[dir], ok);
        cp_async4(bh + c, ok ? p.b_hh[dir] + q * H + u : p.b_hh[dir], ok);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      loaded = dir;
    }
    for (int idx = tid; idx < R * Hp; idx += THREADS) hbuf[idx] = 0.0f;
    // the carry of a tile with no active row does not move that step: the
    // whole cluster skips it, with no load and no barrier
    unsigned long long bits = S > 0 ? step_bits(0, b0, reverse) : 0ull;
    int loaded_t = -1;  // the step whose x tile and mask are in xt, mt
    if (bits) {
      loaded_t = __ffsll((long long)bits) - 1;
      load_step(reverse ? S - 1 - loaded_t : loaded_t, b0);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    // no CTA writes this tile's carry before every CTA has zeroed its own
    // and stored the last tile's
    cluster.sync();

    int cur = 0;
    for (int t = 0; t < S; ++t) {
      if (t > 0 && (t & 63) == 0) bits = step_bits(t, b0, reverse);
      if (!((bits >> (t & 63)) & 1ull)) continue;
      if (loaded_t != t) {
        load_step(reverse ? S - 1 - t : t, b0);
        loaded_t = t;
        __syncthreads();
      }
      const float* hc = hbuf + cur * R * Hp;
      float* hn = hbuf + (cur ^ 1) * R * Hp;
      if (has_item) {
        float acc[4][TERMS][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < TERMS; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0f;
        products<true>(xt, XS, wx_, KX, INp, m0, g, lane, acc);
        products<false>(hc, Hp, ws_, Hp, Hp, m0, g, lane, acc);
        // gates of rows m0 + grp (+8), units g*8 + tig*2 (+1)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + grp + (e >> 1) * 8;
          const int cr = g * 24 + tig * 2 + (e & 1);
          const int k = sw_at(r, unit0 + g * 8 + tig * 2 + (e & 1), Hp);
          const float rg =
              sigmoidf_((acc_sum(acc[T_R], e) + bi[cr]) + bh[cr]);
          const float zg =
              sigmoidf_((acc_sum(acc[T_Z], e) + bi[cr + 8]) + bh[cr + 8]);
          const float ng = tanhf_((acc_sum(acc[T_NX], e) + bi[cr + 16]) +
                                 rg * (acc_sum(acc[T_NH], e) + bh[cr + 16]));
          const float h = hc[k];
          hn[k] = mt[r] > 0.0f ? (1.0f - zg) * ng + zg * h : h;
        }
      }
      __syncthreads();
      // this CTA's new slice, U/4 16-byte chunks a row, into the other CTAs
      const int chunks = U / 4;
      for (int idx = tid; idx < R * chunks; idx += THREADS) {
        const int r = idx / chunks, j = idx - r * chunks;
        float* src = hn + sw_at(r, unit0 + 4 * j, Hp);
        const float4 v = *reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int q = 1; q < CLUSTER; ++q)
          *reinterpret_cast<float4*>(
              cluster.map_shared_rank(src, (rank + q) % CLUSTER)) = v;
      }
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      // the next active step of this 64-step window, fetched while the
      // other CTAs finish theirs
      const unsigned long long rest =
          (t & 63) == 63 ? 0ull : bits >> ((t & 63) + 1);
      if (rest) {
        loaded_t = t + __ffsll((long long)rest);
        load_step(reverse ? S - 1 - loaded_t : loaded_t, b0);
      }
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      // the barrier orders only what came before the arrive: the fetch
      // above needs its own
      if (rest) __syncthreads();
      cur ^= 1;
    }

    // this CTA's units of the final carry
    const float* hc = hbuf + cur * R * Hp;
    for (int idx = tid; idx < R * U; idx += THREADS) {
      const int r = idx / U, u = unit0 + (idx - r * U);
      const int gb = b0 + r;
      if (gb < p.B && u < H) {
        const float v = hc[sw_at(r, u, Hp)];
        float* o = p.out + (int64_t)gb * H + u;
        if (p.ndirs == 2)
          atomicAdd(o, v);
        else
          *o = v;
      }
    }
    __syncthreads();
  }
  // no CTA leaves while another may still write into its shared memory
  cluster.sync();
}

// The opt-in holds per device, so it is set on every call (it is cheap).
int set_smem_attr() {
  return (int)cudaFuncSetAttribute(masked_gru_cluster_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   MAX_SMEM);
}

cudaLaunchConfig_t launch_config(int clusters, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One thread writes the card's global nanosecond timer into buf[*t][col]
// of a [rows, 3] int64 buffer, where 0 <= *t < rows: a timestamp that a CUDA
// graph replays inside a captured step (utils/profiler.stamp).
__global__ void globaltimer_stamp_kernel(long long* buf, const long long* t,
                                         int col, int rows) {
  const long long i = *t;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (i >= 0 && i < rows) buf[i * 3 + col] = (long long)now;
}

}  // namespace

extern "C" {

// Launch the one-thread stamp on `stream` (asynchronous). Returns a
// cudaError_t (0 = success).
int globaltimer_stamp(long long* buf, const long long* t, int col, int rows,
                      void* stream) {
  if (col < 0 || col > 2 || rows < 1) return (int)cudaErrorInvalidValue;
  globaltimer_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(buf, t, col, rows);
  return (int)cudaGetLastError();
}

// The number of clusters of CLUSTER CTAs with `smem` bytes each, for tiles
// of `rows` rows, that the card holds at once, into *out. Returns a
// cudaError_t.
int masked_gru_max_active_clusters(int rows, int smem, int* out) {
  if (rows < 16 || rows > 48 || rows % 16) return (int)cudaErrorInvalidValue;
  int err = set_smem_attr();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, masked_gru_cluster_kernel,
                                             &cfg);
}

// Launch `clusters` clusters on `stream` (asynchronous). The caller checks
// shapes and computes the geometry; the launcher refuses what the kernel
// cannot take. Returns a cudaError_t (0 = success).
int masked_gru_forward(const GruParams* p, int clusters, int smem,
                       void* stream) {
  const int U = p->Hp / CLUSTER;
  if (p->H < 1 || p->Hp % (8 * CLUSTER) || p->Hp < p->H || p->IN < 1 ||
      p->S < 0 || p->B < 1 || p->rows < 16 || p->rows > 48 || p->rows % 16 ||
      (p->ndirs != 1 && p->ndirs != 2) || clusters < 1 || smem > MAX_SMEM ||
      (p->rows / 16) * (U / 8) > WARPS)
    return (int)cudaErrorInvalidValue;
  int err = set_smem_attr();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config(clusters, smem, (cudaStream_t)stream, attr);
  err = (int)cudaLaunchKernelEx(&cfg, masked_gru_cluster_kernel, *p);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
