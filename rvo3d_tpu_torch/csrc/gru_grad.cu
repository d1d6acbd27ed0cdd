// The backward of the masked GRU scan (csrc/masked_gru.cu's function): the
// gradients of the final hidden state's loss with respect to W_ih, W_hh,
// b_ih and b_hh of one direction or of both directions of a biGRU, and,
// when asked, with respect to xs. The semantics are those of autograd
// through ops/masked_gru.py's masked_gru_scan_plain: gate order r, z, n;
// the carry moves only where mask > 0, so the gradient flows through an
// inactive slot unchanged; h0 = 0 takes no gradient. A biGRU's two final
// states are summed, so both directions get the same output gradient.
//
// Replaces no TPU kernel: the JAX package's custom_vjp
// (rvo3d_tpu/ops/pallas_gru.py:126-148) differentiates the plain scan under
// XLA, and the port did the same under autograd: a dense recompute over all
// S slots and every row, ~90 % of a PPO epoch. It was added because the
// training rows hold almost no neighbours: with one active slot a row the
// carry before it is h0 = 0, so that step has no h . W_hh product, forward
// or backward, and adds nothing to dW_hh.
//
// Bound on the H100: at the PPO update's masks (B = 16384, S = 10, IN = 9,
// H = 256, one active slot a row, no xs gradient) the work is the input
// gates and dW_ih at each row's slot, ~0.9 GFLOP, 14 us at the 67 TFLOP/s
// float32 peak, against ~27 MB of xs, mask, grad_out and weights, 8 us at
// 3.35 TB/s: operations bound it, and what the kernel takes beyond that is
// its per-tile reads and barriers and its three launches. At dense masks
// the h . W_hh products bound it: three [ROWS, H] x [H, 3H] products at each
// step after a row's first, at the float32 FMA peak.
//
// Design. Three kernels on the caller's stream, one launcher call:
//   1. gru_grad_transpose_kernel writes W_hh^T [3H, H] of each direction,
//      so the backward product reads it along the thread axis.
//   2. gru_grad_walk_kernel: a persistent grid (the blocks the card holds
//      at once) over tiles of ROWS rows; block b takes a contiguous share
//      of the tiles, one direction after the other. Thread j owns hidden
//      unit j of every row of the tile. Work follows the mask: the block
//      reads the tile's mask and walks only the steps where some row is
//      active; a row's h . W_hh products, forward and backward, run only at
//      steps after its first active one ("continuing" rows; a row starting
//      there has h = 0). A tile whose rows all have at most one active
//      slot skips the forward walk and touches no W_hh: the backward walk
//      recomputes each active step's gates from x and the biases.
//      Carries: the forward walk writes the carry h and the hidden
//      pre-activations gh (4H values) of each continuing (step, row) to a
//      scratch buffer of the block, and nothing at other steps. Shared
//      memory cannot hold them (S x ROWS x 4H floats is 1.3 MB at S = 10,
//      H = 256), and storing gh spares the backward walk a fourth product.
//      Sums: dW_ih, db_ih and db_hh of the block are summed in registers of
//      the thread that owns their columns and added into the block's
//      partial before each product and at the direction's end, so no
//      register holds them across a product. dW_hh is accumulated at each
//      continuing step into the block's own partial in device memory
//      (stored at the first, added later), and a flag says whether the
//      block wrote it.
//   3. gru_grad_sum_kernel sums the blocks' partials in block order (the
//      dW_hh partials of flagged blocks only) and, for a biGRU, the two
//      directions' xs gradients. No float atomics: a repeated call gives
//      the same bits.
// Everything is float32 with FMAs (plain TF32 is not accurate enough for
// the training cell's check). The caller (ops/gru_grad.py) computes the
// geometry and allocates every output and scratch buffer, so a CUDA graph
// can capture the call.

#include <cuda_runtime.h>
#include <stdint.h>

// Outside the anonymous namespace: the extern "C" launcher takes it.
struct GruGradParams {
  const float* xs;        // [S, B, IN], element strides xs_s, xs_b, xs_i
  const float* mask;      // [S, B], element strides m_s, m_b
  const float* grad_out;  // [B, H], contiguous
  const float* w_ih[2];   // [IN, 3H] per direction
  const float* w_hh[2];   // [H, 3H]
  const float* b_ih[2];   // [3H]
  const float* b_hh[2];   // [3H]
  float* w_hh_t;          // scratch [ndirs, 3H, H]
  float* carry;           // scratch [blocks, S, ROWS, 4, Hs]
  float* part;            // scratch [blocks, ndirs, IN + 2 + H, 3H]
  int* part_hh_set;       // scratch [blocks, ndirs]
  float* dx_part;         // [ndirs, S, B, IN] (d_xs itself for one direction), or null
  float* d_out;           // [ndirs, IN + 2 + H, 3H]: dW_ih, db_ih, db_hh, dW_hh
  float* d_xs;            // [S, B, IN], or null
  int64_t xs_s, xs_b, xs_i, m_s, m_b;
  int S, B, IN, H;
  int Hs;       // H rounded up to a multiple of 4 (row stride in shared memory)
  int ndirs;    // 1, or 2 for a biGRU (direction 1 walks in reverse)
  int reverse;  // the direction of a one-direction call
  int ntiles;   // ceil(B / ROWS)
  int blocks;   // blocks of the walk kernel, <= ntiles
};

namespace {

constexpr int THREADS = 256;  // thread j owns hidden unit j: H <= THREADS
constexpr int ROWS = 32;      // rows a tile: one bit each in a step's row masks
constexpr int RC = 16;        // rows a forward-product pass holds
constexpr int KC = 16;        // dW_hh rows a weight-gradient pass holds
constexpr int CG_UNITS = 64;  // carry gradient: threads along the units (4 each)
constexpr int CG_ROWS = ROWS * CG_UNITS / THREADS;  // and rows each (8)
constexpr int MAX_SLOTS = 64;
constexpr int MAX_BLOCKS = 1024;  // walk blocks: the card's resident blocks
constexpr int MAX_SMEM = 232448;

// Gates from the fast exponential, as the forward kernel computes them:
// absolute error ~1e-7, far inside the gradients' tolerance.
__device__ __forceinline__ float sigmoid_(float x) {
  return __frcp_rn(1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_(float x) {
  return 2.0f * sigmoid_(2.0f * x) - 1.0f;
}

__device__ __forceinline__ int slot_of(int t, int S, bool rev) {
  return rev ? S - 1 - t : t;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][g] = sum_k hs[r0 + r][k] * W_hh[k][g*H + j] over k < H: the
// hidden products of unit j's three gates for RC rows. The next four rows
// of W_hh are loaded while the current four are used.
__device__ __forceinline__ void hidden_products(const float* __restrict__ hs,
                                                int r0, int Hs,
                                                const float* __restrict__ w,
                                                int H, int j,
                                                float (&acc)[RC][3]) {
  const int G3 = 3 * H, H4 = H & ~3;
#pragma unroll
  for (int r = 0; r < RC; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
  auto load = [&](int k, float (&wk)[4][3]) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        wk[q][g] = k < H4 ? __ldg(w + (size_t)(k + q) * G3 + g * H + j) : 0.0f;
  };
  float wk[4][3];
  load(0, wk);
#pragma unroll 1
  for (int k = 0; k < H4; k += 4) {
    float wn[4][3];
    load(k + 4, wn);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float4 h4 = ld4(hs + (r0 + r) * Hs + k);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float a = acc[r][g];
        a = fmaf(h4.x, wk[0][g], a);
        a = fmaf(h4.y, wk[1][g], a);
        a = fmaf(h4.z, wk[2][g], a);
        a = fmaf(h4.w, wk[3][g], a);
        acc[r][g] = a;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int g = 0; g < 3; ++g) wk[q][g] = wn[q][g];
  }
#pragma unroll 1
  for (int k = H4; k < H; ++k) {
    float w1[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) w1[g] = __ldg(w + (size_t)k * G3 + g * H + j);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const float h = hs[(r0 + r) * Hs + k];
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[r][g] = fmaf(h, w1[g], acc[r][g]);
    }
  }
}

// dhs[r][u] += sum_c gbuf[r][c] * W_hh[u][c] over the 3H gate columns c
// (wt is W_hh^T [3H][H]): the carry's gradient through the hidden
// products. Thread t sums the 8 x 4 tile of rows 8 (t / 64) .. + 7 and units
// 4 (t % 64) .. + 3 in registers, so a row's four gate gradients read from
// shared memory serve four units and a W_hh^T load serves eight rows. The
// next four rows of W_hh^T are loaded while the current four are used.
__device__ __forceinline__ void carry_grads(const float* __restrict__ gbuf,
                                            int Hs,
                                            const float* __restrict__ wt,
                                            int H, int tid, float* dhs) {
  const int u0 = 4 * (tid % CG_UNITS), r0 = CG_ROWS * (tid / CG_UNITS);
  if (u0 >= H) return;
  const int H4 = H & ~3;
  const bool whole = (H & 3) == 0;  // rows of W_hh^T are float4-aligned
  // four units of row c of W_hh^T, zero past H
  auto load_w = [&](int c, float (&w)[4]) {
    const float* src = wt + (size_t)c * H + u0;
    if (whole) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = u0 + q < H ? __ldg(src + q) : 0.0f;
    }
  };
  float acc[CG_ROWS][4];
#pragma unroll
  for (int r = 0; r < CG_ROWS; ++r) {
    const float4 v = ld4(dhs + (r0 + r) * Hs + u0);
    acc[r][0] = v.x, acc[r][1] = v.y, acc[r][2] = v.z, acc[r][3] = v.w;
  }
#pragma unroll 1
  for (int g = 0; g < 3; ++g) {
    const float* gg = gbuf + g * Hs;
    float wk[4][4];
    if (H4 > 0)
#pragma unroll
      for (int q = 0; q < 4; ++q) load_w(g * H + q, wk[q]);
#pragma unroll 1
    for (int k = 0; k < H4; k += 4) {
      float wn[4][4];
      const int kn = k + 4 < H4 ? k + 4 : k;
#pragma unroll
      for (int q = 0; q < 4; ++q) load_w(g * H + kn + q, wn[q]);
#pragma unroll
      for (int r = 0; r < CG_ROWS; ++r) {
        const float4 d4 = ld4(gg + (r0 + r) * 3 * Hs + k);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(dv[q], wk[q][u], acc[r][u]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) wk[q][u] = wn[q][u];
    }
#pragma unroll 1
    for (int k = H4; k < H; ++k) {
      float w1[4];
      load_w(g * H + k, w1);
#pragma unroll
      for (int r = 0; r < CG_ROWS; ++r) {
        const float dv = gg[(r0 + r) * 3 * Hs + k];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(dv, w1[u], acc[r][u]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < CG_ROWS; ++r)
    *reinterpret_cast<float4*>(dhs + (r0 + r) * Hs + u0) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// The block's dW_hh partial (rows [H][3H] at `part`) += or = the step's
// sum over continuing rows r (bits of `rows`) of hs[r][k] * gbuf[r][g][j],
// for unit j's three gate columns and every k.
__device__ __forceinline__ void weight_grads(const float* __restrict__ hs,
                                             const float* __restrict__ gbuf,
                                             int Hs, unsigned rows, int H,
                                             int j, float* part, bool add) {
  const int G3 = 3 * H;
#pragma unroll 1
  for (int k0 = 0; k0 < H; k0 += KC) {
    float acc[KC][3];
#pragma unroll
    for (int q = 0; q < KC; ++q)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        acc[q][g] = add && k0 + q < H ? part[(size_t)(k0 + q) * G3 + g * H + j] : 0.0f;
    if (k0 + KC <= H) {
#pragma unroll 2
      for (int r = 0; r < ROWS; ++r) {
        if (!((rows >> r) & 1u)) continue;
        const float* gr = gbuf + r * 3 * Hs + j;
        const float dg0 = gr[0], dg1 = gr[Hs], dg2 = gr[2 * Hs];
#pragma unroll
        for (int q4 = 0; q4 < KC; q4 += 4) {
          const float4 h4 = ld4(hs + r * Hs + k0 + q4);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[q4 + e][0] = fmaf(hv[e], dg0, acc[q4 + e][0]);
            acc[q4 + e][1] = fmaf(hv[e], dg1, acc[q4 + e][1]);
            acc[q4 + e][2] = fmaf(hv[e], dg2, acc[q4 + e][2]);
          }
        }
      }
    } else {  // the last KC rows of an H that is no multiple of KC
#pragma unroll 1
      for (int r = 0; r < ROWS; ++r) {
        if (!((rows >> r) & 1u)) continue;
        const float* gr = gbuf + r * 3 * Hs + j;
        const float dg0 = gr[0], dg1 = gr[Hs], dg2 = gr[2 * Hs];
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          const float h = k0 + q < H ? hs[r * Hs + k0 + q] : 0.0f;
          acc[q][0] = fmaf(h, dg0, acc[q][0]);
          acc[q][1] = fmaf(h, dg1, acc[q][1]);
          acc[q][2] = fmaf(h, dg2, acc[q][2]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < KC; ++q)
      if (k0 + q < H)
#pragma unroll
        for (int g = 0; g < 3; ++g) part[(size_t)(k0 + q) * G3 + g * H + j] = acc[q][g];
  }
}

// A load the compiler keeps where it is written: the row phases reload
// their weights after each product, so no register holds them across one.
__device__ __forceinline__ float ld_here(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <int INP>
__global__ void __launch_bounds__(THREADS, 1)
gru_grad_walk_kernel(const GruGradParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, j = tid;
  const int S = p.S, B = p.B, IN = p.IN, H = p.H, Hs = p.Hs, G3 = 3 * H;
  const bool unit = j < H;
  const bool want_dx = p.dx_part != nullptr;

  float* hs = smem;                    // [ROWS][Hs] carry, then h_prev
  float* gbuf = hs + ROWS * Hs;        // [ROWS][3][Hs] gate gradients; the
                                       // forward walk's second carry buffer
  float* rbuf = gbuf + 3 * ROWS * Hs;  // [ROWS][Hs] r gate (xs gradient only)
  float* dhs = rbuf + ROWS * Hs;       // [ROWS][Hs] the carry's gradient
  float* xt = dhs + ROWS * Hs;         // [ROWS][INP] the step's x, zero-padded
  // per walk step: the tile's active rows, and those continuing (active
  // after an earlier active step)
  unsigned* amask = reinterpret_cast<unsigned*>(xt + ROWS * INP);
  unsigned* cmask = amask + MAX_SLOTS;

  const int blk = blockIdx.x;
  const int t_lo = (int)((int64_t)blk * p.ntiles / p.blocks);
  const int t_hi = (int)((int64_t)(blk + 1) * p.ntiles / p.blocks);
  float* carry = p.carry + (size_t)blk * S * ROWS * 4 * Hs;
  const int nrow = IN + 2 + H;

  for (int d = 0; d < p.ndirs; ++d) {
    const bool rev = p.ndirs == 2 ? d == 1 : p.reverse != 0;
    const float* w_ih = p.w_ih[d];
    const float* w_hh = p.w_hh[d];
    const float* wt = p.w_hh_t + (size_t)d * G3 * H;
    float* part = p.part + ((size_t)blk * p.ndirs + d) * nrow * G3;
    float* dxp = want_dx ? p.dx_part + (size_t)d * S * B * IN : nullptr;

    // unit j's columns of W_ih, loaded by each row phase; its sums of dW_ih,
    // db_ih and db_hh, added into the block's partial before each product
    // and at the direction's end
    float wi[3][INP], dwi[3][INP], bih[3], bhh[3], dbih[3], dbhh[3];
    auto load_wi = [&]() {
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int i = 0; i < INP; ++i)
          wi[g][i] = i < IN ? ld_here(w_ih + i * G3 + g * H + j) : 0.0f;
    };
    auto flush = [&]() {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int i = 0; i < INP; ++i) {
          if (i < IN) part[(size_t)i * G3 + g * H + j] += dwi[g][i];
          dwi[g][i] = 0.0f;
        }
        part[(size_t)IN * G3 + g * H + j] += dbih[g];
        part[(size_t)(IN + 1) * G3 + g * H + j] += dbhh[g];
        dbih[g] = dbhh[g] = 0.0f;
      }
    };
    if (unit) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        bih[g] = p.b_ih[d][g * H + j];
        bhh[g] = p.b_hh[d][g * H + j];
        dbih[g] = dbhh[g] = 0.0f;
#pragma unroll
        for (int i = 0; i < INP; ++i) dwi[g][i] = 0.0f;
        for (int i = 0; i < IN + 2; ++i) part[(size_t)i * G3 + g * H + j] = 0.0f;
      }
    }
    bool hh_set = false;  // the block's dW_hh partial holds this direction's sum

    for (int tile = t_lo; tile < t_hi; ++tile) {
      const int b0 = tile * ROWS;
      __syncthreads();  // the previous tile is done with the shared buffers
      if (unit)  // the output's gradient, the carry's at the last step
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          dhs[r * Hs + j] = b0 + r < B ? p.grad_out[(int64_t)(b0 + r) * H + j] : 0.0f;
      for (int t = tid >> 5; t < S; t += THREADS / 32) {  // a warp a step
        const int r = tid & 31;
        const bool on = b0 + r < B &&
            p.mask[slot_of(t, S, rev) * p.m_s + (int64_t)(b0 + r) * p.m_b] > 0.0f;
        const unsigned a = __ballot_sync(0xffffffffu, on);
        if (r == 0) amask[t] = a;
      }
      if (want_dx)
        for (int e = tid; e < S * ROWS * IN; e += THREADS) {
          const int s = e / (ROWS * IN), r = (e / IN) % ROWS, i = e % IN;
          if (b0 + r < B) dxp[((size_t)s * B + b0 + r) * IN + i] = 0.0f;
        }
      __syncthreads();
      if (tid < S) {
        unsigned before = 0;
        for (int t = 0; t < tid; ++t) before |= amask[t];
        cmask[tid] = amask[tid] & before;
      }
      __syncthreads();
      uint64_t act = 0, cont = 0;
      for (int t = 0; t < S; ++t) {
        act |= (uint64_t)(amask[t] != 0) << t;
        cont |= (uint64_t)(cmask[t] != 0) << t;
      }
      if (!act) continue;

      // x of walk step t for the tile's rows, zero past B and IN
      auto load_x = [&](int t) {
        const int s = slot_of(t, S, rev);
        __syncthreads();
        for (int e = tid; e < ROWS * INP; e += THREADS) {
          const int r = e / INP, i = e % INP;
          xt[e] = b0 + r < B && i < IN
                      ? p.xs[s * p.xs_s + (int64_t)(b0 + r) * p.xs_b + i * p.xs_i]
                      : 0.0f;
        }
        __syncthreads();
      };
      auto input_gates = [&](int r, float (&gi)[3]) {
#pragma unroll
        for (int g = 0; g < 3; ++g) gi[g] = bih[g];
#pragma unroll
        for (int i4 = 0; i4 < INP; i4 += 4) {
          const float4 x4 = ld4(xt + r * INP + i4);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int g = 0; g < 3; ++g) gi[g] = fmaf(xv[e], wi[g][i4 + e], gi[g]);
        }
      };

      // forward walk: the carries and hidden pre-activations of the
      // continuing (step, row) pairs, up to the last continuing step; the
      // carry alternates between hs and gbuf, so one barrier a step
      if (cont) {
        const int last = 63 - __clzll((long long)cont);
        float* cur = hs;
        float* nxt = gbuf;
        if (unit) flush();
        for (int e = tid; e < ROWS * Hs; e += THREADS) cur[e] = 0.0f;
        for (int t = 0; t <= last; ++t) {
          if (!((act >> t) & 1)) continue;
          load_x(t);
          const unsigned am = amask[t], cm = cmask[t];
          if (unit) {
#pragma unroll 1
            for (int c = 0; c < ROWS / RC; ++c) {
              float acc[RC][3];
              if ((cm >> (c * RC)) & ((1u << RC) - 1u))
                hidden_products(cur, c * RC, Hs, w_hh, H, j, acc);
              else
#pragma unroll
                for (int r = 0; r < RC; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
              load_wi();
#pragma unroll
              for (int rr = 0; rr < RC; ++rr) {
                const int r = c * RC + rr;
                const float h = cur[r * Hs + j];
                float hn = h;
                if ((am >> r) & 1u) {
                  float gi[3];
                  input_gates(r, gi);
                  const float gh0 = acc[rr][0] + bhh[0], gh1 = acc[rr][1] + bhh[1],
                              gh2 = acc[rr][2] + bhh[2];
                  const float rg = sigmoid_(gi[0] + gh0), zg = sigmoid_(gi[1] + gh1);
                  const float ng = tanh_(gi[2] + rg * gh2);
                  hn = (1.0f - zg) * ng + zg * h;
                  if ((cm >> r) & 1u) {
                    float* cv = carry + ((size_t)t * ROWS + r) * 4 * Hs + j;
                    cv[0] = h;
                    cv[Hs] = gh0;
                    cv[2 * Hs] = gh1;
                    cv[3 * Hs] = gh2;
                  }
                }
                nxt[r * Hs + j] = hn;
              }
            }
          }
          float* tmp = cur;
          cur = nxt;
          nxt = tmp;
        }
      }

      // backward walk over the active steps, last to first
      for (int t = 63 - __clzll((long long)act); t >= 0; --t) {
        if (!((act >> t) & 1)) continue;
        load_x(t);
        const unsigned am = amask[t], cm = cmask[t];
        const bool prod = cm != 0;
        const bool stage = prod || want_dx;
        if (unit) {
          load_wi();
#pragma unroll 2
          for (int r = 0; r < ROWS; ++r) {
            float* hr = hs + r * Hs + j;
            float* gr = gbuf + r * 3 * Hs + j;
            if (!((am >> r) & 1u)) {
              if (stage) {
                *hr = 0.0f;
                gr[0] = gr[Hs] = gr[2 * Hs] = 0.0f;
                if (want_dx) rbuf[r * Hs + j] = 0.0f;
              }
              continue;
            }
            float hp = 0.0f, gh0 = bhh[0], gh1 = bhh[1], gh2 = bhh[2];
            if ((cm >> r) & 1u) {
              const float* cv = carry + ((size_t)t * ROWS + r) * 4 * Hs + j;
              hp = cv[0];
              gh0 = cv[Hs];
              gh1 = cv[2 * Hs];
              gh2 = cv[3 * Hs];
            }
            float gi[3];
            input_gates(r, gi);
            const float rg = sigmoid_(gi[0] + gh0), zg = sigmoid_(gi[1] + gh1);
            const float ng = tanh_(gi[2] + rg * gh2);
            const float g_out = dhs[r * Hs + j];
            const float dpn = g_out * (1.0f - zg) * (1.0f - ng * ng);
            const float dpz = g_out * (hp - ng) * zg * (1.0f - zg);
            const float dpr = dpn * gh2 * rg * (1.0f - rg);
            const float dghn = dpn * rg;
            dhs[r * Hs + j] = g_out * zg;
            dbih[0] += dpr;
            dbih[1] += dpz;
            dbih[2] += dpn;
            dbhh[0] += dpr;
            dbhh[1] += dpz;
            dbhh[2] += dghn;
#pragma unroll
            for (int i4 = 0; i4 < INP; i4 += 4) {
              const float4 x4 = ld4(xt + r * INP + i4);
              const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                dwi[0][i4 + e] = fmaf(xv[e], dpr, dwi[0][i4 + e]);
                dwi[1][i4 + e] = fmaf(xv[e], dpz, dwi[1][i4 + e]);
                dwi[2][i4 + e] = fmaf(xv[e], dpn, dwi[2][i4 + e]);
              }
            }
            if (stage) {
              *hr = hp;
              gr[0] = dpr;
              gr[Hs] = dpz;
              gr[2 * Hs] = want_dx ? dpn : dghn;
              if (want_dx) rbuf[r * Hs + j] = rg;
            }
          }
        }
        if (stage) __syncthreads();
        if (want_dx) {
          // xs gradient: sum over the gate columns of dgi . W_ih^T
          const int s = slot_of(t, S, rev);
          for (int e = tid; e < ROWS * IN; e += THREADS) {
            const int r = e / IN, i = e % IN;
            if (!((am >> r) & 1u)) continue;
            float sum = 0.0f;
            for (int g = 0; g < 3; ++g)
              for (int k = 0; k < H; ++k)
                sum = fmaf(gbuf[(r * 3 + g) * Hs + k],
                           __ldg(w_ih + i * G3 + g * H + k), sum);
            dxp[((size_t)s * B + b0 + r) * IN + i] = sum;
          }
          __syncthreads();
          if (unit)  // dgi of the n gate -> dgh: times r
            for (int r = 0; r < ROWS; ++r) gbuf[(r * 3 + 2) * Hs + j] *= rbuf[r * Hs + j];
          __syncthreads();
        }
        if (prod) {
          if (unit) {
            flush();
            weight_grads(hs, gbuf, Hs, cm, H, j, part + (size_t)(IN + 2) * G3, hh_set);
          }
          carry_grads(gbuf, Hs, wt, H, tid, dhs);
        }
        hh_set = hh_set || prod;
      }
    }

    if (unit) flush();
    if (tid == 0) p.part_hh_set[blk * p.ndirs + d] = hh_set;
  }
}

// W_hh^T [3H][H] of each direction.
__global__ void gru_grad_transpose_kernel(const GruGradParams p) {
  const int H = p.H, G3 = 3 * H;
  const int64_t n = (int64_t)p.ndirs * G3 * H;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int d = (int)(e / ((int64_t)G3 * H));
    const int c = (int)((e / H) % G3), k = (int)(e % H);
    p.w_hh_t[e] = p.w_hh[d][(size_t)k * G3 + c];
  }
}

// The blocks' partials summed in block order (the dW_hh rows over the
// flagged blocks, which each block lists first); the xs gradients of two
// directions added.
__global__ void gru_grad_sum_kernel(const GruGradParams p) {
  __shared__ int flagged[2][MAX_BLOCKS];
  __shared__ int nflagged[2];
  const int G3 = 3 * p.H, nrow = p.IN + 2 + p.H;
  if (threadIdx.x < p.ndirs) {
    const int d = threadIdx.x;
    int n = 0;
    for (int b = 0; b < p.blocks; ++b)
      if (p.part_hh_set[b * p.ndirs + d]) flagged[d][n++] = b;
    nflagged[d] = n;
  }
  __syncthreads();
  const int64_t per_block = (int64_t)p.ndirs * nrow * G3;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < per_block;
       e += step) {
    const int d = (int)(e / ((int64_t)nrow * G3));
    float sum = 0.0f;
    if ((e / G3) % nrow < p.IN + 2) {
      for (int b = 0; b < p.blocks; ++b) sum += p.part[b * per_block + e];
    } else {
      for (int i = 0; i < nflagged[d]; ++i) sum += p.part[flagged[d][i] * per_block + e];
    }
    p.d_out[e] = sum;
  }
  if (p.d_xs != nullptr && p.ndirs == 2) {
    const int64_t n = (int64_t)p.S * p.B * p.IN;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += step)
      p.d_xs[e] = p.dx_part[e] + p.dx_part[n + e];
  }
}

template <int INP>
int walk_smem_attr() {
  return (int)cudaFuncSetAttribute(gru_grad_walk_kernel<INP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   MAX_SMEM);
}

template <int INP>
int max_blocks(int smem, int* out) {
  int err = walk_smem_attr<INP>();
  if (err) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gru_grad_walk_kernel<INP>, THREADS, (size_t)smem);
  if (err) return err;
  err = (int)cudaGetDevice(&dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  *out = per_sm * sms;
  return 0;
}

template <int INP>
int launch_walk(const GruGradParams& p, int smem, cudaStream_t stream) {
  int err = walk_smem_attr<INP>();
  if (err) return err;
  gru_grad_walk_kernel<INP><<<p.blocks, THREADS, (size_t)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int grid_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < 1 ? 1 : b > 4096 ? 4096 : b);
}

}  // namespace

extern "C" {

// The blocks of the walk kernel for x rows of `in_pad` floats and `smem`
// bytes of shared memory that the card holds at once, into *out. Returns a
// cudaError_t.
int gru_grad_max_blocks(int in_pad, int smem, int* out) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  switch (in_pad) {
    case 12: return max_blocks<12>(smem, out);
    case 16: return max_blocks<16>(smem, out);
  }
  return (int)cudaErrorInvalidValue;
}

// Launch the transpose, the walk and the sum on `stream` (asynchronous).
// The caller checks shapes, computes the geometry and allocates every
// buffer; the launcher refuses what the kernels cannot take. Returns a
// cudaError_t (0 = success).
int gru_grad_launch(const GruGradParams* p, int in_pad, int smem, void* stream) {
  if (p->H < 1 || p->H > THREADS || p->Hs < p->H || p->Hs % 4 || p->IN < 1 ||
      p->IN > in_pad || p->S < 0 || p->S > MAX_SLOTS || p->B < 1 ||
      (p->ndirs != 1 && p->ndirs != 2) || p->ntiles != (p->B + ROWS - 1) / ROWS ||
      p->blocks < 1 || p->blocks > p->ntiles || p->blocks > MAX_BLOCKS ||
      smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nt = (int64_t)p->ndirs * 3 * p->H * p->H;
  gru_grad_transpose_kernel<<<grid_for(nt), THREADS, 0, s>>>(*p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  switch (in_pad) {
    case 12: err = launch_walk<12>(*p, smem, s); break;
    case 16: err = launch_walk<16>(*p, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const int64_t nsum = (int64_t)p->ndirs * (p->IN + 2 + p->H) * 3 * p->H;
  gru_grad_sum_kernel<<<grid_for(nsum), THREADS, 0, s>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
