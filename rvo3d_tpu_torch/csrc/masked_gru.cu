// Masked GRU scan: the final hidden state of a GRU in torch gate order
// (r, z, n) over S slots, where the carry advances only where mask > 0 and
// h0 = 0:
//   r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
//   z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
//   n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
//   h' = mask > 0 ? (1 - z) * n + z * h : h
//
// Replaces the Pallas TPU kernel rvo3d_tpu/ops/pallas_gru.py
// (_pallas_forward -> _kernel, pl.pallas_call at :106).
//
// Bound on the H100: per launch the work is 2*B*S*(IN+H)*3H FLOP in f32
// (at B=4096, S=10, IN=9, H=256: ~16.7 GFLOP, ~0.25 ms at 67 TFLOP/s)
// against ~6.6 MB of traffic (~2 us at 3.35 TB/s), so it is compute-bound.
//
// Design. The TPU kernel keeps both weight matrices in VMEM; W_hh at H=256
// is 768 KiB in f32, more than the 227 KB one block can hold, so here W_hh
// streams from L2 (where it stays resident: every block reads the same
// matrix) and the tile's carry lives in shared memory:
//   - one block per tile of TILE_B batch rows, one thread per hidden
//     column j (blockDim.x == H <= 256); thread j owns gate columns j, H+j, 2H+j
//     for all TILE_B rows, so each W_hh element it loads feeds TILE_B FMAs;
//   - h is stored transposed, hs[k][b], so the TILE_B values of column k
//     are read as float4 broadcasts; rows are padded by 4 floats to spread
//     the per-column writes over banks;
//   - x . W_ih (IN = 9) is computed in the block at each step from a
//     shared copy of the step's x tile, read through the caller's strides,
//     so the encoder's [B, nm, 9] neighbours need no [S, B, IN] copy, and
//     `reverse` walks the slots backwards instead of copying xs[::-1];
//   - f32 FMA throughout (no TF32), so the result matches the plain torch
//     scan to f32 rounding.
// wgmma, TMA and clusters are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_B = 32;
constexpr int HS_STRIDE = TILE_B + 4;  // padded row of the transposed carry
// One thread per hidden column, and 3 * TILE_B accumulators per thread: the
// register budget allows at most 256 threads a block.
constexpr int MAX_H = 256;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(MAX_H, 1)
masked_gru_fwd_kernel(const float* __restrict__ xs, int64_t xs_s,
                      int64_t xs_b, int64_t xs_i,
                      const float* __restrict__ mask, int64_t m_s,
                      int64_t m_b,
                      const float* __restrict__ w_ih,  // [IN, 3H]
                      const float* __restrict__ w_hh,  // [H, 3H]
                      const float* __restrict__ b_ih,  // [3H]
                      const float* __restrict__ b_hh,  // [3H]
                      float* __restrict__ out,         // [B, H]
                      int S, int B, int IN, int H, int reverse) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                       // [H][HS_STRIDE]
  float* xsh = hs + H * HS_STRIDE;        // [TILE_B][IN]
  float* msh = xsh + TILE_B * IN;         // [TILE_B]

  const int j = threadIdx.x;
  const int b0 = blockIdx.x * TILE_B;
  const int H3 = 3 * H;

#pragma unroll
  for (int b = 0; b < TILE_B; ++b) hs[j * HS_STRIDE + b] = 0.0f;

  const float bir = b_ih[j], biz = b_ih[H + j], bin = b_ih[2 * H + j];
  const float bhr = b_hh[j], bhz = b_hh[H + j], bhn = b_hh[2 * H + j];

  for (int t = 0; t < S; ++t) {
    const int s = reverse ? (S - 1 - t) : t;
    for (int idx = j; idx < TILE_B * IN; idx += blockDim.x) {
      const int b = idx / IN, i = idx - b * IN;
      const int gb = b0 + b;
      xsh[idx] = gb < B ? xs[s * xs_s + gb * xs_b + i * xs_i] : 0.0f;
    }
    for (int b = j; b < TILE_B; b += blockDim.x) {
      const int gb = b0 + b;
      msh[b] = gb < B ? mask[s * m_s + gb * m_b] : 0.0f;
    }
    __syncthreads();
    // the carry of a tile with no active row does not move this step
    int active = 0;
    for (int b = j; b < TILE_B; b += blockDim.x) active |= msh[b] > 0.0f;
    if (!__syncthreads_or(active)) continue;

    float ar[TILE_B], az[TILE_B], an[TILE_B];
#pragma unroll
    for (int b = 0; b < TILE_B; ++b) ar[b] = az[b] = an[b] = 0.0f;

#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      const float* wrow = w_hh + (int64_t)k * H3;
      const float w0 = __ldg(wrow + j);
      const float w1 = __ldg(wrow + H + j);
      const float w2 = __ldg(wrow + 2 * H + j);
      const float4* hk = reinterpret_cast<const float4*>(hs + k * HS_STRIDE);
#pragma unroll
      for (int q = 0; q < TILE_B / 4; ++q) {
        const float4 hv = hk[q];
        ar[4 * q + 0] = fmaf(hv.x, w0, ar[4 * q + 0]);
        ar[4 * q + 1] = fmaf(hv.y, w0, ar[4 * q + 1]);
        ar[4 * q + 2] = fmaf(hv.z, w0, ar[4 * q + 2]);
        ar[4 * q + 3] = fmaf(hv.w, w0, ar[4 * q + 3]);
        az[4 * q + 0] = fmaf(hv.x, w1, az[4 * q + 0]);
        az[4 * q + 1] = fmaf(hv.y, w1, az[4 * q + 1]);
        az[4 * q + 2] = fmaf(hv.z, w1, az[4 * q + 2]);
        az[4 * q + 3] = fmaf(hv.w, w1, az[4 * q + 3]);
        an[4 * q + 0] = fmaf(hv.x, w2, an[4 * q + 0]);
        an[4 * q + 1] = fmaf(hv.y, w2, an[4 * q + 1]);
        an[4 * q + 2] = fmaf(hv.z, w2, an[4 * q + 2]);
        an[4 * q + 3] = fmaf(hv.w, w2, an[4 * q + 3]);
      }
    }

    // input projection and gates; the new carry goes to ar[] until every
    // thread has finished reading the old one
#pragma unroll
    for (int b = 0; b < TILE_B; ++b) {
      float gr = 0.0f, gz = 0.0f, gn = 0.0f;
      for (int i = 0; i < IN; ++i) {
        const float x = xsh[b * IN + i];
        const float* wi = w_ih + (int64_t)i * H3;
        gr = fmaf(x, __ldg(wi + j), gr);
        gz = fmaf(x, __ldg(wi + H + j), gz);
        gn = fmaf(x, __ldg(wi + 2 * H + j), gn);
      }
      const float r = sigmoidf_((gr + bir) + (ar[b] + bhr));
      const float z = sigmoidf_((gz + biz) + (az[b] + bhz));
      const float n = tanhf((gn + bin) + r * (an[b] + bhn));
      const float h = hs[j * HS_STRIDE + b];
      const float hn = (1.0f - z) * n + z * h;
      ar[b] = msh[b] > 0.0f ? hn : h;
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < TILE_B; ++b) hs[j * HS_STRIDE + b] = ar[b];
    __syncthreads();
  }

#pragma unroll
  for (int b = 0; b < TILE_B; ++b) {
    const int gb = b0 + b;
    if (gb < B) out[(int64_t)gb * H + j] = hs[j * HS_STRIDE + b];
  }
}

}  // namespace

extern "C" {

// Strides are in elements. Returns a cudaError_t (0 = success); the
// launch is asynchronous on `stream`.
int masked_gru_forward(const void* xs, int64_t xs_s, int64_t xs_b,
                       int64_t xs_i, const void* mask, int64_t m_s,
                       int64_t m_b, const void* w_ih, const void* w_hh,
                       const void* b_ih, const void* b_hh, void* out, int S,
                       int B, int IN, int H, int reverse, void* stream) {
  if (H < 1 || H > MAX_H || IN < 1 || S < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  // at most 38 KB at H = 256, IN = 9: under the 48 KB needing no opt-in
  const size_t smem =
      sizeof(float) * ((size_t)H * HS_STRIDE + TILE_B * IN + TILE_B);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + TILE_B - 1) / TILE_B);
  const dim3 block(H);
  masked_gru_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)xs, xs_s, xs_b, xs_i, (const float*)mask, m_s, m_b,
      (const float*)w_ih, (const float*)w_hh, (const float*)b_ih,
      (const float*)b_hh, (float*)out, S, B, IN, H, reverse);
  return (int)cudaGetLastError();
}

}  // extern "C"
