// The few CUDA names csrc/env_drones.cu and csrc/ieee.cuh use, for g++ on
// the host (tests/test_torch_env_drones.py): the round-to-nearest intrinsics
// are the host's IEEE operations (built with -ffp-contract=off, so nothing
// is fused), and a launch runs every thread of every block in turn.
#pragma once
#include <math.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

struct HostIndex { long long x; };
extern HostIndex threadIdx, blockIdx;

struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
using std::max;
using std::min;

// kernel<<<blocks, threads, 0, stream>>>(args) becomes host_launch(blocks, threads, ...)
template <typename F>
void host_launch(int blocks, int threads, F f) {
  for (blockIdx.x = 0; blockIdx.x < blocks; ++blockIdx.x)
    for (threadIdx.x = 0; threadIdx.x < threads; ++threadIdx.x) f();
}
