// Int8 KV-arena append for Hopper (sm_90a): the port's counterpart of the
// JAX package's `_quantize_scatter` (paddle_tpu/serving/block_pool.py:185),
// which XLA fuses into the compiled serve step; it is not a Pallas kernel.
// The plain PyTorch version, the CPU path and this kernel's oracle, is
// `_quantize_scatter` in paddle_tpu_torch/serving/block_pool.py.
//
// What it computes, in place on one layer of the arena and its scales:
// every block a step writes is listed once in its row's `touched` list
// [B, T] (slot 0 = the null block) and `touch_idx` [B, S] maps each new
// token to its row's slot. For each (row, slot, head) block:
//   amax    = max |new| over the slot's tokens (f32, from f32 or bf16),
//   old_eff = 0 if any of them has offset 0 (a fresh block), else the
//             stored scale,
//   new_sc  = max(max(old_eff, amax / 127), 1e-8),
//   ratio   = old_eff / new_sc,
// the block's payload is requantized to round(q * ratio), the scale is
// set to new_sc, and the slot's tokens are written as round(x / new_sc),
// rounding half to even and clipping to [-127, 127]. IEEE division (no
// fast-math; _build.NVCC_FLAGS has none) and the same order of operations
// as the JAX function keep the result bit-equal to it.
//
// Design: one CTA per (row, touched slot, head); K and V are two launches.
// A CTA scans its row's S tokens for its slot (offset -> token table in
// shared memory), reduces the per-head amax over those tokens, forms the
// scale on one thread, then writes each (offset, column) of the block
// once: a new token's quantized value where one lands, the requantized old
// payload elsewhere. Blocks are disjoint across rows (prefix sharing
// copies on write before the step; spec rollback restarts at a block
// head), so no two CTAs write one live block. The null block is scratch:
// the padded tokens and padded `touched` entries that name it are skipped,
// and the kernel never writes it.
//
// Bound: bytes. It reads the step's new tokens and each touched block's
// payload and scale once, and writes the payload and scale back: at the
// serving shape (B 8, H 16, D 128, bs 16) tens of kilobytes a launch,
// microseconds at 3.35 TB/s, so launch latency dominates. A simple kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlockSize = 128;

struct Args {
  const void* src;            // new tokens [B, S, H, D], unit stride on D
  int64_t s_sb, s_ss, s_sh;   // their strides, in elements
  int8_t* arena;              // this layer's payload [H, N, bs, D]
  int64_t a_sh, a_sn;         // its head and block strides (bs * D inner)
  float* scales;              // this layer's scales [H, N] (block stride 1)
  int64_t c_sh;
  const int32_t* offs;        // [B, S] offset of each token in its block
  const int32_t* touched;     // [B, T]
  const int32_t* touch_idx;   // [B, S]
  int S, D, bs, T, N;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// torch.maximum / jnp.maximum: a NaN operand wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// torch.round (half to even), then clamp to [-127, 127], then int8
__device__ __forceinline__ int8_t quantize(float x) {
  return (int8_t)__float2int_rn(fminf(fmaxf(rintf(x), -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    kv_quantize_scatter_kernel(Args a) {
  __shared__ int tok_at[kMaxBlockSize];   // offset -> token, -1 = none
  __shared__ float warp_max[kThreads / 32];
  __shared__ int fresh;
  __shared__ float scale, ratio;
  const int b = blockIdx.x / a.T, slot = blockIdx.x % a.T, h = blockIdx.y;
  const int blk = a.touched[(int64_t)b * a.T + slot];
  if (blk <= 0 || blk >= a.N) return;     // the null block is scratch
  for (int o = threadIdx.x; o < a.bs; o += kThreads) tok_at[o] = -1;
  if (threadIdx.x == 0) fresh = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < a.S; s += kThreads) {
    const int64_t i = (int64_t)b * a.S + s;
    if (a.touch_idx[i] != slot) continue;
    const int o = a.offs[i];
    if (o < 0 || o >= a.bs) continue;
    tok_at[o] = s;
    if (o == 0) fresh = 1;
  }
  __syncthreads();
  const T* src = static_cast<const T*>(a.src) + b * a.s_sb + h * a.s_sh;
  const int n = a.bs * a.D;
  float m = 0.f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int s = tok_at[e / a.D];
    if (s >= 0) m = max_nan(m, fabsf(load(src + s * a.s_ss + e % a.D)));
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float amax = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) amax = max_nan(amax, warp_max[w]);
    float* sc = a.scales + h * a.c_sh + blk;
    const float old_eff = fresh ? 0.f : *sc;
    const float grown = max_nan(max_nan(old_eff, amax / 127.f), 1e-8f);
    scale = grown;
    ratio = old_eff / grown;
    *sc = grown;
  }
  __syncthreads();
  int8_t* dst = a.arena + h * a.a_sh + (int64_t)blk * a.a_sn;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int s = tok_at[e / a.D];
    dst[e] = s >= 0 ? quantize(load(src + s * a.s_ss + e % a.D) / scale)
                    : quantize((float)dst[e] * ratio);
  }
}

}  // namespace

extern "C" {

// dtype of the new tokens: 0 float32, 1 bfloat16. Launches on `stream`
// without synchronising; returns 0 or a CUDA error code.
int kv_quantize_scatter_launch(int dtype, int64_t B, int64_t S, int64_t H,
                               int64_t D, int64_t bs, int64_t T, int64_t N,
                               const void* src, int64_t s_sb, int64_t s_ss,
                               int64_t s_sh, void* arena, int64_t a_sh,
                               int64_t a_sn, void* scales, int64_t c_sh,
                               const void* offs, const void* touched,
                               const void* touch_idx, void* stream) {
  if (bs < 1 || bs > kMaxBlockSize || D < 1) return (int)cudaErrorInvalidValue;
  if (B * T > INT32_MAX || H > 65535) return (int)cudaErrorInvalidConfiguration;
  if (B * T == 0 || H == 0) return 0;
  Args a;
  a.src = src;
  a.s_sb = s_sb;
  a.s_ss = s_ss;
  a.s_sh = s_sh;
  a.arena = static_cast<int8_t*>(arena);
  a.a_sh = a_sh;
  a.a_sn = a_sn;
  a.scales = static_cast<float*>(scales);
  a.c_sh = c_sh;
  a.offs = static_cast<const int32_t*>(offs);
  a.touched = static_cast<const int32_t*>(touched);
  a.touch_idx = static_cast<const int32_t*>(touch_idx);
  a.S = (int)S;
  a.D = (int)D;
  a.bs = (int)bs;
  a.T = (int)T;
  a.N = (int)N;
  const dim3 grid((unsigned)(B * T), (unsigned)H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    kv_quantize_scatter_kernel<float><<<grid, kThreads, 0, st>>>(a);
  else if (dtype == 1)
    kv_quantize_scatter_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
