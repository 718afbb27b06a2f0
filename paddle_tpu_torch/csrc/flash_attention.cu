// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels, plain
// C interface for ctypes.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// `_fwd_kernel` (built by `_build_fwd`), `_dkv_kernel` and `_dq_kernel`
// (built by `_build_bwd`), with their additive-mask (`has_mask`) and dropout
// (`_tile_keep`) variants. What they compute, on [B, S, H, D] tensors with
// scale 1/sqrt(D):
// - forward: O = softmax(Q K^T * scale + M) V and LSE = m + log(l) per
//   query, with an online softmax over key tiles (l clamped to at least
//   1e-30); with dropout, O = (softmax(...) * keep / (1 - p)) V while l
//   sums the undropped P, as on the TPU;
// - dK/dV: over query tiles, p = exp(s - lse), dV += (P * D)^T dO,
//   dS = P * (dO V^T * D - delta) * scale, dK += dS^T Q, where D is the
//   dropout factor keep / (1 - p) (1 without dropout);
// - dQ: over key tiles, the same recompute, dQ += dS K;
//   delta = rowsum(dO * O) comes in precomputed (f32, [B*H, Sq]).
// The mask M is f32 and is read in place through four element strides
// (batch, head, query, key; 0 broadcasts), so a [B, 1, 1, Sk] padding mask
// is never copied; each score gets s * scale + M, clamped at -1e30. The
// mask's gradient is not a kernel: the wrapper recomputes it in plain torch.
// The keep bits are a pure function of absolute coordinates, the same in
// every tiling and in the plain version (ops/philox.py):
//   bits(seed, bh, i, j) = philox4x32_10(counter (j >> 2, i, bh, 0),
//                                        key (seed lo, seed hi))[j & 3],
//   keep = bits >= threshold(p)   (the JAX kernel's threshold rule),
// for query i, key j and bh = b * H + h. Forward, dK/dV and dQ each draw
// them anew. Both variants are runtime flags, uniform over a launch; each
// kernel holds two bodies, the plain one (no variant code at all, so the
// path without mask and dropout runs what it ran before) and the variant
// one, chosen once at the top, so the build stays at 12 instantiations.
// Causal masking is bottom-right aligned: query i sees key j when
// i + (Sk - Sq) >= j. Tiles wholly above the diagonal are skipped, not
// masked. A query row that sees no key at all (only possible when Sq > Sk)
// gets O = 0; GPT training never has Sq > Sk.
//
// Rounding points are the JAX kernels', but for dropout's: scores
// accumulate in f32 and are then scaled (by scale * log2(e): the softmax
// runs in base 2, the same function to a rounding); P (zeroed where
// dropped) is rounded to V's dtype before P V and (P D)^T dO, and the
// dropout's 1 / (1 - p) multiplies the f32 result (the TPU kernel rounds
// P / (1 - p), one rounding more; `attention_ref` rounds as here); dS is
// rounded to the input dtype before dS^T Q and dS K; every accumulator is
// f32. Two more steps hold bf16 dropout to the no-dropout kernel's error:
// the forward can also write O in f32 (`o32`), from which the wrapper takes
// the backward's delta, and dV adds the product of P's bf16 rounding
// residual (without it dV missed 2e-2 against the f32 plain version).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, S, H, D] views with unit
// stride on D; the other strides are arguments, so the strided q/k/v views
// of the fused QKV projection are read in place with no copy. Every row
// start must be 16-byte aligned (the wrapper checks). Offsets are 64-bit.
//
// Bound: at the training shape (B 16, H 8, S 1024, D 128, causal, bf16)
// the forward moves 134 MB (q, k, v, o) for 34 GFLOP and is bound by bytes
// (0.040 ms at 3.35 TB/s); the backward needs 5 causal matmuls (86 GFLOP)
// and is bound by operations (0.087 ms at 989 TFLOP/s). Philox costs ten
// rounds of two 32-bit multiply-highs for four keep bits, on the integer
// units, beside the tensor cores' work.
//
// What the design does about it (a simple design, fourth version):
// - Tensor cores: bf16 products run on mma.sync.m16n8k16 with f32
//   accumulators; fragments come from shared memory through ldmatrix
//   (`.trans` where the right-hand operand is stored [depth][columns], as
//   V is for P V), so no tile is ever stored transposed. float32 inputs
//   take an f32-FMA path on the same fragment layout (no TF32), for parity
//   checks.
// - Tiles of 64 queries x 64 keys; four warps per block, each owning 16
//   rows of the tile, so the softmax and the P / dS round trip through
//   shared memory stay inside one warp (no block barrier between the two
//   products of a tile).
// - Forward: one block per (query tile, batch*head), looping over key
//   tiles. dK/dV: one block per (key tile, batch*head), looping over query
//   tiles. dQ: one block per (query tile, batch*head), looping over key
//   tiles. The backward is split in two kernels with no atomics (the JAX
//   design): each gradient is summed in one fixed order, so the result is
//   the same on every run, at the price of recomputing S and dP twice.
// - The softmax runs in base 2 (exp2f on scores pre-scaled by log2(e)),
//   and the per-element causal / edge test only on the tiles that need it.
// - A two-stage cp.async pipeline: while a tile's products run, the next
//   tile's operands (K and V; Q, dO, LSE and delta for dK/dV) are already
//   on their way to the other half of a double buffer, and no register
//   holds them in transit.
// - Shared memory (bf16, D 128): forward 94 KB, dK/dV 112 KB, dQ 111 KB,
//   so two blocks (eight warps) share an SM, the most their registers
//   allow.
// - Dropout draws each Philox output once: in the forward and dQ layout
//   (rows = queries) the two lanes that hold one group of four keys each
//   draw it for one of their two rows and swap halves; in the dK/dV layout
//   (rows = keys) the four lanes that hold a group's keys each draw one of
//   their four (key group, query) counters and trade words through four
//   shuffles. Mask values are read from global memory (L1-cached) at the
//   score's fragment position.
// Not yet: TMA, P kept in registers as the next product's operand, wgmma,
// the mask tile staged through shared memory, and a fused backward.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// Outside the unnamed namespace: the C entry points take a FlashArgs*, and
// a type with internal linkage would give them internal linkage too.
struct View {
  void* p;
  int64_t sb, ss, sh;  // batch, sequence and head strides, in elements
};

// The additive f32 mask, read in place: element (b, h, i, j) sits at
// p + b * sb + h * sh + i * sq + j * sk; a stride of 0 broadcasts.
struct MaskView {
  const float* p;
  int64_t sb, sh, sq, sk;
};

// Mirrored by the ctypes structure `_Args` in ops/flash_attention.py.
struct FlashArgs {
  int64_t B, H, Sq, Sk;
  View q, k, v, o, dout, dq, dk, dv;
  float* lse;    // [B*H, Sq]
  float* delta;  // [B*H, Sq], backward only
  float scale;
  int32_t causal;
  int32_t has_mask;         // add `mask` to the scaled scores
  int32_t has_dropout;      // drop P where the keep bits say so
  uint32_t keep_threshold;  // keep where bits >= this
  float drop_scale;         // 1 / (1 - p)
  uint64_t seed;            // Philox key: (low word, high word)
  MaskView mask;
  View o32;  // optional f32 copy of O (p null: none), for an exact delta
};

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kTile = 64;      // queries per query tile, keys per key tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * kLog2e)
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. Plain: lane (g, t) = (lane / 4, lane % 4)
// receives row g, columns 2t and 2t + 1 of each; `.trans`: column g, rows
// 2t and 2t + 1.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One warp: acc[j] += A[16][K] * B[K][8j .. 8j+7] for j < NT. A's rows
// are at `a` (stride lda, [row][depth]); B is stored [column][depth]
// (stride ldb) or, with kBKN, [depth][column]. Both live in shared memory.
// acc[j] is the m16n8 accumulator fragment: element e of lane (g = lane /
// 4, t = lane % 4) is row g + 8 * (e / 2), column 8j + 2t + e % 2.
template <int NT, int K, bool kBKN>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4],
                                          const __nv_bfloat16* a, int lda,
                                          const __nv_bfloat16* b, int ldb) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "whole 16 x 16 steps");
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  // matrix mi of A: rows 8 * (mi % 2) + r, depth 8 * (mi / 2)
  const __nv_bfloat16* al = a + (8 * (mi & 1) + r) * lda + 8 * (mi >> 1);
  // matrices of B: (b0, b1) of column tile 2jj, then of 2jj + 1
  const __nv_bfloat16* bl =
      kBKN ? b + (8 * (mi & 1) + r) * ldb + 8 * (mi >> 1)
           : b + (8 * (mi >> 1) + r) * ldb + 8 * (mi & 1);
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm(af, al + k0);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t bf[4];
      if (kBKN)
        ldsm_t(bf, bl + k0 * ldb + 16 * jj);
      else
        ldsm(bf, bl + 16 * jj * ldb + k0);
      mma_bf16(acc[2 * jj], af, bf[0], bf[1]);
      mma_bf16(acc[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

// The same product in float32 FMAs on the same fragment layout.
template <int NT, int K, bool kBKN>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const float* a,
                                          int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + g * lda + k);
    const float4 a1 = *reinterpret_cast<const float4*>(a + (g + 8) * lda + k);
    const float x0[4] = {a0.x, a0.y, a0.z, a0.w};
    const float x1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t;
      float y0[4], y1[4];  // B[k .. k+3][n] and B[k .. k+3][n + 1]
      if (kBKN) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 u = *reinterpret_cast<const float2*>(b + (k + i) * ldb + n);
          y0[i] = u.x;
          y1[i] = u.y;
        }
      } else {
        const float4 u0 = *reinterpret_cast<const float4*>(b + n * ldb + k);
        const float4 u1 = *reinterpret_cast<const float4*>(b + (n + 1) * ldb + k);
        y0[0] = u0.x, y0[1] = u0.y, y0[2] = u0.z, y0[3] = u0.w;
        y1[0] = u1.x, y1[1] = u1.y, y1[2] = u1.z, y1[3] = u1.w;
      }
      float* c = acc[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[0] = fmaf(x0[i], y0[i], c[0]);
        c[1] = fmaf(x0[i], y1[i], c[1]);
        c[2] = fmaf(x1[i], y0[i], c[2]);
        c[3] = fmaf(x1[i], y1[i], c[3]);
      }
    }
  }
}

// Asynchronous copies to shared memory: `bytes` of 16 (or of 4) are read
// from `src`, the rest of the 16 (or 4) is zero-filled; with bytes 0
// nothing is read. Complete after cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts copying rows [r0, r0 + kTile) of a [n_rows, D] slab (row stride
// `rs` elements) into shared memory `dst` (row stride ld); rows past
// n_rows (>= 1) read nothing and come out zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t rs, int64_t r0,
                                          int64_t n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = D / kVec;  // 16-byte vectors per row
  static_assert(kTile * kVpr % kThreads == 0, "tile must split evenly");
#pragma unroll
  for (int i = threadIdx.x; i < kTile * kVpr; i += kThreads) {
    const int r = i / kVpr, c = (i % kVpr) * kVec;
    const bool in = r0 + r < n_rows;
    cp_async16(dst + r * ld + c, src + (in ? r0 + r : 0) * rs + c,
               in ? 16 : 0);
  }
}

// The same for kTile f32 values of a row of n (>= 1) values.
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int64_t r0, int64_t n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = r0 + i < n;
    cp_async4(dst + i, src + (in ? r0 + i : 0), in ? 4 : 0);
  }
}

// Shared-memory row strides: a 16-byte pad keeps the fragment loads of the
// eight rows of an 8x8 matrix on distinct banks.
template <typename T, int D> struct Ld {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kD = D + kPad;      // rows of depth D
  static constexpr int kT = kTile + kPad;  // rows of depth kTile
};

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

// Key tiles a query tile [q0, q0 + kTile) visits: all of them, or with
// causal masking those up to the last visible key of its last live row.
__device__ __forceinline__ int key_tiles(const FlashArgs& a, int64_t q0) {
  const int64_t n = (a.Sk + kTile - 1) / kTile;
  if (!a.causal) return (int)n;
  const int64_t last = min64(q0 + kTile, a.Sq) - 1 + (a.Sk - a.Sq);
  return last < 0 ? 0 : (int)min64(n, last / kTile + 1);
}

__device__ __forceinline__ bool visible(const FlashArgs& a, int64_t qpos,
                                        int64_t kpos) {
  return qpos < a.Sq && kpos < a.Sk &&
         (!a.causal || qpos + (a.Sk - a.Sq) >= kpos);
}

// Whether every (query, key) pair of the query tile at q0 and the key tile
// at k0 is visible, so the per-element test can be skipped.
__device__ __forceinline__ bool all_visible(const FlashArgs& a, int64_t q0,
                                            int64_t k0) {
  return q0 + kTile <= a.Sq && k0 + kTile <= a.Sk &&
         (!a.causal || q0 + (a.Sk - a.Sq) >= k0 + kTile - 1);
}

template <typename T>
__device__ __forceinline__ const T* slab(const View& v, int64_t b, int64_t h) {
  return static_cast<const T*>(v.p) + b * v.sb + h * v.sh;
}

// Writes a warp's [16][D] f32 accumulator (times `mul` per row) to rows
// [r0 + 16 * warp, ...) of `out`, skipping rows at or past n_rows.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const View& out, int64_t b,
                                           int64_t h, int64_t r0,
                                           int64_t n_rows,
                                           const float (&acc)[D / 8][4],
                                           const float (&mul)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  T* base = static_cast<T*>(out.p) + b * out.sb + h * out.sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = r0 + warp * 16 + g + 8 * i;
    if (r >= n_rows) continue;
    T* row = base + r * out.ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(row + 8 * j + 2 * t, acc[j][2 * i] * mul[i],
             acc[j][2 * i + 1] * mul[i]);
  }
}

template <typename T>
constexpr bool kBf16 = false;
template <>
constexpr bool kBf16<__nv_bfloat16> = true;

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// ---------------------------------------------------------------------------
// mask and dropout
// ---------------------------------------------------------------------------

// The mask's slab of batch*head bh (null without a mask).
__device__ __forceinline__ const float* mask_slab(const FlashArgs& a,
                                                  int64_t bh) {
  if (!a.has_mask) return nullptr;
  return a.mask.p + (bh / a.H) * a.mask.sb + (bh % a.H) * a.mask.sh;
}

// The base-2 score x (s * scale * log2(e)) of a live (query, key) pair plus
// its mask value, clamped at kNegInf like a hidden pair.
__device__ __forceinline__ float add_mask(const FlashArgs& a, const float* mb,
                                          int64_t qpos, int64_t kpos,
                                          float x) {
  const float m = __ldg(mb + qpos * a.mask.sq + kpos * a.mask.sk);
  return fmaxf(fmaf(m, kLog2e, x), kNegInf);
}

// Philox4x32-10 (Random123's philox4x32) at counter (c0, c1, c2, 0) under
// the 64-bit key `seed`; ops/philox.py is the same function in torch.
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint64_t seed) {
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32), c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t pick(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// 1 where the keep bits keep, else 0. The 1 / (1 - p) is applied in f32
// where the kept value meets the accumulator, so a kept P is rounded to
// V's dtype exactly as without dropout.
__device__ __forceinline__ float keep_flag(const FlashArgs& a, uint32_t bits) {
  return bits >= a.keep_threshold ? 1.f : 0.f;
}

// Keep flags of a lane's four elements of one m16n8 accumulator tile
// with rows = queries (the forward and dQ layout): element 2i + u is query
// qrow + 8i, key kcol + u, where qrow = q0 + 16 * warp + g and kcol = k0 +
// 8j + 2t. Lanes t and t ^ 1 hold the same group of four keys (kcol >> 2);
// each draws it for one of the two rows and passes its partner the half
// the partner needs. Every lane of the warp must call this together.
__device__ __forceinline__ void drop_rows(const FlashArgs& a, int64_t bh,
                                          int64_t qrow, int64_t kcol,
                                          float (&f)[4]) {
  const bool odd = threadIdx.x & 1;  // t & 1: words 2, 3 of the group
  const uint4 r = philox((uint32_t)(kcol >> 2), (uint32_t)(qrow + (odd ? 8 : 0)),
                         (uint32_t)bh, a.seed);
  // even lanes drew row g and keep words 0, 1; odd lanes row g + 8, words 2, 3
  const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  f[0] = keep_flag(a, odd ? x0 : r.x);
  f[1] = keep_flag(a, odd ? x1 : r.y);
  f[2] = keep_flag(a, odd ? r.z : x0);
  f[3] = keep_flag(a, odd ? r.w : x1);
}

// The same for the dK/dV layout (rows = keys): element e is key krow + 8 *
// (e / 2), query qcol + e % 2, where krow = k0 + 16 * warp + g and qcol =
// q0 + 8j + 2t. The four lanes g & 3 = u of a quad (same t) hold one key
// group's four keys at both key rows and both queries: lane u draws the
// counter of element u (key group of row u / 2, query qcol + u % 2), and
// in round k sends word u ^ k of it to lane u ^ k, which takes it as its
// element u ^ k. Every lane of the warp must call this together.
__device__ __forceinline__ void drop_cols(const FlashArgs& a, int64_t bh,
                                          int64_t krow, int64_t qcol,
                                          float (&f)[4]) {
  const int u = (threadIdx.x >> 2) & 3;
  const uint4 r = philox((uint32_t)(((krow - u) >> 2) + 2 * (u >> 1)),
                         (uint32_t)(qcol + (u & 1)), (uint32_t)bh, a.seed);
  uint4 got;  // word k: element u ^ k
  got.x = pick(r, u);
  got.y = __shfl_xor_sync(0xffffffffu, pick(r, u ^ 1), 4);
  got.z = __shfl_xor_sync(0xffffffffu, pick(r, u ^ 2), 8);
  got.w = __shfl_xor_sync(0xffffffffu, pick(r, u ^ 3), 12);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = keep_flag(a, pick(got, u ^ e));
}

// ---------------------------------------------------------------------------
// forward: grid (query tiles, B*H)
// ---------------------------------------------------------------------------

// kVar: the mask / dropout variant (runtime flags inside); without it the
// body compiles to the plain kernel, untouched by the variants' code.
template <typename T, int D, bool kVar>
__device__ __forceinline__ void fwd_body(const FlashArgs& a) {
  using L = Ld<T, D>;
  extern __shared__ uint4 smem_u4[];
  constexpr int kTileElems = kTile * L::kD;
  T* qs = reinterpret_cast<T*>(smem_u4);  // [kTile][kD]
  T* kvs = qs + kTileElems;               // [2 stages][K, V][kTile][kD]
  T* ps = kvs + 4 * kTileElems;           // [kTile][kT], P of this tile

  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* kg = slab<T>(a.k, b, h);
  const T* vg = slab<T>(a.v, b, h);
  // K and V of key tile kt into its stage
  auto fetch = [&](int kt) {
    T* dst = kvs + (kt & 1) * 2 * kTileElems;
    load_tile<T, D>(dst, L::kD, kg, a.k.ss, (int64_t)kt * kTile, a.Sk);
    load_tile<T, D>(dst + kTileElems, L::kD, vg, a.v.ss,
                    (int64_t)kt * kTile, a.Sk);
  };
  const int n_kt = key_tiles(a, q0);
  load_tile<T, D>(qs, L::kD, slab<T>(a.q, b, h), a.q.ss, q0, a.Sq);
  if (n_kt > 0) fetch(0);
  cp_async_commit();

  float o[D / 8][4];
  zero(o);
  // m is the running row max of the base-2 scores s * scale * log2(e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;
  T* pw = ps + warp * 16 * L::kT;  // this warp's rows of P
  const bool has_mask = kVar && a.has_mask;
  const bool has_drop = kVar && a.has_dropout;
  const float* mb = mask_slab(a, bh);
  const int64_t qrow = q0 + warp * 16 + g;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int64_t k0 = (int64_t)kt * kTile;
    const T* ks = kvs + (kt & 1) * 2 * kTileElems;
    const T* vs = ks + kTileElems;
    if (kt + 1 < n_kt) {
      fetch(kt + 1);  // into the stage the previous tile freed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q) has landed for every thread

    float s[kTile / 8][4];
    zero(s);
    warp_gemm<kTile / 8, D, false>(s, qs + warp * 16 * L::kD, L::kD, ks,
                                   L::kD);

    // rows past Sq are masked whole: finite garbage, never stored
    const bool full = all_visible(a, q0, k0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t qpos = qrow + 8 * (e >> 1);
        const int64_t kpos = k0 + 8 * j + 2 * t + (e & 1);
        const bool live = full || visible(a, qpos, kpos);
        float x = live ? s[j][e] * sl2 : kNegInf;
        if (has_mask && live) x = add_mask(a, mb, qpos, kpos, x);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (has_drop) drop_rows(a, bh, qrow, k0 + 8 * j + 2 * t, f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(s[j][2 * i] - m[i]);
        const float p1 = exp2f(s[j][2 * i + 1] - m[i]);
        // l takes the unrounded p before dropout, as on the TPU
        sum[i] += p0 + p1;
        if (has_drop)
          store2(pw + (g + 8 * i) * L::kT + 8 * j + 2 * t, p0 * f[2 * i],
                 p1 * f[2 * i + 1]);
        else
          store2(pw + (g + 8 * i) * L::kT + 8 * j + 2 * t, p0, p1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    __syncwarp();
    warp_gemm<D / 8, kTile, true>(o, pw, L::kT, vs, L::kD);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
    inv[i] = (has_drop ? a.drop_scale : 1.f) / lc;
    const int64_t qpos = q0 + warp * 16 + g + 8 * i;
    if (t == 0 && qpos < a.Sq)
      a.lse[bh * a.Sq + qpos] = m[i] * kLn2 + logf(lc);
  }
  store_rows<T, D>(a.o, b, h, q0, a.Sq, o, inv);
  if (kVar && a.o32.p) store_rows<float, D>(a.o32, b, h, q0, a.Sq, o, inv);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(const FlashArgs a) {
  if (a.has_mask || a.has_dropout)
    fwd_body<T, D, true>(a);
  else
    fwd_body<T, D, false>(a);
}

// ---------------------------------------------------------------------------
// dK/dV: grid (key tiles, B*H). Warps own 16 keys; the products run on the
// transposed tiles (rows = keys, columns = queries).
// ---------------------------------------------------------------------------

template <typename T, int D, bool kVar>
__device__ __forceinline__ void dkv_body(const FlashArgs& a) {
  using L = Ld<T, D>;
  extern __shared__ uint4 smem_u4[];
  constexpr int kTileElems = kTile * L::kD;
  T* ks = reinterpret_cast<T*>(smem_u4);  // [kTile][kD]
  T* vs = ks + kTileElems;                // [kTile][kD]
  T* qds = vs + kTileElems;               // [2 stages][Q, dO][kTile][kD]
  T* pt = qds + 4 * kTileElems;           // [kTile][kT], P^T then dS^T
  // [2 stages][LSE, delta][kTile]
  float* rows = reinterpret_cast<float*>(pt + kTile * L::kT);

  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t off = a.Sk - a.Sq;
  const T* qg = slab<T>(a.q, b, h);
  const T* dog = slab<T>(a.dout, b, h);
  // Q, dO, LSE and delta of query tile qi into its stage
  auto fetch = [&](int qi) {
    const int64_t q0 = (int64_t)qi * kTile;
    T* dst = qds + (qi & 1) * 2 * kTileElems;
    float* r = rows + (qi & 1) * 2 * kTile;
    load_tile<T, D>(dst, L::kD, qg, a.q.ss, q0, a.Sq);
    load_tile<T, D>(dst + kTileElems, L::kD, dog, a.dout.ss, q0, a.Sq);
    load_row(r, a.lse + bh * a.Sq, q0, a.Sq);
    load_row(r + kTile, a.delta + bh * a.Sq, q0, a.Sq);
  };
  // first query tile holding a query that sees key k0
  int qt_begin = 0;
  if (a.causal && k0 - off > 0) qt_begin = (int)((k0 - off) / kTile);
  const int n_qt = (int)((a.Sq + kTile - 1) / kTile);
  load_tile<T, D>(ks, L::kD, slab<T>(a.k, b, h), a.k.ss, k0, a.Sk);
  load_tile<T, D>(vs, L::kD, slab<T>(a.v, b, h), a.v.ss, k0, a.Sk);
  fetch(qt_begin);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  const float sl2 = a.scale * kLog2e;
  T* pw = pt + warp * 16 * L::kT;
  const bool has_mask = kVar && a.has_mask;
  const bool has_drop = kVar && a.has_dropout;
  const float* mb = mask_slab(a, bh);
  const int64_t krow = k0 + warp * 16 + g;

  for (int qi = qt_begin; qi < n_qt; ++qi) {
    const int64_t q0 = (int64_t)qi * kTile;
    const T* qs = qds + (qi & 1) * 2 * kTileElems;
    const T* dos = qs + kTileElems;
    const float* lse_s = rows + (qi & 1) * 2 * kTile;
    const float* delta_s = lse_s + kTile;
    if (qi + 1 < n_qt) {
      fetch(qi + 1);  // into the stage the previous tile freed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and K, V) has landed for every thread

    float st[kTile / 8][4], dpt[kTile / 8][4];
    zero(st);
    zero(dpt);
    warp_gemm<kTile / 8, D, false>(st, ks + warp * 16 * L::kD, L::kD, qs,
                                   L::kD);
    warp_gemm<kTile / 8, D, false>(dpt, vs + warp * 16 * L::kD, L::kD, dos,
                                   L::kD);

    // P^T (times the keep flags), rounded into shared memory for
    // dV += (P keep)^T dO; st keeps P, dpt becomes dP D
    const bool full = all_visible(a, q0, k0);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (has_drop) drop_cols(a, bh, krow, q0 + 8 * j + 2 * t, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t qpos = q0 + 8 * j + 2 * t + (e & 1);
        const int64_t kpos = krow + 8 * (e >> 1);
        const float lse2 = lse_s[qpos - q0] * kLog2e;
        float p = 0.f;
        if (full || visible(a, qpos, kpos))
          p = has_mask
                  ? exp2f(add_mask(a, mb, qpos, kpos, st[j][e] * sl2) - lse2)
                  : exp2f(fmaf(st[j][e], sl2, -lse2));
        // with dropout, a dropped P is kept negated: |st| is P for dS,
        // max(st, 0) is P keep for dV
        st[j][e] = has_drop && f[e] == 0.f ? -p : p;
        if (has_drop) dpt[j][e] *= f[e] * a.drop_scale;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        T* dst = pw + (g + 8 * i) * L::kT + 8 * j + 2 * t;
        if (has_drop)
          store2(dst, fmaxf(st[j][2 * i], 0.f), fmaxf(st[j][2 * i + 1], 0.f));
        else
          store2(dst, st[j][2 * i], st[j][2 * i + 1]);
      }
    }
    __syncwarp();
    warp_gemm<D / 8, kTile, true>(dv, pw, L::kT, dos, L::kD);
    __syncwarp();
    if (kBf16<T> && has_drop) {
      // dV += (the rounding residual of P keep)^T dO: with dropout the
      // largest dV entries carry the bf16 rounding of their P through a
      // 1 / (1 - p) gain, and the residual product keeps them at the
      // no-dropout kernel's precision
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x0 = fmaxf(st[j][2 * i], 0.f);
          const float x1 = fmaxf(st[j][2 * i + 1], 0.f);
          store2(pw + (g + 8 * i) * L::kT + 8 * j + 2 * t,
                 x0 - __bfloat162float(__float2bfloat16_rn(x0)),
                 x1 - __bfloat162float(__float2bfloat16_rn(x1)));
        }
      __syncwarp();
      warp_gemm<D / 8, kTile, true>(dv, pw, L::kT, dos, L::kD);
      __syncwarp();
    }
    // dS^T over the same buffer, for dK += dS^T Q
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = 8 * j + 2 * t;
        const float p0 = has_drop ? fabsf(st[j][2 * i]) : st[j][2 * i];
        const float p1 =
            has_drop ? fabsf(st[j][2 * i + 1]) : st[j][2 * i + 1];
        store2(pw + (g + 8 * i) * L::kT + c,
               p0 * (dpt[j][2 * i] - delta_s[c]) * a.scale,
               p1 * (dpt[j][2 * i + 1] - delta_s[c + 1]) * a.scale);
      }
    __syncwarp();
    warp_gemm<D / 8, kTile, true>(dk, pw, L::kT, qs, L::kD);
    __syncthreads();  // every warp is done with this stage before its refill
  }

  const float one[2] = {1.f, 1.f};
  const float ds = has_drop ? a.drop_scale : 1.f, dscale[2] = {ds, ds};
  store_rows<T, D>(a.dk, b, h, k0, a.Sk, dk, one);
  store_rows<T, D>(a.dv, b, h, k0, a.Sk, dv, dscale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv(const FlashArgs a) {
  if (a.has_mask || a.has_dropout)
    dkv_body<T, D, true>(a);
  else
    dkv_body<T, D, false>(a);
}

// ---------------------------------------------------------------------------
// dQ: grid (query tiles, B*H)
// ---------------------------------------------------------------------------

template <typename T, int D, bool kVar>
__device__ __forceinline__ void dq_body(const FlashArgs& a) {
  using L = Ld<T, D>;
  extern __shared__ uint4 smem_u4[];
  constexpr int kTileElems = kTile * L::kD;
  T* qs = reinterpret_cast<T*>(smem_u4);  // [kTile][kD]
  T* dos = qs + kTileElems;               // [kTile][kD]
  T* kvs = dos + kTileElems;              // [2 stages][K, V][kTile][kD]
  T* dss = kvs + 4 * kTileElems;          // [kTile][kT], dS of this tile

  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* kg = slab<T>(a.k, b, h);
  const T* vg = slab<T>(a.v, b, h);
  // K and V of key tile kj into its stage
  auto fetch = [&](int kj) {
    T* dst = kvs + (kj & 1) * 2 * kTileElems;
    load_tile<T, D>(dst, L::kD, kg, a.k.ss, (int64_t)kj * kTile, a.Sk);
    load_tile<T, D>(dst + kTileElems, L::kD, vg, a.v.ss,
                    (int64_t)kj * kTile, a.Sk);
  };
  const int n_kt = key_tiles(a, q0);
  load_tile<T, D>(qs, L::kD, slab<T>(a.q, b, h), a.q.ss, q0, a.Sq);
  load_tile<T, D>(dos, L::kD, slab<T>(a.dout, b, h), a.dout.ss, q0, a.Sq);
  if (n_kt > 0) fetch(0);
  cp_async_commit();
  float lse2[2], delta[2];  // lse2: the row's LSE in base 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qpos = q0 + warp * 16 + g + 8 * i;
    lse2[i] = qpos < a.Sq ? a.lse[bh * a.Sq + qpos] * kLog2e : 0.f;
    delta[i] = qpos < a.Sq ? a.delta[bh * a.Sq + qpos] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;

  float dq[D / 8][4];
  zero(dq);
  T* dw = dss + warp * 16 * L::kT;
  const bool has_mask = kVar && a.has_mask;
  const bool has_drop = kVar && a.has_dropout;
  const float* mb = mask_slab(a, bh);
  const int64_t qrow = q0 + warp * 16 + g;

  for (int kj = 0; kj < n_kt; ++kj) {
    const int64_t k0 = (int64_t)kj * kTile;
    const T* ks = kvs + (kj & 1) * 2 * kTileElems;
    const T* vs = ks + kTileElems;
    if (kj + 1 < n_kt) {
      fetch(kj + 1);  // into the stage the previous tile freed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q, dO) has landed for every thread

    float s[kTile / 8][4], dp[kTile / 8][4];
    zero(s);
    zero(dp);
    warp_gemm<kTile / 8, D, false>(s, qs + warp * 16 * L::kD, L::kD, ks,
                                   L::kD);
    warp_gemm<kTile / 8, D, false>(dp, dos + warp * 16 * L::kD, L::kD, vs,
                                   L::kD);
    const bool full = all_visible(a, q0, k0);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (has_drop) {
        drop_rows(a, bh, qrow, k0 + 8 * j + 2 * t, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] *= a.drop_scale;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * i + u;
          const int64_t qpos = qrow + 8 * i, kpos = k0 + 8 * j + 2 * t + u;
          float p = 0.f;
          if (full || visible(a, qpos, kpos))
            p = has_mask
                    ? exp2f(add_mask(a, mb, qpos, kpos, s[j][e] * sl2) -
                            lse2[i])
                    : exp2f(fmaf(s[j][e], sl2, -lse2[i]));
          const float dpe = has_drop ? dp[j][e] * f[e] : dp[j][e];
          ds[u] = p * (dpe - delta[i]) * a.scale;
        }
        store2(dw + (g + 8 * i) * L::kT + 8 * j + 2 * t, ds[0], ds[1]);
      }
    }
    __syncwarp();
    warp_gemm<D / 8, kTile, true>(dq, dw, L::kT, ks, L::kD);
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();

  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(a.dq, b, h, q0, a.Sq, dq, one);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq(const FlashArgs a) {
  if (a.has_mask || a.has_dropout)
    dq_body<T, D, true>(a);
  else
    dq_body<T, D, false>(a);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int D> constexpr size_t fwd_smem() {
  using L = Ld<T, D>;  // Q, two stages of K and V, P
  return sizeof(T) * (5 * kTile * L::kD + kTile * L::kT);
}
template <typename T, int D> constexpr size_t dkv_smem() {
  using L = Ld<T, D>;  // K, V, two stages of Q, dO, LSE and delta, P
  return sizeof(T) * (6 * kTile * L::kD + kTile * L::kT) +
         4 * kTile * sizeof(float);
}
template <typename T, int D> constexpr size_t dq_smem() {
  using L = Ld<T, D>;  // Q, dO, two stages of K and V, dS
  return sizeof(T) * (6 * kTile * L::kD + kTile * L::kT);
}

// Raises a kernel's dynamic shared-memory cap once (not a stream
// operation, so it stays out of captured graphs after the first call),
// then launches it on grid (tiles, B*H).
template <typename Kernel>
int launch(Kernel kernel, size_t smem, bool& ready, int64_t tiles,
           const FlashArgs& a, cudaStream_t stream) {
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  kernel<<<dim3((unsigned)tiles, (unsigned)(a.B * a.H)), kThreads, smem,
           stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int fwd(const FlashArgs& a, cudaStream_t stream) {
  static bool ready = false;
  return launch(flash_fwd<T, D>, fwd_smem<T, D>(), ready,
                (a.Sq + kTile - 1) / kTile, a, stream);
}

// which: 1 = dK/dV, 2 = dQ, 3 = both (dK/dV first)
template <typename T, int D>
int bwd(const FlashArgs& a, int which, cudaStream_t stream) {
  static bool ready_dkv = false, ready_dq = false;
  if (which & 1) {
    const int err = launch(flash_dkv<T, D>, dkv_smem<T, D>(), ready_dkv,
                           (a.Sk + kTile - 1) / kTile, a, stream);
    if (err) return err;
  }
  if (which & 2)
    return launch(flash_dq<T, D>, dq_smem<T, D>(), ready_dq,
                  (a.Sq + kTile - 1) / kTile, a, stream);
  return 0;
}

int check(const FlashArgs* a) {
  if (a->B * a->H > 65535) return (int)cudaErrorInvalidConfiguration;
  if (a->has_mask && a->mask.p == nullptr) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Writes a->o and
// a->lse, adding a->mask when a->has_mask and dropping P when
// a->has_dropout. Returns cudaGetLastError() after the launch (0 on
// success). Launches on `stream` and does not synchronise.
extern "C" int flash_attention_fwd_launch(int dtype, int64_t head_dim,
                                          const FlashArgs* a, void* stream) {
  if (a->B * a->H == 0 || a->Sq == 0) return 0;
  if (int err = check(a)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return fwd<float, 64>(*a, st);
  if (dtype == 0 && head_dim == 128) return fwd<float, 128>(*a, st);
  if (dtype == 1 && head_dim == 64) return fwd<__nv_bfloat16, 64>(*a, st);
  if (dtype == 1 && head_dim == 128) return fwd<__nv_bfloat16, 128>(*a, st);
  return (int)cudaErrorInvalidValue;
}

// The backward kernels (`which`: 1 = dK/dV, 2 = dQ, 3 = both). Reads q, k,
// v, dout, lse, delta (and the mask); writes dk and dv (1), dq (2). The
// mask and dropout flags and the seed must be the forward's. Same
// conventions as the forward.
extern "C" int flash_attention_bwd_launch(int dtype, int64_t head_dim,
                                          int which, const FlashArgs* a,
                                          void* stream) {
  if (a->B * a->H == 0 || a->Sq == 0 || a->Sk == 0) return 0;
  if (int err = check(a)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return bwd<float, 64>(*a, which, st);
  if (dtype == 0 && head_dim == 128) return bwd<float, 128>(*a, which, st);
  if (dtype == 1 && head_dim == 64) return bwd<__nv_bfloat16, 64>(*a, which, st);
  if (dtype == 1 && head_dim == 128) return bwd<__nv_bfloat16, 128>(*a, which, st);
  return (int)cudaErrorInvalidValue;
}
