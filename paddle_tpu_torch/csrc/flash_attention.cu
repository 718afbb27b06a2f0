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
// for query i, key j and bh = b * heads_total + head_offset + h: the
// model's head coordinate, so a tensor-parallel rank holding heads
// [head_offset, head_offset + H) draws the bits the whole model draws for
// them (heads_total = H and head_offset 0 without tensor parallelism). The
// query coordinate is absolute too: i = q_row0 + the row's index in the
// call, so a sequence-parallel rank whose queries start at q_row0 of the
// whole sequence draws the whole sequence's bits for its rows (q_row0 0
// alone; the key coordinate is the row's index in k, which holds the
// sequence from its start). Forward, dK/dV and dQ each draw them anew. Both variants are runtime flags, uniform over a launch; each
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
// Which design runs: every bf16 kernel runs the sm_90a design
// (`flash_fwd_sm90`, `flash_dkv_sm90`, `flash_dq_sm90`: TMA, wgmma,
// warp-specialised warpgroups); every float32 kernel runs the 3xTF32
// design (`flash_fwd_f32`, `flash_dkv_f32`, `flash_dq_f32`:
// split-precision products on the tensor cores through mma.sync). The f32
// kernels are the card-vs-CPU parity path and the pipelined GPT-3 1.3B's
// (it trains in f32, as the JAX model does).
//
// The sm_90a design. What bounded the mma.sync kernels on bf16: Ampere's
// mma.sync cannot reach the tensor cores' full rate, each warp's ldmatrix
// re-read whole K / V tiles for 16 rows, P and dS went through shared
// memory before every second product, and no warp loaded while others
// computed. So:
// - A block is three warpgroups. Warpgroup 0, the producer, gives its
//   registers up (setmaxnreg 24); one thread issues TMA tile loads into a
//   ring of stages guarded by full / empty mbarriers, and warp 1 stages the
//   f32 rows TMA cannot take (LSE and delta; a key-only mask's values) with
//   plain loads. Warpgroups 1 and 2, the consumers, take 240 registers
//   each and run the products as wgmma. The tensor maps cover the [B, S,
//   H, D] views with their own strides (so the fused projection's strided
//   q/k/v are read in place), 64-column boxes with 128-byte swizzle, rows
//   past S zero-filled; they are encoded on the host at each launch with
//   the driver's cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (sm90.cuh), and passed by value.
// - Forward: a block owns 128 queries (64 a consumer) and loops over key
//   tiles of 128; Q is loaded once, K and V sit in 3 (D 128, 226 KB of
//   shared memory) or 4 (D 64) stages. S = Q K^T is an SS wgmma (both operands K-major); the online
//   softmax runs on the accumulator in registers; P, packed to bf16 in
//   place, is the A operand of O += P V (RS, V read MN-major as stored), so
//   P never touches shared memory. Tile kt's S product is issued together
//   with tile kt - 1's P V, and two named barriers order the consumers'
//   issues (ping-pong), so one consumer's softmax runs beside the other's
//   products. Causal query tiles start heaviest first.
// - dK/dV: a block owns 128 keys (64 a consumer, K and V loaded once) and
//   loops over a ring of 64-query Q / dO tiles (3 stages at D 128, 4 at D
//   64). Every product has keys as its rows: S^T = K Q^T and dP^T = V dO^T
//   are SS; P^T (times the keep flags), its bf16 rounding residual under
//   dropout and dS^T are packed in registers as the A operands of dV +=
//   (P keep)^T dO and dK += dS^T Q (RS, dO and Q read MN-major from the same
//   swizzled tiles that served as K-major operands).
// - dQ: a block owns 128 queries (64 a consumer; Q and dO loaded once, LSE
//   and delta held in two registers a thread) and loops over a ring of 4
//   K / V stages of 64 keys (194 KB of shared memory at D 128, 98 KB at D
//   64). S = Q K^T and dP = dO V^T are SS; dS is computed on the
//   accumulators in registers and packed to bf16 as the A operand of dQ +=
//   dS K (RS, K read MN-major from the tile that served Q K^T). The tile
//   width is set by registers: a consumer thread holds S and dP (32 f32
//   each), the dQ accumulator (D / 2 f32) and the packed dS (16), so tile
//   kt's S and dP products run beside tile kt - 1's dQ product within the
//   240 registers (at 128 keys and D 128, S, dP and dQ alone would take
//   192). The consumers ping-pong as in the forward; causal query tiles
//   start heaviest first, and a consumer only waits for and releases the
//   block's key tiles that none of its rows sees.
// - Variants are compile-time: a kernel per (mask kind, dropout), chosen on
//   the host: no mask, a key-only mask ([B, 1, 1, Sk]: staged per key tile
//   in the forward and dQ, held in two registers for the whole block in
//   dK/dV), any other mask (read per element), each with or without
//   dropout. With runtime flags inside the unrolled tile loops instead, the
//   variant forwards ran slower than the mma.sync kernels on the H100.
//   Hidden (causal / edge) pairs are found by one integer compare per score
//   against per-row limits, and only on the tiles that need it; exp2 runs
//   on the special function unit directly.
//
// The float32 forward, dK/dV and dQ (3xTF32). The FMA designs they
// replace ran at 4.8-7.2x their FMA bound at a pipeline stage's shape on
// the H100 (the forward at 5.3x, 1.9x behind PyTorch's f32 attention):
// scalar FMAs (67 TFLOP/s at best) fed by shared-memory loads on every
// k-step, 182-221 KB of shared memory a block of four warps (one block an
// SM), P through shared memory, and a copy that nothing overlapped. So:
// - Products on the tensor cores in split precision: each f32 operand x is
//   hi + lo with hi = x rounded to TF32 (to nearest, ties away from zero,
//   in two integer instructions) and lo = x - hi (exact), and each product
//   is lo_a hi_b + hi_a lo_b + hi_a hi_b, three mma.sync.m16n8k8.tf32. The
//   tensor core reads lo's top 19 bits, and lo_a lo_b is left out:
//   together about 2^-21 of each product, the order of f32's rounding.
//   3xTF32 runs at a third of the dense TF32 rate, 165 TFLOP/s, against 67
//   for FMAs, and leaves the FMA and load pipes to the softmax recompute,
//   the mask and Philox.
// - The tensor core adds a product into its accumulator rounding toward
//   zero: one chain of 192 mma into a dV accumulator (1024 queries, two
//   warps) drifted 4.5e-5 from float64 on the H100, where plain f32
//   products stay within 1.0e-5, and an emulation of that rounding on the
//   CPU drifts alike (2.3e-5 at 256 queries, 5.1e-5 at 512). So no chain
//   is long: each product sums four k-steps (32 of its depth) into a fresh
//   accumulator and adds that into its sums in f32. Then every error
//   stays within 4.4e-6 of float64 and within 2e-5 of the plain f32
//   version (tests/test_torch_flash_split_f32.py emulates the roundings
//   and the chains on the CPU against float64; one TF32 pass misses the
//   same gate by two orders of magnitude).
// - mma.sync, not wgmma: wgmma's tf32 form reads both shared-memory
//   operands K-major only (the transpose is for 16-bit types), and O += P
//   V, dV += (P D)^T dO, dK += dS^T Q and dQ += dS K all read their
//   right-hand operand MN-major, as stored; wgmma would need [D][rows]
//   copies of V, dO, Q and K. mma.sync's fragments are loaded by the threads from any
//   layout: rows are padded by 16 bytes (stride = 4 mod 32 words), which
//   makes both the row-major reads (A, and B of S and dP) and the column
//   reads (B of O, dV, dK, dQ: rows 2t and 2t + 1, column g) free of bank
//   conflicts, so no tile is stored transposed.
// - The accumulator of S^T (or S) and dP^T (or dP) is the m16n8 layout,
//   and a lane's two columns 2t, 2t + 1 serve as depth t and t + 4 of the
//   next product's A fragment (the B operand reads rows in the same
//   order): P and dS stay in registers. The softmax, add_mask, drop_rows /
//   drop_cols and store_rows keep the FMA design's fragment positions.
// - Operands are split at each fragment load, not once per tile into hi /
//   lo planes: planes would double the tiles' shared memory (405 KB at D
//   128 for dK/dV's six tiles), which does not fit one block of eight
//   warps. Each A fragment is split once per k-step and reused over a row
//   of n-tiles; each B value once per warp that reads it.
// - Eight warps a block (one block an SM at D 128): 64 keys (dK/dV) or 64
//   queries (forward, dQ) a block in four row groups of 16. In dK/dV the two warps
//   of a row group split the products: one computes S^T, P and dV, the
//   other dP^T, dS^T (P handed over through shared memory, a dropped
//   entry negated, a named barrier a pair) and dK, so a warp holds one
//   [16][D] accumulator (two would take 128 of its 255 registers and
//   spill). In the forward and dQ the two warps of a row group take the
//   two halves of each 64-key tile, each with its own sums (the forward's
//   with its own online softmax), merged half 0 then half 1 through shared
//   memory at the end: one fixed order. A warp whose rows see none of its
//   columns skips the tile.
// - Q / dO (dK/dV) or K / V (forward, dQ) tiles come through a two-stage
//   cp.async ring, the next tile in flight while this one's products run;
//   the backward's grid is (B*H, tiles), heaviest causal tiles first.
//   Under causal masking a forward block takes query tiles n - 1 - p and p
//   in turn, so every block visits n + 1 key tiles: at a pipeline stage's
//   shape (16 tiles, 16 batch*heads) 128 equal blocks fill 128 of the 132
//   SMs in one wave, where one block a tile made 256 blocks of 1 to 16
//   visits.
//
// Every design: the backward is split in two kernels with no atomics (the
// JAX design): each gradient is summed in one fixed order, so the result
// is the same on every run, at the price of recomputing S and dP twice.
// Dropout draws each Philox output once: in the forward and dQ layout
// (rows = queries) the two lanes that hold one group of four keys each
// draw it for one of their two rows and swap halves; in the dK/dV layout
// (rows = keys) the four lanes that hold a group's keys each draw one of
// their four (key group, query) counters and trade words through four
// shuffles (the wgmma accumulator is the m16n8 layout repeated along N, so
// every kind of kernel shares these helpers).
// Not yet: a persistent grid (one block an SM walking over tiles, so one
// tile's epilogue overlaps the next's loads); TMA stores of the outputs;
// overlap inside a dK/dV consumer (the next tile's S^T product beside this
// tile's dV and dK); a fused backward.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

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
  // the dropout keep bits' head coordinate (a tensor-parallel rank holds
  // heads [head_offset, head_offset + H) of heads_total): bh = b *
  // heads_total + head_offset + h; heads_total = H, head_offset 0 alone
  int64_t heads_total;
  int64_t head_offset;
  // the keep bits' query coordinate of the call's first query row (a
  // sequence-parallel rank's offset in the whole sequence; 0 alone)
  int64_t q_row0;
};

// The TMA descriptors of the bf16 sm_90a kernels over q, k, v and dout,
// encoded on the host at each launch and passed by value (a CUDA graph
// captures them with the launch).
struct TmaMaps {
  CUtensorMap q, k, v, dout;
};

namespace {

constexpr int kF32Threads = 256;  // the f32 kernels: eight warps
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

// The block's kN threads start copying rows [r0, r0 + kTile) of a
// [n_rows, D] slab (row stride `rs` elements) into shared memory `dst`
// (row stride ld); rows past n_rows (>= 1) read nothing and come out zero.
template <typename T, int D, int kN = kF32Threads>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t rs, int64_t r0,
                                          int64_t n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = D / kVec;  // 16-byte vectors per row
  static_assert(kTile * kVpr % kN == 0, "tile must split evenly");
#pragma unroll
  for (int i = threadIdx.x; i < kTile * kVpr; i += kN) {
    const int r = i / kVpr, c = (i % kVpr) * kVec;
    const bool in = r0 + r < n_rows;
    cp_async16(dst + r * ld + c, src + (in ? r0 + r : 0) * rs + c,
               in ? 16 : 0);
  }
}

// The same for kTile f32 values of a row of n (>= 1) values.
template <int kN = kF32Threads>
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int64_t r0, int64_t n) {
  for (int i = threadIdx.x; i < kTile; i += kN) {
    const bool in = r0 + i < n;
    cp_async4(dst + i, src + (in ? r0 + i : 0), in ? 4 : 0);
  }
}

// Shared-memory row strides: a 16-byte pad keeps the fragment loads of the
// eight rows of an 8x8 matrix on distinct banks.
template <typename T, int D> struct Ld {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kD = D + kPad;  // rows of depth D
};

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

// Key tiles (of KT keys) a query tile [q0, q0 + QT) visits: all of them,
// or with causal masking those up to the last visible key of its last live
// row.
template <int QT = kTile, int KT = kTile>
__device__ __forceinline__ int key_tiles(const FlashArgs& a, int64_t q0) {
  const int64_t n = (a.Sk + KT - 1) / KT;
  if (!a.causal) return (int)n;
  const int64_t last = min64(q0 + QT, a.Sq) - 1 + (a.Sk - a.Sq);
  return last < 0 ? 0 : (int)min64(n, last / KT + 1);
}

__device__ __forceinline__ bool visible(const FlashArgs& a, int64_t qpos,
                                        int64_t kpos) {
  return qpos < a.Sq && kpos < a.Sk &&
         (!a.causal || qpos + (a.Sk - a.Sq) >= kpos);
}

// Whether every (query, key) pair of the QT queries at q0 and the KT keys
// at k0 is visible, so the per-element test can be skipped.
template <int QT = kTile, int KT = kTile>
__device__ __forceinline__ bool all_visible(const FlashArgs& a, int64_t q0,
                                            int64_t k0) {
  return q0 + QT <= a.Sq && k0 + KT <= a.Sk &&
         (!a.causal || q0 + (a.Sk - a.Sq) >= k0 + KT - 1);
}

template <typename T>
__device__ __forceinline__ const T* slab(const View& v, int64_t b, int64_t h) {
  return static_cast<const T*>(v.p) + b * v.sb + h * v.sh;
}

// Writes a thread's part of a [16][D] f32 accumulator fragment (times
// `mul` per row) to rows `row` and row + 8 of `out` (row: the fragment's
// row g), skipping rows at or past n_rows.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const View& out, int64_t b,
                                           int64_t h, int64_t row,
                                           int64_t n_rows,
                                           const float (&acc)[D / 8][4],
                                           const float (&mul)[2]) {
  const int t = threadIdx.x & 3;
  T* base = static_cast<T*>(out.p) + b * out.sb + h * out.sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = row + 8 * i;
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
__device__ __forceinline__ float add_mask_at(const float* m, float x) {
  return fmaxf(fmaf(__ldg(m), kLog2e, x), kNegInf);
}
__device__ __forceinline__ float add_mask(const FlashArgs& a, const float* mb,
                                          int64_t qpos, int64_t kpos,
                                          float x) {
  return add_mask_at(mb + qpos * a.mask.sq + kpos * a.mask.sk, x);
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

// 1 where the keep bits keep, else 0. The 1 / (1 - p) is applied in f32
// where the kept value meets the accumulator, so a kept P is rounded to
// V's dtype exactly as without dropout.
__device__ __forceinline__ float keep_flag(const FlashArgs& a, uint32_t bits) {
  return bits >= a.keep_threshold ? 1.f : 0.f;
}

// Keep flags of a lane's four elements of one m16n8 accumulator tile
// with rows = queries (the forward and dQ layout): element 2i + u is query
// qrow + 8i, key kcol + u, where qrow = q0 + 16 * warp + g and kcol = k0 +
// 8j + 2t (the bits' query coordinate adds a.q_row0). Lanes t and t ^ 1
// hold the same group of four keys (kcol >> 2); each draws it for one of
// the two rows and passes its partner the half the partner needs. Every
// lane of the warp must call this together.
__device__ __forceinline__ void drop_rows(const FlashArgs& a, int64_t bh,
                                          int64_t qrow, int64_t kcol,
                                          float (&f)[4]) {
  const bool odd = threadIdx.x & 1;  // t & 1: words 2, 3 of the group
  const uint4 r = philox((uint32_t)(kcol >> 2),
                         (uint32_t)(a.q_row0 + qrow + (odd ? 8 : 0)),
                         (uint32_t)bh, a.seed);
  // even lanes drew row g and keep words 0, 1; odd lanes row g + 8, words 2, 3
  const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  f[0] = keep_flag(a, odd ? x0 : r.x);
  f[1] = keep_flag(a, odd ? x1 : r.y);
  f[2] = keep_flag(a, odd ? r.z : x0);
  f[3] = keep_flag(a, odd ? r.w : x1);
}

// The same for the dK/dV layout (rows = keys), used by the bf16 and the
// f32 dK/dV kernels: element e is key krow + 8 * (e / 2), query qcol + e %
// 2, where krow is the lane's key row (g of a 16-key row group) and qcol =
// q0 + 8j + 2t (the bits' query coordinate adds a.q_row0). The four
// lanes g & 3 = u of a quad (same t) hold one key
// group's four keys at both key rows and both queries: lane u draws the
// counter of element u (key group of row u / 2, query qcol + u % 2), and
// the words are traded by a 4 x 4 transpose over the quad's lanes (two
// rounds of two shuffles, each lane choosing by its own bits). With picks
// by a lane-dependent index in place of the transpose, the sm_90a dK/dV
// kernel's dropout variants took 0.16-0.19 ms a call more on the H100
// (torch_flash_bench.py, PERF.md). Every lane of the warp must call this
// together.
__device__ __forceinline__ void drop_cols_sm90(const FlashArgs& a, int64_t bh,
                                               int64_t krow, int64_t qcol,
                                               float (&f)[4]) {
  const int u = (threadIdx.x >> 2) & 3;
  const uint4 r = philox((uint32_t)(((krow - u) >> 2) + 2 * (u >> 1)),
                         (uint32_t)(a.q_row0 + qcol + (u & 1)), (uint32_t)bh,
                         a.seed);
  // lane u holds word w of counter u; lane u needs word u of counter e as
  // its element e. Round 1 swaps with lane u ^ 1 the words w with
  // (u ^ w) & 1, round 2 with lane u ^ 2 those with (u ^ w) & 2.
  const bool o1 = u & 1, o2 = u & 2;
  const uint32_t s0 = __shfl_xor_sync(0xffffffffu, o1 ? r.x : r.y, 4);
  const uint32_t s1 = __shfl_xor_sync(0xffffffffu, o1 ? r.z : r.w, 4);
  const uint32_t a0 = o1 ? s0 : r.x, a1 = o1 ? r.y : s0;
  const uint32_t a2 = o1 ? s1 : r.z, a3 = o1 ? r.w : s1;
  const uint32_t t0 = __shfl_xor_sync(0xffffffffu, o2 ? a0 : a2, 8);
  const uint32_t t1 = __shfl_xor_sync(0xffffffffu, o2 ? a1 : a3, 8);
  f[0] = keep_flag(a, o2 ? t0 : a0);
  f[1] = keep_flag(a, o2 ? t1 : a1);
  f[2] = keep_flag(a, o2 ? a2 : t0);
  f[3] = keep_flag(a, o2 ? a3 : t1);
}

// ---------------------------------------------------------------------------
// float32 dK/dV and dQ: 3xTF32 products on mma.sync, eight warps a block
// ---------------------------------------------------------------------------

// x = hi + lo with hi = x rounded to TF32 (to nearest, ties away from zero:
// half a TF32 ulp added to the bit pattern, the 13 low bits cleared) and lo
// = x - hi, exact in f32. lo goes to the tensor core as it is, which reads
// a TF32 operand's top 19 bits: lo loses at most 2^-21 |x|. Three integer
// and FP instructions (cvt.rna.tf32.f32 compiles to a longer sequence with
// a NaN test; the operands here are finite).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One m16n8k8 step of c += A B in 3xTF32: A's hi and lo fragments (split
// once, reused over a row of n-tiles), B's two values split here. The
// small products go first; lo * lo (about 2^-22 of the product) is dropped.
// The tensor core adds into c rounding toward zero, so a long chain into
// one accumulator drifts (4.5e-5 on dV at 1024 queries): every caller
// keeps its chains short and adds them into its sums in f32.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(c, alo, h0, h1);
  mma_tf32(c, ahi, l0, l1);
  mma_tf32(c, ahi, h0, h1);
}

template <int N>
__device__ __forceinline__ void add_into(float (&acc)[N][4],
                                         const float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += c[j][e];
}

// The A fragment of rows [16][k .. k+7] of a tile stored [row][depth]
// (stride ld) at `w`: element i is row g + 8 * (i & 1), depth k + t + 4 *
// (i >> 1), split into hi and lo.
__device__ __forceinline__ void load_a(const float* w, int ld, int k,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = w + g * ld + k + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * ld], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * ld + 4], hi[3], lo[3]);
}

// The A fragment of an m16n8 accumulator tile used as the left operand of
// the next product, whose depth runs over the tile's 8 columns: depth t is
// column 2t and depth t + 4 column 2t + 1 (the B operand reads its rows in
// the same order), so the values never leave the thread.
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// s = X Y^T for the warp's 16 rows of X (at `xw`) against N * 8 rows of Y
// (at `yw`), both stored [row][depth] with stride L::kD, over depth D: the
// scores of S = Q K^T (or S^T = K Q^T) and of dP = dO V^T (dP^T). Chains
// of four k-steps (32 of the depth), each added into s in f32.
template <int D, int N>
__device__ __forceinline__ void rows_product(float (&s)[N][4], const float* xw,
                                             const float* yw) {
  using L = Ld<float, D>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  zero(s);
  // not unrolled: unrolled, the hoisted loads took dQ at D 128 to 255
  // registers and 0.168 ms a call against 0.158 on the H100
#pragma unroll 1
  for (int kc = 0; kc < D; kc += 32) {
    float c[N][4];
    zero(c);
#pragma unroll
    for (int kk = kc; kk < kc + 32; kk += 8) {
      uint32_t ahi[4], alo[4];
      load_a(xw, L::kD, kk, ahi, alo);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float* yr = yw + (8 * j + g) * L::kD + kk + t;
        mma3(c[j], ahi, alo, yr[0], yr[4]);
      }
    }
    add_into(s, c);
  }
}

// acc[16][D] += C^T-as-A B: the warp's m16 x (N * 8) accumulator tiles c
// (P^T, dS^T or dS) times rows [N * 8][D] of a tile stored [row][depth] at
// `bw` (dO, Q or K). Chains of four k-steps (32 rows) for each n-tile of
// acc, each added into acc in f32.
template <int D, int N>
__device__ __forceinline__ void cols_product(float (&acc)[D / 8][4],
                                             const float (&c)[N][4],
                                             const float* bw) {
  using L = Ld<float, D>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ahi[N][4], alo[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) acc_as_a(c[j], ahi[j], alo[j]);
  static_assert(N % 4 == 0, "chains of four k-steps");
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j0 = 0; j0 < N; j0 += 4) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = j0; j < j0 + 4; ++j) {
        const float* br = bw + (8 * j + 2 * t) * L::kD + 8 * n + g;
        mma3(d, ahi[j], alo[j], br[0], br[L::kD]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += d[e];
    }
}

// Adds half 1's accumulators into half 0's (warp w + 4 into warp w, one
// fixed order), through shared memory `red` laid out by fragment position
// (conflict-free), after every warp is done with the tiles.
template <int N>
__device__ __forceinline__ void sum_halves(float* red, float (&acc)[N][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = red + (warp & 3) * N * 4 * 32 + lane;
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = acc[j][e];
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += mine[(4 * j + e) * 32];
  }
}

// dK/dV: grid (B*H, key tiles). A block owns 64 keys (K and V loaded
// once) and walks the query tiles of 64 through a two-stage cp.async
// ring; every product has keys as its rows. Warp w owns keys 16 * (w & 3)
// of the block; warps 0-3 compute S^T = K Q^T, P and dV += (P keep)^T dO,
// warps 4-7 dP^T = V dO^T, dS^T (with the P their partner hands over
// through shared memory) and dK += dS^T Q: two products each, one
// [16][D] accumulator a warp. Key tile 0 sees the most queries under
// causal masking and starts first.
template <int D, bool kVar>
__device__ __forceinline__ void dkv_f32_body(const FlashArgs& a) {
  using L = Ld<float, D>;
  extern __shared__ uint4 smem_u4[];
  constexpr int kTileElems = kTile * L::kD;
  float* ks = reinterpret_cast<float*>(smem_u4);  // [kTile][kD]
  float* vs = ks + kTileElems;                    // [kTile][kD]
  float* qds = vs + kTileElems;  // [2 stages][Q, dO][kTile][kD]
  float* rows = qds + 4 * kTileElems;  // [2 stages][LSE, delta][kTile]
  float* pbuf = rows + 4 * kTile;  // [4 row groups][16 * kTile], P^T

  const int64_t bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  // the keep bits' head coordinate: the model's head, not this launch's
  const int64_t dbh = b * a.heads_total + a.head_offset + h;
  const int64_t k0 = (int64_t)blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3;
  const bool is_p = warp < 4;  // the S^T / P / dV warp of its row group
  const int64_t off = a.Sk - a.Sq;
  const float* qg = slab<float>(a.q, b, h);
  const float* dog = slab<float>(a.dout, b, h);
  // Q, dO, LSE and delta of query tile qi into its stage
  auto fetch = [&](int qi) {
    const int64_t q0 = (int64_t)qi * kTile;
    float* dst = qds + (qi & 1) * 2 * kTileElems;
    float* r = rows + (qi & 1) * 2 * kTile;
    load_tile<float, D, kF32Threads>(dst, L::kD, qg, a.q.ss, q0, a.Sq);
    load_tile<float, D, kF32Threads>(dst + kTileElems, L::kD, dog, a.dout.ss,
                                     q0, a.Sq);
    load_row<kF32Threads>(r, a.lse + bh * a.Sq, q0, a.Sq);
    load_row<kF32Threads>(r + kTile, a.delta + bh * a.Sq, q0, a.Sq);
  };
  // first query tile holding a query that sees key k0
  int qt_begin = 0;
  if (a.causal && k0 - off > 0) qt_begin = (int)((k0 - off) / kTile);
  const int n_qt = (int)((a.Sq + kTile - 1) / kTile);
  load_tile<float, D, kF32Threads>(ks, L::kD, slab<float>(a.k, b, h), a.k.ss,
                                   k0, a.Sk);
  load_tile<float, D, kF32Threads>(vs, L::kD, slab<float>(a.v, b, h), a.v.ss,
                                   k0, a.Sk);
  fetch(qt_begin);
  cp_async_commit();

  float acc[D / 8][4];  // dV (warps 0-3) or dK (warps 4-7)
  zero(acc);
  const float sl2 = a.scale * kLog2e;
  const bool has_mask = kVar && a.has_mask;
  const bool has_drop = kVar && a.has_dropout;
  const float* mb = mask_slab(a, bh);
  const int64_t kfirst = k0 + 16 * wr, krow = kfirst + g;
  const float* xw = (is_p ? ks : vs) + 16 * wr * L::kD;
  float* pw = pbuf + wr * 16 * kTile + lane;

  for (int qi = qt_begin; qi < n_qt; ++qi) {
    const int64_t q0 = (int64_t)qi * kTile;
    const float* qs = qds + (qi & 1) * 2 * kTileElems;
    const float* dos = qs + kTileElems;
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

    // the row group's 16 keys, skipped where no query of the tile sees them
    const bool live =
        kfirst < a.Sk &&
        (!a.causal || min64(q0 + kTile - 1, a.Sq - 1) + off >= kfirst);
    if (live) {
      // S^T = K Q^T (warps 0-3) or dP^T = V dO^T (4-7): [16 keys][64]
      float s[kTile / 8][4];
      rows_product<D>(s, xw, is_p ? qs : dos);
      const bool full = all_visible<kTile, 16>(a, q0, kfirst);
      if (is_p) {
        // s becomes P^T times the keep flags; its partner gets P^T, a
        // dropped entry negated
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          float f[4] = {1.f, 1.f, 1.f, 1.f};
          const int c = 8 * j + 2 * t;
          if (has_drop) drop_cols_sm90(a, dbh, krow, q0 + c, f);
          const float lse2[2] = {lse_s[c] * kLog2e, lse_s[c + 1] * kLog2e};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t qpos = q0 + c + (e & 1), kpos = krow + 8 * (e >> 1);
            float p = 0.f;
            if (full || visible(a, qpos, kpos))
              p = has_mask
                      ? exp2f(add_mask(a, mb, qpos, kpos, s[j][e] * sl2) -
                              lse2[e & 1])
                      : exp2f(fmaf(s[j][e], sl2, -lse2[e & 1]));
            pw[(4 * j + e) * 32] = f[e] == 0.f ? -p : p;
            s[j][e] = p * f[e];
          }
        }
        sm90::bar_arrive(1 + wr, 64);
      } else {
        sm90::bar_sync(1 + wr, 64);  // the partner's P^T has landed
        // s becomes dS^T = P (dP keep / (1 - p) - delta) * scale
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float del[2] = {delta_s[c], delta_s[c + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ps = pw[(4 * j + e) * 32];
            const float dpe =
                has_drop ? (signbit(ps) ? 0.f : s[j][e] * a.drop_scale)
                         : s[j][e];
            s[j][e] = fabsf(ps) * (dpe - del[e & 1]) * a.scale;
          }
        }
      }
      // dV += (P keep)^T dO or dK += dS^T Q over the tile's 64 queries
      cols_product<D>(acc, s, is_p ? dos : qs);
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();

  const float ds = is_p && has_drop ? a.drop_scale : 1.f, mul[2] = {ds, ds};
  store_rows<float, D>(is_p ? a.dv : a.dk, b, h, krow, a.Sk, acc, mul);
}

// design: f32 3xTF32 mma.sync.m16n8k8, 64 keys x 64-query tiles, 8 warps:
//   a row group's two warps split S^T/P/dV and dP^T/dS^T/dK, P handed
//   over through shared memory; 2-stage cp.async
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_dkv_f32(const FlashArgs a) {
  if (a.has_mask || a.has_dropout)
    dkv_f32_body<D, true>(a);
  else
    dkv_f32_body<D, false>(a);
}

// dQ: grid (B*H, query tiles). A block owns 64 queries (Q and dO loaded
// once, LSE and delta in registers) and walks the key tiles of 64 through
// a two-stage cp.async ring. Warp w owns queries 16 * (w & 3) of the
// block and keys 32 * (w >> 2) of each tile, with its own dQ sums; the
// two halves are added at the end. Under causal masking the last query
// tile sees the most keys and starts first.
template <int D, bool kVar>
__device__ __forceinline__ void dq_f32_body(const FlashArgs& a) {
  using L = Ld<float, D>;
  extern __shared__ uint4 smem_u4[];
  constexpr int kTileElems = kTile * L::kD;
  float* qs = reinterpret_cast<float*>(smem_u4);  // [kTile][kD]
  float* dos = qs + kTileElems;                   // [kTile][kD]
  float* kvs = dos + kTileElems;  // [2 stages][K, V][kTile][kD]

  const int64_t bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  // the keep bits' head coordinate: the model's head, not this launch's
  const int64_t dbh = b * a.heads_total + a.head_offset + h;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, half = warp >> 2;
  const int64_t off = a.Sk - a.Sq;
  const float* kg = slab<float>(a.k, b, h);
  const float* vg = slab<float>(a.v, b, h);
  // K and V of key tile kj into its stage
  auto fetch = [&](int kj) {
    float* dst = kvs + (kj & 1) * 2 * kTileElems;
    load_tile<float, D, kF32Threads>(dst, L::kD, kg, a.k.ss,
                                     (int64_t)kj * kTile, a.Sk);
    load_tile<float, D, kF32Threads>(dst + kTileElems, L::kD, vg, a.v.ss,
                                     (int64_t)kj * kTile, a.Sk);
  };
  const int n_kt = key_tiles(a, q0);
  load_tile<float, D, kF32Threads>(qs, L::kD, slab<float>(a.q, b, h), a.q.ss,
                                   q0, a.Sq);
  load_tile<float, D, kF32Threads>(dos, L::kD, slab<float>(a.dout, b, h),
                                   a.dout.ss, q0, a.Sq);
  if (n_kt > 0) fetch(0);
  cp_async_commit();
  const int64_t qfirst = q0 + 16 * wr, qrow = qfirst + g;
  float lse2[2], delta[2];  // lse2: the row's LSE in base 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qpos = qrow + 8 * i;
    lse2[i] = qpos < a.Sq ? a.lse[bh * a.Sq + qpos] * kLog2e : 0.f;
    delta[i] = qpos < a.Sq ? a.delta[bh * a.Sq + qpos] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;

  float dq[D / 8][4];
  zero(dq);
  const bool has_mask = kVar && a.has_mask;
  const bool has_drop = kVar && a.has_dropout;
  const float* mb = mask_slab(a, bh);
  const float* qw = qs + 16 * wr * L::kD;
  const float* dow = dos + 16 * wr * L::kD;

  for (int kj = 0; kj < n_kt; ++kj) {
    const int64_t k0 = (int64_t)kj * kTile;
    const float* ks = kvs + (kj & 1) * 2 * kTileElems;
    const float* vs = ks + kTileElems;
    if (kj + 1 < n_kt) {
      fetch(kj + 1);  // into the stage the previous tile freed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and Q, dO) has landed for every thread

    // this warp's 32 keys, skipped whole where its 16 queries see none
    const int64_t kh = k0 + 32 * half;
    const bool live = qfirst < a.Sq && kh < a.Sk &&
                      (!a.causal || min64(qfirst + 15, a.Sq - 1) + off >= kh);
    if (live) {
      const float* kw = ks + 32 * half * L::kD;
      // S = Q K^T and dP = dO V^T: [16 queries][32 keys] each
      float s[4][4], dp[4][4];
      rows_product<D>(s, qw, kw);
      rows_product<D>(dp, dow, vs + 32 * half * L::kD);
      // s becomes dS
      const bool full = all_visible<16, 32>(a, qfirst, kh);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4] = {1.f, 1.f, 1.f, 1.f};
        const int64_t kcol = kh + 8 * j + 2 * t;
        if (has_drop) drop_rows(a, dbh, qrow, kcol, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int64_t qpos = qrow + 8 * i, kpos = kcol + (e & 1);
          float p = 0.f;
          if (full || visible(a, qpos, kpos))
            p = has_mask ? exp2f(add_mask(a, mb, qpos, kpos, s[j][e] * sl2) -
                                 lse2[i])
                         : exp2f(fmaf(s[j][e], sl2, -lse2[i]));
          const float dpe = has_drop ? dp[j][e] * (f[e] * a.drop_scale)
                                     : dp[j][e];
          s[j][e] = p * (dpe - delta[i]) * a.scale;
        }
      }
      // dQ += dS K over the 32 keys
      cols_product<D>(dq, s, kw);
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles' memory now holds the halves' sums

  sum_halves(reinterpret_cast<float*>(smem_u4), dq);
  if (half == 0) {
    const float one[2] = {1.f, 1.f};
    store_rows<float, D>(a.dq, b, h, qrow, a.Sq, dq, one);
  }
}

// design: f32 3xTF32 mma.sync.m16n8k8, 64 queries x 64-key tiles, 8
//   warps: a row group's two warps take the two key halves of each tile,
//   their dQ sums added half 0 then half 1; 2-stage cp.async
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_dq_f32(const FlashArgs a) {
  if (a.has_mask || a.has_dropout)
    dq_f32_body<D, true>(a);
  else
    dq_f32_body<D, false>(a);
}

// Forward: grid (B*H, query-tile slots). A block owns 64 queries at a time
// (Q in shared memory) and walks the key tiles of 64 through a two-stage
// cp.async ring. Warp w owns queries 16 * (w & 3) of the tile and keys 32 *
// (w >> 2) of each key tile, with its own online softmax (m, l) and O
// sums: S = Q K^T over its 32 keys, P = exp2(S - m) kept in registers as
// the A operand of O += P V (one chain of four k-steps into each n-tile of
// O, added after the alpha rescale). At the end the two key halves are
// merged through shared memory in one order: m = max(m0, m1), each half's
// O and l scaled by exp2(m_h - m), half 1 added into half 0. Under causal
// masking a block takes query tiles n - 1 - p and p, the heaviest first,
// so every block of a batch*head visits n + 1 key tiles.
template <int D, bool kVar>
__device__ __forceinline__ void fwd_f32_body(const FlashArgs& a) {
  using L = Ld<float, D>;
  extern __shared__ uint4 smem_u4[];
  constexpr int kTileElems = kTile * L::kD;
  float* qs = reinterpret_cast<float*>(smem_u4);  // [kTile][kD]
  float* kvs = qs + kTileElems;  // [2 stages][K, V][kTile][kD]
  // the halves' merge, over the tiles' memory once they are done with:
  float* red = qs;                           // O, as sum_halves lays it out
  float* mrow = red + 4 * (D / 8) * 4 * 32;  // [half][row group][lane][2]
  float* lrow = mrow + 2 * 4 * 32 * 2;       // [row group][lane][2]

  const int64_t bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  // the keep bits' head coordinate: the model's head, not this launch's
  const int64_t dbh = b * a.heads_total + a.head_offset + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, half = warp >> 2;
  const int64_t off = a.Sk - a.Sq;
  const float* kg = slab<float>(a.k, b, h);
  const float* vg = slab<float>(a.v, b, h);
  // K and V of key tile kj into its stage
  auto fetch = [&](int kj) {
    float* dst = kvs + (kj & 1) * 2 * kTileElems;
    load_tile<float, D>(dst, L::kD, kg, a.k.ss, (int64_t)kj * kTile, a.Sk);
    load_tile<float, D>(dst + kTileElems, L::kD, vg, a.v.ss,
                        (int64_t)kj * kTile, a.Sk);
  };
  const float sl2 = a.scale * kLog2e;
  const bool has_mask = kVar && a.has_mask;
  const bool has_drop = kVar && a.has_dropout;
  const float* mb = mask_slab(a, bh);
  // causal: query tile n - 1 - p (the heavier) then tile p; otherwise p
  const int n_qt = (int)((a.Sq + kTile - 1) / kTile), p = blockIdx.y;
  const int first = a.causal ? n_qt - 1 - p : p;
  const int n_tiles = a.causal && p < first ? 2 : 1;

  for (int it = 0; it < n_tiles; ++it) {
    const int64_t q0 = (int64_t)(it == 0 ? first : p) * kTile;
    const int n_kt = key_tiles(a, q0);
    __syncthreads();  // the previous tile's merge is done with this memory
    load_tile<float, D>(qs, L::kD, slab<float>(a.q, b, h), a.q.ss, q0, a.Sq);
    if (n_kt > 0) fetch(0);
    cp_async_commit();

    float o[D / 8][4];
    zero(o);
    // m is the running row max of the base-2 scores s * scale * log2(e)
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const int64_t qfirst = q0 + 16 * wr, qrow = qfirst + g;
    const float* qw = qs + 16 * wr * L::kD;

    for (int kj = 0; kj < n_kt; ++kj) {
      const int64_t k0 = (int64_t)kj * kTile;
      const float* ks = kvs + (kj & 1) * 2 * kTileElems;
      const float* vs = ks + kTileElems;
      if (kj + 1 < n_kt) {
        fetch(kj + 1);  // into the stage the previous tile freed
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this tile (and Q) has landed for every thread

      // this warp's 32 keys, skipped whole where its 16 queries see none
      const int64_t kh = k0 + 32 * half;
      const bool live =
          qfirst < a.Sq && kh < a.Sk &&
          (!a.causal || min64(qfirst + 15, a.Sq - 1) + off >= kh);
      if (live) {
        // S = Q K^T: [16 queries][32 keys]
        float s[4][4];
        rows_product<D>(s, qw, ks + 32 * half * L::kD);
        // rows past Sq are masked whole: finite garbage, never stored
        const bool full = all_visible<16, 32>(a, qfirst, kh);
        // the mask's values of the lane's two rows start at mrow[i] + kcol
        // (taken once a tile: 64-bit addresses per score made the D 128
        // variant spill)
        const float* mrow[2] = {mb, mb};
        int64_t kcol = 0;
        if (has_mask) {
          mrow[0] = mb + qrow * a.mask.sq;
          mrow[1] = mrow[0] + 8 * a.mask.sq;
          kcol = (kh + 2 * t) * a.mask.sk;
        }
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t qpos = qrow + 8 * (e >> 1);
            const int64_t kpos = kh + 8 * j + 2 * t + (e & 1);
            const bool seen = full || visible(a, qpos, kpos);
            float x = seen ? s[j][e] * sl2 : kNegInf;
            if (has_mask && seen)
              x = add_mask_at(
                  mrow[e >> 1] + kcol + (8 * j + (e & 1)) * a.mask.sk, x);
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
        // s becomes P times the keep flags
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float f[4] = {1.f, 1.f, 1.f, 1.f};
          if (has_drop) drop_rows(a, dbh, qrow, kh + 8 * j + 2 * t, f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = exp2f(s[j][e] - m[e >> 1]);
            // l takes the unrounded p before dropout, as on the TPU
            sum[e >> 1] += pe;
            s[j][e] = pe * f[e];
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
        // O += P V over the 32 keys: one chain of four k-steps an n-tile
        cols_product<D>(o, s, vs + 32 * half * L::kD);
      }
      __syncthreads();  // every warp is done with this stage before its refill
    }
    cp_async_wait<0>();
    __syncthreads();  // the tiles' memory now holds the halves' merge

    // each half rescales to the joint max; half 1 is added into half 0
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mrow[((half * 4 + wr) * 32 + lane) * 2 + i] = m[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float other = mrow[(((half ^ 1) * 4 + wr) * 32 + lane) * 2 + i];
      const float mm = fmaxf(m[i], other);
      const float f = exp2f(m[i] - mm);
      l[i] *= f;
      m[i] = mm;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * i] *= f;
        o[j][2 * i + 1] *= f;
      }
    }
    if (half == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) lrow[(wr * 32 + lane) * 2 + i] = l[i];
    }
    sum_halves(red, o);  // (its barrier also lands half 1's l)
    if (half == 0) {
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float lc = fmaxf(l[i] + lrow[(wr * 32 + lane) * 2 + i], 1e-30f);
        inv[i] = (has_drop ? a.drop_scale : 1.f) / lc;
        const int64_t qpos = qrow + 8 * i;
        if (t == 0 && qpos < a.Sq)
          a.lse[bh * a.Sq + qpos] = m[i] * kLn2 + logf(lc);
      }
      store_rows<float, D>(a.o, b, h, qrow, a.Sq, o, inv);
      if (kVar && a.o32.p)
        store_rows<float, D>(a.o32, b, h, qrow, a.Sq, o, inv);
    }
  }
}

// design: f32 3xTF32 mma.sync.m16n8k8, 64 queries x 64-key tiles, 8
//   warps: a row group's two warps take the two key halves of each tile,
//   each with its own online softmax, merged half 0 then half 1; P in
//   registers; causal blocks pair query tiles n-1-p and p; 2-stage
//   cp.async; a kernel without and one with the mask / dropout code
template <int D, bool kVar>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_fwd_f32(const FlashArgs a) {
  fwd_f32_body<D, kVar>(a);
}

// ---------------------------------------------------------------------------
// bf16 forward and dK/dV on sm_90a: one producer warpgroup (TMA) and two
// consumer warpgroups (wgmma), the products' P and dS kept in registers
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWg = 128;                // threads of a warpgroup
constexpr int kSm90Threads = 3 * kWg;   // producer, consumer 0, consumer 1
constexpr int kRowBytes = 128;          // a row of one 64-column block
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Shared memory of the forward (byte offsets from a 1024-byte aligned
// base): Q [128][D] once, a ring of K and V [128][D] tiles with the key
// tile's f32 mask values (a key-only mask), and the barriers. Each tile is
// D / 64 column blocks of [128][64] (kBox bytes), 128-byte swizzled.
template <int D> struct FwdSm90 {
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kBox = 128 * kRowBytes;
  static constexpr int kTileB = D / 64 * kBox;
  static constexpr int kQ = 0, kK = kTileB, kV = kK + kStages * kTileB;
  static constexpr int kMask = kV + kStages * kTileB;   // f32 [stages][128]
  static constexpr int kBar = kMask + kStages * 128 * 4;  // q, full, empty
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// Named barriers of the consumers' ping-pong: barrier 1 + c lets consumer
// c issue its products (id 0 is __syncthreads).
constexpr int kPingPong = 2 * kWg;

// kMask: 0 none, 1 a key-only mask ([B, 1, 1, Sk], staged per key tile),
// 2 any other mask (read per element); kDrop: dropout.
template <int D, int kMask, bool kDrop>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_fwd_sm90(const __grid_constant__ FlashArgs a,
                   const __grid_constant__ TmaMaps tm) {
  using L = FwdSm90<D>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_sm90[];
  const uint32_t raw = sm90::smem_u32(smem_sm90);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const auto full = [&](int s) { return bar_q + 8 + 8 * s; };
  const auto empty = [&](int s) { return bar_q + 8 + 8 * (S + s); };
  float* mask_s = reinterpret_cast<float*>(smem_sm90 + (base - raw) + L::kMask);

  constexpr bool has_mask = kMask != 0, key_mask = kMask == 1;
  constexpr bool has_drop = kDrop;
  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // the keep bits' head coordinate: the model's head, not this launch's
  const int64_t dbh = b * a.heads_total + a.head_offset + h;
  // causal: the query tiles with the most key tiles start first
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int64_t q0 = (int64_t)qt * 128;
  const int n_kt = key_tiles<128, 128>(a, q0);
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      // TMA's arrival, and the mask loader warp's 32 lanes
      sm90::mbar_init(full(s), key_mask ? 33 : 1);
      sm90::mbar_init(empty(s), 8);  // the consumers' eight warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {
    // producer: one thread issues every TMA load; warp 1 stages the mask
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      sm90::mbar_expect_tx(bar_q, L::kTileB);
      for (int c = 0; c < D / 64; ++c)
        sm90::tma_load_4d(base + L::kQ + c * L::kBox, &tm.q, bar_q, c * 64,
                          (int)h, (int)q0, (int)b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S;
        sm90::mbar_wait(empty(s), ((kt / S) & 1) ^ 1);
        sm90::mbar_expect_tx(full(s), 2 * L::kTileB);
        for (int c = 0; c < D / 64; ++c) {
          const uint32_t off = s * L::kTileB + c * L::kBox;
          sm90::tma_load_4d(base + L::kK + off, &tm.k, full(s), c * 64, (int)h,
                            kt * 128, (int)b);
          sm90::tma_load_4d(base + L::kV + off, &tm.v, full(s), c * 64, (int)h,
                            kt * 128, (int)b);
        }
      }
    } else if (warp == 1 && key_mask) {
      const float* mrow = a.mask.p + b * a.mask.sb;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S;
        sm90::mbar_wait(empty(s), ((kt / S) & 1) ^ 1);
        for (int i = lane; i < 128; i += 32) {
          // plain loads: a row of Sk f32 values need not suit a bulk copy
          const int64_t kpos = (int64_t)kt * 128 + i;
          mask_s[s * 128 + i] = kpos < a.Sk ? __ldg(mrow + kpos * a.mask.sk) : 0.f;
        }
        sm90::mbar_arrive(full(s));
      }
    }
    return;
  }

  // consumer c owns query rows [q0 + 64 c, q0 + 64 c + 64)
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % kWg, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t qc0 = q0 + 64 * c;
  const int64_t qrow = qc0 + 16 * w + g;  // and qrow + 8
  const float sl2 = a.scale * kLog2e;
  const float* mb = mask_slab(a, bh);
  const uint32_t qa = base + L::kQ + c * 64 * kRowBytes;

  float o[D / 8][4];
  zero(o);
  // m is the running row max of the base-2 scores s * scale * log2(e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[16][4];     // a tile's scores, then its P (dropped entries zero)
  uint32_t p[8][4];   // P in bf16: the A operand of O += P V
  float alpha[2];     // this tile's rescale of O

  // S = Q K^T of key tile kt (issued, not waited for)
  const auto issue_s = [&](int kt) {
    const int st = kt % S;
    sm90::mbar_wait(full(st), (kt / S) & 1);
    const uint32_t kb = base + L::kK + st * L::kTileB;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kBox + (kk % 4) * 32;
      sm90::wgmma_ss(s, sm90::desc_sw128(qa + off, 16, 1024),
                     sm90::desc_sw128(kb + off, 16, 1024), kk > 0);
    }
  };
  // O += P V of key tile kt; V [keys][D] is read MN-major, as stored
  const auto issue_pv = [&](int kt) {
    const uint32_t vb = base + L::kV + (kt % S) * L::kTileB;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      sm90::wgmma_rs(o, p[kk], sm90::desc_sw128(vb + kk * 16 * kRowBytes,
                                                 L::kBox, 1024),
                     1);
  };
  const auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(kt % S));
  };
  // the online softmax of tile kt: s becomes P (times the keep flags), m
  // and l move on, alpha is O's rescale
  const auto softmax = [&](int kt) {
    const int64_t k0 = (int64_t)kt * 128;
    const bool all = all_visible<64, 128>(a, qc0, k0);
    // row i sees the tile's columns [0, lim[i]): keys past Sk and, with
    // causal masking, past the diagonal are hidden; rows past Sq see none
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t qpos = qrow + 8 * i;
      const int64_t hi =
          a.causal ? min64(a.Sk, qpos + a.Sk - a.Sq + 1) : a.Sk;
      lim[i] = qpos >= a.Sq || hi <= k0 ? 0 : (int)min64(hi - k0, 128);
    }
    const float* ms = mask_s + (kt % S) * 128;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const bool live = all || col < lim[e >> 1];
        float x = live ? s[j][e] * sl2 : kNegInf;
        if (has_mask && live)
          x = key_mask ? fmaxf(fmaf(ms[col], kLog2e, x), kNegInf)
                       : add_mask(a, mb, qrow + 8 * (e >> 1), k0 + col, x);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = sm90::exp2_approx(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (has_drop) drop_rows(a, dbh, qrow, k0 + 8 * j + 2 * t, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = sm90::exp2_approx(s[j][e] - m[e >> 1]);
        sum[e >> 1] += pe;  // l takes P before dropout, as on the TPU
        s[j][e] = has_drop ? pe * f[e] : pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
  };
  const auto pack_p = [&] {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) sm90::pack_a(p[kk], s[2 * kk], s[2 * kk + 1]);
  };

  // Consumer 0 issues first; each then lets the other issue once its own
  // products are queued, so one's softmax runs beside the other's products.
  const int me = 1 + c, other = 2 - c;
  if (c == 1) sm90::bar_arrive(1, kPingPong);
  sm90::mbar_wait(bar_q, 0);
  if (n_kt > 0) {
    sm90::bar_sync(me, kPingPong);
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_commit();
    sm90::bar_arrive(other, kPingPong);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    softmax(0);
    pack_p();
    // tile kt's S = Q K^T runs beside tile kt - 1's O += P V
    for (int kt = 1; kt < n_kt; ++kt) {
      sm90::bar_sync(me, kPingPong);
      sm90::wgmma_fence();
      issue_s(kt);
      sm90::wgmma_commit();
      issue_pv(kt - 1);
      sm90::wgmma_commit();
      sm90::bar_arrive(other, kPingPong);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      softmax(kt);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(p);
      release(kt - 1);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
      pack_p();
    }
    sm90::wgmma_fence();
    issue_pv(n_kt - 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(p);
    release(n_kt - 1);
  }
  if (c == 0) sm90::bar_sync(1, kPingPong);  // consumer 1's last arrival

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
    inv[i] = (has_drop ? a.drop_scale : 1.f) / lc;
    const int64_t qpos = qrow + 8 * i;
    if (t == 0 && qpos < a.Sq)
      a.lse[bh * a.Sq + qpos] = m[i] * kLn2 + logf(lc);
  }
  store_rows<bf16, D>(a.o, b, h, qrow, a.Sq, o, inv);
  if (kDrop && a.o32.p) store_rows<float, D>(a.o32, b, h, qrow, a.Sq, o, inv);
}

// Shared memory of dK/dV: K and V [128][D] of the block's key tile once,
// a ring of Q and dO [64][D] tiles with their f32 LSE and delta rows, and
// the barriers.
template <int D> struct DkvSm90 {
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kKBox = 128 * kRowBytes;  // a block of K or V
  static constexpr int kQBox = 64 * kRowBytes;   // a block of Q or dO
  static constexpr int kKV = D / 64 * kKBox, kQD = D / 64 * kQBox;
  static constexpr int kK = 0, kV = kKV, kQ = 2 * kKV;
  static constexpr int kDO = kQ + kStages * kQD;
  static constexpr int kRows = kDO + kStages * kQD;  // f32 [stages][2][64]
  static constexpr int kBar = kRows + kStages * 2 * 64 * 4;  // kv, full, empty
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int kMask, bool kDrop>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dkv_sm90(const __grid_constant__ FlashArgs a,
                   const __grid_constant__ TmaMaps tm) {
  using L = DkvSm90<D>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_sm90[];
  const uint32_t raw = sm90::smem_u32(smem_sm90);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_kv = base + L::kBar;
  const auto full = [&](int s) { return bar_kv + 8 + 8 * s; };
  const auto empty = [&](int s) { return bar_kv + 8 + 8 * (S + s); };
  float* rows_s = reinterpret_cast<float*>(smem_sm90 + (base - raw) + L::kRows);

  constexpr bool has_mask = kMask != 0, key_mask = kMask == 1;
  constexpr bool has_drop = kDrop;
  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // the keep bits' head coordinate: the model's head, not this launch's
  const int64_t dbh = b * a.heads_total + a.head_offset + h;
  const int64_t k0 = (int64_t)blockIdx.x * 128;
  const int64_t off = a.Sk - a.Sq;
  // first query tile holding a query that sees key k0
  int qt_begin = 0;
  if (a.causal && k0 - off > 0) qt_begin = (int)((k0 - off) / 64);
  const int n_qt = (int)((a.Sq + 63) / 64);
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(full(s), 33);  // TMA's arrival and the row loader's
      sm90::mbar_init(empty(s), 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {
    // producer: one thread issues every TMA load; warp 1 loads LSE and
    // delta (plain loads: a row of Sq f32 values need not suit a bulk copy)
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      sm90::mbar_expect_tx(bar_kv, 2 * L::kKV);
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(base + L::kK + c * L::kKBox, &tm.k, bar_kv, c * 64,
                          (int)h, (int)k0, (int)b);
        sm90::tma_load_4d(base + L::kV + c * L::kKBox, &tm.v, bar_kv, c * 64,
                          (int)h, (int)k0, (int)b);
      }
      for (int qi = qt_begin; qi < n_qt; ++qi) {
        const int i = qi - qt_begin, s = i % S;
        sm90::mbar_wait(empty(s), ((i / S) & 1) ^ 1);
        sm90::mbar_expect_tx(full(s), 2 * L::kQD);
        for (int c = 0; c < D / 64; ++c) {
          const uint32_t o = s * L::kQD + c * L::kQBox;
          sm90::tma_load_4d(base + L::kQ + o, &tm.q, full(s), c * 64, (int)h,
                            qi * 64, (int)b);
          sm90::tma_load_4d(base + L::kDO + o, &tm.dout, full(s), c * 64,
                            (int)h, qi * 64, (int)b);
        }
      }
    } else if (warp == 1) {
      const float* lse = a.lse + bh * a.Sq;
      const float* delta = a.delta + bh * a.Sq;
      for (int qi = qt_begin; qi < n_qt; ++qi) {
        const int i = qi - qt_begin, s = i % S;
        sm90::mbar_wait(empty(s), ((i / S) & 1) ^ 1);
        for (int r = lane; r < 64; r += 32) {
          const int64_t qpos = (int64_t)qi * 64 + r;
          const bool in = qpos < a.Sq;
          rows_s[s * 128 + r] = in ? lse[qpos] : 0.f;
          rows_s[s * 128 + 64 + r] = in ? delta[qpos] : 0.f;
        }
        sm90::mbar_arrive(full(s));
      }
    }
    return;
  }

  // consumer c owns keys [k0 + 64 c, k0 + 64 c + 64); every product has
  // keys as its rows
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % kWg, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t kc0 = k0 + 64 * c;
  const int64_t krow = kc0 + 16 * w + g;  // and krow + 8
  const float sl2 = a.scale * kLog2e;
  const float* mb = mask_slab(a, bh);
  const uint32_t ka = base + L::kK + c * 64 * kRowBytes;
  const uint32_t va = base + L::kV + c * 64 * kRowBytes;
  // a key-only mask is constant along this thread's two key rows
  float mk[2] = {0.f, 0.f};
  if (key_mask)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (krow + 8 * i < a.Sk) mk[i] = __ldg(mb + (krow + 8 * i) * a.mask.sk);

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  sm90::mbar_wait(bar_kv, 0);
  for (int qi = qt_begin; qi < n_qt; ++qi) {
    const int i = qi - qt_begin, s = i % S;
    const int64_t q0 = (int64_t)qi * 64;
    sm90::mbar_wait(full(s), (i / S) & 1);
    const uint32_t qb = base + L::kQ + s * L::kQD;
    const uint32_t dob = base + L::kDO + s * L::kQD;
    const float* lse_s = rows_s + s * 128;
    const float* delta_s = lse_s + 64;

    // S^T = K Q^T and dP^T = V dO^T, all four operands K-major
    float st[8][4], dpt[8][4];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk / 4) * L::kKBox + (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * L::kQBox + (kk % 4) * 32;
      sm90::wgmma_ss(st, sm90::desc_sw128(ka + ko, 16, 1024),
                     sm90::desc_sw128(qb + qo, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk / 4) * L::kKBox + (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * L::kQBox + (kk % 4) * 32;
      sm90::wgmma_ss(dpt, sm90::desc_sw128(va + ko, 16, 1024),
                     sm90::desc_sw128(dob + qo, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // P^T (times the keep flags) and its bf16 rounding residual for dV,
    // dS^T for dK, packed as A operands: n-tile j is depth step j / 2
    const bool all = all_visible<64, 64>(a, q0, kc0);
    // key row i sees the tile's query columns [lo[i], hi[i])
    int lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t kpos = krow + 8 * i, first = kpos - off - q0;
      hi[i] = kpos < a.Sk ? (int)min64(64, a.Sq - q0) : 0;
      lo[i] = !a.causal || first < 0 ? 0 : (int)min64(first, 64);
    }
    uint32_t pa[4][4], ra[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (has_drop) drop_cols_sm90(a, dbh, krow, q0 + 8 * j + 2 * t, f);
      float pk[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int r = e >> 1;  // the key row, krow + 8 r
        const float lse2 = lse_s[col] * kLog2e;
        float p = 0.f;
        if (all || (col >= lo[r] && col < hi[r])) {
          if (has_mask) {
            const float x = st[j][e] * sl2;
            p = sm90::exp2_approx(
                (key_mask ? fmaxf(fmaf(mk[r], kLog2e, x), kNegInf)
                          : add_mask(a, mb, q0 + col, krow + 8 * r, x)) -
                lse2);
          } else {
            p = sm90::exp2_approx(fmaf(st[j][e], sl2, -lse2));
          }
        }
        pk[e] = has_drop ? p * f[e] : p;
        const float dpe =
            has_drop ? dpt[j][e] * (f[e] * a.drop_scale) : dpt[j][e];
        ds[e] = p * (dpe - delta_s[col]) * a.scale;
      }
      const int kk = j / 2, r = 2 * (j % 2);  // depth step, register pair
      pa[kk][r] = sm90::pack_bf16(pk[0], pk[1]);
      pa[kk][r + 1] = sm90::pack_bf16(pk[2], pk[3]);
      if (has_drop) {
        float rk[4];  // P keep minus its bf16 rounding
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rk[e] = pk[e] - __bfloat162float(__float2bfloat16_rn(pk[e]));
        ra[kk][r] = sm90::pack_bf16(rk[0], rk[1]);
        ra[kk][r + 1] = sm90::pack_bf16(rk[2], rk[3]);
      }
      dsa[kk][r] = sm90::pack_bf16(ds[0], ds[1]);
      dsa[kk][r + 1] = sm90::pack_bf16(ds[2], ds[3]);
    }
    // dV += (P keep)^T dO (+ the residual's product under dropout: with
    // dropout the largest dV entries carry P's bf16 rounding through a
    // 1 / (1 - p) gain), dK += dS^T Q; dO and Q are read MN-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs(dv, pa[kk], sm90::desc_sw128(dob + kk * 16 * kRowBytes,
                                                  L::kQBox, 1024),
                     1);
    if (has_drop)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs(dv, ra[kk],
                       sm90::desc_sw128(dob + kk * 16 * kRowBytes, L::kQBox,
                                        1024),
                       1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs(dk, dsa[kk], sm90::desc_sw128(qb + kk * 16 * kRowBytes,
                                                   L::kQBox, 1024),
                     1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    sm90::fence_regs(pa);
    if (has_drop) sm90::fence_regs(ra);
    sm90::fence_regs(dsa);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(s));
  }

  const float one[2] = {1.f, 1.f};
  const float dsc = has_drop ? a.drop_scale : 1.f, dscale[2] = {dsc, dsc};
  store_rows<bf16, D>(a.dk, b, h, krow, a.Sk, dk, one);
  store_rows<bf16, D>(a.dv, b, h, krow, a.Sk, dv, dscale);
}

// Shared memory of dQ: Q and dO [128][D] of the block's query tile once, a
// ring of K and V [kKT][D] tiles with the key tile's f32 mask values (a
// key-only mask), and the barriers. Key tiles are 64 wide: S and dP take
// 32 registers each, so the next tile's S and dP fit beside the dQ
// accumulator while this tile's dQ product runs. (128-key tiles at D 64
// spilled under dropout and ran the ERNIE shape's mask + dropout case 15 %
// slower on the H100, torch_flash_bench.py.)
template <int D> struct DqSm90 {
  static constexpr int kKT = 64;
  static constexpr int kStages = 4;
  static constexpr int kQBox = 128 * kRowBytes;  // a block of Q or dO
  static constexpr int kKBox = kKT * kRowBytes;  // a block of K or V
  static constexpr int kQD = D / 64 * kQBox, kKV = D / 64 * kKBox;
  static constexpr int kQ = 0, kDO = kQD, kK = 2 * kQD;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kMask = kV + kStages * kKV;         // f32 [stages][kKT]
  static constexpr int kBar = kMask + kStages * kKT * 4;   // q, full, empty
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int kMask, bool kDrop>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dq_sm90(const __grid_constant__ FlashArgs a,
                  const __grid_constant__ TmaMaps tm) {
  using L = DqSm90<D>;
  constexpr int S = L::kStages, KT = L::kKT;
  extern __shared__ uint8_t smem_sm90[];
  const uint32_t raw = sm90::smem_u32(smem_sm90);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const auto full = [&](int s) { return bar_q + 8 + 8 * s; };
  const auto empty = [&](int s) { return bar_q + 8 + 8 * (S + s); };
  float* mask_s = reinterpret_cast<float*>(smem_sm90 + (base - raw) + L::kMask);

  constexpr bool has_mask = kMask != 0, key_mask = kMask == 1;
  constexpr bool has_drop = kDrop;
  const int64_t bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  // the keep bits' head coordinate: the model's head, not this launch's
  const int64_t dbh = b * a.heads_total + a.head_offset + h;
  // causal: the query tiles with the most key tiles start first
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int64_t q0 = (int64_t)qt * 128;
  const int n_kt = key_tiles<128, KT>(a, q0);
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      // TMA's arrival, and the mask loader warp's 32 lanes
      sm90::mbar_init(full(s), key_mask ? 33 : 1);
      sm90::mbar_init(empty(s), 8);  // the consumers' eight warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {
    // producer: one thread issues every TMA load; warp 1 stages the mask
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      sm90::mbar_expect_tx(bar_q, 2 * L::kQD);
      for (int c = 0; c < D / 64; ++c) {
        sm90::tma_load_4d(base + L::kQ + c * L::kQBox, &tm.q, bar_q, c * 64,
                          (int)h, (int)q0, (int)b);
        sm90::tma_load_4d(base + L::kDO + c * L::kQBox, &tm.dout, bar_q,
                          c * 64, (int)h, (int)q0, (int)b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S;
        sm90::mbar_wait(empty(s), ((kt / S) & 1) ^ 1);
        sm90::mbar_expect_tx(full(s), 2 * L::kKV);
        for (int c = 0; c < D / 64; ++c) {
          const uint32_t off = s * L::kKV + c * L::kKBox;
          sm90::tma_load_4d(base + L::kK + off, &tm.k, full(s), c * 64, (int)h,
                            kt * KT, (int)b);
          sm90::tma_load_4d(base + L::kV + off, &tm.v, full(s), c * 64, (int)h,
                            kt * KT, (int)b);
        }
      }
    } else if (warp == 1 && key_mask) {
      const float* mrow = a.mask.p + b * a.mask.sb;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S;
        sm90::mbar_wait(empty(s), ((kt / S) & 1) ^ 1);
        for (int i = lane; i < KT; i += 32) {
          const int64_t kpos = (int64_t)kt * KT + i;
          mask_s[s * KT + i] = kpos < a.Sk ? __ldg(mrow + kpos * a.mask.sk) : 0.f;
        }
        sm90::mbar_arrive(full(s));
      }
    }
    return;
  }

  // consumer c owns query rows [q0 + 64 c, q0 + 64 c + 64); c is
  // broadcast from lane 0 so that ptxas sees it warp-uniform: the loops
  // below run to a bound that depends on c, and a bound ptxas takes for
  // divergent makes it serialise every wgmma of the kernel (C7520)
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int c = __shfl_sync(0xffffffffu, wg, 0) - 1;
  const int tid = threadIdx.x % kWg, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t qc0 = q0 + 64 * c;
  const int64_t qrow = qc0 + 16 * w + g;  // and qrow + 8
  const float sl2 = a.scale * kLog2e;
  const float* mb = mask_slab(a, bh);
  const uint32_t qa = base + L::kQ + c * 64 * kRowBytes;
  const uint32_t da = base + L::kDO + c * 64 * kRowBytes;
  // the key tiles that hold a key one of this consumer's rows sees (the
  // block's later tiles, causal, are only waited for and released)
  const int n_mine = qc0 < a.Sq ? key_tiles<64, KT>(a, qc0) : 0;
  float lse2[2], delta[2];  // lse2: the row's LSE in base 2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qpos = qrow + 8 * i;
    lse2[i] = qpos < a.Sq ? a.lse[bh * a.Sq + qpos] * kLog2e : 0.f;
    delta[i] = qpos < a.Sq ? a.delta[bh * a.Sq + qpos] : 0.f;
  }

  float dq[D / 8][4];
  zero(dq);
  float s[KT / 8][4];    // a tile's scores, then its dS
  float dp[KT / 8][4];   // dO V^T
  uint32_t ds[KT / 16][4];  // dS in bf16: the A operand of dQ += dS K

  // S = Q K^T and dP = dO V^T of key tile kt, all four operands K-major
  // (issued, not waited for)
  const auto issue_sdp = [&](int kt) {
    const int st = kt % S;
    sm90::mbar_wait(full(st), (kt / S) & 1);
    const uint32_t kb = base + L::kK + st * L::kKV;
    const uint32_t vb = base + L::kV + st * L::kKV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qo = (kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * L::kKBox + (kk % 4) * 32;
      sm90::wgmma_ss(s, sm90::desc_sw128(qa + qo, 16, 1024),
                     sm90::desc_sw128(kb + ko, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qo = (kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * L::kKBox + (kk % 4) * 32;
      sm90::wgmma_ss(dp, sm90::desc_sw128(da + qo, 16, 1024),
                     sm90::desc_sw128(vb + ko, 16, 1024), kk > 0);
    }
  };
  // dQ += dS K of key tile kt; K [keys][D] is read MN-major, from the same
  // swizzled tile that served Q K^T
  const auto issue_dq = [&](int kt) {
    const uint32_t kb = base + L::kK + (kt % S) * L::kKV;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      sm90::wgmma_rs(dq, ds[kk], sm90::desc_sw128(kb + kk * 16 * kRowBytes,
                                                   L::kKBox, 1024),
                     1);
  };
  const auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(kt % S));
  };
  // dS of tile kt in place of its scores: p = exp(s - lse) recomputed,
  // dS = P (dP D - delta) * scale, D the dropout factor keep / (1 - p)
  const auto grad_s = [&](int kt) {
    const int64_t k0 = (int64_t)kt * KT;
    const bool all = all_visible<64, KT>(a, qc0, k0);
    // row i sees the tile's columns [0, lim[i]): keys past Sk and, with
    // causal masking, past the diagonal are hidden; rows past Sq see none
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t qpos = qrow + 8 * i;
      const int64_t hi =
          a.causal ? min64(a.Sk, qpos + a.Sk - a.Sq + 1) : a.Sk;
      lim[i] = qpos >= a.Sq || hi <= k0 ? 0 : (int)min64(hi - k0, KT);
    }
    const float* ms = mask_s + (kt % S) * KT;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (has_drop) drop_rows(a, dbh, qrow, k0 + 8 * j + 2 * t, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int r = e >> 1;  // the query row, qrow + 8 r
        float p = 0.f;
        if (all || col < lim[r]) {
          if (has_mask) {
            const float x = s[j][e] * sl2;
            p = sm90::exp2_approx(
                (key_mask ? fmaxf(fmaf(ms[col], kLog2e, x), kNegInf)
                          : add_mask(a, mb, qrow + 8 * r, k0 + col, x)) -
                lse2[r]);
          } else {
            p = sm90::exp2_approx(fmaf(s[j][e], sl2, -lse2[r]));
          }
        }
        const float dpe =
            has_drop ? dp[j][e] * (f[e] * a.drop_scale) : dp[j][e];
        s[j][e] = p * (dpe - delta[r]) * a.scale;
      }
    }
  };
  const auto pack_ds = [&] {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      sm90::pack_a(ds[kk], s[2 * kk], s[2 * kk + 1]);
  };

  // Consumer 0 issues first; each then lets the other issue once its own
  // products are queued, so one's dS work runs beside the other's products.
  // Both take part in the ping-pong for each of the block's n_kt tiles.
  const int me = 1 + c, other = 2 - c;
  if (c == 1) sm90::bar_arrive(1, kPingPong);
  sm90::mbar_wait(bar_q, 0);
  if (n_mine > 0) {
    sm90::bar_sync(me, kPingPong);
    sm90::wgmma_fence();
    issue_sdp(0);
    sm90::wgmma_commit();
    sm90::bar_arrive(other, kPingPong);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    grad_s(0);
    pack_ds();
    // tile kt's S and dP run beside tile kt - 1's dQ += dS K
    for (int kt = 1; kt < n_mine; ++kt) {
      sm90::bar_sync(me, kPingPong);
      sm90::wgmma_fence();
      issue_sdp(kt);
      sm90::wgmma_commit();
      issue_dq(kt - 1);
      sm90::wgmma_commit();
      sm90::bar_arrive(other, kPingPong);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      grad_s(kt);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(ds);
      release(kt - 1);
      pack_ds();
    }
    sm90::wgmma_fence();
    issue_dq(n_mine - 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    sm90::fence_regs(ds);
    release(n_mine - 1);
  }
  for (int kt = n_mine; kt < n_kt; ++kt) {
    sm90::bar_sync(me, kPingPong);
    sm90::bar_arrive(other, kPingPong);
    sm90::mbar_wait(full(kt % S), (kt / S) & 1);
    release(kt);
  }
  if (c == 0) sm90::bar_sync(1, kPingPong);  // consumer 1's last arrival

  const float one[2] = {1.f, 1.f};
  store_rows<bf16, D>(a.dq, b, h, qrow, a.Sq, dq, one);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_f32_smem() {
  using L = Ld<float, D>;  // Q, two stages of K and V
  return sizeof(float) * 5 * kTile * L::kD;
}
template <int D> constexpr size_t dkv_f32_smem() {
  using L = Ld<float, D>;  // K, V, two stages of Q, dO, LSE and delta, P^T
  return sizeof(float) * (6 * kTile * L::kD + 4 * kTile + 4 * 16 * kTile);
}
template <int D> constexpr size_t dq_f32_smem() {
  using L = Ld<float, D>;  // Q, dO, two stages of K and V
  return sizeof(float) * 6 * kTile * L::kD;
}
// (168,960 / 220,160 / 202,752 bytes at D 128: one block of eight warps
// an SM; 87,040 / 121,856 / 104,448 at D 64. The forward's merge and dQ's
// halves' sums reuse the tiles' memory: 4 * 16 * D floats, and the
// forward's m and l rows.)
static_assert(dq_f32_smem<128>() <= 232448 && dkv_f32_smem<128>() <= 232448,
              "one block must fit an SM");

// Raises a kernel's dynamic shared-memory cap once (not a stream
// operation, so it stays out of captured graphs after the first call),
// then launches it.
template <typename Kernel>
int launch(Kernel kernel, size_t smem, bool& ready, dim3 grid, int threads,
           const FlashArgs& a, cudaStream_t stream) {
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The f32 dK/dV and dQ grid: (B*H, tiles), so the blocks of every
// batch*head's heaviest tile are dispatched first.
dim3 bwd_grid(const FlashArgs& a, int64_t rows) {
  return dim3((unsigned)(a.B * a.H), (unsigned)((rows + kTile - 1) / kTile));
}

// The f32 forward's grid: (B*H, query tiles), or under causal masking (B*H,
// pairs of query tiles n - 1 - p and p).
dim3 fwd_f32_grid(const FlashArgs& a) {
  const int64_t n = (a.Sq + kTile - 1) / kTile;
  return dim3((unsigned)(a.B * a.H), (unsigned)(a.causal ? (n + 1) / 2 : n));
}

// The bf16 kernels' launches: tensor maps over the [B, S, H, D] views
// (boxes of `q_rows` rows for q and dout, `kv_rows` for k and v), then one
// block of three warpgroups per 128-row tile and batch*head.
template <int D, typename Kernel>
int launch_sm90(Kernel kernel, size_t smem, bool& ready, int64_t tiles,
                int q_rows, int kv_rows, const FlashArgs& a,
                cudaStream_t stream) {
  TmaMaps m;
  const struct {
    CUtensorMap* map;
    const View& v;
    int64_t s;
    int rows;
  } maps[4] = {{&m.q, a.q, a.Sq, q_rows},
               {&m.k, a.k, a.Sk, kv_rows},
               {&m.v, a.v, a.Sk, kv_rows},
               {&m.dout, a.dout, a.Sq, q_rows}};
  for (const auto& x : maps) {
    if (!x.v.p) {  // the forward has no dout
      *x.map = CUtensorMap{};
      continue;
    }
    if (int err = sm90::encode_bshd(x.map, x.v.p, a.B, x.s, a.H, D, x.v.sb,
                                    x.v.ss, x.v.sh, x.rows))
      return err;
  }
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  kernel<<<dim3((unsigned)tiles, (unsigned)(a.B * a.H)), kSm90Threads, smem,
           stream>>>(a, m);
  return (int)cudaGetLastError();
}

template <int D, int kMask, bool kDrop>
int fwd_sm90(const FlashArgs& a, cudaStream_t stream) {
  static bool ready = false;
  return launch_sm90<D>(flash_fwd_sm90<D, kMask, kDrop>, FwdSm90<D>::kBytes,
                        ready, (a.Sq + 127) / 128, 128, 128, a, stream);
}

template <int D, int kMask, bool kDrop>
int dkv_sm90(const FlashArgs& a, cudaStream_t stream) {
  static bool ready = false;
  return launch_sm90<D>(flash_dkv_sm90<D, kMask, kDrop>, DkvSm90<D>::kBytes,
                        ready, (a.Sk + 127) / 128, 64, 128, a, stream);
}

template <int D, int kMask, bool kDrop>
int dq_sm90(const FlashArgs& a, cudaStream_t stream) {
  static bool ready = false;
  return launch_sm90<D>(flash_dq_sm90<D, kMask, kDrop>, DqSm90<D>::kBytes,
                        ready, (a.Sq + 127) / 128, 128, DqSm90<D>::kKT, a,
                        stream);
}

// The variant a launch runs: kMask 0 without a mask, 1 for a mask that
// depends on the key alone (batch and key strides only), 2 for any other.
int mask_kind(const FlashArgs& a) {
  if (!a.has_mask) return 0;
  return a.mask.sh == 0 && a.mask.sq == 0 ? 1 : 2;
}

template <int D, template <int, int, bool> class Run>
int dispatch_sm90(const FlashArgs& a, cudaStream_t stream) {
  switch (2 * mask_kind(a) + (a.has_dropout ? 1 : 0)) {
    case 0: return Run<D, 0, false>::go(a, stream);
    case 1: return Run<D, 0, true>::go(a, stream);
    case 2: return Run<D, 1, false>::go(a, stream);
    case 3: return Run<D, 1, true>::go(a, stream);
    case 4: return Run<D, 2, false>::go(a, stream);
    default: return Run<D, 2, true>::go(a, stream);
  }
}
template <int D, int kMask, bool kDrop> struct RunFwd {
  static int go(const FlashArgs& a, cudaStream_t s) {
    return fwd_sm90<D, kMask, kDrop>(a, s);
  }
};
template <int D, int kMask, bool kDrop> struct RunDkv {
  static int go(const FlashArgs& a, cudaStream_t s) {
    return dkv_sm90<D, kMask, kDrop>(a, s);
  }
};
template <int D, int kMask, bool kDrop> struct RunDq {
  static int go(const FlashArgs& a, cudaStream_t s) {
    return dq_sm90<D, kMask, kDrop>(a, s);
  }
};

template <typename T, int D>
int fwd(const FlashArgs& a, cudaStream_t stream) {
  if constexpr (kBf16<T>) {
    return dispatch_sm90<D, RunFwd>(a, stream);
  } else {
    static bool ready = false, ready_var = false;
    if (a.has_mask || a.has_dropout)
      return launch(flash_fwd_f32<D, true>, fwd_f32_smem<D>(), ready_var,
                    fwd_f32_grid(a), kF32Threads, a, stream);
    return launch(flash_fwd_f32<D, false>, fwd_f32_smem<D>(), ready,
                  fwd_f32_grid(a), kF32Threads, a, stream);
  }
}

template <typename T, int D>
int bwd_dkv(const FlashArgs& a, cudaStream_t stream) {
  if constexpr (kBf16<T>) {
    return dispatch_sm90<D, RunDkv>(a, stream);
  } else {
    static bool ready = false;
    return launch(flash_dkv_f32<D>, dkv_f32_smem<D>(), ready,
                  bwd_grid(a, a.Sk), kF32Threads, a, stream);
  }
}

template <typename T, int D>
int bwd_dq(const FlashArgs& a, cudaStream_t stream) {
  if constexpr (kBf16<T>) {
    return dispatch_sm90<D, RunDq>(a, stream);
  } else {
    static bool ready = false;
    return launch(flash_dq_f32<D>, dq_f32_smem<D>(), ready,
                  bwd_grid(a, a.Sq), kF32Threads, a, stream);
  }
}

int check(const FlashArgs* a) {
  if (a->B * a->H > 65535) return (int)cudaErrorInvalidConfiguration;
  if (a->has_mask && a->mask.p == nullptr) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// The library is this one translation unit, or seven of it compiled in
// parallel and linked (ops/_build.py `PARTS`): with FLASH_KIND 1, 2 or 3
// and FLASH_D 64 or 128, one family of kernels (forward, dK/dV, dQ) at one
// head_dim, both dtypes; with FLASH_KIND 0, the two entry points alone.
#ifdef FLASH_KIND
#define FLASH_HAS(kind, d) (FLASH_KIND == (kind) && FLASH_D == (d))
#define FLASH_ENTRY (FLASH_KIND == 0)
#else
#define FLASH_HAS(kind, d) 1
#define FLASH_ENTRY 1
#endif

// One family's launch at one head_dim: dtype 0 = float32, 1 = bfloat16.
extern "C" {
int flash_fwd_64(int dtype, const FlashArgs* a, cudaStream_t st);
int flash_fwd_128(int dtype, const FlashArgs* a, cudaStream_t st);
int flash_dkv_64(int dtype, const FlashArgs* a, cudaStream_t st);
int flash_dkv_128(int dtype, const FlashArgs* a, cudaStream_t st);
int flash_dq_64(int dtype, const FlashArgs* a, cudaStream_t st);
int flash_dq_128(int dtype, const FlashArgs* a, cudaStream_t st);

#if FLASH_HAS(1, 64)
int flash_fwd_64(int dtype, const FlashArgs* a, cudaStream_t st) {
  return dtype ? fwd<__nv_bfloat16, 64>(*a, st) : fwd<float, 64>(*a, st);
}
#endif
#if FLASH_HAS(1, 128)
int flash_fwd_128(int dtype, const FlashArgs* a, cudaStream_t st) {
  return dtype ? fwd<__nv_bfloat16, 128>(*a, st) : fwd<float, 128>(*a, st);
}
#endif
#if FLASH_HAS(2, 64)
int flash_dkv_64(int dtype, const FlashArgs* a, cudaStream_t st) {
  return dtype ? bwd_dkv<__nv_bfloat16, 64>(*a, st)
               : bwd_dkv<float, 64>(*a, st);
}
#endif
#if FLASH_HAS(2, 128)
int flash_dkv_128(int dtype, const FlashArgs* a, cudaStream_t st) {
  return dtype ? bwd_dkv<__nv_bfloat16, 128>(*a, st)
               : bwd_dkv<float, 128>(*a, st);
}
#endif
#if FLASH_HAS(3, 64)
int flash_dq_64(int dtype, const FlashArgs* a, cudaStream_t st) {
  return dtype ? bwd_dq<__nv_bfloat16, 64>(*a, st)
               : bwd_dq<float, 64>(*a, st);
}
#endif
#if FLASH_HAS(3, 128)
int flash_dq_128(int dtype, const FlashArgs* a, cudaStream_t st) {
  return dtype ? bwd_dq<__nv_bfloat16, 128>(*a, st)
               : bwd_dq<float, 128>(*a, st);
}
#endif
}  // extern "C"

#if FLASH_ENTRY
// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Writes a->o and
// a->lse, adding a->mask when a->has_mask and dropping P when
// a->has_dropout. Returns cudaGetLastError() after the launch (0 on
// success). Launches on `stream` and does not synchronise.
extern "C" int flash_attention_fwd_launch(int dtype, int64_t head_dim,
                                          const FlashArgs* a, void* stream) {
  if (a->B * a->H == 0 || a->Sq == 0) return 0;
  if (int err = check(a)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (head_dim == 64) return flash_fwd_64(dtype, a, st);
  if (head_dim == 128) return flash_fwd_128(dtype, a, st);
  return (int)cudaErrorInvalidValue;
}

// The backward kernels (`which`: 1 = dK/dV, 2 = dQ, 3 = both, dK/dV
// first). Reads q, k, v, dout, lse, delta (and the mask); writes dk and dv
// (1), dq (2). The mask and dropout flags and the seed must be the
// forward's. Same conventions as the forward.
extern "C" int flash_attention_bwd_launch(int dtype, int64_t head_dim,
                                          int which, const FlashArgs* a,
                                          void* stream) {
  if (a->B * a->H == 0 || a->Sq == 0 || a->Sk == 0) return 0;
  if (int err = check(a)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  const bool d64 = head_dim == 64;
  if (which & 1) {
    if (int err = d64 ? flash_dkv_64(dtype, a, st)
                      : flash_dkv_128(dtype, a, st))
      return err;
  }
  if (which & 2)
    return d64 ? flash_dq_64(dtype, a, st) : flash_dq_128(dtype, a, st);
  return 0;
}
#endif
