// Ragged paged attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_ragged_kernel` (built by `_build_ragged`,
// paddle_tpu/ops/pallas/paged_attention.py), both of its variants: every
// live query token attends, with an fp32 softmax, over its row's live KV
// blocks under the positional causal mask `q_start + i >= j * bs + k`,
// which also hides the stale tail of a partly filled last block. Dead
// query tiles (at or past ceil(max(q_len, 1) / QT)) return at once; rows
// inside a live tile past q_len are neither computed nor written (their
// output is garbage, as on the TPU, and the engine discards it).
//
// - Float arena (the arena has q's dtype): P is rounded to that dtype
//   before the PV product, as the TPU kernel's `p.astype(vt.dtype)` does.
// - Int8 arena (`quant=True` on the TPU): each (layer, head, block) tile
//   carries one float32 scale in the sidecars k_scale / v_scale [L, H, N].
//   SIMT design: a 16-byte load brings 16 int8 values, which are converted
//   to float and multiplied by their block's scale as they are staged into
//   the f32 shared tiles (the chunk's scales are read once into shared
//   memory), so the products see dequantized K and V exactly as the TPU
//   kernel's `kt.astype(f32) * scale` before its dot. P stays fp32 (V is
//   fp32 after the dequant). Everything after staging is the float path's.
//   sm_90a design: the int8 values enter the tensor-core products exactly
//   (as fp16 in split rows, bf16 in wide rows); K's scale multiplies S's
//   columns in f32, and V's multiplies P, which is then rounded to the
//   product's 16-bit type (one rounding the TPU kernel, whose P stays f32,
//   does not make).
//
// Layouts (the JAX package's): q and out [B, S, H, D] with unit stride on
// D (other strides are arguments, so the strided q view of the fused QKV
// projection needs no copy); arenas [L, H, N, bs, D] contiguous and
// 16-byte aligned; scale sidecars [L, H, N] float32 contiguous;
// block_tables [B, nb] int32; q_start, kv_live, q_lens [B] int32.
//
// Bound: memory. A decode step reads each live KV block of each head once,
// about 2 * live_blocks * bs * D * H * itemsize bytes per step and layer
// (itemsize 1 plus two 4-byte scales a block for the int8 arena), over the
// card's 3.35 TB/s; the arithmetic (4 * q_len * kv_len * D * H flops) is
// far below the ridge for decode and short chunks.
//
// Two designs, chosen on the host by shape alone (`kernel_design` in
// ops/paged_attention.py, mirrored by the C entry's `design`):
//
// The sm_90a design: bfloat16 q at head_dim 128 with a block size of 16,
// 32, 64 or 128, over a bf16 or an int8 arena (the serving shape). K/V
// are staged in shared memory in their stored type by TMA (a tensor map
// over the arena's blocks, 16 keys of one block a box, 128-byte swizzled,
// the table read by the issuing lane), never widened to f32. A launch
// holds rows of two kinds, told apart inside the kernels by q_len:
// - Split rows (q_len <= 8: decode, verify): `rpa_split_sm90`, one block
//   per (row, head, split of 256 keys) whose four warps each keep a ring of
//   16-key TMA stages in flight and run S and P V on mma.sync (fp16 over
//   the int8 arena, its values converted exactly in registers); the warps'
//   partials merge in fixed order, then the splits' in `rpa_combine`
//   (its `kWait` instantiation), launched as a programmatic dependent
//   (PDL) so its blocks are scheduled under the split pass's tail. No atomics: two runs
//   are bit-identical.
// - Wide rows (q_len > 8: prefill chunks): `rpa_wide_sm90`, one block per
//   (row, head, 64-query tile): a producer warp walks the row's blocks
//   into a 4-stage ring of 64-key tiles, one consumer warpgroup runs
//   S = Q K^T as an SS wgmma and O += P V as an RS wgmma (the int8 stage
//   widened to bf16 tiles first). K/V are read once per 64 queries (the
//   SIMT design re-read them once per 8). Launched only when the step is
//   wider than 8.
// The workspace keeps the SIMT design's size (its 64-key chunks give more
// splits than 256-key ones), fixed by (B, H, D, bs, nb).
//
// The SIMT design (the first port, kept as it was): float32 q (the
// card-vs-CPU parity path; wgmma has no f32 form), and bf16 at head_dims
// 16, 32 and 64 or block sizes that are not a multiple of 16 (1, 4, 8 in
// the card tests). What it does:
// - Work is cut into chunks of whole KV blocks, about 64 keys each
//   (4 blocks of 16), staged in shared memory with 16-byte loads; each
//   thread issues up to 8 K and 8 V loads before using any, so their
//   latencies overlap.
// - A row whose live queries fit one 8-query tile (every decode and
//   verify row) spreads its chunks over the grid, one chunk per thread
//   block ("split-KV"), so a decode step runs about
//   sum(ceil(kv_live / 4)) * H blocks instead of B * H, several resident
//   per SM, and their loads overlap. Each writes its chunk's partial
//   (max m, sum l, unnormalised acc) to a workspace; a second pass
//   (`rpa_combine`) merges them: out = sum_i e^(m_i - M) acc_i /
//   sum_i e^(m_i - M) l_i. A query that sees only chunk 0 is written
//   directly by the first pass.
// - A wider row (a prefill chunk) has enough query tiles to fill the
//   card: each tile walks its chunks in one thread block with an online
//   softmax and stops after the chunk holding its last query's position.
// - Nothing past kv_live is read: the padded table tail costs nothing.
// Grid: one 128-thread block per (query tile, head, split, row) item; an
// item without work returns before it touches K/V. (A persistent grid
// that walked the items in a loop measured slower: its fixed round-robin
// share left blocks that drew long items holding the kernel.)
//
// Shared memory of the SIMT design (floats): Q [QT][D], K [CK][D + 4], V
// [CK][D], P [QT][CK4],
// m / l / alpha [QT], the chunk's K and V scales [CB] each (int8 arena);
// CK = keys per chunk, CK4 = CK rounded up to 4, CB = blocks per chunk. The
// math reads shared memory as float4: a score is one key against a group
// of 4 query rows, a PV term 4 output columns of one row against 4 keys
// (the K row padding keeps a quarter-warp's float4 loads of 8 keys on
// distinct banks).
//
// One call of the wrapper is one launch: the SIMT design's pair (attend,
// combine), or the sm_90a design's (wide, when wider than 8), split and
// combine kernels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQTile = 8;
constexpr int kChunkKeys = 64;  // target keys per chunk (whole blocks, >= 1)
constexpr int kLoadBatch = 8;   // 16-byte K and V loads in flight per thread
constexpr float kNegInf = -1e30f;

// blocks per chunk and splits per row for a block size and table width
__host__ __device__ inline int64_t chunk_blocks(int64_t bs) {
  return bs >= kChunkKeys ? 1 : kChunkKeys / bs;
}
__host__ __device__ inline int64_t max_splits(int64_t bs, int64_t nb) {
  const int64_t cb = chunk_blocks(bs);
  return (nb + cb - 1) / cb;
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* out) {
    const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = f[i];
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(const uint4& u, float* out) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(c[i]);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// P is rounded to the V dtype before the PV product, as the TPU kernel
// does with `p.astype(vt.dtype)`; V from an int8 arena is float32 after
// its dequant, so P stays float32 there.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, const int8_t*) { return x; }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // int8 arena: [L, H, N] sidecars; null otherwise
  const float* v_scale;
  void* out;
  float* ws;  // split partials [B][H][n_split][QT][4 + D]: m, l, -, -, acc
  const int32_t* tables;
  const int32_t* q_start;
  const int32_t* kv_live;
  const int32_t* q_lens;
  int64_t S, H, bs, nb, num_blocks, n_split, cblocks;
  int64_t q_sb, q_ss, q_sh, o_sb, o_ss, o_sh;
  int64_t layer_off, a_sh, a_sn, sc_layer_off, sc_sh;
  float scale;
};

template <int D>
__device__ __forceinline__ float* partial(const Params& p, int64_t b, int h,
                                          int split, int r) {
  return p.ws + ((((b * p.H + h) * p.n_split + split) * kQTile + r) * (4 + D));
}

// The first pass: one block per work item, query tile `tile` of row `b`,
// head `h`, KV split `split`. Returns at once (uniformly over the block)
// when the item holds no work. T is q's and out's type, TA the arena's
// (T itself, or int8_t with the scale sidecars).
template <typename T, typename TA, int D>
__global__ void __launch_bounds__(kThreads) rpa_attend(Params p) {
  static_assert(D % 16 == 0 && D <= 128 && kThreads % (D / 4) == 0,
                "D must be one of 16, 32, 64, 128");
  static_assert(D % Vec<TA>::N == 0, "D must hold whole 16-byte vectors");
  constexpr bool kQuant = std::is_same<TA, int8_t>::value;
  constexpr int kD4 = D / 4;                   // float4 columns of a row
  constexpr int kRowStep = kThreads / kD4;     // PV rows per pass
  constexpr int kAcc = (kQTile + kRowStep - 1) / kRowStep;
  constexpr int kVec = Vec<TA>::N;
  constexpr int kKStride = D + 4;              // padded K row (floats)

  const int64_t ntiles = (p.S + kQTile - 1) / kQTile;
  int64_t item = blockIdx.x;
  const int tile = (int)(item % ntiles);
  item /= ntiles;
  const int h = (int)(item % p.H);
  item /= p.H;
  const int split = (int)(item % p.n_split);
  const int64_t b = item / p.n_split;

  const int tid = threadIdx.x;
  const int ql = max(p.q_lens[b], 1);
  const int row0 = tile * kQTile;
  if (row0 >= ql) return;  // dead query tile
  const int rows = min(kQTile, ql - row0);
  const int live = min(max(p.kv_live[b], 1), (int)p.nb);
  const int64_t ckeys = p.cblocks * p.bs;
  const int64_t ckp = (ckeys + 3) / 4 * 4;    // P row stride (floats)
  const int nchunks = (int)((live + p.cblocks - 1) / p.cblocks);
  const int64_t qpos0 = (int64_t)p.q_start[b] + row0;
  // chunks holding a key some query of this tile can see
  const int nvis = (int)min((int64_t)nchunks, (qpos0 + rows - 1) / ckeys + 1);
  const bool split_row = ql <= kQTile;
  int c_begin, c_end;
  if (split_row) {
    if (split >= nvis) return;
    c_begin = split;
    c_end = split + 1;
  } else {
    if (split != 0) return;
    c_begin = 0;
    c_end = nvis;
  }

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kQTile][D]
  float* ks = qs + kQTile * D;                  // [ckeys][D + 4]
  float* vs = ks + ckeys * kKStride;            // [ckeys][D]
  float* ps = vs + ckeys * D;                   // [kQTile][ckp]
  float* m_s = ps + kQTile * ckp;               // [kQTile]
  float* l_s = m_s + kQTile;                    // [kQTile]
  float* a_s = l_s + kQTile;                    // [kQTile]
  float* ksc_s = a_s + kQTile;                  // [cblocks] (int8 arena)
  float* vsc_s = ksc_s + p.cblocks;             // [cblocks]

  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < kQTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int64_t s = row0 + r;
    qs[i] = (r < rows && s < p.S)
                ? to_float(q[b * p.q_sb + s * p.q_ss + h * p.q_sh + d])
                : 0.f;
  }
  if (tid < kQTile) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;
  }

  const int c4 = tid % kD4;   // this thread's float4 column in PV
  const int rb = tid / kD4;   // and its first row
  float4 acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const TA* kbase = static_cast<const TA*>(p.k) + p.layer_off + h * p.a_sh;
  const TA* vbase = static_cast<const TA*>(p.v) + p.layer_off + h * p.a_sh;
  const int32_t* table = p.tables + b * p.nb;
  const int warp = tid / 32, lane = tid % 32;
  const int tile_vecs = (int)(p.bs * D / kVec);  // 16-byte vectors per block
  const int ngroups = (rows + 3) / 4;            // 4-row score groups

  for (int c = c_begin; c < c_end; ++c) {
    const int j0 = c * (int)p.cblocks;
    const int nblk = min((int)p.cblocks, live - j0);
    const int nkeys = nblk * (int)p.bs;
    if constexpr (kQuant) {
      // this chunk's block scales, once per block (every thread has
      // finished staging the previous chunk, the only reader of these)
      if (tid < nblk) {
        int64_t blk = table[j0 + tid];
        if (blk < 0 || blk >= p.num_blocks) blk = 0;
        const int64_t so = p.sc_layer_off + h * p.sc_sh + blk;
        ksc_s[tid] = p.k_scale[so];
        vsc_s[tid] = p.v_scale[so];
      }
    }
    __syncthreads();  // the previous chunk's K/V/P are no longer read
    // issue a batch of 16-byte loads per thread before using any of them,
    // so their latencies overlap
    const int nvec = nblk * tile_vecs;
    for (int i0 = tid; i0 < nvec; i0 += kThreads * kLoadBatch) {
      uint4 ku[kLoadBatch], vu[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nvec) {
          const int jj = i / tile_vecs, w = i % tile_vecs;
          int64_t blk = table[j0 + jj];
          if (blk < 0 || blk >= p.num_blocks) blk = 0;  // stay in the arena
          const int64_t off = blk * p.a_sn + (int64_t)w * kVec;
          ku[u] = *reinterpret_cast<const uint4*>(kbase + off);
          vu[u] = *reinterpret_cast<const uint4*>(vbase + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < nvec) {
          const int jj = i / tile_vecs, w = i % tile_vecs;
          float kf[kVec], vf[kVec];
          Vec<TA>::unpack(ku[u], kf);
          Vec<TA>::unpack(vu[u], vf);
          if constexpr (kQuant) {
            // dequantize with the block's scale before any product
            const float ks = ksc_s[jj], vsc = vsc_s[jj];
#pragma unroll
            for (int x = 0; x < kVec; ++x) {
              kf[x] *= ks;
              vf[x] *= vsc;
            }
          }
          const int e = w * kVec;
          const int key = jj * (int)p.bs + e / D, d = e % D;
          float4* kd = reinterpret_cast<float4*>(ks + key * kKStride + d);
          float4* vd = reinterpret_cast<float4*>(vs + key * D + d);
#pragma unroll
          for (int x = 0; x < kVec / 4; ++x) {
            kd[x] = make_float4(kf[4 * x], kf[4 * x + 1], kf[4 * x + 2],
                                kf[4 * x + 3]);
            vd[x] = make_float4(vf[4 * x], vf[4 * x + 1], vf[4 * x + 2],
                                vf[4 * x + 3]);
          }
        }
      }
    }
    __syncthreads();

    // scores: each thread takes one key against a group of 4 query rows,
    // reading K and Q as float4 (rows past `rows` hold zeros)
    const int64_t kpos0 = (int64_t)j0 * p.bs;
    for (int i = tid; i < ngroups * nkeys; i += kThreads) {
      const int g = i / nkeys, k = i % nkeys;
      const int r0 = g * 4;
      const float4* kr = reinterpret_cast<const float4*>(ks + k * kKStride);
      const float4* q0 = reinterpret_cast<const float4*>(qs + r0 * D);
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d4 = 0; d4 < kD4; ++d4) {
        const float4 kv = kr[d4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qv = q0[j * kD4 + d4];
          s[j] = fmaf(qv.x, kv.x, s[j]);
          s[j] = fmaf(qv.y, kv.y, s[j]);
          s[j] = fmaf(qv.z, kv.z, s[j]);
          s[j] = fmaf(qv.w, kv.w, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + j;
        if (r < rows)
          ps[r * ckp + k] = (qpos0 + r >= kpos0 + k) ? s[j] * p.scale
                                                     : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per live row
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* pr = ps + r * ckp;
      float mx = kNegInf;
      for (int k = lane; k < nkeys; k += 32) mx = fmaxf(mx, pr[k]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int k = lane; k < nkeys; k += 32) {
        const float e = expf(pr[k] - m_new);
        sum += e;
        pr[k] = round_to(e, kbase);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][4 columns] = alpha[r] * acc + sum_k P[r][k] * V[k][4 columns],
    // P read four keys at a time
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = rb + i * kRowStep;
      if (r < rows) {
        const float* pr = ps + r * ckp;
        const float al = a_s[r];
        float4 a = acc[i];
        a.x *= al;
        a.y *= al;
        a.z *= al;
        a.w *= al;
        int k = 0;
        for (; k + 4 <= nkeys; k += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + k);
          const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 v = reinterpret_cast<const float4*>(vs + (k + u) * D)[c4];
            a.x = fmaf(pk[u], v.x, a.x);
            a.y = fmaf(pk[u], v.y, a.y);
            a.z = fmaf(pk[u], v.z, a.z);
            a.w = fmaf(pk[u], v.w, a.w);
          }
        }
        for (; k < nkeys; ++k) {
          const float pk = pr[k];
          const float4 v = reinterpret_cast<const float4*>(vs + k * D)[c4];
          a.x = fmaf(pk, v.x, a.x);
          a.y = fmaf(pk, v.y, a.y);
          a.z = fmaf(pk, v.z, a.z);
          a.w = fmaf(pk, v.w, a.w);
        }
        acc[i] = a;
      }
    }
  }

  // a query sees chunks [0, nsp); the first pass finishes it when nsp is 1
  // (or the row is not split), else leaves this chunk's partial
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int r = rb + i * kRowStep;
    const int64_t s = row0 + r;
    if (r >= rows || s >= p.S) continue;
    const float a4[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
    const int64_t nsp = min((int64_t)nchunks, (qpos0 + r) / ckeys + 1);
    if (!split_row || (nsp == 1 && split == 0)) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      T* o = out + b * p.o_sb + s * p.o_ss + h * p.o_sh + 4 * c4;
#pragma unroll
      for (int u = 0; u < 4; ++u) store(o + u, a4[u] * inv);
    } else if (split < nsp) {
      float* part = partial<D>(p, b, h, split, r);
      *reinterpret_cast<float4*>(part + 4 + 4 * c4) = acc[i];
      if (c4 == 0) {
        part[0] = m_s[r];
        part[1] = l_s[r];
      }
    }
  }
}

// merges the split rows' partials: grid (H, B, QT), one block per query;
// one warp reduces the splits' (m, l), then one thread per d sums the
// weighted acc
// (kWait: launched as a programmatic dependent of the sm_90a split pass,
// whose partials it waits for; see rpa_split_sm90)
template <typename T, int D, bool kWait = false>
__global__ void __launch_bounds__(kThreads) rpa_combine(Params p) {
  if constexpr (kWait) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float ml[2];
  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int r = blockIdx.z;
  const int ql = max(p.q_lens[b], 1);
  if (ql > kQTile || r >= ql || r >= p.S) return;  // not a split query
  const int live = min(max(p.kv_live[b], 1), (int)p.nb);
  const int64_t ckeys = p.cblocks * p.bs;
  const int64_t nchunks = (live + p.cblocks - 1) / p.cblocks;
  const int lane = threadIdx.x % 32;
  const int nsp = (int)min(nchunks, ((int64_t)p.q_start[b] + r) / ckeys + 1);
  if (nsp <= 1) return;  // finished by the first pass
  if (threadIdx.x < 32) {
    float mx = kNegInf;
    for (int i = lane; i < nsp; i += 32)
      mx = fmaxf(mx, partial<D>(p, b, h, i, r)[0]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int i = lane; i < nsp; i += 32) {
      const float* part = partial<D>(p, b, h, i, r);
      l += expf(part[0] - mx) * part[1];
    }
    l = warp_sum(l);
    if (lane == 0) {
      ml[0] = mx;
      ml[1] = l;
    }
  }
  __syncthreads();
  const float mx = ml[0];
  const float inv = 1.f / fmaxf(ml[1], 1e-30f);
  T* out = static_cast<T*>(p.out);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
    for (int i = 0; i < nsp; ++i) {
      const float* part = partial<D>(p, b, h, i, r);
      o += expf(part[0] - mx) * part[4 + d];
    }
    store(out + b * p.o_sb + r * p.o_ss + h * p.o_sh + d, o * inv);
  }
}

// ---------------------------------------------------------------------------
// The sm_90a design: bf16 q over a bf16 or an int8 arena, head_dim 128,
// block sizes that are multiples of 16. K/V tiles arrive by TMA from a
// tensor map over the arena's blocks (`sm90::encode_arena`), in their
// stored type, 128-byte swizzled, 16 keys of one block a box.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kSm90D = 128;
constexpr int kBoxKeys = 16;      // keys of one TMA box (rows of a block)
constexpr int kSplitKeys = 256;   // keys a split row's block walks
constexpr int kSplitWarps = kThreads / 32;
constexpr int kWideQ = 64;        // queries of a wide row's block
constexpr int kWideKeys = 64;     // keys of a wide row's key tile
constexpr int kWideThreads = 160; // a consumer warpgroup, a producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWg = 128;          // threads of a warpgroup
// a hidden wide-row score: exp2 of it is exactly 0 once the row's max is
// finite (key 0 is in every live row's first key tile)
constexpr float kMinusInf = -__builtin_huge_valf();

struct ArenaMaps {
  CUtensorMap k, v;
};

// 16-byte shared-memory offset of chunk `chunk` (16 bytes) of row `row` in
// a 128-byte swizzled box: the chunk index is XORed with the row's low bits
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The four int8 values of `w` as floats, exactly: byte x ^ 0x80 (x + 128)
// becomes the low mantissa byte of 2^23, and 2^23 + 128 is subtracted
// (byte permutes and adds: a higher issue rate than integer-to-float
// conversions).
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + i)) -
           8388736.f;
}

// m16n8k16 with rows 8-15 of A zero (a1 = a3 = 0): only c[0], c[1]
// matter. kHalf: fp16 operands, else bf16.
template <bool kHalf>
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  if constexpr (kHalf)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_half(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two int8 values, given as bytes u ^ 0x80 (x + 128) in bytes 0 and 2 of
// `w` with 0x64 in bytes 1 and 3 (fp16 1024 + x + 128), as the fp16 pair
// (x0, x1), exactly: one half2 subtract of 1152.
__device__ __forceinline__ uint32_t biased_to_half2(uint32_t w) {
  uint32_t r;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(w), "r"(0x64806480u));
  return r;
}
// bytes i0 and i1 of w (already XORed with 0x80) as an fp16 pair
template <int kSel>
__device__ __forceinline__ uint32_t i8pair_half2(uint32_t u) {
  return biased_to_half2(__byte_perm(u, 0x64646464u, kSel));
}

// the table entry of a row's block j (j < live), clamped into the arena
__device__ __forceinline__ int64_t arena_block(const Params& p,
                                               const int32_t* table, int j) {
  int64_t blk = table[j];
  return (blk < 0 || blk >= p.num_blocks) ? 0 : blk;
}

// Shared memory of a split-row block: each warp owns a ring of stages of
// 16 keys (K then V; bf16: two column boxes [16][64] each; int8: one box
// [16][128]) and its barriers.
template <typename TA> struct SplitSm90 {
  static constexpr bool kQuant = std::is_same<TA, int8_t>::value;
  static constexpr int kStages = kQuant ? 3 : 2;
  static constexpr int kHalf = (kQuant ? 1 : 2) * kBoxKeys * 128;
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kWarpBytes = kStages * kStage;
  static constexpr int kBar = kSplitWarps * kWarpBytes;
  static constexpr int kBytes = kBar + 8 * kSplitWarps * kStages + 1024;
};

// Split rows (q_len <= 8: decode, verify): one 128-thread block per (row,
// head, split of 256 keys). Its four warps are independent pipelines: warp
// w takes the split's 16-key stages w, w + 4, ..., lane 0 keeping a ring of
// TMA loads in flight, and runs an online softmax over them on mma.sync
// m16n8k16 (queries are the 16 rows, 8 of them zero): S = Q K^T with Q in
// registers and K^T fragments read from the stored tile, then O += P V
// with P in registers (the S accumulator is already P's A fragment) and V
// fragments gathered from the stored tile. The depth of both products is
// permuted so that each lane reads 4 consecutive columns (int8: one 4-byte
// load; bf16: 8 bytes) and 4 consecutive keys: K^T's lane (g, t) takes
// columns 16s + 4t .. + 3 of key kp(nt, g) = 4 (g / 2) + 2 nt + g % 2, and
// the PV product's output column n of n-tile j is d = 32 (j / 4) + 4 n +
// j % 4, so lane (g, t) reads V[4t + i][32 J + 4 g .. + 3]. Over the int8
// arena both products run in fp16: an int8 pair becomes an fp16 pair
// exactly with one byte permute and one half2 subtract (`i8pair_half2`);
// q is converted to fp16 once; K's block scale multiplies S, V's
// multiplies P before P is rounded to fp16. The warps' partials are
// merged in shared memory in warp order, then written as the split's
// partial for `rpa_combine` (or as the output when the split is the
// query's only one).
template <typename TA>
__global__ void __launch_bounds__(kThreads)
    rpa_split_sm90(const Params p, const __grid_constant__ ArenaMaps am) {
  using L = SplitSm90<TA>;
  constexpr int R = L::kStages, D = kSm90D;
  constexpr bool kQuant = L::kQuant;
  int64_t item = blockIdx.x;
  const int h = (int)(item % p.H);
  item /= p.H;
  const int split = (int)(item % p.n_split);
  const int64_t b = item / p.n_split;
  const int ql = max(p.q_lens[b], 1);
  if (ql > kQTile) return;  // a wide row: rpa_wide_sm90 takes it
  const int rows = (int)min((int64_t)ql, p.S);
  const int live = min(max(p.kv_live[b], 1), (int)p.nb);
  const int64_t sk = p.cblocks * p.bs;
  const int nchunks = (int)((live + p.cblocks - 1) / p.cblocks);
  const int64_t qpos0 = p.q_start[b];
  const int nvis = (int)min((int64_t)nchunks, (qpos0 + ql - 1) / sk + 1);
  if (split >= nvis) return;
  const int64_t kbeg = split * sk;
  const int64_t kend =
      min(min(kbeg + sk, (int64_t)live * p.bs), qpos0 + ql);
  const int nst = (int)((kend - kbeg + kBoxKeys - 1) / kBoxKeys);

  extern __shared__ uint8_t smem_rpa[];
  const uint32_t raw = sm90::smem_u32(smem_rpa);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sbase = smem_rpa + (base - raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t wbase = base + warp * L::kWarpBytes;
  uint8_t* wptr = sbase + warp * L::kWarpBytes;
  const uint32_t bar0 = base + L::kBar + warp * R * 8;
  if (lane == 0) {
    for (int s = 0; s < R; ++s) sm90::mbar_init(bar0 + 8 * s, 1);
    sm90::mbar_fence_init();
  }
  __syncwarp();

  const int32_t* table = p.tables + b * p.nb;
  // the arena row (block of one layer and head) of block 0 of this head
  const int64_t head_row = (p.layer_off + h * p.a_sh) / p.a_sn;
  const int n_my = nst > warp ? (nst - warp + kSplitWarps - 1) / kSplitWarps
                              : 0;
  const auto stage_key = [&](int i) {
    return kbeg + (int64_t)(warp + kSplitWarps * i) * kBoxKeys;
  };
  const auto issue = [&](int i) {
    const int s = i % R;
    const int64_t key0 = stage_key(i);
    const int c2 = (int)(head_row + arena_block(p, table, (int)(key0 / p.bs)));
    const int r0 = (int)(key0 % p.bs);
    const uint32_t bar = bar0 + 8 * s, dst = wbase + s * L::kStage;
    sm90::mbar_expect_tx(bar, L::kStage);
    if constexpr (kQuant) {
      sm90::tma_load_3d(dst, &am.k, bar, 0, r0, c2);
      sm90::tma_load_3d(dst + L::kHalf, &am.v, bar, 0, r0, c2);
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sm90::tma_load_3d(dst + c * 2048, &am.k, bar, 64 * c, r0, c2);
        sm90::tma_load_3d(dst + L::kHalf + c * 2048, &am.v, bar, 64 * c, r0,
                          c2);
      }
    }
  };
  if (lane == 0)
    for (int i = 0; i < min(R, n_my); ++i) issue(i);

  // Q's A fragments (row g; columns 16 s + 4 t .. + 3), zero past the
  // live rows
  uint32_t qa[D / 16][2];
  {
    const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb +
                        g * p.q_ss + h * p.q_sh;
#pragma unroll
    for (int s = 0; s < D / 16; ++s)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int d = 16 * s + 4 * t + 2 * u;
        if (g >= rows)
          qa[s][u] = 0u;
        else if constexpr (kQuant)  // the int8 arena's products run in fp16
          qa[s][u] = pack_half(__uint_as_float((uint32_t)q[d] << 16),
                               __uint_as_float((uint32_t)q[d + 1] << 16));
        else
          qa[s][u] = (uint32_t)q[d] | ((uint32_t)q[d + 1] << 16);
      }
  }
  const float sl2 = p.scale * kLog2e;
  const int64_t qpos = qpos0 + g;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m = kNegInf, l = 0.f;  // base-2 running max; this lane's sum

  for (int i = 0; i < n_my; ++i) {
    const int s = i % R;
    const int64_t key0 = stage_key(i);
    float ks = sl2, vs = 1.f;
    if constexpr (kQuant) {
      const int64_t so = p.sc_layer_off + h * p.sc_sh +
                         arena_block(p, table, (int)(key0 / p.bs));
      ks *= __ldg(p.k_scale + so);
      vs = __ldg(p.v_scale + so);
    }
    sm90::mbar_wait(bar0 + 8 * s, (i / R) & 1);
    const uint8_t* kt = wptr + s * L::kStage;
    const uint8_t* vt = kt + L::kHalf;
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int st = 0; st < D / 16; ++st)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int key = 4 * (g / 2) + 2 * nt + (g & 1);
        const int d = 16 * st + 4 * t;
        uint32_t b0, b1;
        if constexpr (kQuant) {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(
                                 kt + swz(key, d >> 4) + (d & 15)) ^
                             0x80808080u;
          b0 = i8pair_half2<0x4140>(u);
          b1 = i8pair_half2<0x4342>(u);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(
              kt + (d >> 6) * 2048 + swz(key, (d & 63) >> 3) + 2 * (d & 7));
          b0 = w.x;
          b1 = w.y;
        }
        mma16816<kQuant>(sc[nt], qa[st][0], qa[st][1], b0, b1);
      }
    // online softmax of query g over the stage's keys 4 t + 2 nt + e
    float x[2][2], mx = kNegInf;
    bool vis[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t kpos = key0 + 4 * t + 2 * nt + e;
        vis[nt][e] = g < rows && kpos <= qpos;
        x[nt][e] = vis[nt][e] ? sc[nt][e] * ks : kNegInf;
        mx = fmaxf(mx, x[nt][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = sm90::exp2_approx(m - m_new);
    m = m_new;
    float pe[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        pe[nt][e] = vis[nt][e] ? sm90::exp2_approx(x[nt][e] - m_new) : 0.f;
    l = l * alpha + pe[0][0] + pe[0][1] + pe[1][0] + pe[1][1];
    // P's A fragment: keys 4t, 4t + 1 (logical 2t, 2t + 1) and 4t + 2,
    // 4t + 3 (logical 2t + 8, 2t + 9); int8: times V's block scale
    const uint32_t pa0 = kQuant ? pack_half(pe[0][0] * vs, pe[0][1] * vs)
                                : sm90::pack_bf16(pe[0][0], pe[0][1]);
    const uint32_t pa2 = kQuant ? pack_half(pe[1][0] * vs, pe[1][1] * vs)
                                : sm90::pack_bf16(pe[1][0], pe[1][1]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
    }
#pragma unroll
    for (int J = 0; J < D / 32; ++J) {
      const int d = 32 * J + 4 * g;
      if constexpr (kQuant) {
        uint32_t r[4];  // key 4 t + u, columns d .. d + 3, XORed 0x80
#pragma unroll
        for (int u = 0; u < 4; ++u)
          r[u] = *reinterpret_cast<const uint32_t*>(
                     vt + swz(4 * t + u, d >> 4) + (d & 15)) ^
                 0x80808080u;
        // keys (4t, 4t + 1) and (4t + 2, 4t + 3) of columns d, d + 1 (lo)
        // and d + 2, d + 3 (hi), interleaved
        const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
        mma16816<true>(o[4 * J], pa0, pa2, i8pair_half2<0x4140>(lo01),
                       i8pair_half2<0x4140>(lo23));
        mma16816<true>(o[4 * J + 1], pa0, pa2, i8pair_half2<0x4342>(lo01),
                       i8pair_half2<0x4342>(lo23));
        mma16816<true>(o[4 * J + 2], pa0, pa2, i8pair_half2<0x4140>(hi01),
                       i8pair_half2<0x4140>(hi23));
        mma16816<true>(o[4 * J + 3], pa0, pa2, i8pair_half2<0x4342>(hi01),
                       i8pair_half2<0x4342>(hi23));
      } else {
        uint2 r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = 4 * t + u;
          r[u] = *reinterpret_cast<const uint2*>(
              vt + (d >> 6) * 2048 + swz(key, (d & 63) >> 3) + 2 * (d & 7));
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const uint32_t sel = (jj & 1) ? 0x7632u : 0x5410u;
          const uint32_t lo0 = jj < 2 ? r[0].x : r[0].y;
          const uint32_t lo1 = jj < 2 ? r[1].x : r[1].y;
          const uint32_t lo2 = jj < 2 ? r[2].x : r[2].y;
          const uint32_t lo3 = jj < 2 ? r[3].x : r[3].y;
          mma16816<false>(o[4 * J + jj], pa0, pa2, __byte_perm(lo0, lo1, sel),
                   __byte_perm(lo2, lo3, sel));
        }
      }
    }
    __syncwarp();
    if (lane == 0 && i + R < n_my) {
      sm90::fence_proxy_async();
      issue(i + R);
    }
  }
  // the merge pass may now be scheduled (it waits for this grid's end)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // the warp's partial in its own ring (its loads have all landed):
  // m [8], l [8], o [8][D]; lane (g, t) holds columns 32 J + 8 t .. + 7
  float* part = reinterpret_cast<float*>(wptr);
  if (t == 0) {
    part[g] = m;
    part[kQTile + g] = l;
  }
#pragma unroll
  for (int J = 0; J < D / 32; ++J) {
    float* dst = part + 2 * kQTile + g * D + 32 * J + 8 * t;
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(o[4 * J][0], o[4 * J + 1][0], o[4 * J + 2][0],
                    o[4 * J + 3][0]);
    reinterpret_cast<float4*>(dst)[1] =
        make_float4(o[4 * J][1], o[4 * J + 1][1], o[4 * J + 2][1],
                    o[4 * J + 3][1]);
  }
  __syncthreads();

  // merge the warps in order; thread d takes column d of every live query
  const int d = threadIdx.x;
  bf16* out = static_cast<bf16*>(p.out);
  for (int r = 0; r < rows; ++r) {
    float mw[kSplitWarps], mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      mw[w] = reinterpret_cast<const float*>(sbase + w * L::kWarpBytes)[r];
      mm = fmaxf(mm, mw[w]);
    }
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float* pw =
          reinterpret_cast<const float*>(sbase + w * L::kWarpBytes);
      const float f = sm90::exp2_approx(mw[w] - mm);
      acc += f * pw[2 * kQTile + r * D + d];
      lsum += f * pw[kQTile + r];
    }
    const int64_t nsp = min((int64_t)nchunks, (qpos0 + r) / sk + 1);
    if (nsp == 1 && split == 0) {
      out[b * p.o_sb + r * p.o_ss + h * p.o_sh + d] =
          __float2bfloat16(acc / fmaxf(lsum, 1e-30f));
    } else if (split < nsp) {
      float* pp = partial<D>(p, b, h, split, r);
      pp[4 + d] = acc;
      if (d == 0) {
        pp[0] = mm * kLn2;  // rpa_combine merges in natural units
        pp[1] = lsum;
      }
    }
  }
}

// Shared memory of a wide-row block: Q [64][D] once, a ring of K and V
// stages of 64 keys in the stored type (bf16: two column boxes [64][64]
// each; int8: one box [64][128]), for the int8 arena the stage's K and V
// widened to bf16 tiles and the keys' f32 block scales, and the barriers.
template <typename TA> struct WideSm90 {
  static constexpr bool kQuant = std::is_same<TA, int8_t>::value;
  static constexpr int kStages = 4;
  static constexpr int kBox = kWideKeys * 128;  // [64 rows][128 bytes]
  static constexpr int kTile = 2 * kBox;        // a bf16 [64][128] tile
  static constexpr int kHalf = kQuant ? kBox : kTile;
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kQ = 0, kRing = kTile;
  static constexpr int kConv = kRing + kStages * kStage;
  static constexpr int kScale = kConv + (kQuant ? 2 * kTile : 0);
  static constexpr int kBar = kScale + (kQuant ? 2 * kWideKeys * 4 : 0);
  static constexpr int kBytes = kBar + 8 * 2 * kStages + 1024;
};

// Wide rows (q_len > 8: prefill chunks): one block per (row, head, tile of
// 64 queries), so K/V are read once per 64 queries. Warp 4 issues TMA
// loads of the row's blocks, through the table, into a ring of 64-key
// stages (a box is 16 keys of one block; key tiles past the row's live
// blocks repeat its last live block, masked by position); warps 0-3, one
// consumer warpgroup, run S = Q K^T as an SS wgmma (m64n64k16), an fp32
// online softmax on the accumulator, and O += P V as an RS wgmma
// (m64n128k16) with P packed to bf16 in registers. Key tiles past the
// tile's last query position are never loaded. The int8 arena's stages
// are widened to bf16 tiles by the consumers (exact) before the products;
// K's scale multiplies S's columns, V's multiplies P before it is rounded.
template <typename TA>
__global__ void __launch_bounds__(kWideThreads, 1)
    rpa_wide_sm90(const Params p, const __grid_constant__ ArenaMaps am) {
  using L = WideSm90<TA>;
  constexpr int R = L::kStages, D = kSm90D;
  constexpr bool kQuant = L::kQuant;
  const int64_t ntiles = (p.S + kWideQ - 1) / kWideQ;
  int64_t item = blockIdx.x;
  const int tile = (int)(item % ntiles);
  item /= ntiles;
  const int h = (int)(item % p.H);
  const int64_t b = item / p.H;
  const int ql = max(p.q_lens[b], 1);
  const int t0 = tile * kWideQ;
  if (ql <= kQTile || t0 >= ql) return;  // a split row, or a dead tile
  const int rows = (int)min((int64_t)min(kWideQ, ql - t0), p.S - t0);
  const int live = min(max(p.kv_live[b], 1), (int)p.nb);
  const int64_t live_keys = (int64_t)live * p.bs;
  const int64_t qpos0 = (int64_t)p.q_start[b] + t0;
  const int64_t kend = min(live_keys, qpos0 + rows);
  const int n_kt = (int)((kend + kWideKeys - 1) / kWideKeys);

  extern __shared__ uint8_t smem_rpa[];
  const uint32_t raw = sm90::smem_u32(smem_rpa);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sbase = smem_rpa + (base - raw);
  const uint32_t bar = base + L::kBar;
  const auto full = [&](int s) { return bar + 8 * s; };
  const auto empty = [&](int s) { return bar + 8 * (R + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 4);  // the consumers' four warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int32_t* table = p.tables + b * p.nb;
  const int64_t head_row = (p.layer_off + h * p.a_sh) / p.a_sn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    if (lane == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % R;
        sm90::mbar_wait(empty(s), ((kt / R) & 1) ^ 1);
        sm90::mbar_expect_tx(full(s), L::kStage);
        const uint32_t dst = base + L::kRing + s * L::kStage;
#pragma unroll
        for (int u = 0; u < kWideKeys / kBoxKeys; ++u) {
          const int64_t key = (int64_t)kt * kWideKeys + u * kBoxKeys;
          const int j = (int)min(key / p.bs, (int64_t)live - 1);
          const int c2 = (int)(head_row + arena_block(p, table, j));
          const int r0 = (int)(key % p.bs);
          const uint32_t off = u * kBoxKeys * 128;
          if constexpr (kQuant) {
            sm90::tma_load_3d(dst + off, &am.k, full(s), 0, r0, c2);
            sm90::tma_load_3d(dst + L::kHalf + off, &am.v, full(s), 0, r0, c2);
          } else {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              sm90::tma_load_3d(dst + c * L::kBox + off, &am.k, full(s),
                                64 * c, r0, c2);
              sm90::tma_load_3d(dst + L::kHalf + c * L::kBox + off, &am.v,
                                full(s), 64 * c, r0, c2);
            }
          }
        }
      }
    }
    return;
  }

  // consumers: Q [64][D] of rows t0.. into the swizzled tile (zero past
  // the live rows)
  const int tid = threadIdx.x, w = tid / 32, g = lane / 4, t = lane % 4;
  {
    const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb +
                        h * p.q_sh;
    for (int i = tid; i < kWideQ * (D / 8); i += kWg) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (r < rows) {
        const uint16_t* src = q + (int64_t)(t0 + r) * p.q_ss + 8 * c8;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = (uint32_t)src[2 * u] | ((uint32_t)src[2 * u + 1] << 16);
      }
      *reinterpret_cast<uint4*>(sbase + L::kQ + (c8 / 8) * L::kBox +
                                swz(r, c8 % 8)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1, kWg);

  const float sl2 = p.scale * kLog2e;
  float* ksc_s = reinterpret_cast<float*>(sbase + L::kScale);
  float* vsc_s = ksc_s + kWideKeys;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[kWideKeys / 8][4];
  uint32_t pa[kWideKeys / 16][4];
  const int row_base = 16 * w + g;  // and + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % R;
    sm90::mbar_wait(full(st), (kt / R) & 1);
    uint32_t kb = base + L::kRing + st * L::kStage, vb = kb + L::kHalf;
    if constexpr (kQuant) {
      // every warp is done with the previous tile's bf16 K/V and scales
      sm90::bar_sync(1, kWg);
      const uint8_t* rawk = sbase + L::kRing + st * L::kStage;
      for (int i = tid; i < 2 * kWideKeys * 8; i += kWg) {
        const int which = i / (kWideKeys * 8), r = (i / 8) % kWideKeys;
        const int c = i % 8;  // 16 int8 columns 16 c .. 16 c + 15
        const uint4 src = *reinterpret_cast<const uint4*>(
            rawk + which * L::kHalf + swz(r, c));
        const uint32_t wv[4] = {src.x, src.y, src.z, src.w};
        uint32_t bv[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float f[4];
          i8x4_to_f32(wv[u], f);
          bv[2 * u] = sm90::pack_bf16(f[0], f[1]);
          bv[2 * u + 1] = sm90::pack_bf16(f[2], f[3]);
        }
        uint8_t* dst = sbase + L::kConv + which * L::kTile + (c / 4) * L::kBox;
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * (c % 4))) =
            make_uint4(bv[0], bv[1], bv[2], bv[3]);
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * (c % 4) + 1)) =
            make_uint4(bv[4], bv[5], bv[6], bv[7]);
      }
      if (tid < kWideKeys) {
        const int64_t key = (int64_t)kt * kWideKeys + tid;
        const int j = (int)min(key / p.bs, (int64_t)live - 1);
        const int64_t so = p.sc_layer_off + h * p.sc_sh +
                           arena_block(p, table, j);
        ksc_s[tid] = __ldg(p.k_scale + so);
        vsc_s[tid] = __ldg(p.v_scale + so);
      }
      sm90::fence_proxy_async();
      sm90::bar_sync(1, kWg);
      if (lane == 0) sm90::mbar_arrive(empty(st));  // the int8 stage is free
      kb = base + L::kConv;
      vb = kb + L::kTile;
    }
    // S = Q K^T (both K-major in their swizzled tiles)
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kBox + (kk % 4) * 32;
      sm90::wgmma_ss(s, sm90::desc_sw128(base + L::kQ + off, 16, 1024),
                     sm90::desc_sw128(kb + off, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // online softmax: row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2
    const int64_t k0 = (int64_t)kt * kWideKeys;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kWideKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_base + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
        const int64_t kpos = k0 + col;
        const bool vis = row < rows && kpos <= qpos0 + row && kpos < live_keys;
        float x = s[j][e] * sl2;
        if constexpr (kQuant) x *= ksc_s[col];
        x = vis ? x : kMinusInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = sm90::exp2_approx(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];  // this lane's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < kWideKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a hidden score is -inf, so its P is exactly 0 (m stays finite)
        const float pe = sm90::exp2_approx(s[j][e] - m[e >> 1]);
        l[e >> 1] += pe;
        s[j][e] = kQuant ? pe * vsc_s[8 * j + 2 * t + (e & 1)] : pe;
      }
#pragma unroll
    for (int kk = 0; kk < kWideKeys / 16; ++kk)
      sm90::pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    // O += P V, V [keys][D] read MN-major as stored
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWideKeys / 16; ++kk)
      sm90::wgmma_rs(o, pa[kk],
                     sm90::desc_sw128(vb + kk * 16 * 128, L::kBox, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(pa);
    if constexpr (!kQuant) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty(st));
    }
  }

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row_base + 8 * i;
    if (row >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* orow = out + b * p.o_sb + (int64_t)(t0 + row) * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

// raises a kernel's dynamic shared-memory cap once (not a stream
// operation, so it stays out of captured graphs after the first call)
template <typename K>
int raise_smem_cap(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return (int)err;
}

// The sm_90a design's launch: the wide rows' kernel (only when the step is
// wider than a split row can be), the split rows' kernel, their merge.
template <typename TA>
int launch_sm90(const Params& p, int64_t B, int64_t arena_blocks,
                cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TA, int8_t>::value;
  ArenaMaps am;
  int err = sm90::encode_arena(&am.k, const_cast<void*>(p.k), kQuant,
                               arena_blocks, p.bs, kSm90D, kBoxKeys);
  if (err) return err;
  err = sm90::encode_arena(&am.v, const_cast<void*>(p.v), kQuant,
                           arena_blocks, p.bs, kSm90D, kBoxKeys);
  if (err) return err;
  if (p.S > kQTile) {
    static bool wide_cap = false;
    err = raise_smem_cap(rpa_wide_sm90<TA>, WideSm90<TA>::kBytes, wide_cap);
    if (err) return err;
    const int64_t n = (p.S + kWideQ - 1) / kWideQ * p.H * B;
    if (n > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
    rpa_wide_sm90<TA><<<(unsigned)n, kWideThreads, WideSm90<TA>::kBytes,
                        stream>>>(p, am);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  static bool split_cap = false;
  err = raise_smem_cap(rpa_split_sm90<TA>, SplitSm90<TA>::kBytes, split_cap);
  if (err) return err;
  const int64_t n = p.n_split * p.H * B;
  if (n > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  rpa_split_sm90<TA><<<(unsigned)n, kThreads, SplitSm90<TA>::kBytes,
                       stream>>>(p, am);
  err = (int)cudaGetLastError();
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.H, (unsigned)B, kQTile);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // the merge, launched as a programmatic dependent: its blocks are
  // scheduled while the split pass's last blocks run and wait for its end
  return (int)cudaLaunchKernelEx(&cfg, rpa_combine<bf16, kSm90D, true>, p);
}

template <typename T, typename TA, int D>
int launch(const Params& p, int64_t B, cudaStream_t stream) {
  const int64_t ckeys = p.cblocks * p.bs;
  const int64_t ckp = (ckeys + 3) / 4 * 4;
  const size_t smem = sizeof(float) *
      (kQTile * D + ckeys * (D + 4) + ckeys * D + kQTile * ckp + 3 * kQTile +
       2 * p.cblocks);
  auto attend = rpa_attend<T, TA, D>;
  // raise the kernel's dynamic shared-memory cap once per size it needs
  // (not a stream operation, so it stays out of captured graphs after the
  // first call at a given size)
  static size_t smem_cap = 0;
  if (smem > smem_cap) {
    const cudaError_t err = cudaFuncSetAttribute(
        attend, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_cap = smem;
  }
  const int64_t n_items =
      (p.S + kQTile - 1) / kQTile * p.H * p.n_split * B;
  if (n_items > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  attend<<<(unsigned)n_items, kThreads, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rpa_combine<T, D><<<dim3((unsigned)p.H, (unsigned)B, kQTile), kThreads, 0,
                      stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename TA>
int launch_d(int64_t D, const Params& p, int64_t B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, TA, 16>(p, B, stream);
    case 32: return launch<T, TA, 32>(p, B, stream);
    case 64: return launch<T, TA, 64>(p, B, stream);
    case 128: return launch<T, TA, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of workspace a call needs (the split rows' partials).
extern "C" int64_t ragged_paged_attention_workspace(int64_t B, int64_t H,
                                                    int64_t D, int64_t bs,
                                                    int64_t nb) {
  return B * H * max_splits(bs, nb) * kQTile * (4 + D);
}

// dtype (q and out) and arena_dtype: 0 = float32, 1 = bfloat16, 2 = int8
// (the arena only). design: 0 the SIMT design, 1 the sm_90a design (bf16
// q, head_dim 128, block size a multiple of 16; refused otherwise);
// n_layers is the arena's first dimension. A float arena has q's dtype; an int8 arena needs the
// float32 scale sidecars k_scale / v_scale [L, H, N] (offsets in floats:
// sc_layer_off to the layer, sc_sh between heads), which are null for a
// float arena. `ws` holds at least ragged_paged_attention_workspace(...)
// floats. Returns cudaGetLastError() after the launches (0 on success).
// Launches on `stream` and does not synchronise.
extern "C" int ragged_paged_attention_launch(
    int design, int dtype, int arena_dtype, int64_t n_layers, int64_t B, int64_t S, int64_t H, int64_t D,
    int64_t bs, int64_t nb, int64_t num_blocks, const void* q, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, const void* k, const void* v,
    int64_t layer_off, int64_t a_sh, int64_t a_sn, const float* k_scale,
    const float* v_scale, int64_t sc_layer_off, int64_t sc_sh,
    const void* tables, const void* q_start,
    const void* kv_live, const void* q_lens, void* out, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, float* ws, float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (B > 65535 || H > 65535)
    return (int)cudaErrorInvalidConfiguration;  // merge-pass grid limits
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.out = out;
  p.ws = ws;
  p.tables = static_cast<const int32_t*>(tables);
  p.q_start = static_cast<const int32_t*>(q_start);
  p.kv_live = static_cast<const int32_t*>(kv_live);
  p.q_lens = static_cast<const int32_t*>(q_lens);
  p.S = S;
  p.H = H;
  p.bs = bs;
  p.nb = nb;
  p.num_blocks = num_blocks;
  p.cblocks = chunk_blocks(bs);
  p.n_split = max_splits(bs, nb);
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.layer_off = layer_off;
  p.a_sh = a_sh;
  p.a_sn = a_sn;
  p.sc_layer_off = sc_layer_off;
  p.sc_sh = sc_sh;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (dtype != 1 || D != kSm90D || bs % kBoxKeys || kSplitKeys % bs ||
        (arena_dtype != 1 && arena_dtype != 2))
      return (int)cudaErrorInvalidValue;
    if (arena_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
      return (int)cudaErrorInvalidValue;
    // split rows walk kSplitKeys keys a block; their partials fit the
    // workspace sized for the SIMT design's 64-key chunks
    p.cblocks = kSplitKeys / bs;
    p.n_split = (nb + p.cblocks - 1) / p.cblocks;
    const int64_t arena_blocks = n_layers * H * num_blocks;
    return arena_dtype == 2 ? launch_sm90<int8_t>(p, B, arena_blocks, st)
                            : launch_sm90<bf16>(p, B, arena_blocks, st);
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  if (arena_dtype == 2) {
    if (k_scale == nullptr || v_scale == nullptr)
      return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch_d<float, int8_t>(D, p, B, st);
    if (dtype == 1) return launch_d<__nv_bfloat16, int8_t>(D, p, B, st);
    return (int)cudaErrorInvalidValue;
  }
  if (arena_dtype != dtype) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_d<float, float>(D, p, B, st);
  if (dtype == 1) return launch_d<__nv_bfloat16, __nv_bfloat16>(D, p, B, st);
  return (int)cudaErrorInvalidValue;
}
