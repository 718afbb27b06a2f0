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
//   A 16-byte load brings 16 int8 values, which are converted to float and
//   multiplied by their block's scale as they are staged into the f32
//   shared tiles (the chunk's scales are read once into shared memory), so
//   the products see dequantized K and V exactly as the TPU kernel's
//   `kt.astype(f32) * scale` before its dot. P stays fp32 (V is fp32 after
//   the dequant). Everything after staging is the float path's.
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
// What the design does about it:
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
// Not yet: an overlap of one chunk's loads with the previous chunk's
// math (cp.async / TMA pipeline), and wgmma; wide tiles re-read K/V once
// per 8-query tile, mostly from L2.
//
// Grid: one 128-thread block per (query tile, head, split, row) item; an
// item without work returns before it touches K/V. (A persistent grid
// that walked the items in a loop measured slower: its fixed round-robin
// share left blocks that drew long items holding the kernel.)
//
// Shared memory (floats): Q [QT][D], K [CK][D + 4], V [CK][D], P [QT][CK4],
// m / l / alpha [QT], the chunk's K and V scales [CB] each (int8 arena);
// CK = keys per chunk, CK4 = CK rounded up to 4, CB = blocks per chunk. The
// math reads shared memory as float4: a score is one key against a group
// of 4 query rows, a PV term 4 output columns of one row against 4 keys
// (the K row padding keeps a quarter-warp's float4 loads of 8 keys on
// distinct banks).
//
// One call of the wrapper is one launch of the pair (attend, combine).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) rpa_combine(Params p) {
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
// (the arena only). A float arena has q's dtype; an int8 arena needs the
// float32 scale sidecars k_scale / v_scale [L, H, N] (offsets in floats:
// sc_layer_off to the layer, sc_sh between heads), which are null for a
// float arena. `ws` holds at least ragged_paged_attention_workspace(...)
// floats. Returns cudaGetLastError() after the launches (0 on success).
// Launches on `stream` and does not synchronise.
extern "C" int ragged_paged_attention_launch(
    int dtype, int arena_dtype, int64_t B, int64_t S, int64_t H, int64_t D,
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
