// Split-KV attention of the serving decode step (kernel E) for Hopper: one
// query row per slot over that slot's ragged, paged KV prefix, bf16 in and
// out, f32 inside.
//
// It replaces no TPU kernel.  The reference computes the ragged decode's
// attention as plain jnp (src/repro/model/attention.py,
// `paged_decode_attention`, through `_sdpa`), and the port first did the
// same in PyTorch (model/attention.py `_sdpa_dense`): in every layer that
// path casts the whole (slots, kv_len, hkv, d) bf16 prefix of the cache to
// f32 copies, masks a full f32 score tensor and runs two batched f32
// gemvs, reading every slot to the end of the longest slot's bucket.  On
// granite's 16-slot docqa tick that was three quarters of the card's time.
// This kernel was added for speed and computes the same function.
//
// What it computes, for slot i and query head hq (kv head hq / rep):
// row j of the prefix counts when j < kv_len, j <= lengths[i] and, with a
// window, j > lengths[i] - window; q is scaled in f32 by 1/sqrt(d), K and V
// rows are widened from bf16 to f32 in registers (exact), and the scores,
// their max, exp, sum and P·V are f32, as `_sdpa_dense` computes them.
// Only the summation order differs (an online softmax per split and a
// merge of the splits).  A slot with no row in range, which only a slot
// that is not decoding can be, gets zeros.
//
// What bounds it on an H100: bytes.  Each (row, kv head) brings 2·d bf16
// values of K and V for 4·rep f32 operations per value pair, about 4 f32
// operations per byte at granite's group of 4, where the card's ridge is
// some 20 (67 TFLOP/s f32 over 3.35 TB/s).  The least it can move is each
// slot's valid rows once: granite's docqa tick (16 slots of about 2,300
// rows, 8 kv heads of d 64) reads some 75 MB a layer, 22 µs at 3.35 TB/s.
// The design is about reading those bytes once, wide, with enough of them
// in flight:
//
// * A block owns one (slot, kv head) and one split of the prefix's rows,
//   and serves every query head of the group from one load of each K and V
//   row, so the group's rep heads share the bytes.
// * The split's range is cut to the slot's own valid rows, read from
//   `lengths` on the device; a block whose range lies wholly outside them
//   exits at once.  So the bytes follow each slot's length, not the
//   bucket's, and one launch (one CUDA graph per kv bucket) serves every
//   mix of lengths.
// * Rows arrive through a ring of kStages tiles in shared memory filled by
//   cp.async, 16 bytes a thread, every thread of the block a loader: each
//   tile is T = 8192 / d rows of K and of V (16 KB each), so a block keeps
//   up to 64 KB in flight while it computes on the oldest tile.
// * Compute.  Below the loads, the cost is instructions per (row, head):
//   widening bf16, the cross-lane sums of the scores and the exps.  A group
//   of d / 16 neighbouring lanes owns a pair of the group's query heads and
//   one row slot, each lane 16 columns of q and of both heads'
//   accumulators, so a K or V row widened once serves two heads.  The
//   group takes rows rs, rs + nrs, ... of a tile in batches of four, sums
//   each score over its lanes with shuffles, spreads the batch's eight exps
//   over its lanes and gathers them back, and keeps a running max, sum and
//   accumulator per head in registers (online softmax, one rescale a
//   batch).  At the end of the block the row slots of each head are merged
//   in shared memory.
// * Splits: with one split the block writes the bf16 output; otherwise it
//   writes its f32 (max, sum, accumulator) partials, and a second small
//   kernel, a block for each (slot, query head), merges the splits that
//   intersect the slot's valid rows (it recomputes them from `lengths`, so
//   an exited block leaves nothing to read).  The wrapper picks the split length
//   from kv_len and b·hkv, host ints fixed per decode graph.
//
// Layout: q (b, 1, h, d) and out (b, 1, h, d) contiguous in d; k and v
// (b, kv_len, hkv, d) addressed through their strides, so a page-aligned
// prefix of the cache is read in place.  Built for head dims 64, 128 and
// 256; rep (h / hkv) is a runtime argument, at most two heads for each
// lane group of a block (8192 / d).
#include "common.cuh"

#include <math.h>

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kBatch = 4;  // rows a lane group scores before one rescale
constexpr int kMaxSplits = kThreads;  // the merge takes one split a thread

template <int D>
struct Decode {
  static constexpr int kLanes = D / 16;               // lanes of one (head pair, row slot)
  static constexpr int kGroups = kThreads / kLanes;   // 64, 32, 16
  static constexpr int kTile = 8192 / D;              // rows per ring slot: 16 KB of K
  static constexpr int kSlotElems = kTile * D;
  static constexpr size_t kSmem = 2ull * kStages * kSlotElems * sizeof(bf16);
};

// The slot's rows [lo, hi) of the prefix: j < kv_len, j <= len and, with a
// window, j > len - window.  Empty when lo >= hi.
__device__ __forceinline__ void slot_rows(long long len, int kv_len, int window, int& lo,
                                          int& hi) {
  long long h = len + 1 < kv_len ? len + 1 : kv_len;
  long long l = window > 0 ? len - window + 1 : 0;
  l = l < 0 ? 0 : (l > kv_len ? kv_len : l);
  lo = int(l);
  hi = int(h < 0 ? 0 : h);
}

__device__ __forceinline__ void widen8(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A lane's 16 columns of one row: the 8-column chunks `lane` and
// `lane + lanes`, so neighbouring lanes read neighbouring 16 bytes.
template <int L>
__device__ __forceinline__ void widen_row(const bf16* row, int lane, float* f) {
  widen8(*reinterpret_cast<const uint4*>(row + 8 * lane), f);
  widen8(*reinterpret_cast<const uint4*>(row + 8 * (lane + L)), f + 8);
}

// s[k][h] at a k and h known only at run time, by selects.
__device__ __forceinline__ float pick(const float (&s)[kBatch][2], int k, int h) {
  float v = s[0][0];
#pragma unroll
  for (int kk = 0; kk < kBatch; ++kk)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (kk == k && hh == h) v = s[kk][hh];
  return v;
}

struct KvStrides {
  long long b, r, h;
};

// One (slot, kv head) and one split of its rows.  A group of D / 16 lanes
// owns two query heads of the group (a head pair) and one row slot: each
// lane 16 columns of q and of the two accumulators, so each K and V row
// widened from bf16 serves two heads.  A batch of kBatch rows is scored,
// the scores reduced over the group's lanes, and their exps spread over
// the lanes (one or two each) and gathered back by shuffles.
template <int D>
__global__ void __launch_bounds__(kThreads, 2) decode_split_kernel(
    const bf16* __restrict__ Q, const bf16* __restrict__ K, const bf16* __restrict__ V,
    const long long* __restrict__ lengths, bf16* __restrict__ O, float* __restrict__ part,
    int hkv, int rep, int kv_len, int window, int chunk, int splits, long long q_sb,
    long long q_sh, KvStrides ks, KvStrides vs) {
  using G = Decode<D>;
  constexpr int L = G::kLanes, T = G::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + kStages * G::kSlotElems;

  const int bh = blockIdx.x, split = blockIdx.y;
  const int slot = bh / hkv, g = bh - slot * hkv;
  const int H = hkv * rep;
  const int tid = threadIdx.x;
  int lo, hi;
  slot_rows(lengths[slot], kv_len, window, lo, hi);
  const int r0 = max(split * chunk, lo);
  const int r1 = min(split * chunk + chunk, hi);
  if (r0 >= r1) {
    if (splits == 1)  // no merge follows: the slot's output is zero
      for (int idx = tid; idx < rep * D; idx += kThreads)
        O[((long long)slot * H + g * rep) * D + idx] = __float2bfloat16(0.0f);
    return;
  }

  const int lane = tid % L;
  const int grp = tid / L;
  const int npairs = (rep + 1) / 2;
  const int nrs = G::kGroups / npairs;  // row slots
  const int pair = grp % npairs, rs = grp / npairs;
  const int nh = min(2, rep - 2 * pair);  // heads of the pair (1 for an odd group's last)
  const bool computes = rs < nrs;
  const unsigned gmask =
      L == 32 ? 0xffffffffu : (((1u << L) - 1u) << ((tid % 32) / L * L));

  float q[2][16];
  {
    const float scale = sqrtf(float(D));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h < nh) {
        widen_row<L>(Q + slot * q_sb + (long long)(g * rep + 2 * pair + h) * q_sh, lane,
                     q[h]);
#pragma unroll
        for (int e = 0; e < 16; ++e) q[h][e] = q[h][e] / scale;
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) q[h][e] = 0.0f;
      }
    }
  }

  const bf16* kb = K + slot * ks.b + g * ks.h;
  const bf16* vb = V + slot * vs.b + g * vs.h;
  const int ntiles = (r1 - r0 + T - 1) / T;
  auto load = [&](int t) {
    bf16* dk = sk + (t % kStages) * G::kSlotElems;
    bf16* dv = sv + (t % kStages) * G::kSlotElems;
    const int base = r0 + t * T;
    for (int idx = tid; idx < T * (D / 8); idx += kThreads) {
      const int r = idx / (D / 8), c = (idx - r * (D / 8)) * 8;
      const int row = base + r;
      if (row < r1) {
        cp_async16(dk + r * D + c, kb + row * ks.r + c);
        cp_async16(dv + r * D + c, vb + row * vs.r + c);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load(t);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, acc[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[h][e] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < ntiles) load(t + kStages - 1);
    cp_async_commit();
    if (!computes) continue;
    const bf16* tk = sk + (t % kStages) * G::kSlotElems;
    const bf16* tv = sv + (t % kStages) * G::kSlotElems;
    const int rows = min(T, r1 - (r0 + t * T));
    for (int r = rs; r < rows; r += kBatch * nrs) {
      float s[kBatch][2];
      bool ok[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int rr = r + k * nrs;
        ok[k] = rr < rows;
        s[k][0] = s[k][1] = 0.0f;
        if (ok[k]) {
          float kf[16];
          widen_row<L>(tk + rr * D, lane, kf);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            s[k][0] = fmaf(q[0][e], kf[e], s[k][0]);
            s[k][1] = fmaf(q[1][e], kf[e], s[k][1]);
          }
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
#pragma unroll
          for (int h = 0; h < 2; ++h) s[k][h] += __shfl_xor_sync(gmask, s[k][h], off, L);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (!ok[k]) s[k][0] = s[k][1] = -INFINITY;
        mx[0] = fmaxf(mx[0], s[k][0]);
        mx[1] = fmaxf(mx[1], s[k][1]);
      }
      // each lane takes the exp of one or two of the batch's scores (row
      // k, head h); a shuffle from its lane brings each back to every lane
      float p[kBatch][2];
      if (L == 4) {
        const float e0 = expf(pick(s, lane, 0) - mx[0]);
        const float e1 = expf(pick(s, lane, 1) - mx[1]);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          p[k][0] = __shfl_sync(gmask, e0, k, L);
          p[k][1] = __shfl_sync(gmask, e1, k, L);
        }
      } else {
        const int mk = lane & 3, mh = (lane >> 2) & 1;
        const float e = expf(pick(s, mk, mh) - (mh ? mx[1] : mx[0]));
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
#pragma unroll
          for (int h = 0; h < 2; ++h) p[k][h] = __shfl_sync(gmask, e, k + 4 * h, L);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sc = expf(m[h] - mx[h]);  // 0 on the first batch (m = -inf)
        l[h] = l[h] * sc + ((p[0][h] + p[1][h]) + (p[2][h] + p[3][h]));
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[h][e] *= sc;
        m[h] = mx[h];
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (!ok[k]) continue;
        float vf[16];
        widen_row<L>(tv + (r + k * nrs) * D, lane, vf);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          acc[0][e] = fmaf(p[k][0], vf[e], acc[0][e]);
          acc[1][e] = fmaf(p[k][1], vf[e], acc[1][e]);
        }
      }
    }
  }

  // merge the row slots of each head: (max, sum) and the accumulator
  // columns of every (row slot, head), through shared memory the ring no
  // longer needs
  cp_async_wait<0>();
  __syncthreads();
  float* sm_ml = reinterpret_cast<float*>(smem_raw);
  float* sm_acc = sm_ml + 2 * 2 * G::kGroups;
  if (computes) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= nh) continue;
      const int at = rs * rep + 2 * pair + h;
      if (lane == 0) {
        sm_ml[2 * at] = m[h];
        sm_ml[2 * at + 1] = l[h];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) sm_acc[at * D + 8 * (lane + j * L) + e] = acc[h][8 * j + e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int hh = idx / D, e = idx - hh * D;
    float M = -INFINITY;
    for (int j = 0; j < nrs; ++j) M = fmaxf(M, sm_ml[2 * (j * rep + hh)]);
    float Ls = 0.0f, A = 0.0f;
    for (int j = 0; j < nrs; ++j) {
      const int at = j * rep + hh;
      const float w = expf(sm_ml[2 * at] - M);  // 0 for a row slot that saw no row
      Ls = fmaf(sm_ml[2 * at + 1], w, Ls);
      A = fmaf(sm_acc[at * D + e], w, A);
    }
    if (splits == 1) {
      O[((long long)slot * H + g * rep + hh) * D + e] =
          __float2bfloat16(Ls > 0.0f ? A / Ls : 0.0f);
    } else {
      float* pp = part + (((long long)bh * splits + split) * rep + hh) * (D + 2);
      pp[e] = A;
      if (e == 0) {
        pp[D] = M;
        pp[D + 1] = Ls;
      }
    }
  }
}

// The sum (kMax false) or max of one value a thread over the block.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32;
  __syncthreads();  // scratch may still be read by an earlier reduction
  if (threadIdx.x % 32 == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w) v = kMax ? fmaxf(v, scratch[w]) : v + scratch[w];
  return v;
}

// Merge the splits of one (slot, kv head, query head) that intersect the
// slot's valid rows: a thread a split finds the maxima's max and each
// split's weight, then a thread a column sums the weighted accumulators.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_merge_kernel(
    const float* __restrict__ part, const long long* __restrict__ lengths,
    bf16* __restrict__ O, int hkv, int rep, int kv_len, int window, int chunk, int splits) {
  __shared__ float w[kMaxSplits];
  __shared__ float scratch[kThreads / 32];
  const int bh = blockIdx.x, hh = blockIdx.y;
  const int slot = bh / hkv, g = bh - slot * hkv;
  const int tid = threadIdx.x;
  int lo, hi;
  slot_rows(lengths[slot], kv_len, window, lo, hi);
  const int s0 = lo / chunk;
  const int n = lo < hi ? (hi - 1) / chunk + 1 - s0 : 0;
  const long long step = (long long)rep * (D + 2);
  const float* pp = part + ((long long)(bh * splits + s0) * rep + hh) * (D + 2);
  const float m = tid < n ? pp[tid * step + D] : -INFINITY;
  const float M = block_reduce<true>(m, scratch);
  const float ws = tid < n ? expf(m - M) : 0.0f;
  w[tid] = ws;
  const float Ls = block_reduce<false>(tid < n ? pp[tid * step + D + 1] * ws : 0.0f, scratch);
  for (int e = tid; e < D; e += kThreads) {
    float A = 0.0f;
    for (int j = 0; j < n; ++j) A = fmaf(pp[j * step + e], w[j], A);
    O[((long long)slot * hkv * rep + g * rep + hh) * D + e] =
        __float2bfloat16(Ls > 0.0f ? A / Ls : 0.0f);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const long long* lengths, bf16* o,
           float* part, int B, int hkv, int rep, int kv_len, int window, int chunk,
           int splits, long long q_sb, long long q_sh, KvStrides ks, KvStrides vs,
           cudaStream_t stream) {
  using G = Decode<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::kSmem));
  if (attr != cudaSuccess) return int(attr);
  if (rep > 2 * G::kGroups || chunk % G::kTile || splits != (kv_len + chunk - 1) / chunk ||
      splits > kMaxSplits || (splits > 1 && part == nullptr))
    return -1;
  const dim3 grid(B * hkv, splits);
  decode_split_kernel<D><<<grid, kThreads, G::kSmem, stream>>>(
      q, k, v, lengths, o, part, hkv, rep, kv_len, window, chunk, splits, q_sb, q_sh, ks, vs);
  if (splits > 1)
    decode_merge_kernel<D><<<dim3(B * hkv, rep), kThreads, 0, stream>>>(
        part, lengths, o, hkv, rep, kv_len, window, chunk, splits);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace repro

extern "C" {

// q, out: (B, 1, H, D), out contiguous; k, v: (B, kv_len, HKV, D) with D
// contiguous, strides in elements; lengths: B int64 in device memory;
// window 0 for none; rows per split `chunk` (a multiple of 4096 / D) and
// `splits` = ceil(kv_len / chunk), at most 256; part: B·HKV·splits·(H/HKV)·(D+2) f32 of
// scratch, null with one split.  Returns 0 on success, a cudaError_t code if
// a launch was refused, and -1 for a head size, group or geometry the
// kernel is not built for, or operands not 16-byte aligned.
int repro_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, void* part, int B, int H,
                                int HKV, int kv_len, int D, int window, int chunk,
                                int splits, long long qsb, long long qsh, long long ksb,
                                long long ksr, long long ksh, long long vsb, long long vsr,
                                long long vsh, void* stream) {
  using repro::bf16;
  using repro::KvStrides;
  if (B < 1 || kv_len < 1 || HKV <= 0 || H % HKV || window < 0 || chunk < 1) return -1;
  for (long long st : {qsb, qsh, ksb, ksr, ksh, vsb, vsr, vsh})
    if (st < 0 || st % 8) return -1;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) & 15) return -1;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const long long* lp = static_cast<const long long*>(lengths);
  bf16* op = static_cast<bf16*>(o);
  float* pp = static_cast<float*>(part);
  const KvStrides ks{ksb, ksr, ksh}, vs{vsb, vsr, vsh};
  const int rep = H / HKV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return repro::launch<64>(qp, kp, vp, lp, op, pp, B, HKV, rep, kv_len, window, chunk,
                             splits, qsb, qsh, ks, vs, s);
  if (D == 128)
    return repro::launch<128>(qp, kp, vp, lp, op, pp, B, HKV, rep, kv_len, window, chunk,
                              splits, qsb, qsh, ks, vs, s);
  if (D == 256)
    return repro::launch<256>(qp, kp, vp, lp, op, pp, B, HKV, rep, kv_len, window, chunk,
                              splits, qsb, qsh, ks, vs, s);
  return -1;
}

}  // extern "C"
