// Causal flash attention (online softmax) for Hopper, bf16 in and out.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (`_kernel`
// l.31-68, `flash_attention` l.71-114): a (b·h, q_blocks, k_blocks) grid
// with the k axis innermost, the running max, sum and accumulator in f32
// VMEM scratch, blocks wholly above the (offset) diagonal skipped, and
// `q_offset` a runtime scalar in SMEM, read from a device array, so one
// compiled kernel serves every prefill chunk.  Here a block owns BQ query
// rows of one (batch, head) and loops over its kv tiles itself; the f32
// state stays in registers.
//
// Layout: q (b, sq, h, d) and out (b, sq, h, d); k and v (kb, kv, hkv, d)
// with kb >= b, each addressed through its own strides with d contiguous, so
// the kernel reads a page-aligned prefix of the KV cache in place.  Query
// head h reads kv head h / rep (GQA) directly: the repeat the TPU wrapper
// materializes (ops.py:36-39) is never built.
//
// The chunk's position is device data, as the reference's SMEM scalar is: a
// two-int32 descriptor in device memory holds `q_offset` and the batch row
// of k and v at which the query batch starts (a serving slot).  Each block
// reads it once, so a CUDA graph that captured the launch serves every
// chunk position and every slot: the caller writes the descriptor in place
// before a replay.  The tensor maps span every batch row of the cache at
// kv_len, so one map serves every slot of a kv bucket.  A descriptor that
// points outside the cache (a negative offset, or rows past kb) traps: the
// launch fails instead of reading rows that are not the slot's.
//
// What bounds it on an H100: at granite's serving chunk (one slot: b·h
// 1·32, 256 query rows at offset 768 over a 1024-row prefix, d = 64) the
// causal work is 7.34 M (q, k) pairs, 1.88 GFLOP of tensor-core products
// (1.90 µs at 989 TFLOP/s), against 4.19 MB of q, k, v and out (1.25 µs at
// 3.35 TB/s): operations bound it; gemma3's global-layer chunk (b·h 1·8
// over 4 kv heads, d = 256) does the same 1.88 GFLOP over 6.3 MB.  At these
// sizes, though, a block walks at most 8 (d ≤ 128) or 16 (d = 256) kv
// tiles, so launch, the first loads and the pipeline's fill set a floor far
// above the bound; the design is about keeping every SM busy from the
// first microsecond:
//
// * Enough blocks at one slot.  A block has one consumer warpgroup of
//   BQ = 64 query rows; at b·h 1·32, c 256 that gives 128 blocks on 132
//   SMs (gemma3's 8 heads give 32).  repro_torch.plan.attention_launch_geometry
//   picks the ring depth.
// * Loads off the critical path.  One producer warp keeps TMA loads of K
//   and V tiles (BK = 128 kv rows at d ≤ 128, 64 at d = 256, so that a K+V
//   slot stays at 64 KB) in flight in a ring of `stages` slots, each
//   guarded by a full and an empty mbarrier.  K and V are read through
//   4-D tensor maps (d, hkv, kv, b) over the cache's own strides, encoded
//   once per cache prefix and cached (hopper.cuh); rows past kv_len arrive
//   as zeros and are masked.  Q is a new tensor every call, so it is not
//   given a tensor map: the warpgroup copies its 64 rows once with
//   cp.async while the first K/V tiles are on their way.  At d ≤ 128 each
//   warp then keeps its 16 rows as register fragments for the whole run;
//   at d = 256 those fragments (64 registers a thread) would not fit beside
//   O's 128 f32 accumulators, so Q stays in shared memory, written in the
//   128-byte-swizzled K-major layout TMA gives K, and is read as wgmma's A
//   operand through a descriptor.  Kv tiles past the causal diagonal of the
//   block's last row, and past kv_len, are never loaded.
// * wgmma for both products, bf16 in, f32 accumulate.  S = Q·Kᵀ is
//   m64n{BK}k16 with K K-major in 128-byte-swizzled shared memory (d
//   contiguous, imm-trans-b = 0) and Q from registers (d ≤ 128) or from
//   shared memory (d = 256).  O += P·V is m64n{d}k16
//   with P from registers (the S accumulators rounded to bf16 in place, as
//   the tensor cores take them; the accumulator layout of S is the A
//   fragment layout of the next product) and V MN-major (d contiguous,
//   imm-trans-b = 1), as the matmul kernel reads its weight.
// * The softmax off the tensor cores' critical path.  With one warpgroup
//   per SM nothing else hides its latency, so each step starts S_t and
//   P_{t−1}·V_{t−1} together and runs tile t's softmax while P·V is on the
//   tensor cores (FlashAttention-3's intra-warpgroup pipelining; its
//   ping-pong of two warpgroups would need two query tiles per SM, which
//   one slot does not have).  The softmax: the mask (causal against
//   q_offset + row, and the ragged kv_len edge; only on tiles that reach
//   the diagonal or the edge), the online update in f32 in the log2
//   domain, one FFMA and one ex2 per score, the row max and sum in four
//   independent chains and then over the four threads that share a row.
//   A masked score is −∞ here where the reference writes −1e30: the two
//   differ only for a row with every column masked, which no query row
//   has (column 0 is always visible).  Output is acc / max(l, 1e−30).
//
// Head dims 64, 128 and 256 (one, two or four 64-column swizzle atoms per
// row); other head dims return -1.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;   // flash_attention.py:28
constexpr int kAtom = 64;           // bf16 columns of one 128-byte swizzle row
constexpr int kAlign = 1024;        // swizzle atom: slot alignment
constexpr int kMaxSmem = 232448;    // shared memory a block may use on H100
constexpr int BQ = 64;              // query rows of a block: one consumer warpgroup
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + one producer warp

template <int D>
struct Geometry {
  static_assert(D == 64 || D == 128 || D == 256, "built for head dims 64, 128, 256");
  // kv rows per tile, the n of S = Q·Kᵀ: at d = 256 a slot of 128-row K
  // and V tiles would be 128 KB, and two of them would not fit beside Q
  static constexpr int BK = D > 128 ? 64 : 128;
  // Q as wgmma's A operand from shared memory (d = 256), in 64-column
  // swizzle atoms of BQ rows; else a padded row-major staging tile that
  // the warps read into register fragments
  static constexpr bool kQSmem = D > 128;
  static constexpr uint32_t kTileBytes = BK * D * 2;      // one K or V tile
  static constexpr uint32_t kSlotBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kQLd = kQSmem ? D : D + kPad;      // Q row (padded)
  static constexpr size_t kQBytes = size_t(BQ) * kQLd * 2;
  // slack to align the ring to the swizzle atom; the ring; Q; two mbarriers
  // per slot
  static size_t smem_bytes(int stages) {
    return kAlign + size_t(stages) * kSlotBytes + kQBytes + 2 * stages * sizeof(uint64_t);
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of one kv tile on a thread's S accumulators
// (rows pos0 and pos0 + 8, columns col0 + 8j (+1)): where `edge`, mask
// columns past kv_len or past the row's position to −∞; the running row
// max m (log2 domain, scaled) over the four threads that share a row;
// P = 2^(S·scale − m) in place, one FFMA and one ex2 per score; l updated
// as a per-thread partial sum; alpha, the factor by which O is rescaled.
// A row with every column masked so far keeps m = −1e30, P = 0.  Maxima
// and sums run in four independent chains per row.
template <int SN>
__device__ __forceinline__ void softmax_tile(float (&sacc)[SN], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, int col0,
                                             int pos0, int kv_len, int causal,
                                             float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < SN / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * j + (e & 1);
        const int pos = pos0 + (e >> 1) * 8;
        if (col >= kv_len || (causal && col > pos)) sacc[4 * j + e] = -INFINITY;
      }
    }
  }
  float mr[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) mr[i][0] = mr[i][1] = mr[i][2] = mr[i][3] = -INFINITY;
#pragma unroll
  for (int j = 0; j < SN / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mr[e >> 1][j & 3] = fmaxf(mr[e >> 1][j & 3], sacc[4 * j + e]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = fmaxf(fmaxf(mr[i][0], mr[i][1]), fmaxf(mr[i][2], mr[i][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mnew = fmaxf(m[i], mx * scale_log2);
    alpha[i] = ex2(m[i] - mnew);
    m[i] = mnew;
  }
  float rs[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) rs[i][0] = rs[i][1] = rs[i][2] = rs[i][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < SN / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sacc[4 * j + e], scale_log2, -m[e >> 1]));
      sacc[4 * j + e] = p;
      rs[e >> 1][j & 3] += p;
    }
  }
  // l stays a per-thread partial sum (the four threads of a row scale it
  // by the same alpha); it is reduced over the row once, at the end
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = l[i] * alpha[i] + ((rs[i][0] + rs[i][1]) + (rs[i][2] + rs[i][3]));
}

// Start S = Q·Kᵀ for one tile on the tensor cores (not waited for): Q from registers, K
// K-major at `kt`; a k16 step is 32 bytes along a swizzled row, the second
// 64 columns of d (D = 128) are the next BK·128 bytes.
template <int D>
__device__ __forceinline__ void mma_s(float (&sacc)[Geometry<D>::BK / 2],
                                      const uint32_t (&qf)[D / 16][4], const uint8_t* kt) {
  constexpr int BK = Geometry<D>::BK;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_rs<BK, 0>(sacc, qf[ks], desc_sw128(kt + (ks / 4) * BK * 128 + (ks % 4) * 32, 16, 1024),
                    ks > 0);
  wgmma_commit();
}

// The same with Q from shared memory at `sq`, laid out as K is: the 64-column
// atoms of d are BQ·128 bytes apart (d = 256, BK = 64).
template <int D>
__device__ __forceinline__ void mma_s(float (&sacc)[Geometry<D>::BK / 2], const uint8_t* sq,
                                      const uint8_t* kt) {
  constexpr int BK = Geometry<D>::BK;
  static_assert(BK == 64, "the shared-memory Q product is m64n64k16");
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_m64n64k16_bf16_ss_kk(sacc, desc_sw128(sq + (ks / 4) * BQ * 128 + (ks % 4) * 32, 16, 1024),
                               desc_sw128(kt + (ks / 4) * BK * 128 + (ks % 4) * 32, 16, 1024),
                               ks > 0);
  wgmma_commit();
}

// Start O += P·V for one tile on the tensor cores (not waited for): P from registers, V
// MN-major at `vt`; a k16 step is 16 rows of 128 bytes, the 64-column
// atoms of d are BK·128 bytes apart.
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2],
                                       const uint32_t (&pf)[Geometry<D>::BK / 16][4],
                                       const uint8_t* vt) {
  constexpr int BK = Geometry<D>::BK;
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
    wgmma_rs<D, 1>(o, pf[kc], desc_sw128(vt + kc * 16 * 128, BK * 128, 1024), 1);
  wgmma_commit();
}

// The block's BQ rows of Q from row q0 of a (rows, D) matrix with row
// stride `ld` (zeros past `rows`) into shared memory as a K-major wgmma
// operand with 128-byte swizzle, the layout TMA's SWIZZLE_128B gives K:
// 64-column atoms of BQ rows × 128 bytes one after another, and the 16-byte
// chunk c of row r at chunk c ^ (r % 8) of its row.  Neighbouring threads
// copy neighbouring chunks of a row.
template <int D>
__device__ __forceinline__ void load_q_sw128(uint8_t* sq, const bf16* g, long long ld, int rows,
                                             int q0, int tid) {
  constexpr int kChunks = D / 8;   // 16-byte chunks of a row
  for (int idx = tid; idx < BQ * kChunks; idx += kConsumers) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    uint8_t* dst = sq + (c / 8) * (BQ * 128) + r * 128 + (((c % 8) ^ (r % 8)) * 16);
    const bf16* src = g + (long long)(q0 + r) * ld + c * 8;
    if (q0 + r >= rows) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    } else if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src);
    } else {
      bf16* d = reinterpret_cast<bf16*>(dst);
      for (int e = 0; e < 8; ++e) d[e] = src[e];
    }
  }
}

struct Strides {
  long long b, s, h;   // elements; d is contiguous
};

// grid (ceil(sq/BQ), B·H); a block walks the kv tiles its rows can see.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const bf16* __restrict__ Q,
                 bf16* __restrict__ O, const int* __restrict__ desc, int kv_batch, int H,
                 int rep, int sq, int kv_len, int causal, float scale_log2, Strides qs,
                 Strides os, int stages) {
  using G = Geometry<D>;
  constexpr int BK = G::BK;
  constexpr int KS = D / 16;    // k16 steps of S = Q·Kᵀ
  constexpr int PS = BK / 16;   // k16 steps of O += P·V
  constexpr int SN = BK / 2;    // S accumulators per thread
  constexpr int ON = D / 2;     // O accumulators per thread

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  bf16* sQ = reinterpret_cast<bf16*>(ring + size_t(stages) * G::kSlotBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(sQ) + G::kQBytes);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;
  const int q0 = blockIdx.x * BQ;
  // the descriptor: the chunk's position and the slot's batch row in k, v.
  // Its load sits before the first TMA (which needs the row): 1-2% of the
  // launch at the serving shapes with L2 flushed (PERF.md §6, row B)
  const int q_offset = __ldg(desc);
  const int kv_row = __ldg(desc + 1);
  if (q_offset < 0 || kv_row < 0 || kv_row + int(gridDim.y) / H > kv_batch) __trap();
  const int kb = kv_row + b;

  // kv tiles that hold any column this block's rows may see (at least one:
  // column 0 is visible to every row)
  const int last_pos = q_offset + min(q0 + BQ, sq) - 1;
  const int kv_end = causal ? min(kv_len, last_pos + 1) : kv_len;
  const int ntiles = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: one lane keeps the ring loading
    if (tid == kConsumers) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(&empty[s], phase ^ 1);
        uint8_t* slot = ring + size_t(s) * G::kSlotBytes;
        mbar_arrive_expect_tx(&full[s], G::kSlotBytes);
#pragma unroll
        for (int a = 0; a < D / kAtom; ++a) {
          tma_load_4d(slot + a * BK * 128, &map_k, &full[s], a * kAtom, hk, t * BK, kb);
          tma_load_4d(slot + G::kTileBytes + a * BK * 128, &map_v, &full[s], a * kAtom, hk,
                      t * BK, kb);
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
    return;
  }

  // a consumer thread's place: warp w owns block rows [16w, 16w+16);
  // acc[4j..4j+3] sit at rows row, row, row+8, row+8 and columns
  // 8j + 2·t4 (+1)
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row = warp * 16 + g;
  float o[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  // the block's 64 Q rows (zeros past sq), copied while the first K/V
  // tiles are on their way, then held as register fragments (d ≤ 128) or
  // left in shared memory for wgmma to read (d = 256)
  uint32_t qf[G::kQSmem ? 1 : KS][4];
  if constexpr (G::kQSmem) {
    load_q_sw128<D>(reinterpret_cast<uint8_t*>(sQ), Q + b * qs.b + h * qs.h, qs.s, sq, q0, tid);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async_smem();   // wgmma reads Q through the async proxy
    named_barrier_sync(1, kConsumers);
  } else {
    load_tile(sQ, Q + b * qs.b + h * qs.h, qs.s, sq, D, q0, 0, BQ, D, tid, kConsumers);
    cp_async_commit();
    cp_async_wait<0>();
    named_barrier_sync(1, kConsumers);
    const bf16* p0 = sQ + row * G::kQLd + 2 * t4;
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      const bf16* p = p0 + kc * 16;
      qf[kc][0] = *reinterpret_cast<const uint32_t*>(p);
      qf[kc][1] = *reinterpret_cast<const uint32_t*>(p + 8 * G::kQLd);
      qf[kc][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      qf[kc][3] = *reinterpret_cast<const uint32_t*>(p + 8 * G::kQLd + 8);
    }
  }
  const int pos0 = q_offset + q0 + row;   // sequence positions of the rows
  const int first_pos = q_offset + q0;
  float sacc[SN];
  uint32_t pf[PS][4];   // P of the previous tile, the A operand of P·V

  // Tile t: S_t = Q·K_tᵀ and O += P_{t−1}·V_{t−1} go to the tensor cores
  // together; the softmax of S_t runs while P·V does; then O is rescaled
  // and P_t packed for the next tile.  Slot t−1 is released once its
  // P·V is done, so the ring needs two slots at least.  The first tile
  // has no P·V before it, the last one's comes after the loop.  Both are
  // outside the loop, and P is fenced before every wgmma.fence, because
  // otherwise the compiler moves P's packing past the fence and ptxas
  // inserts a wgmma wait that serializes the softmax behind P·V.
  auto softmax_of = [&](int t, float (&alpha)[2]) {
    const int k0 = t * BK;
    softmax_tile(sacc, m, l, alpha, k0 + BK > kv_len || (causal && k0 + BK - 1 > first_pos),
                 k0 + 2 * t4, pos0, kv_len, causal, scale_log2);
  };
  auto pack = [&]() {
    // the S accumulators of n8 slices 2kc and 2kc+1, rounded to bf16,
    // are the A fragment of k step kc
#pragma unroll
    for (int kc = 0; kc < PS; ++kc) {
      pf[kc][0] = pack_bf16x2(sacc[8 * kc], sacc[8 * kc + 1]);
      pf[kc][1] = pack_bf16x2(sacc[8 * kc + 2], sacc[8 * kc + 3]);
      pf[kc][2] = pack_bf16x2(sacc[8 * kc + 4], sacc[8 * kc + 5]);
      pf[kc][3] = pack_bf16x2(sacc[8 * kc + 6], sacc[8 * kc + 7]);
    }
  };
  auto start_s = [&](const uint8_t* kt) {
    if constexpr (G::kQSmem)
      mma_s<D>(sacc, reinterpret_cast<const uint8_t*>(sQ), kt);
    else
      mma_s<D>(sacc, qf, kt);
  };
  int s = 0;
  uint32_t phase = 0;
  auto next = [&]() {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  };
  mbar_wait(&full[s], phase);
  __syncwarp();  // wgmma is .aligned: each warp enters it converged
  fence_regs(sacc);
  wgmma_fence();
  start_s(ring + size_t(s) * G::kSlotBytes);
  wgmma_wait<0>();
  fence_regs(sacc);
  float alpha[2];
  softmax_of(0, alpha);   // O is still zero: no rescale
  pack();
  int prev = s;
  next();
  for (int t = 1; t < ntiles; ++t) {
    mbar_wait(&full[s], phase);
    __syncwarp();
    fence_regs(sacc);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    start_s(ring + size_t(s) * G::kSlotBytes);
    mma_pv<D>(o, pf, ring + size_t(prev) * G::kSlotBytes + G::kTileBytes);
    wgmma_wait<1>();   // S_t is done; P·V may still run
    fence_regs(sacc);
    softmax_of(t, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    if (tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < ON; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack();
    prev = s;
    next();
  }
  fence_regs(o);
  fence_regs(pf);
  wgmma_fence();
  mma_pv<D>(o, pf, ring + size_t(prev) * G::kSlotBytes + G::kTileBytes);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pf);
  if (tid == 0) mbar_arrive(&empty[prev]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv0 = 1.0f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l[1], 1e-30f);
  const int r0 = q0 + row;
  const int r1 = r0 + 8;
  bf16* Ob = O + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(Ob + r0 * os.s + col) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(Ob + r1 * os.s + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int D>
int launch(const CUtensorMap& map_k, const CUtensorMap& map_v, const bf16* q, bf16* o,
           const int* desc, int B, int KB, int H, int rep, int sq, int kv_len, int causal,
           int stages, Strides qs, Strides os, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return int(attr);
  // the loop holds slot t−1 while it waits on slot t: two slots at least
  const size_t smem = Geometry<D>::smem_bytes(stages);
  if (stages < 2 || smem > size_t(kMaxSmem)) return -1;
  const float scale_log2 = 1.4426950408889634f / sqrtf(float(D));
  const dim3 grid((sq + BQ - 1) / BQ, B * H);
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(map_k, map_v, q, o, desc, KB, H, rep, sq,
                                                    kv_len, causal, scale_log2, qs, os,
                                                    stages);
  return int(cudaGetLastError());
}

// The 4-D map (d, hkv, kv, b) of the first kv_len rows of every batch row of
// a k or v cache, read in boxes of one 64-column swizzle atom × `bk` rows of
// one (batch, kv head).  The stride of
// a dimension of size 1 is never used; it is set to the natural one, so a
// view whose unused stride is odd still encodes.
bool kv_map(const void* p, int B, int HKV, int kv_len, int D, int bk, long long sb,
            long long ss, long long sh, CUtensorMap* out) {
  if (HKV == 1) sh = D;
  if (kv_len == 1) ss = sh * HKV;
  if (B == 1) sb = ss * kv_len;
  const uint64_t dims[4] = {uint64_t(D), uint64_t(HKV), uint64_t(kv_len), uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(sh) * 2, uint64_t(ss) * 2, uint64_t(sb) * 2};
  const uint32_t box[4] = {uint32_t(kAtom), 1, uint32_t(bk), 1};
  return tensor_map(p, 4, dims, strides, box, out);
}

}  // namespace
}  // namespace repro

extern "C" {

// q, out: (B, sq, H, D); k, v: (KB, kv_len, H/rep, D) with KB >= B, strides in
// elements; desc: two int32 in device memory, q_offset and the batch row of
// k and v that query batch 0 reads (q batch i reads kv row desc[1] + i);
// `stages` K/V slots in the load ring.  Returns 0 on success, a cudaError_t
// code if the launch was refused, -1 for a head size or ring the kernel is
// not built for (or k, v not 16-byte aligned with strides that are
// multiples of 8), and -2 if a TMA tensor map could not be encoded.  The
// descriptor is not read here: the kernel checks it.
int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                               const void* desc, int B, int KB, int H, int HKV, int sq,
                               int kv_len, int D, int causal, int stages, long long qsb,
                               long long qss, long long qsh, long long ksb, long long kss,
                               long long ksh,
                               long long vsb, long long vss, long long vsh, long long osb,
                               long long oss, long long osh, void* stream) {
  using repro::bf16;
  using repro::Strides;
  if (B < 1 || KB < B || sq < 1 || kv_len < 1 || HKV <= 0 || H % HKV) return -1;
  if (D != 64 && D != 128 && D != 256) return -1;
  for (long long st : {ksb, kss, ksh, vsb, vss, vsh})
    if (st < 0 || st % 8) return -1;
  if ((reinterpret_cast<uintptr_t>(k) & 15) || (reinterpret_cast<uintptr_t>(v) & 15))
    return -1;
  const int bk = D == 256 ? repro::Geometry<256>::BK : repro::Geometry<64>::BK;
  CUtensorMap map_k, map_v;
  if (!repro::kv_map(k, KB, HKV, kv_len, D, bk, ksb, kss, ksh, &map_k) ||
      !repro::kv_map(v, KB, HKV, kv_len, D, bk, vsb, vss, vsh, &map_v))
    return -2;
  const int rep = H / HKV;
  const Strides qs{qsb, qss, qsh}, os{osb, oss, osh};
  const bf16* qp = static_cast<const bf16*>(q);
  bf16* op = static_cast<bf16*>(o);
  const int* dp = static_cast<const int*>(desc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 256)
    return repro::launch<256>(map_k, map_v, qp, op, dp, B, KB, H, rep, sq, kv_len, causal,
                             stages, qs, os, s);
  if (D == 128)
    return repro::launch<128>(map_k, map_v, qp, op, dp, B, KB, H, rep, sq, kv_len, causal,
                             stages, qs, os, s);
  return repro::launch<64>(map_k, map_v, qp, op, dp, B, KB, H, rep, sq, kv_len, causal,
                           stages, qs, os, s);
}

}  // extern "C"
