// Causal attention of the training step (kernel F) for Hopper: a forward and
// its own backward, bf16 q, k, v in, f32 arithmetic inside, in the port's
// layouts: q (B, S, H, D), k and v (B, S, HKV, D), GQA with rep = H / HKV,
// causal from row 0, head dims 64 and 128.
//
// It replaces no TPU kernel.  The reference trains through plain jnp
// attention (src/repro/model/attention.py `attention` -> `_sdpa`), whose
// Pallas flash kernel has no VJP, and the port did the same in PyTorch
// (model/attention.py `_sdpa_dense`): per layer it materialises the
// (B, HKV, rep, S, S) f32 scores, a masked copy, the probabilities and
// their gradients, some 4.3 GB each at granite's 2 x 4096, three times a
// step under REMAT="full".  This kernel was added for speed and computes the
// same function; it never writes scores, probabilities or their gradients
// to device memory.
//
// Arithmetic, as `_sdpa_dense` does it in f32.  q is scaled by 1/sqrt(D) in
// f32; q, k, v and dO are bf16 and widen exactly; masked entries are exact
// zeros; every product is exact on the widened values and sums are f32.
// The products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 accumulation): a bf16 x bf16 product is exact in f32, and an f32
// operand (q/sqrt(D) at D 128, P, dS) is split into three bf16 parts
// hi + mid + lo that sum to it exactly, each part multiplied exactly.  At
// D 64 the scale is 1/8, a power of two, so the scores are q.k times 1/8 and
// dK is dS^T.q times 1/8, bit for bit what scaling q first gives.  There is
// no TF32 and no bf16 rounding of P or dS.  What differs from the plain path
// is the summation order and where a rounding falls: the forward's online
// softmax (P·V over exp(s - m) with the running max, rescaled as it grows,
// then divided by the row sum), the backward's P = exp(s - m) * (1/l) from
// the stored row max and 1/sum, and its row sum of dP * P taken as dO . O
// over the forward's f32 O.
//
// Passes, each 64-row tiles, four warps of 16 rows, a block for each
// (batch, head, tile), tiles above the diagonal never visited:
// * forward: a block per (batch, q head, q tile), one online pass over the
//   k tiles at or below the diagonal.  It writes O in bf16 and in f32 (kept
//   for the backward's row sums) and each row's max and 1/sum, (2, B, H, S)
//   f32, from which the backward recomputes P.
// * backward: a pre-pass D = rowsum(dO * O) in f32; a dK/dV kernel with a
//   block per (batch, kv head, k tile) that runs over the rep query heads of
//   the group and their q tiles at or below the diagonal and sums them in
//   f32 registers before one cast to bf16, as the plain path's einsum sums
//   over r before its cast; and a dQ kernel with a block per (batch, q
//   head, q tile) over its k tiles.  Each recomputes S and dP in registers.
//   dQ needs no atomics, so the backward is deterministic.
//
// What bounds it on an H100: operations.  Granite's layer (B 2, H 32, S 4096,
// D 64) holds 69 GFLOP a causal product; the forward's two and the
// backward's five products are 0.48 TFLOP, 7.2 ms at the f32 peak of
// 67 TFLOP/s.  With the splits the kernel runs 4 (forward) + 13
// (backward) causal products' worth of bf16 MMAs, 1.19 TFLOP, 1.2 ms at the
// 989 TFLOP/s bf16 peak.  Beside the MMAs run an exp a score in the forward
// and two in the backward (the special-function units) and the splits (the
// CUDA cores).  Tiles are staged in shared memory by cp.async, double
// buffered, and read into fragments with ldmatrix.
#include "common.cuh"

#include <math.h>
#include <string.h>

#include <initializer_list>

namespace repro {
namespace {

constexpr int kTile = 64;  // rows of a q tile and of a k tile
constexpr int kWarps = 4;  // a warp owns 16 rows of its block's tile
constexpr int kThreads = 32 * kWarps;

template <int D>
struct Geo {
  static_assert(D == 64 || D == 128, "kernel F is built for head dims 64 and 128");
  // bf16 parts that hold q / sqrt(D): q itself at D 64 (the scale 1/8 is
  // applied to the products, exactly), three parts of the f32 q / sqrt(128)
  static constexpr int NQ = D == 64 ? 1 : 3;
  static constexpr float kPost = D == 64 ? 0.125f : 1.0f;
  static constexpr int LD = D + kPad;    // shared-memory row stride, elements
  static constexpr int T = kTile * LD;   // elements of one tile
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}

// c += a · b for a 16x16 A fragment and a 16x8 B fragment.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr(smem)), "l"(gmem));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}

// Split two f32 values into three bf16x2 parts whose sums give them back
// exactly: each remainder is exact in f32 and the last fits 8 bits.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  x -= hf.x;
  y -= hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(x, y);
  const float2 mf = __bfloat1622float2(m);
  x -= mf.x;
  y -= mf.y;
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(x, y));
}

// The three A fragments of the 16x16 block held as two 16x8 accumulators
// (columns 0-7 in c0, 8-15 in c1).
__device__ __forceinline__ void split_block(const float (&c0)[4], const float (&c1)[4],
                                            uint32_t (&a)[3][4]) {
  split_pair(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split_pair(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split_pair(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split_pair(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

// This lane's ldmatrix row address for the 16x16 block at (r0, c0) of a
// tile: as an A operand (rows are m) or a transposed B operand (rows are k)
template <int LD>
__device__ __forceinline__ const bf16* at_a(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8;
}

// ... and as a B operand whose rows are n (two n-tiles of 8, k 16 wide)
template <int LD>
__device__ __forceinline__ const bf16* at_b(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8;
}

// (acc0 | acc1) += X[x0:x0+16, :] · Y[y0:y0+16, :]^T over the D columns, X
// and Y given as NX and NY bf16 part tiles (one of them a single part).
template <int D, int NX, int NY>
__device__ __forceinline__ void dot_block(float (&acc0)[4], float (&acc1)[4], const bf16* X,
                                          const bf16* Y, int x0, int y0, int lane) {
  constexpr int LD = Geo<D>::LD, T = Geo<D>::T;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int py = 0; py < NY; ++py) {
      uint32_t b[4];
      ldsm(b, at_b<LD>(Y + py * T, y0, ks * 16, lane));
#pragma unroll
      for (int px = 0; px < NX; ++px) {
        uint32_t a[4];
        ldsm(a, at_a<LD>(X + px * T, x0, ks * 16, lane));
        mma(acc0, a, b[0], b[1]);
        mma(acc1, a, b[2], b[3]);
      }
    }
  }
}

// acc[D/8] += A · Y[y0:y0+16, 0:D], A a 16x16 block as NA part fragments,
// Y given as NY bf16 part tiles whose rows are the k index.
template <int D, int NA, int NY>
__device__ __forceinline__ void acc_block(float (&acc)[D / 8][4], const uint32_t (&a)[NA][4],
                                          const bf16* Y, int y0, int lane) {
  constexpr int LD = Geo<D>::LD, T = Geo<D>::T;
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
#pragma unroll
    for (int py = 0; py < NY; ++py) {
      uint32_t b[4];
      ldsm_t(b, at_a<LD>(Y + py * T, y0, dp * 16, lane));
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        mma(acc[2 * dp], a[i], b[0], b[1]);
        mma(acc[2 * dp + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// The warp's 16 x 64 scaled scores against one k tile; on the diagonal tile
// the entries above it are -inf.
template <int D>
__device__ __forceinline__ void scores(float (&s)[8][4], const bf16* sQ, const bf16* sK,
                                       int warp, int lane, bool diag) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    dot_block<D, Geo<D>::NQ, 1>(s[2 * c], s[2 * c + 1], sQ, sK, warp * 16, c * 16, lane);
  const int row = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[n][e] * Geo<D>::kPost;
      s[n][e] = diag && n * 8 + col + (e & 1) > row + 8 * (e >> 1) ? -INFINITY : x;
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ld, int S,
                                          int r0) {
  load_tile(dst, src, ld, S, D, r0, 0, kTile, D, threadIdx.x, kThreads);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const bf16* __restrict__ qp, long long part, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ o32,
               float* __restrict__ rmax, float* __restrict__ rinv, int S, int H, int HKV) {
  using G = Geo<D>;
  constexpr int T = G::T;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // NQ parts
  bf16* sK = sQ + G::NQ * T;                 // two stages
  bf16* sV = sK + 2 * T;                     // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, hq = bh - b * H, hk = hq / (H / HKV);
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const long long qld = (long long)H * D, kld = (long long)HKV * D;
  const bf16* qb = qp + (long long)b * S * qld + (long long)hq * D;
  const bf16* kb = k + (long long)b * S * kld + (long long)hk * D;
  const bf16* vb = v + (long long)b * S * kld + (long long)hk * D;
#pragma unroll
  for (int p = 0; p < G::NQ; ++p) load_rows<D>(sQ + p * T, qb + p * part, qld, S, qt * kTile);
  load_rows<D>(sK, kb, kld, S, 0);
  load_rows<D>(sV, vb, kld, S, 0);
  cp_async_commit();

  // online over the k tiles: each row's running max m and sum l of
  // exp(s - m), the accumulator rescaled whenever m grows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  for (int j = 0; j <= qt; ++j) {
    if (j < qt) {
      load_rows<D>(sK + ((j + 1) & 1) * T, kb, kld, S, (j + 1) * kTile);
      load_rows<D>(sV + ((j + 1) & 1) * T, vb, kld, S, (j + 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    scores<D>(s, sQ, sK + (j & 1) * T, warp, lane, j == qt);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hf], s[n][2 * hf + 1]));
      const float mn = fmaxf(m[hf], quad_max(mx));
      const float alpha = expf(m[hf] - mn);  // 1 exactly while the max stands
      l[hf] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * hf] *= alpha;
        acc[n][2 * hf + 1] *= alpha;
      }
      m[hf] = mn;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float p[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[i][e] = expf(s[2 * c + i][e] - m[e >> 1]);
          sum[e >> 1] += p[i][e];
        }
      uint32_t a[3][4];
      split_block(p[0], p[1], a);
      acc_block<D, 3, 1>(acc, a, sV + (j & 1) * T, c * 16, lane);
    }
    l[0] += quad_sum(sum[0]);
    l[1] += quad_sum(sum[1]);
    __syncthreads();
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv[e >> 1];

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = qt * kTile + warp * 16 + (lane >> 2) + 8 * hf;
    if (r >= S) continue;
    const long long base = ((long long)b * S + r) * qld + (long long)hq * D + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x = acc[n][2 * hf], y = acc[n][2 * hf + 1];
      *reinterpret_cast<float2*>(o32 + base + n * 8) = make_float2(x, y);
      *reinterpret_cast<__nv_bfloat162*>(o + base + n * 8) = __floats2bfloat162_rn(x, y);
    }
    if ((lane & 3) == 0) {
      const long long at = ((long long)b * H + hq) * S + r;
      rmax[at] = m[hf];
      rinv[at] = inv[hf];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// q / sqrt(D) in f32, as three bf16 parts (D 128).
__global__ void __launch_bounds__(256)
    qsplit_kernel(const bf16* __restrict__ q, bf16* __restrict__ parts, long long pairs,
                  long long part, float scale) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < pairs; i += gridDim.x * 256LL) {
    const float2 x = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(q)[i]);
    uint32_t h, m, l;
    split_pair(x.x * scale, x.y * scale, h, m, l);
    uint32_t* out = reinterpret_cast<uint32_t*>(parts);
    out[i] = h;
    out[i + part / 2] = m;
    out[i + part] = l;
  }
}

// delta[b, h, s] = sum over d of dO · O, in f32; a warp a row.
template <int D>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const bf16* __restrict__ dout, const float* __restrict__ o32,
                 float* __restrict__ delta, long long rows, int S, int H) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
#pragma unroll
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + row * D + c));
    const float2 y = *reinterpret_cast<const float2*>(o32 + row * D + c);
    acc += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bs = row / H;
    const int h = int(row - bs * H);
    const long long b = bs / S;
    delta[(b * H + h) * S + (bs - b * S)] = acc;
  }
}

// dK and dV of one k tile of one kv head: over the group's rep query heads
// and their q tiles at or below the diagonal, summed in f32 registers.
template <int D>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const bf16* __restrict__ qp, long long part, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ rmax, const float* __restrict__ rinv,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int S, int H, int HKV) {
  using G = Geo<D>;
  constexpr int T = G::T, NQ = G::NQ, STAGE = (NQ + 1) * T;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + T;
  bf16* stage0 = sV + T;  // two stages of NQ q parts and dO
  float* stats = reinterpret_cast<float*>(stage0 + 2 * STAGE);  // two stages of m, 1/l, D
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bk = blockIdx.x, b = bk / HKV, hk = bk - b * HKV;
  const int kt = blockIdx.y;  // k tile 0 has the most q tiles: first
  const int rep = H / HKV, nqt = gridDim.y, per = nqt - kt, n_it = rep * per;
  const long long qld = (long long)H * D, kld = (long long)HKV * D;
  const long long kofs = (long long)b * S * kld + (long long)hk * D;
  load_rows<D>(sK, k + kofs, kld, S, kt * kTile);
  load_rows<D>(sV, v + kofs, kld, S, kt * kTile);

  auto load_stage = [&](int it) {
    const int hq = hk * rep + it / per, qt = kt + it % per;
    bf16* st = stage0 + (it & 1) * STAGE;
    const long long qofs = (long long)b * S * qld + (long long)hq * D;
#pragma unroll
    for (int p = 0; p < NQ; ++p) load_rows<D>(st + p * T, qp + p * part + qofs, qld, S, qt * kTile);
    load_rows<D>(st + NQ * T, dout + qofs, qld, S, qt * kTile);
    float* sst = stats + (it & 1) * 3 * kTile;
    const long long at = ((long long)b * H + hq) * S + qt * kTile;
    for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
      const int w = i / kTile, r = i - w * kTile;
      const float* src = (w == 0 ? rmax : w == 1 ? rinv : delta) + at + r;
      if (qt * kTile + r < S)
        cp_async4(sst + i, src);
      else
        sst[i] = 0.0f;
    }
  };

  load_stage(0);
  cp_async_commit();
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;
  const int g = lane >> 2, col = 2 * (lane & 3);
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int qt = kt + it % per;
    const bool diag = qt == kt;
    const bf16* sQ = stage0 + (it & 1) * STAGE;
    const bf16* sO = sQ + NQ * T;
    const float* sm = stats + (it & 1) * 3 * kTile;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 16 q rows at a time
      float st[2][4] = {}, dpt[2][4] = {};
      dot_block<D, 1, NQ>(st[0], st[1], sK, sQ, warp * 16, c * 16, lane);  // S^T
      dot_block<D, 1, 1>(dpt[0], dpt[1], sV, sO, warp * 16, c * 16, lane);  // dP^T
      float p[2][4], ds[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c * 16 + i * 8 + col + (e & 1);  // q row in its tile
          const int kr = warp * 16 + g + 8 * (e >> 1);    // k row in its tile
          const bool live = (!diag || qc >= kr) && qt * kTile + qc < S;
          const float x = live ? expf(st[i][e] * G::kPost - sm[qc]) * sm[kTile + qc] : 0.0f;
          p[i][e] = x;
          ds[i][e] = x * (dpt[i][e] - sm[2 * kTile + qc]);
        }
      uint32_t ap[3][4], as[3][4];
      split_block(p[0], p[1], ap);
      split_block(ds[0], ds[1], as);
      acc_block<D, 3, 1>(dva, ap, sO, c * 16, lane);
      acc_block<D, 3, NQ>(dka, as, sQ, c * 16, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = kt * kTile + warp * 16 + g + 8 * hf;
    if (r >= S) continue;
    const long long base = kofs + (long long)r * kld + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + n * 8) = __floats2bfloat162_rn(
          dka[n][2 * hf] * G::kPost, dka[n][2 * hf + 1] * G::kPost);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + n * 8) =
          __floats2bfloat162_rn(dva[n][2 * hf], dva[n][2 * hf + 1]);
    }
  }
}

// dQ of one q tile of one q head, over its k tiles at or below the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const bf16* __restrict__ qp, long long part, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ rmax, const float* __restrict__ rinv,
              const float* __restrict__ delta, bf16* __restrict__ dq, int S, int H, int HKV,
              float scale) {
  using G = Geo<D>;
  constexpr int T = G::T, NQ = G::NQ;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // NQ parts
  bf16* sO = sQ + NQ * T;                    // dO
  bf16* sK = sO + T;                         // two stages
  bf16* sV = sK + 2 * T;                     // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, hq = bh - b * H, hk = hq / (H / HKV);
  const int qt = gridDim.y - 1 - blockIdx.y;
  const long long qld = (long long)H * D, kld = (long long)HKV * D;
  const long long qofs = (long long)b * S * qld + (long long)hq * D;
  const bf16* kb = k + (long long)b * S * kld + (long long)hk * D;
  const bf16* vb = v + (long long)b * S * kld + (long long)hk * D;
#pragma unroll
  for (int p = 0; p < NQ; ++p) load_rows<D>(sQ + p * T, qp + p * part + qofs, qld, S, qt * kTile);
  load_rows<D>(sO, dout + qofs, qld, S, qt * kTile);
  load_rows<D>(sK, kb, kld, S, 0);
  load_rows<D>(sV, vb, kld, S, 0);
  cp_async_commit();
  const int g = lane >> 2, col = 2 * (lane & 3);
  float m[2], li[2], dd[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = qt * kTile + warp * 16 + g + 8 * hf;
    const long long at = ((long long)b * H + hq) * S + r;
    m[hf] = r < S ? rmax[at] : 0.0f;
    li[hf] = r < S ? rinv[at] : 0.0f;
    dd[hf] = r < S ? delta[at] : 0.0f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  for (int j = 0; j <= qt; ++j) {
    if (j < qt) {
      load_rows<D>(sK + ((j + 1) & 1) * T, kb, kld, S, (j + 1) * kTile);
      load_rows<D>(sV + ((j + 1) & 1) * T, vb, kld, S, (j + 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kst = sK + (j & 1) * T;
    const bf16* vst = sV + (j & 1) * T;
    const bool diag = j == qt;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 16 k rows at a time
      float s[2][4] = {}, dp[2][4] = {};
      dot_block<D, NQ, 1>(s[0], s[1], sQ, kst, warp * 16, c * 16, lane);
      dot_block<D, 1, 1>(dp[0], dp[1], sO, vst, warp * 16, c * 16, lane);
      float ds[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          const int qr = warp * 16 + g + 8 * hf, kc = c * 16 + i * 8 + col + (e & 1);
          const bool live = (!diag || kc <= qr) && qt * kTile + qr < S;
          const float x = live ? expf(s[i][e] * G::kPost - m[hf]) * li[hf] : 0.0f;
          ds[i][e] = x * (dp[i][e] - dd[hf]);
        }
      uint32_t as[3][4];
      split_block(ds[0], ds[1], as);
      acc_block<D, 3, 1>(acc, as, kst, c * 16, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = qt * kTile + warp * 16 + g + 8 * hf;
    if (r >= S) continue;
    const long long base = qofs + (long long)r * qld + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * hf] * scale, acc[n][2 * hf + 1] * scale);
  }
}

template <int D>
constexpr int fwd_smem() {
  return (Geo<D>::NQ + 4) * Geo<D>::T * 2;
}
template <int D>
constexpr int dkdv_smem() {
  return (2 + 2 * (Geo<D>::NQ + 1)) * Geo<D>::T * 2 + 2 * 3 * kTile * 4;
}
template <int D>
constexpr int dq_smem() {
  return (Geo<D>::NQ + 5) * Geo<D>::T * 2;
}

struct Shape {
  int B, S, H, HKV;
  float scale;  // 1 / sqrt(D) in f32, as the plain path multiplies by it
  long long part;
  int nt;
};

// q / sqrt(D) as three bf16 parts into `parts` (D 128); a no-op at D 64,
// where the kernels read q itself.
template <int D>
int split_q(const bf16* q, bf16* parts, const Shape& sh, cudaStream_t stream) {
  if (Geo<D>::NQ == 1) return 0;
  if (parts == nullptr) return -1;
  const long long pairs = sh.part / 2;
  const int blocks = int(pairs / 256 < 4096 ? (pairs + 255) / 256 : 4096);
  qsplit_kernel<<<blocks, 256, 0, stream>>>(q, parts, pairs, sh.part, sh.scale);
  return int(cudaGetLastError());
}

template <int D>
int forward(const bf16* q, const bf16* k, const bf16* v, bf16* parts, bf16* o, float* o32,
            float* stats, const Shape& sh, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem<D>());
  if (attr != cudaSuccess) return int(attr);
  int rc = split_q<D>(q, parts, sh, stream);
  if (rc != 0) return rc;
  const bf16* qp = Geo<D>::NQ == 1 ? q : parts;
  const long long rows = (long long)sh.B * sh.H * sh.S;
  fwd_kernel<D><<<dim3(sh.B * sh.H, sh.nt), kThreads, fwd_smem<D>(), stream>>>(
      qp, sh.part, k, v, o, o32, stats, stats + rows, sh.S, sh.H, sh.HKV);
  return int(cudaGetLastError());
}

template <int D>
int backward(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* o32,
             const float* stats, bf16* parts, float* delta, bf16* dq, bf16* dk, bf16* dv,
             const Shape& sh, cudaStream_t stream) {
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<D>());
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  if (attr1 != cudaSuccess) return int(attr1);
  if (attr2 != cudaSuccess) return int(attr2);
  int rc = split_q<D>(q, parts, sh, stream);
  if (rc != 0) return rc;
  const bf16* qp = Geo<D>::NQ == 1 ? q : parts;
  const long long rows = (long long)sh.B * sh.H * sh.S;
  const float* rmax = stats;
  const float* rinv = stats + rows;
  delta_kernel<D><<<int((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      dout, o32, delta, rows, sh.S, sh.H);
  rc = int(cudaGetLastError());
  if (rc != 0) return rc;
  dkdv_kernel<D><<<dim3(sh.B * sh.HKV, sh.nt), kThreads, dkdv_smem<D>(), stream>>>(
      qp, sh.part, k, v, dout, rmax, rinv, delta, dk, dv, sh.S, sh.H, sh.HKV);
  rc = int(cudaGetLastError());
  if (rc != 0) return rc;
  dq_kernel<D><<<dim3(sh.B * sh.H, sh.nt), kThreads, dq_smem<D>(), stream>>>(
      qp, sh.part, k, v, dout, rmax, rinv, delta, dq, sh.S, sh.H, sh.HKV, sh.scale);
  return int(cudaGetLastError());
}

// The shape checks both entry points share; false for what the kernels are
// not built for.
bool make_shape(int B, int S, int H, int HKV, int D, Shape& sh,
                std::initializer_list<const void*> ptrs) {
  if (B < 1 || S < 1 || HKV < 1 || H % HKV || (D != 64 && D != 128)) return false;
  const int nt = (S + kTile - 1) / kTile;
  if (nt > 65535 || (long long)B * H > 0x7fffffffLL) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  sh = Shape{B, S, H, HKV, 1.0f / sqrtf(float(D)), (long long)B * S * H * D, nt};
  return true;
}

}  // namespace
}  // namespace repro

extern "C" {

// q, o: (B, S, H, D); k, v: (B, S, HKV, D); all contiguous, q, k, v bf16;
// o bf16 and o32 f32; stats: (2, B, H, S) f32, each row's max of the scaled
// scores and 1 / its sum of exp; qparts: 3·B·S·H·D bf16 of scratch at D 128
// (null at D 64).  Returns 0 on success, a cudaError_t code if a launch was
// refused, and -1 for a shape or head size the kernels are not built for.
int repro_train_attention_fwd(const void* q, const void* k, const void* v, void* qparts,
                              void* o, void* o32, void* stats, int B, int S, int H, int HKV,
                              int D, void* stream) {
  using repro::bf16;
  repro::Shape sh;
  if (!repro::make_shape(B, S, H, HKV, D, sh, {q, k, v, qparts, o, o32, stats})) return -1;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* pb = static_cast<bf16*>(qparts);
  bf16* ob = static_cast<bf16*>(o);
  float* o32b = static_cast<float*>(o32);
  float* sb = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return repro::forward<64>(qb, kb, vb, pb, ob, o32b, sb, sh, s);
  return repro::forward<128>(qb, kb, vb, pb, ob, o32b, sb, sh, s);
}

// The gradients of the forward above: dout (B, S, H, D) bf16 contiguous;
// o32 and stats as the forward wrote them; delta: B·H·S f32 of scratch;
// dq like q, dk and dv like k, bf16.
int repro_train_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* o32, const void* stats, void* qparts, void* delta,
                              void* dq, void* dk, void* dv, int B, int S, int H, int HKV, int D,
                              void* stream) {
  using repro::bf16;
  repro::Shape sh;
  if (!repro::make_shape(B, S, H, HKV, D, sh,
                         {q, k, v, dout, o32, stats, qparts, delta, dq, dk, dv}))
    return -1;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  const float* o32b = static_cast<const float*>(o32);
  const float* sb = static_cast<const float*>(stats);
  bf16* pb = static_cast<bf16*>(qparts);
  float* deltab = static_cast<float*>(delta);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return repro::backward<64>(qb, kb, vb, db, o32b, sb, pb, deltab, dqb, dkb, dvb, sh, s);
  return repro::backward<128>(qb, kb, vb, db, o32b, sb, pb, deltab, dqb, dkb, dvb, sh, s);
}

}  // extern "C"
