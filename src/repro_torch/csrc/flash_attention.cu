// Causal flash attention (online softmax) for Hopper, bf16 in and out.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (`_kernel`,
// `flash_attention`): a (b·h, q_blocks, k_blocks) grid with the k axis
// innermost, the running max, sum and accumulator in f32 VMEM scratch,
// blocks wholly above the (offset) diagonal skipped, and `q_offset` a
// runtime scalar so one compiled kernel serves every prefill chunk.  Here
// one block owns BQ query rows of one (batch, head) and loops over the kv
// tiles itself; the f32 state stays in registers.
//
// Layout: q (b, sq, h, d) and out (b, sq, h, d); k and v (b, kv, hkv, d),
// each addressed through its own strides with d contiguous, so the kernel
// reads a page-aligned prefix of the KV cache in place.  Query head h reads
// kv head h / rep (GQA) directly: the repeat the TPU wrapper materializes
// (ops.py:36-39) is never built.
//
// Each warp owns 16 query rows and computes with mma.sync m16n8k16 (bf16 in,
// f32 accumulate): S = Q·Kᵀ for a BK-wide kv tile in registers, scale and
// mask (causal against q_offset + row, and the ragged kv_len edge, with the
// reference's −1e30), the online-softmax update in f32 (row max and sum
// reduced over the four threads that share a row), then O += P·V with P
// rounded to bf16 as the tensor cores take it.  Output is
// acc / max(l, 1e−30).  Kv tiles past the causal diagonal of the block's
// last row, and past kv_len, are never loaded.
//
// What bounds it on an H100: at the serving path's chunk (4·32 heads, 256
// query rows at offset 768 over a 1024-row prefix, d = 64) the causal work
// is 7.5 GFLOP of tensor-core products (7.6 µs at 989 TFLOP/s) against
// 16.8 MB of q, k, v and out (5.0 µs at 3.35 TB/s): operations bound it,
// narrowly.  Reading kv head h/rep in place keeps k and v at their GQA size
// (4× less than the repeated copy) and the four query heads of a group hit
// the same kv tiles in L2.  The softmax runs on CUDA cores between the two
// products; overlapping them (FlashAttention-3's ping-pong with wgmma) and
// TMA loads are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;   // flash_attention.py:28

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides {
  long long b, s, h;   // elements; d is contiguous
};

template <int D, int BK>
__global__ void __launch_bounds__(256)
    flash_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                 const bf16* __restrict__ V, bf16* __restrict__ O, int H, int rep,
                 int sq, int kv_len, int q_offset, int causal, float scale_log2,
                 Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int LD = D + kPad;
  constexpr int NT = BK / 8;    // n8 tiles of S
  constexpr int KC = D / 16;    // k16 chunks of the QKᵀ product
  constexpr int DT = D / 8;     // n8 tiles of O
  const int nwarps = blockDim.x / 32;
  const int BQ = nwarps * 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BK * LD;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;       // row within the warp's 16 (and +8)
  const int t = lane % 4;       // column pair within an n8 tile

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;
  const int q0 = blockIdx.x * BQ;

  const bf16* Qb = Q + b * qs.b + h * qs.h;
  const bf16* Kb = K + b * ks.b + hk * ks.h;
  const bf16* Vb = V + b * vs.b + hk * vs.h;
  bf16* Ob = O + b * os.b + h * os.h;

  load_tile(sQ, Qb, qs.s, sq, D, q0, 0, BQ, D, tid, blockDim.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KC][4];
  {
    const bf16* base = sQ + (warp * 16) * LD;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const bf16* p = base + kc * 16 + 2 * t;
      qf[kc][0] = *reinterpret_cast<const uint32_t*>(p + g * LD);
      qf[kc][1] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD);
      qf[kc][2] = *reinterpret_cast<const uint32_t*>(p + g * LD + 8);
      qf[kc][3] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD + 8);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  const int pos0 = q_offset + q0 + warp * 16 + g;   // sequence position of row g
  const int pos1 = pos0 + 8;

  // kv tiles that hold any column this block's rows may see
  const int last_pos = q_offset + min(q0 + BQ, sq) - 1;
  const int kv_end = causal ? min(kv_len, last_pos + 1) : kv_len;
  const int ntiles = (kv_end + BK - 1) / BK;

  for (int kb = 0; kb < ntiles; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();   // every warp is done with the previous tile
    load_tile(sK, Kb, ks.s, kv_len, D, k0, 0, BK, D, tid, blockDim.x);
    load_tile(sV, Vb, vs.s, kv_len, D, k0, 0, BK, D, tid, blockDim.x);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q·Kᵀ (16 × BK per warp)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const bf16* kp = sK + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp + kc * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + kc * 16 + 8);
        mma_bf16_16816(s[nt], qf[kc], b0, b1);
      }
    }

    // scale (log2 domain), mask, and the running row max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int pos = (e < 2) ? pos0 : pos1;
        const bool ok = col < kv_len && (!causal || col <= pos);
        const float x = ok ? s[nt][e] * scale_log2 : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
    // l stays a per-thread partial sum (all four threads of a row scale it
    // by the same alpha); it is reduced over the row once, at the end
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P·V: the S accumulators of two n8 tiles are the A fragment
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const bf16* vp = sV + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const bf16* v = vp + dn * 8;
        const uint32_t b0 = pack_bf16(v[0], v[LD]);
        const uint32_t b1 = pack_bf16(v[8 * LD], v[9 * LD]);
        mma_bf16_16816(o[dn], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv0 = 1.0f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l[1], 1e-30f);
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(Ob + r0 * os.s + col) =
          __floats2bfloat162_rn(o[dn][0] * inv0, o[dn][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(Ob + r1 * os.s + col) =
          __floats2bfloat162_rn(o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

template <int D, int BK>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H,
           int rep, int sq, int kv_len, int q_offset, int causal, int BQ,
           Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = size_t(BQ + 2 * BK) * (D + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const float scale_log2 = 1.4426950408889634f / sqrtf(float(D));
  dim3 grid((sq + BQ - 1) / BQ, B * H);
  flash_kernel<D, BK><<<grid, (BQ / 16) * 32, smem, stream>>>(
      q, k, v, o, H, rep, sq, kv_len, q_offset, causal, scale_log2, qs, ks, vs, os);
  return int(cudaGetLastError());
}

template <int D>
int launch_d(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H,
             int rep, int sq, int kv_len, int q_offset, int causal, int BQ, int BK,
             Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  switch (BK) {
    case 16: return launch<D, 16>(q, k, v, o, B, H, rep, sq, kv_len, q_offset, causal, BQ, qs, ks, vs, os, stream);
    case 32: return launch<D, 32>(q, k, v, o, B, H, rep, sq, kv_len, q_offset, causal, BQ, qs, ks, vs, os, stream);
    case 64: return launch<D, 64>(q, k, v, o, B, H, rep, sq, kv_len, q_offset, causal, BQ, qs, ks, vs, os, stream);
    case 128: return launch<D, 128>(q, k, v, o, B, H, rep, sq, kv_len, q_offset, causal, BQ, qs, ks, vs, os, stream);
  }
  return -1;
}

}  // namespace
}  // namespace repro

extern "C" {

// q, out: (B, sq, H, D); k, v: (B, kv, H/rep, D), strides in elements.
// Returns 0 on success, a cudaError_t code if the launch was refused, and
// -1 for a head size or tile the kernel is not instantiated for.
int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                               int B, int H, int HKV, int sq, int kv_len, int D,
                               int q_offset, int causal, int BQ, int BK,
                               long long qsb, long long qss, long long qsh,
                               long long ksb, long long kss, long long ksh,
                               long long vsb, long long vss, long long vsh,
                               long long osb, long long oss, long long osh,
                               void* stream) {
  using repro::bf16;
  using repro::Strides;
  if (HKV <= 0 || H % HKV) return -1;
  if (BQ < 16 || BQ > 128 || BQ % 16) return -1;
  const int rep = H / HKV;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return repro::launch_d<16>(qp, kp, vp, op, B, H, rep, sq, kv_len, q_offset, causal, BQ, BK, qs, ks, vs, os, s);
    case 32: return repro::launch_d<32>(qp, kp, vp, op, B, H, rep, sq, kv_len, q_offset, causal, BQ, BK, qs, ks, vs, os, s);
    case 64: return repro::launch_d<64>(qp, kp, vp, op, B, H, rep, sq, kv_len, q_offset, causal, BQ, BK, qs, ks, vs, os, s);
    case 128: return repro::launch_d<128>(qp, kp, vp, op, B, H, rep, sq, kv_len, q_offset, causal, BQ, BK, qs, ks, vs, os, s);
  }
  return -1;
}

}  // extern "C"
