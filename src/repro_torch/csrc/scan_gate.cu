// Mamba selective scan for Hopper, in two forms:
//
//   scan_gate:      h_t = a_t ⊙ h_{t-1} + b_t from h0,
//                   o_t = (h_t · c_t + x_t ⊙ d_skip) ⊙ silu(z_t),
//                   returns o (x's type) and h_last (f32);
//   selective_scan: the same recurrence from zero, y_t = h_t · c_t (f32),
//                   no skip, no gate, no state out.
//
// Replaces the TPU kernels src/repro/kernels/scan_gate.py (`_kernel`,
// `scan_gate`) and src/repro/kernels/mamba_scan.py (`_kernel`,
// `selective_scan`).  Both keep a (d_block × state) hidden state in VMEM
// scratch across a sequential chunk axis of the grid and halve the chunk
// until it divides the sequence.  Here nothing is carried between blocks:
// a block owns d_block channels × state lanes for the whole sequence, one
// thread per h[d, n] held in a register, and loops over time inside the
// kernel with `seq` a runtime argument, so a ragged prefill chunk needs no
// recompile and no divisibility.  The state lanes of one channel are
// neighbouring threads of one warp (state divides 32), so h · c_t is a
// shuffle reduction.  The c rows of `chunk` time steps are staged in shared
// memory at a time; a_t and b_t are loaded for kUnroll steps before the
// recurrence consumes them, so a block waits on device memory once per
// kUnroll steps, not once per step.  selective_scan writes y_t from the
// channel's lane 0.  scan_gate keeps the kUnroll sums of a batch of steps
// in shared memory and then applies the skip and the SiLU gate in f32 on
// the channel's lanes in parallel, lane u for step u (with x_u and z_u
// loaded at the start of the batch), so the gate's exp and divide stay off
// the recurrence's critical path.
//
// Geometry comes from repro_torch.plan.plan_scan_gate / plan_mamba_scan:
// d_block = plan "d", chunk = plan "t", state = plan "n".
//
// What bounds it on an H100: at the serving shape (1 × 256 rows × 8192
// channels × 16 states) a_bar and b_bar are 268 MB of f32 that
// `_ssm_inputs` materialises and the kernel must read once (80 µs at
// 3.35 TB/s), against some 150 MFLOP (about 2 µs at the 67 TFLOP/s f32
// CUDA-core rate): it is bound by bytes.  Loads are coalesced (a block
// reads d_block × state consecutive floats per step).  TMA, prefetching
// further ahead and fusing `_ssm_inputs` into the kernel (so a_bar and
// b_bar never reach device memory) are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kUnroll = 8;
// A block has at most kMaxThreads threads (plan_* give d_block × state =
// 512), and the register budget is held so that two blocks fit an SM: at
// the serving shape the 256 blocks then run in one wave on 132 SMs.
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(bf16* p, float v) { *p = __float2bfloat16(v); }

// kGate: scan_gate (skip, gate, h0, h_last); otherwise selective_scan.
// T: the type of x, z and o (bf16 or f32).
template <bool kGate, typename T>
__global__ void __launch_bounds__(kMaxThreads, 2) scan_kernel(const float* __restrict__ A, const float* __restrict__ B,
                            const float* __restrict__ C, const T* __restrict__ X,
                            const float* __restrict__ Dk, const T* __restrict__ Z,
                            const float* __restrict__ H0, T* __restrict__ O,
                            float* __restrict__ Hout, int seq, int di, int st,
                            int d_block, int chunk) {
  extern __shared__ float sc[];  // chunk × st rows of c, then d_block × kUnroll sums
  float* sy = sc + chunk * st;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = tid % st;
  const int dl = tid / st;
  const int d = blockIdx.x * d_block + dl;
  const bool valid = d < di;
  const long long step = (long long)di * st;  // elements of a (or b) per time step
  const long long base = (long long)bi * seq * step + (long long)d * st + n;
  const float* c = C + (long long)bi * seq * st;

  float h = 0.0f;
  float dk = 0.0f;
  if (kGate && valid) {
    if (H0 != nullptr) h = H0[((long long)bi * di + d) * st + n];
    dk = Dk[d];
  }

  for (int t0 = 0; t0 < seq; t0 += chunk) {
    const int len = min(chunk, seq - t0);
    __syncthreads();  // the previous chunk's reads of sc are done
    for (int i = tid; i < len * st; i += blockDim.x) sc[i] = c[(long long)t0 * st + i];
    __syncthreads();
    for (int u0 = 0; u0 < len; u0 += kUnroll) {
      const long long o0 = ((long long)bi * seq + t0 + u0) * di + d;  // o at step u0
      float av[kUnroll], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = valid && u0 + u < len;
        const long long at = base + (long long)(t0 + u0 + u) * step;
        av[u] = in ? A[at] : 0.0f;
        bv[u] = in ? B[at] : 0.0f;
      }
      float xn = 0.0f, zn = 0.0f;  // the skip and gate inputs of step u0 + n
      if (kGate && valid && n < kUnroll && u0 + n < len) {
        xn = load_f32(X + o0 + (long long)n * di);
        zn = load_f32(Z + o0 + (long long)n * di);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u0 + u >= len) break;  // the same for every thread of the block
        h = av[u] * h + bv[u];
        float y = h * sc[(u0 + u) * st + n];
        for (int off = st >> 1; off > 0; off >>= 1) y += __shfl_xor_sync(0xffffffffu, y, off);
        if (n == 0 && valid) {
          if (kGate)
            sy[dl * kUnroll + u] = y;
          else
            store_f32(O + o0 + (long long)u * di, y);
        }
      }
      if (kGate) {
        __syncwarp();  // the channel's sums are in sy (its lanes share a warp)
        for (int u = n; valid && u < kUnroll && u0 + u < len; u += st) {
          const long long o = o0 + (long long)u * di;
          const float x = u == n ? xn : load_f32(X + o);
          const float z = u == n ? zn : load_f32(Z + o);
          store_f32(O + o, (sy[dl * kUnroll + u] + x * dk) * (z / (1.0f + expf(-z))));
        }
        __syncwarp();  // sy is read before the next batch writes it
      }
    }
  }
  if (kGate && valid && Hout != nullptr) Hout[((long long)bi * di + d) * st + n] = h;
}

// 0 on success, a cudaError_t code if the launch was refused, -1 for a
// geometry the kernel does not take.
template <bool kGate, typename T>
int launch(const float* A, const float* B, const float* C, const T* X, const float* Dk,
           const T* Z, const float* H0, T* O, float* Hout, int batch, int seq, int di,
           int st, int d_block, int chunk, cudaStream_t stream) {
  const int threads = d_block * st;
  if (st < 1 || 32 % st || d_block < 1 || threads % 32 || threads > kMaxThreads || chunk < 1)
    return -1;
  const size_t smem = (size_t(chunk) * st + size_t(d_block) * kUnroll) * sizeof(float);
  if (smem > 48 * 1024) return -1;
  if (batch == 0 || seq == 0 || di == 0) return 0;
  dim3 grid((di + d_block - 1) / d_block, batch);
  scan_kernel<kGate, T><<<grid, threads, smem, stream>>>(A, B, C, X, Dk, Z, H0, O, Hout,
                                                         seq, di, st, d_block, chunk);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace repro

extern "C" {

// a, b: (batch, seq, di, st) f32; c: (batch, seq, st) f32; x, z, o:
// (batch, seq, di) bf16 (x_is_bf16 = 1) or f32; d_skip: (di,) f32; h0 and
// h_last: (batch, di, st) f32, h0 may be null (zeros).  All contiguous.
int repro_scan_gate(const void* A, const void* B, const void* C, const void* X,
                    const void* Dk, const void* Z, const void* H0, void* O, void* Hout,
                    int batch, int seq, int di, int st, int d_block, int chunk,
                    int x_is_bf16, void* stream) {
  using repro::bf16;
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* c = static_cast<const float*>(C);
  const float* dk = static_cast<const float*>(Dk);
  const float* h0 = static_cast<const float*>(H0);
  float* hout = static_cast<float*>(Hout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return repro::launch<true, bf16>(a, b, c, static_cast<const bf16*>(X), dk,
                                     static_cast<const bf16*>(Z), h0, static_cast<bf16*>(O),
                                     hout, batch, seq, di, st, d_block, chunk, s);
  return repro::launch<true, float>(a, b, c, static_cast<const float*>(X), dk,
                                    static_cast<const float*>(Z), h0, static_cast<float*>(O),
                                    hout, batch, seq, di, st, d_block, chunk, s);
}

// a, b: (batch, seq, di, st) f32; c: (batch, seq, st) f32; y: (batch, seq,
// di) f32.  All contiguous.
int repro_selective_scan(const void* A, const void* B, const void* C, void* Y, int batch,
                         int seq, int di, int st, int d_block, int chunk, void* stream) {
  return repro::launch<false, float>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), nullptr, nullptr, nullptr, nullptr,
      static_cast<float*>(Y), nullptr, batch, seq, di, st, d_block, chunk,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
