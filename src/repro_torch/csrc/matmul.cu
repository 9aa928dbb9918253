// Planned tiled matmul for Hopper: C[M,N] = A[M,K] · B[K,N], bf16 in and
// out, f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul_polytops.py (`_kernel`,
// `matmul`): a (m/bm, n/bn, k/bk) grid with k innermost, accumulating in an
// f32 VMEM scratch.  Here the k axis is a loop inside the block (blocks run
// in parallel in no order, so nothing can be carried between them), and
// the accumulator lives in registers as tensor-core fragments.
//
// Tiles (BM = plan "i", BN = plan "j", BK = plan "kk") come from
// repro_torch.plan.plan_matmul.  Eight warps form a 2×4 grid; each warp owns
// a (BM/2)×(BN/4) piece of the output as 16×16×16 bf16 WMMA fragments.
// A and B tiles stream through two shared-memory stages with cp.async, so
// the next k tile loads while the tensor cores work on the current one.
// Ragged M, N and K are zero-filled at load and masked at store.
//
// What bounds it on an H100: at the serving path's shapes (256 rows ×
// 2048 × 8192 and 256 × 8192 × 2048) the product does 8.6 GFLOP (8.7 µs at
// 989 TFLOP/s) but must read 34 MB of weights (10 µs at 3.35 TB/s), so it
// is bound by bytes: the weight matrix has to stream from device memory
// once.  With BM = 128 each weight tile is read by the two row blocks of a
// 256-row chunk, the second read usually from L2.  The down projection
// (N = 2048) launches only 32 blocks on 132 SMs; splitting K, wgmma and TMA
// are later work.
#include <mma.h>

#include "common.cuh"

namespace repro {
namespace {

using namespace nvcuda;

constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                  bf16* __restrict__ C, int M, int N, int K, int BK) {
  constexpr int WTM = BM / kWarpsM;  // warp tile rows
  constexpr int WTN = BN / kWarpsN;  // warp tile cols
  constexpr int FM = WTM / 16;
  constexpr int FN = WTN / 16;
  static_assert(FM >= 1 && FN >= 1, "warp tile must hold a 16x16 fragment");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  const int a_stage = BM * (BK + kPad);
  const int b_stage = BK * (BN + kPad);
  bf16* sB = sA + 2 * a_stage;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (K + BK - 1) / BK;
  load_tile(sA, A, K, M, K, m0, 0, BM, BK, tid, kThreads);
  load_tile(sB, B, N, K, N, 0, n0, BK, BN, tid, kThreads);
  cp_async_commit();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) {
      // the other stage was last read in iteration kt-1, which ended
      // with a barrier
      const int nxt = cur ^ 1;
      load_tile(sA + nxt * a_stage, A, K, M, K, m0, (kt + 1) * BK, BM, BK, tid,
                kThreads);
      load_tile(sB + nxt * b_stage, B, N, K, N, (kt + 1) * BK, n0, BK, BN, tid,
                kThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* a = sA + cur * a_stage;
    const bf16* b = sB + cur * b_stage;
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * WTM + i * 16) * (BK + kPad) + kk,
                               BK + kPad);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * (BN + kPad) + wn * WTN + j * 16,
                               BN + kPad);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: fragments → shared memory (f32) → bf16 with the ragged
  // edge masked; consecutive threads write consecutive columns
  float* stage = reinterpret_cast<float*>(smem_raw);
  constexpr int LDS = BN + 4;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(stage + (wm * WTM + i * 16) * LDS + wn * WTN + j * 16,
                              acc[i][j], LDS, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN;
    const int c = idx - r * BN;
    if (m0 + r < M && n0 + c < N)
      C[(long long)(m0 + r) * N + n0 + c] = __float2bfloat16(stage[r * LDS + c]);
  }
}

template <int BM, int BN>
int launch(const bf16* A, const bf16* B, bf16* C, int M, int N, int K, int BK,
           cudaStream_t stream) {
  const size_t main_bytes =
      2 * (size_t(BM) * (BK + kPad) + size_t(BK) * (BN + kPad)) * sizeof(bf16);
  const size_t epi_bytes = size_t(BM) * (BN + 4) * sizeof(float);
  const size_t smem = main_bytes > epi_bytes ? main_bytes : epi_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<BM, BN><<<grid, kThreads, smem, stream>>>(A, B, C, M, N, K, BK);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace repro

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, and
// -1 for a tile the kernel is not instantiated for.
int repro_matmul_bf16(const void* A, const void* B, void* C, int M, int N, int K,
                      int BM, int BN, int BK, void* stream) {
  using repro::bf16;
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  bf16* c = static_cast<bf16*>(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BK < 16 || BK > 128 || BK % 16) return -1;
  if (BN == 64) {
    if (BM == 32) return repro::launch<32, 64>(a, b, c, M, N, K, BK, s);
    if (BM == 64) return repro::launch<64, 64>(a, b, c, M, N, K, BK, s);
    if (BM == 128) return repro::launch<128, 64>(a, b, c, M, N, K, BK, s);
  } else if (BN == 128) {
    if (BM == 32) return repro::launch<32, 128>(a, b, c, M, N, K, BK, s);
    if (BM == 64) return repro::launch<64, 128>(a, b, c, M, N, K, BK, s);
    if (BM == 128) return repro::launch<128, 128>(a, b, c, M, N, K, BK, s);
  }
  return -1;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
