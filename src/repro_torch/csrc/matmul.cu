// Planned matmul for Hopper: C[M,N] = A[M,K] · B[K,N], bf16 in and out, f32
// accumulation, one cast to bf16 at the end.
//
// Replaces the TPU kernel src/repro/kernels/matmul_polytops.py (`_kernel`
// l.27-37, `matmul` l.47-71): a (m/bm, n/bn, k/bk) grid, k innermost,
// accumulating in an f32 VMEM scratch.  Here a block owns one output tile
// (or one K split of it) and loops over its k range; the accumulator lives
// in registers.
//
// What bounds it on an H100: at the serving path's shapes, 256 rows × 2048
// × 8192 (gate/up projections) and 256 × 8192 × 2048 (down), the product
// does 8.6 GFLOP (8.7 µs at 989 TFLOP/s) but moves 38.8 MB, mostly the
// weight (11.6 µs at 3.35 TB/s): it is bound by bytes.  So every SM has to
// take part, and each has to keep enough loads in flight to stream its
// share of the weight once.  What each design choice does about that:
//
// * Tiles BM × 128 × 64 (BM = plan "i" ∈ {64, 128}, 128 = plan "j",
//   64 = plan "kk", one 128-byte swizzle row of bf16).  Gate/up gives
//   2 × 64 = 128 blocks on 132 SMs.
// * Split-K for the rest.  The down projection has 2 × 16 = 32 tiles, so
//   its K is split 4 ways (repro_torch.plan.matmul_launch_geometry picks
//   the split and the ring depth): 128 blocks.  Each split writes its f32
//   partial tile to a workspace in device memory (it stays in L2), then
//   takes a ticket from the tile's integer counter; the split that takes
//   the last ticket adds the partials in split order 0, 1, 2, 3 (its own
//   from registers, in its place in that order), casts once and stores, and
//   resets the counter for the next launch.  The sum is deterministic: the
//   same inputs give the same bits on every launch, whichever split
//   finishes last (the engine's greedy tokens depend on it), with no float
//   atomics and no second launch.  A thread-block cluster along K that
//   reduces through distributed shared memory was built first, but an
//   H100 cannot hold the down projection's 32 clusters of four such blocks
//   at once (cudaOccupancyMaxActiveClusters), so they ran in two waves;
//   the workspace needs no co-scheduling.
// * TMA loads into a ring of `stages` shared-memory slots (32 KB each at
//   BM = 128), each guarded by a full and an empty mbarrier.  One producer
//   warp keeps every free slot loading, so up to `stages` tiles are in
//   flight on each SM while the tensor cores work.  A is K-major; B, the
//   weight in its (in, out) orientation, is N-contiguous and is loaded as
//   two 64-column boxes per slot and fed to wgmma with the transpose-B
//   layout: the weights are never copied or transposed.  128-byte swizzle
//   lets wgmma read both without bank conflicts.
// * One or two consumer warpgroups of 64 rows each run wgmma m64n128k16
//   (bf16 → f32) with the accumulator in registers.
// * Ragged M, N and K inside a tile are zero-filled by TMA on load and
//   masked on store.  TMA needs 16-byte row strides, so K and N must be
//   multiples of 8 and the operands 16-byte aligned: the wrapper
//   (kernels/matmul_polytops.py) pads them otherwise.
// * Host cost per launch: the shared-memory attribute is set once per
//   instantiation; tensor maps are cached by pointer and shape
//   (hopper.cuh), so a weight's map is encoded once;
//   cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
//   the library needs no -lcuda.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

using namespace hopper;

constexpr int BN = 128;               // plan "j": wgmma n
constexpr int BK = 64;                // plan "kk": one 128-byte swizzle row
constexpr int kBoxN = 64;             // B box width: one 128-byte swizzle row
constexpr int kEpiLd = BN + 8;        // f32 row stride of the staged tile
constexpr int kAlign = 1024;          // swizzle atom: slot alignment
constexpr int kMaxSmem = 232448;      // shared memory a block may use on H100

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int NWG>
struct Geometry {
  static constexpr int BM = 64 * NWG;
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32;   // + one producer warp
  static constexpr uint32_t kABytes = BM * BK * 2;
  static constexpr uint32_t kBBytes = BK * BN * 2;
  static constexpr uint32_t kSlotBytes = kABytes + kBBytes;
  static constexpr size_t kEpiBytes = size_t(BM) * kEpiLd * sizeof(float);

  __host__ __device__ static size_t ring_or_epilogue(int stages) {
    const size_t ring = size_t(stages) * kSlotBytes;
    return ring > kEpiBytes ? ring : kEpiBytes;
  }
  // slack to align the ring to the swizzle atom; the ring (the staged f32
  // tile reuses it after the main loop); two mbarriers per slot; a flag
  static size_t smem_bytes(int stages) {
    return kAlign + ring_or_epilogue(stages) + 2 * stages * sizeof(uint64_t) + 16;
  }
};

// grid (ceil(N/128), ceil(M/BM), split); block z sums k tiles
// [z·kps, (z+1)·kps).  With split > 1, `ws` holds split f32 partial tiles
// per output tile and `counters` one int per output tile, zero between
// launches.
template <int NWG>
__global__ void __launch_bounds__(Geometry<NWG>::kThreads, 1)
    matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, bf16* __restrict__ C,
                  float* __restrict__ ws, int* __restrict__ counters, int M, int N,
                  int kps, int stages) {
  using G = Geometry<NWG>;
  constexpr int BM = G::BM;
  constexpr int kTileF4 = BM * BN / 4;   // float4s in one f32 tile

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::ring_or_epilogue(stages));
  uint64_t* empty = full + stages;
  int* last_flag = reinterpret_cast<int*>(empty + stages);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = gridDim.z;
  const int z = blockIdx.z;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // a consumer thread's place in the tile: warpgroup wg owns rows
  // [64·wg, 64·wg + 64); acc[4j..4j+3] sit at (r, c), (r, c+1), (r+8, c),
  // (r+8, c+1) with c = 8j + c0
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  if (tid >= G::kConsumers) {
    // producer warp: one lane keeps the ring loading
    if (tid == G::kConsumers) {
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < kps; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        uint8_t* slot = ring + size_t(s) * G::kSlotBytes;
        const int k0 = (z * kps + kt) * BK;
        mbar_arrive_expect_tx(&full[s], G::kSlotBytes);
        tma_load_2d(slot, &map_a, &full[s], k0, m0);
        tma_load_2d(slot + G::kABytes, &map_b, &full[s], n0, k0);
        tma_load_2d(slot + G::kABytes + G::kBBytes / 2, &map_b, &full[s], n0 + kBoxN, k0);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    int s = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < kps; ++kt) {
      mbar_wait(&full[s], phase);
      __syncwarp();  // wgmma is .aligned: each warp enters it converged
      const uint8_t* a = ring + size_t(s) * G::kSlotBytes + wg * 64 * 128;
      const uint8_t* b = ring + size_t(s) * G::kSlotBytes + G::kABytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // A: 16 columns of K are 32 bytes along the swizzled row;
        // B: 16 rows of K are 16 · 128 bytes
        wgmma_m64n128k16_bf16_tn(acc, desc_sw128(a + ks * 32, 16, 1024),
                                 desc_sw128(b + ks * 16 * 128, G::kBBytes / 2, 1024));
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid % 128 == 0) mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
  }

  if (split > 1) {
    // write this split's partial (float4 i of thread t at i·kConsumers + t,
    // coalesced) and take a ticket; the split with the last ticket sums all
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const size_t first = size_t(tile) * split * kTileF4;
    float4* parts = reinterpret_cast<float4*>(ws) + first;
    if (tid < G::kConsumers) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        parts[size_t(z) * kTileF4 + i * G::kConsumers + tid] =
            make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) {
      const int ticket = atomicAdd(&counters[tile], 1);
      *last_flag = ticket == split - 1;
      if (ticket == split - 1) counters[tile] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!*last_flag) return;
    __threadfence();
    if (tid < G::kConsumers) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int p = 0; p < split; ++p) {
          const float4 x =
              p == z ? make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3])
                     : __ldcg(parts + size_t(p) * kTileF4 + i * G::kConsumers + tid);
          v.x += x.x;
          v.y += x.y;
          v.z += x.z;
          v.w += x.w;
        }
        acc[4 * i] = v.x;
        acc[4 * i + 1] = v.y;
        acc[4 * i + 2] = v.z;
        acc[4 * i + 3] = v.w;
      }
    }
  } else if (tid < G::kConsumers) {
    // every consumer's wgmma has read its last slot before the ring is reused
    named_barrier_sync(1, G::kConsumers);
  }

  // stage the f32 tile in shared memory over the ring, then store it as
  // bf16, 8 columns (16 bytes) per thread and step, the ragged edge masked
  float* stage = reinterpret_cast<float*>(ring);
  if (tid < G::kConsumers) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(stage + r * kEpiLd + 8 * j + c0) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(stage + (r + 8) * kEpiLd + 8 * j + c0) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  constexpr int kChunks = BN / 8;
  for (int idx = tid; idx < BM * kChunks; idx += G::kThreads) {
    const int row = idx / kChunks;
    const int col = (idx % kChunks) * 8;
    const int gr = m0 + row;
    const int gc = n0 + col;
    if (gr >= M || gc >= N) continue;  // N is a multiple of 8
    const float4 x = *reinterpret_cast<const float4*>(stage + row * kEpiLd + col);
    const float4 y = *reinterpret_cast<const float4*>(stage + row * kEpiLd + col + 4);
    *reinterpret_cast<uint4*>(C + (long long)gr * N + gc) =
        make_uint4(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w), pack_bf16x2(y.x, y.y),
                   pack_bf16x2(y.z, y.w));
  }
}

template <int NWG>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, bf16* C, float* ws,
           int* counters, int M, int N, int K, int split, int stages,
           cudaStream_t stream) {
  using G = Geometry<NWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_kernel<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return int(attr);
  const int ktiles = (K + BK - 1) / BK;
  if (split < 1 || ktiles % split || stages < 1) return -1;
  if (split > 1 && (ws == nullptr || counters == nullptr)) return -1;
  const size_t smem = G::smem_bytes(stages);
  if (smem > size_t(kMaxSmem)) return -1;
  const dim3 grid((N + BN - 1) / BN, (M + G::BM - 1) / G::BM, split);
  matmul_kernel<NWG><<<grid, G::kThreads, smem, stream>>>(map_a, map_b, C, ws, counters,
                                                          M, N, ktiles / split, stages);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace repro

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, -1 for
// a tile or geometry the kernel is not instantiated for (or K, N not
// multiples of 8, an operand not 16-byte aligned, a split without its
// workspace), and -2 if a TMA tensor map could not be encoded.  `ws`: split ·
// ceil(M/BM) · ceil(N/128) · BM · 128 floats; `counters`: ceil(M/BM) ·
// ceil(N/128) ints, zero before the first launch (each launch leaves them
// zero).  Both may be null when split is 1.
int repro_matmul_bf16(const void* A, const void* B, void* C, void* ws, void* counters,
                      int M, int N, int K, int BM, int BN, int BK, int split,
                      int stages, void* stream) {
  using repro::bf16;
  if (BN != repro::BN || BK != repro::BK || M < 1 || N < 1 || K < 1) return -1;
  if (K % 8 || N % 8 || (reinterpret_cast<uintptr_t>(A) & 15) ||
      (reinterpret_cast<uintptr_t>(B) & 15) || (reinterpret_cast<uintptr_t>(C) & 15))
    return -1;
  if (BM != 64 && BM != 128) return -1;
  CUtensorMap map_a, map_b;
  if (!repro::hopper::tensor_map_2d(A, M, K, BM, BK, &map_a) ||
      !repro::hopper::tensor_map_2d(B, K, N, BK, repro::kBoxN, &map_b))
    return -2;
  bf16* c = static_cast<bf16*>(C);
  float* w = static_cast<float*>(ws);
  int* n = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BM == 64) return repro::launch<1>(map_a, map_b, c, w, n, M, N, K, split, stages, s);
  return repro::launch<2>(map_a, map_b, c, w, n, M, N, K, split, stages, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
