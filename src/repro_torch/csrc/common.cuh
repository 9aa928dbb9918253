// Helpers shared by the port's Hopper kernels: asynchronous global→shared
// copies (cp.async, Ampere and later) and a tile loader that zero-fills the
// ragged edge of a matrix.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

typedef __nv_bfloat16 bf16;

// Shared-memory row padding in elements: 16 bytes, which keeps every row
// start 16-byte aligned for cp.async and spreads a column of fragment
// loads over distinct banks.
constexpr int kPad = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the rows×cols tile at (r0, c0) of a row-major matrix with `rows_total`
// rows, `cols_total` columns and a row stride of `ld` elements into shared
// memory with a row stride of `cols + kPad`.  Elements outside the matrix
// become zero.  16-byte chunks that lie wholly inside the matrix and are
// aligned go through cp.async; the rest is copied element by element.
// `cols` must be a multiple of 8.
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g, long long ld,
                                          int rows_total, int cols_total, int r0,
                                          int c0, int rows, int cols, int tid,
                                          int nthreads) {
  const int chunks = cols / 8;
  for (int idx = tid; idx < rows * chunks; idx += nthreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const int gr = r0 + r;
    const int gc = c0 + c;
    bf16* dst = smem + r * (cols + kPad) + c;
    const bf16* src = g + (long long)gr * ld + gc;
    if (gr < rows_total && gc + 8 <= cols_total &&
        (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src);
    } else {
      for (int e = 0; e < 8; ++e) {
        dst[e] = (gr < rows_total && gc + e < cols_total) ? src[e]
                                                          : __float2bfloat16(0.0f);
      }
    }
  }
}

}  // namespace repro
