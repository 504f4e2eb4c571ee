// Shared device definitions of the attention kernels: the bf16 type, the
// masked score and the full warp mask.  The one-token decode (row, paged
// and one shard's partial) is decode_tc.cuh, the multi-query verify body
// (row and paged verify, chunked prefill) verify_tc.cuh, both on the
// tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;   // the JAX kernels' masked score
constexpr unsigned FULL = 0xffffffffu;

}  // namespace repro
