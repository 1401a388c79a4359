// The WKV7 recurrence shared by the whole-sequence kernels, all in the
// chunked form of wkv7_chunk.cuh: the forward (wkv7_fwd.cu), the backward
// (wkv7_bwd.cu) and the fused-prep pair (wkv7_fused.cu). Per (batch b,
// head h), state S (64 x 64) f32, rows i the value dim, columns j the key
// dim (rwkvtts_torch/ops/wkv7.py):
//     w_t  = exp(-exp(w_raw_t))
//     sa_i = sum_j S_ij z_j
//     S_ij = S_ij w_j + sa_i b_j + v_i k_j
//     y_i  = sum_j S_ij r_j
// and S = 0 before a position whose reset flag is set. A training forward
// also writes the state after every CHUNK-th step and after the last (the
// "anchors"), from which the backward recomputes each chunk.
#pragma once

#include "common.cuh"

namespace wkv7 {

constexpr int N = 64;
constexpr int CHUNK = 16;  // steps between saved states

__host__ __device__ inline int n_chunks(int T_len) { return (T_len + CHUNK - 1) / CHUNK; }

// fused prep (ops/wkv7.py::wkv7_fused_plain): k_eff = k_raw (1 + (a - 1) k_a)
__device__ __forceinline__ float k_eff(float k_raw, float a, float k_a) {
    return k_raw * fmaf(a - 1.f, k_a, 1.f);
}

// the l2 norm of kx = k_raw k_k from its sum of squares, eps^2 clamped
// before the sqrt (ops/norm.py::l2_normalize)
__device__ __forceinline__ float l2_norm(float ss) { return sqrtf(fmaxf(ss, 1e-24f)); }

}  // namespace wkv7
