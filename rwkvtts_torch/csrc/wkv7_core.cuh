// The WKV7 recurrence shared by the whole-sequence kernels: the forward
// (wkv7_fwd.cu), and, through wkv7_chunk.cuh, the chunked backward
// (wkv7_bwd.cu) and the fused-prep pair (wkv7_fused.cu). Per (batch b,
// head h), state S (64 x 64) f32, rows i the value dim, columns j the key
// dim (rwkvtts_torch/ops/wkv7.py):
//     w_t  = exp(-exp(w_raw_t))
//     sa_i = sum_j S_ij z_j
//     S_ij = S_ij w_j + sa_i b_j + v_i k_j
//     y_i  = sum_j S_ij r_j
// and S = 0 before a position whose reset flag is set.
//
// Forward layout (one CTA of 64 threads per (b, h)): thread i holds row i
// of S in registers, so sa_i and y_i are its own dot products and a step
// needs no reduction. A training forward also writes the state after
// every CHUNK-th step and after the last (the "anchors"), from which the
// backward recomputes each chunk.
#pragma once

#include "common.cuh"

namespace wkv7 {

constexpr int N = 64;
constexpr int CHUNK = 16;  // steps between saved states

__host__ __device__ inline int n_chunks(int T_len) { return (T_len + CHUNK - 1) / CHUNK; }

__device__ __forceinline__ float decay(float w_raw) { return expf(-expf(w_raw)); }

// fused prep (ops/wkv7.py::wkv7_fused_plain): k_eff = k_raw (1 + (a - 1) k_a)
__device__ __forceinline__ float k_eff(float k_raw, float a, float k_a) {
    return k_raw * fmaf(a - 1.f, k_a, 1.f);
}

// the l2 norm of kx = k_raw k_k from its sum of squares, eps^2 clamped
// before the sqrt (ops/norm.py::l2_normalize)
__device__ __forceinline__ float l2_norm(float ss) { return sqrtf(fmaxf(ss, 1e-24f)); }

// One forward step for row i (thread i): S <- S diag(w) + sa b^T + v k^T,
// then y_i = S_i . r, returned. The vectors are in shared memory; vi is v[i].
__device__ __forceinline__ float fwd_row_step(float (&S)[N], float vi, const float* r,
                                              const float* w, const float* k,
                                              const float* z, const float* b) {
    float sa = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) sa = fmaf(S[j], z[j], sa);
    float yi = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        S[j] = fmaf(S[j], w[j], fmaf(sa, b[j], vi * k[j]));
        yi = fmaf(S[j], r[j], yi);
    }
    return yi;
}

}  // namespace wkv7
