// The WKV7 recurrence shared by the whole-sequence kernels: the forward
// (wkv7_fwd.cu), the backward (wkv7_bwd.cu) and the fused-prep pair
// (wkv7_fused.cu). Per (batch b, head h), state S (64 x 64) f32, rows i the
// value dim, columns j the key dim (rwkvtts_torch/ops/wkv7.py):
//     w_t  = exp(-exp(w_raw_t))
//     sa_i = sum_j S_ij z_j
//     S_ij = S_ij w_j + sa_i b_j + v_i k_j
//     y_i  = sum_j S_ij r_j
// and S = 0 before a position whose reset flag is set.
//
// Forward layout (one CTA of 64 threads per (b, h)): thread i holds row i
// of S in registers, so sa_i and y_i are its own dot products and a step
// needs no reduction. A training forward also writes sa (f32, one vector a
// step) and the state after every CHUNK-th step (the "anchors").
//
// Backward layout (the upstream RWKV-7 CUDA training kernel's): thread i
// holds column i of S, and both row i and column i of dS (192 registers).
// Every column sum the backward needs (dr, dk, db, dw, dz) is then a dot
// product over the thread's own column, every row sum (dv, dsa) one over
// its own row, and only the vector dsa crosses threads (one shared-memory
// pass a step). The state before a step is recovered by stepping back,
//     S_{t-1}[:, i] = (S_t[:, i] - sa b_i - v k_i) / w_i,
// with sa saved by the forward, re-anchored at every saved state. Stepping
// back divides by w: callers keep w_raw <= -0.5 (the model's soft clamp),
// so w >= exp(-exp(-0.5)) = 0.545, and a CHUNK of 16 bounds the growth of
// the rounding error to (1/0.545)^15 in the worst column; measured in f32
// against an f64 reference it stays near 1.5e-5 of max |grad|. A reset
// position cannot be stepped back through (the state it zeroed is gone), so
// there the column is recomputed forward from the last anchor (at most
// CHUNK - 1 steps, with the saved sa).
#pragma once

#include "common.cuh"

namespace wkv7 {

constexpr int N = 64;
constexpr int CHUNK = 16;  // steps between saved states

__host__ __device__ inline int n_chunks(int T_len) { return (T_len + CHUNK - 1) / CHUNK; }

__device__ __forceinline__ float decay(float w_raw) { return expf(-expf(w_raw)); }

// d w / d w_raw for w = exp(-exp(w_raw))
__device__ __forceinline__ float ddecay(float w, float w_raw) { return -w * expf(w_raw); }

// fused prep (ops/wkv7.py::wkv7_fused_plain): k_eff = k_raw (1 + (a - 1) k_a)
__device__ __forceinline__ float k_eff(float k_raw, float a, float k_a) {
    return k_raw * fmaf(a - 1.f, k_a, 1.f);
}

// the l2 norm of kx = k_raw k_k from its sum of squares, eps^2 clamped
// before the sqrt (ops/norm.py::l2_normalize)
__device__ __forceinline__ float l2_norm(float ss) { return sqrtf(fmaxf(ss, 1e-24f)); }

// One forward step for row i (thread i): S <- S diag(w) + sa b^T + v k^T,
// then y_i = S_i . r. The vectors are in shared memory; vi is v[i].
__device__ __forceinline__ void fwd_row_step(float (&S)[N], float vi, const float* r,
                                             const float* w, const float* k,
                                             const float* z, const float* b,
                                             float& sa_out, float& y_out) {
    float sa = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) sa = fmaf(S[j], z[j], sa);
    float yi = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        S[j] = fmaf(S[j], w[j], fmaf(sa, b[j], vi * k[j]));
        yi = fmaf(S[j], r[j], yi);
    }
    sa_out = sa;
    y_out = yi;
}

// One forward step for column i, given the step's sa (the backward's
// recompute path): S[:, i] <- S[:, i] w_i + sa b_i + v k_i.
template <typename T>
__device__ __forceinline__ void fwd_col_step(float (&cS)[N], bool reset, float wi, float ki,
                                             float bi, const float* sa, const T* v) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const float s = reset ? 0.f : cS[j];
        cS[j] = fmaf(s, wi, fmaf(sa[j], bi, to_f32(v[j]) * ki));
    }
}

// Lane gradients of one backward step (w.r.t. the decay w, not w_raw).
struct LaneGrads {
    float dr, dw, dk, dv, dz, db;
};

// One backward step for thread i. On entry cS is column i of S_t, rG / cG
// row i / column i of dL/dS_t excluding step t's own y term; the step's
// vectors (r, w, k, v, z, b, sa, dy) are in shared memory. On exit cS is
// column i of the state before the step (0 at a reset; the caller
// re-anchors it), rG / cG the gradient w.r.t. that state. dsa_sh is a
// shared vector of N floats; the call synchronises the block once, and the
// caller synchronises again before the next call writes dsa_sh.
__device__ __forceinline__ LaneGrads bwd_col_step(float (&cS)[N], float (&rG)[N],
                                                  float (&cG)[N], int i, bool reset,
                                                  const float* r, const float* w,
                                                  const float* k, const float* v,
                                                  const float* z, const float* b,
                                                  const float* sa, const float* dy,
                                                  float* dsa_sh) {
    const float dyi = dy[i], ri = r[i], wi = w[i], ki = k[i], bi = b[i], zi = z[i];
    LaneGrads g;
    float dr = 0.f, dv = 0.f, dk = 0.f, db = 0.f, dsa = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        rG[j] = fmaf(dyi, r[j], rG[j]);
        cG[j] = fmaf(dy[j], ri, cG[j]);
        dr = fmaf(cS[j], dy[j], dr);
        dv = fmaf(rG[j], k[j], dv);
        dk = fmaf(cG[j], v[j], dk);
        db = fmaf(cG[j], sa[j], db);
        dsa = fmaf(rG[j], b[j], dsa);
    }
    const float iw = 1.f / wi;
    float dw = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
        cS[j] = reset ? 0.f : (cS[j] - fmaf(sa[j], bi, v[j] * ki)) * iw;
        dw = fmaf(cS[j], cG[j], dw);
    }
    dsa_sh[i] = dsa;
    __syncthreads();
    float dz = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) dz = fmaf(cS[j], dsa_sh[j], dz);
#pragma unroll
    for (int j = 0; j < N; ++j) {
        rG[j] = reset ? 0.f : fmaf(rG[j], w[j], dsa * z[j]);
        cG[j] = reset ? 0.f : fmaf(cG[j], wi, dsa_sh[j] * zi);
    }
    g.dr = dr;
    g.dw = dw;
    g.dk = dk;
    g.dv = dv;
    g.dz = dz;
    g.db = db;
    return g;
}

// Column i of the state after step t - 1 (t > 0) when the state cannot be
// stepped back to: from the anchor at a chunk boundary, or recomputed from
// the previous anchor (or s0) after a reset. lane(u, wi, ki, bi) gives this
// thread's decay, key and b at step u; sa rows are (b, t, h) f32 with step
// stride `step`, v rows of type T likewise.
template <typename T, typename Lane>
__device__ __forceinline__ void reload_col(float (&cS)[N], int i, int t, const float* anc,
                                           const float* s0, const uint8_t* resets_b,
                                           const float* sa, const T* v, int64_t step,
                                           Lane lane) {
    if (t % CHUNK == 0) {
        const float* a = anc + (int64_t)(t / CHUNK - 1) * N * N;
#pragma unroll
        for (int j = 0; j < N; ++j) cS[j] = a[j * N + i];
        return;
    }
    const int u0 = (t / CHUNK) * CHUNK;  // the chunk holding t - 1 and t
    if (u0 == 0) {
#pragma unroll
        for (int j = 0; j < N; ++j) cS[j] = s0 ? s0[j * N + i] : 0.f;
    } else {
        const float* a = anc + (int64_t)(u0 / CHUNK - 1) * N * N;
#pragma unroll
        for (int j = 0; j < N; ++j) cS[j] = a[j * N + i];
    }
    for (int u = u0; u < t; ++u) {
        float wi, ki, bi;
        lane(u, wi, ki, bi);
        const bool rs = resets_b && resets_b[u];
        fwd_col_step<T>(cS, rs, wi, ki, bi, sa + u * step, v + u * step);
    }
}

}  // namespace wkv7
