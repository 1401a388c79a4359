// WKV7 forward over a whole sequence (the prompt prefill).
//
// Replaces: rwkvtts_tpu/ops/wkv7_pallas.py::_fwd_kernel (reached through
// _fwd_call / wkv7_pallas), on its primal path: y and the final state; the
// chunk-entry states and the saved inverse serve only training and are not
// written.
//
// Recurrence, per (batch b, head h), state S (64 x 64) f32, rows i = value
// dim, columns j = key dim (ops/wkv7.py:3-14):
//     w_t = exp(-exp(w_raw_t))
//     sa_i = sum_j S_ij z_j
//     S_ij = S_ij w_j + sa_i b_j + v_i k_j
//     y_i  = sum_j S_ij r_j
// and S = 0 before a position whose reset flag is set.
//
// What bounds it on this card, reckoned from the prefill shape (B=64,
// T=128, H=16, bf16): the six inputs and y are 7 x 16.8 MB and the f32
// state 2 x 16.8 MB, ~0.15 GB or 45 us at 3.35 TB/s; the arithmetic is
// 3 x 64 x 64 FMAs per (b, h) and step, 3.2 GFLOP in all. Neither bounds
// it: the T steps of each (b, h) are strictly sequential, so the bound is
// the latency of one step (a shared-memory round trip and a block
// barrier) times T.
//
// Design: one CTA of 64 threads per (b,h); thread i keeps state row i in 64
// f32 registers for the whole sequence, so the state touches device memory
// only at entry and exit. Step t's six input vectors are staged in shared
// memory (double-buffered, one barrier per step), and step t+1's values
// are loaded into registers before step t computes, which hides the global
// load latency behind the step's arithmetic. The chunked tensor-core form
// (the TPU kernel's reformulation) is later work.
#include "common.cuh"

namespace {

constexpr int N = 64;

template <typename T>
__global__ void __launch_bounds__(N) wkv7_fwd_kernel(
    int T_len, int H,
    const T* __restrict__ r, const T* __restrict__ w_raw,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ z, const T* __restrict__ b,
    const float* __restrict__ s0, const uint8_t* __restrict__ resets,
    T* __restrict__ y, float* __restrict__ s_out) {
    const int bh = blockIdx.x;  // b * H + h
    const int bi = bh / H;
    const int h = bh - bi * H;
    const int i = threadIdx.x;

    // [buffer][r, w, k, v, z, b][j]
    __shared__ float stage[2][6][N];

    float S[N];
    const int64_t srow = ((int64_t)bh * N + i) * N;
#pragma unroll
    for (int j = 0; j < N; ++j) S[j] = s0 ? s0[srow + j] : 0.f;

    const int64_t step = (int64_t)H * N;              // stride of t
    const int64_t base = ((int64_t)bi * T_len * H + h) * N + i;
    const T* const src[6] = {r, w_raw, k, v, z, b};

    float nxt[6];
    auto load = [&](int t) {
        const int64_t o = base + t * step;
#pragma unroll
        for (int q = 0; q < 6; ++q) nxt[q] = to_f32(src[q][o]);
        nxt[1] = expf(-expf(nxt[1]));  // decay from its raw form
    };
    if (T_len > 0) {
        load(0);
#pragma unroll
        for (int q = 0; q < 6; ++q) stage[0][q][i] = nxt[q];
    }

    for (int t = 0; t < T_len; ++t) {
        __syncthreads();  // stage[t & 1] complete; stage[~t & 1] free
        if (t + 1 < T_len) load(t + 1);
        const float(*cur)[N] = stage[t & 1];
        if (resets && resets[(int64_t)bi * T_len + t]) {
#pragma unroll
            for (int j = 0; j < N; ++j) S[j] = 0.f;
        }
        float sa = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) sa = fmaf(S[j], cur[4][j], sa);
        const float vi = cur[3][i];
        float yi = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
            S[j] = fmaf(S[j], cur[1][j], fmaf(sa, cur[5][j], vi * cur[2][j]));
            yi = fmaf(S[j], cur[0][j], yi);
        }
        y[base + t * step] = from_f32<T>(yi);
        if (t + 1 < T_len) {
#pragma unroll
            for (int q = 0; q < 6; ++q) stage[(t + 1) & 1][q][i] = nxt[q];
        }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) s_out[srow + j] = S[j];
}

template <typename T>
int launch(int B, int T_len, int H, void* r, void* w, void* k, void* v,
           void* z, void* b, void* s0, void* resets, void* y, void* s_out,
           cudaStream_t stream) {
    RWKV_TRY(wkv7_fwd_kernel<T><<<B * H, N, 0, stream>>>(
        T_len, H, (const T*)r, (const T*)w, (const T*)k, (const T*)v,
        (const T*)z, (const T*)b, (const float*)s0, (const uint8_t*)resets,
        (T*)y, (float*)s_out));
    return 0;
}

}  // namespace

// r..b: (B, T, H, 64) of `dtype`; s0: (B, H, 64, 64) f32 or null; resets:
// (B, T) bool or null; y: (B, T, H, 64) of `dtype`; s_out: (B, H, 64, 64)
// f32. Returns the CUDA error of the launch (0 on success).
extern "C" int wkv7_fwd(int dtype, int B, int T_len, int H, void* r, void* w,
                        void* k, void* v, void* z, void* b, void* s0,
                        void* resets, void* y, void* s_out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == DT_F32)
        return launch<float>(B, T_len, H, r, w, k, v, z, b, s0, resets, y, s_out, st);
    if (dtype == DT_BF16)
        return launch<bf16>(B, T_len, H, r, w, k, v, z, b, s0, resets, y, s_out, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
