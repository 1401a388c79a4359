// WKV7 forward over a whole sequence: the prompt prefill, and the forward of
// training (ops/wkv7_cuda.py::WKV7).
//
// Replaces: rwkvtts_tpu/ops/wkv7_pallas.py::_fwd_kernel (reached through
// _fwd_call / wkv7_pallas). It writes y and the final state; for training
// it also writes what the backward (wkv7_bwd.cu) needs: the state at every
// chunk boundary (the TPU kernel's chunk-entry states, one chunk later),
// from which the backward recomputes each chunk. The TPU kernel's saved
// inverse has no counterpart: the recurrence here is the per-step one. The
// recurrence and its layout are in wkv7_core.cuh.
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
// only at entry and exit (and at the chunk boundaries when training). Step
// t's six input vectors are staged in shared memory (double-buffered, one
// barrier per step), and step t+1's values are loaded into registers before
// step t computes, which hides the global load latency behind the step's
// arithmetic. The chunked tensor-core form (the TPU kernel's
// reformulation) is later work.
#include "wkv7_core.cuh"

namespace {

using wkv7::N;

template <typename T, bool SAVE>
__global__ void __launch_bounds__(N) wkv7_fwd_kernel(
    int T_len, int H,
    const T* __restrict__ r, const T* __restrict__ w_raw,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ z, const T* __restrict__ b,
    const float* __restrict__ s0, const uint8_t* __restrict__ resets,
    T* __restrict__ y, float* __restrict__ s_out, float* __restrict__ anchors) {
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
        nxt[1] = wkv7::decay(nxt[1]);
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
        const float yi =
            wkv7::fwd_row_step(S, cur[3][i], cur[0], cur[1], cur[2], cur[4], cur[5]);
        y[base + t * step] = from_f32<T>(yi);
        if (SAVE && ((t + 1) % wkv7::CHUNK == 0 || t + 1 == T_len)) {
            float* a = anchors + (((int64_t)bh * wkv7::n_chunks(T_len) + t / wkv7::CHUNK) * N + i) * N;
#pragma unroll
            for (int j = 0; j < N; j += 4)
                *reinterpret_cast<float4*>(a + j) = make_float4(S[j], S[j + 1], S[j + 2], S[j + 3]);
        }
        if (t + 1 < T_len) {
#pragma unroll
            for (int q = 0; q < 6; ++q) stage[(t + 1) & 1][q][i] = nxt[q];
        }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) s_out[srow + j] = S[j];
}

template <typename T>
int launch(int B, int T_len, int H, void* r, void* w, void* k, void* v, void* z,
           void* b, void* s0, void* resets, void* y, void* s_out, void* anchors,
           cudaStream_t stream) {
    if (anchors)
        RWKV_TRY(wkv7_fwd_kernel<T, true><<<B * H, N, 0, stream>>>(
            T_len, H, (const T*)r, (const T*)w, (const T*)k, (const T*)v,
            (const T*)z, (const T*)b, (const float*)s0, (const uint8_t*)resets,
            (T*)y, (float*)s_out, (float*)anchors));
    else
        RWKV_TRY(wkv7_fwd_kernel<T, false><<<B * H, N, 0, stream>>>(
            T_len, H, (const T*)r, (const T*)w, (const T*)k, (const T*)v,
            (const T*)z, (const T*)b, (const float*)s0, (const uint8_t*)resets,
            (T*)y, (float*)s_out, nullptr));
    return 0;
}

}  // namespace

// r..b: (B, T, H, 64) of `dtype`; s0: (B, H, 64, 64) f32 or null; resets:
// (B, T) bool or null; y: (B, T, H, 64) of `dtype`; s_out: (B, H, 64, 64)
// f32. For training, anchors: (B, H, ceil(T / 16), 64, 64) f32, the state
// after steps 15, 31, ... and T - 1; null for the primal alone. Returns the
// CUDA error of the launch (0 on success).
extern "C" int wkv7_fwd(int dtype, int B, int T_len, int H, void* r, void* w,
                        void* k, void* v, void* z, void* b, void* s0,
                        void* resets, void* y, void* s_out, void* anchors,
                        void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == DT_F32)
        return launch<float>(B, T_len, H, r, w, k, v, z, b, s0, resets, y, s_out,
                             anchors, st);
    if (dtype == DT_BF16)
        return launch<bf16>(B, T_len, H, r, w, k, v, z, b, s0, resets, y, s_out,
                            anchors, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
