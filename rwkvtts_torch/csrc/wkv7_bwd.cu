// WKV7 backward over a whole sequence (ops/wkv7_cuda.py::WKV7.backward).
//
// Replaces: rwkvtts_tpu/ops/wkv7_pallas.py::_bwd_kernel (reached through
// _bwd_call, the backward of wkv7_pallas): the reverse sweep that gives
// dr, dw_raw, dk, dv, dz, db in the input dtype and ds0 in f32, with
// resets. The TPU kernel recomputes each chunk in its matrix form from the
// chunk-entry state and differentiates it; this one walks the steps from
// T - 1 down to 0 and steps the state back (wkv7_core.cuh), re-anchored
// at the states wkv7_fwd.cu saved.
//
// What bounds it on this card, at the training shape (B=8, T=2048, H=16,
// bf16): the inputs, dy and the six gradients are 13 x 33.5 MB, sa 67 MB
// and the anchors 268 MB, ~0.77 GB or 0.23 ms at 3.35 TB/s; the
// arithmetic is about 11 x 64 x 64 FMAs per (b, h) and step, 24 GFLOP, or
// 0.36 ms at the 67 TFLOP/s of f32 FMA. Neither bounds it: the 2048 steps
// of each of the 128 (b, h) are sequential, one CTA each, so the bound is
// one step's latency times T.
//
// Design: one CTA of 64 threads per (b, h), the upstream kernel's layout
// (thread i holds column i of S and row i and column i of dS: no per-step
// reduction but the broadcast of dsa). Step t's eight input vectors (r, w,
// k, v, z, b, sa, dy) are staged in shared memory, double-buffered, with
// step t-1's loads issued before step t computes.
#include "wkv7_core.cuh"

namespace {

using wkv7::N;

template <typename T>
__global__ void __launch_bounds__(N) wkv7_bwd_kernel(
    int T_len, int H,
    const T* __restrict__ r, const T* __restrict__ w_raw,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ z, const T* __restrict__ b,
    const float* __restrict__ s0, const uint8_t* __restrict__ resets,
    const float* __restrict__ anchors, const float* __restrict__ sa,
    const T* __restrict__ dy, const float* __restrict__ dsfin,
    T* __restrict__ dr, T* __restrict__ dw, T* __restrict__ dk,
    T* __restrict__ dv, T* __restrict__ dz, T* __restrict__ db,
    float* __restrict__ ds0) {
    const int bh = blockIdx.x;
    const int bi = bh / H;
    const int h = bh - bi * H;
    const int i = threadIdx.x;

    enum { R, W, K, V, Z, B_, SA, DY, WRAW, NV };
    __shared__ float stage[2][NV][N];
    __shared__ float dsa_sh[N];

    const int64_t step = (int64_t)H * N;
    const int64_t row0 = ((int64_t)bi * T_len * H + h) * N;  // (b, 0, h, 0)
    const int64_t base = row0 + i;
    const int nc = wkv7::n_chunks(T_len);
    const float* anc = anchors + (int64_t)bh * nc * N * N;
    const float* s0_bh = s0 ? s0 + (int64_t)bh * N * N : nullptr;
    const uint8_t* rs_b = resets ? resets + (int64_t)bi * T_len : nullptr;

    float cS[N], rG[N], cG[N];
    {
        const float* a = anc + (int64_t)(nc - 1) * N * N;  // the final state
        const float* g = dsfin ? dsfin + (int64_t)bh * N * N : nullptr;
#pragma unroll
        for (int j = 0; j < N; ++j) {
            cS[j] = a[j * N + i];
            rG[j] = g ? g[i * N + j] : 0.f;
            cG[j] = g ? g[j * N + i] : 0.f;
        }
    }

    float nxt[NV];
    auto load = [&](int t) {
        const int64_t o = base + t * step;
        nxt[R] = to_f32(r[o]);
        nxt[WRAW] = to_f32(w_raw[o]);
        nxt[W] = wkv7::decay(nxt[WRAW]);
        nxt[K] = to_f32(k[o]);
        nxt[V] = to_f32(v[o]);
        nxt[Z] = to_f32(z[o]);
        nxt[B_] = to_f32(b[o]);
        nxt[SA] = sa[o];
        nxt[DY] = to_f32(dy[o]);
    };
    auto lane = [&](int u, float& wi, float& ki, float& bi_) {
        const int64_t o = base + u * step;
        wi = wkv7::decay(to_f32(w_raw[o]));
        ki = to_f32(k[o]);
        bi_ = to_f32(b[o]);
    };

    if (T_len > 0) {
        load(T_len - 1);
#pragma unroll
        for (int q = 0; q < NV; ++q) stage[(T_len - 1) & 1][q][i] = nxt[q];
    }
    for (int t = T_len - 1; t >= 0; --t) {
        __syncthreads();  // stage[t & 1] complete; the other buffer and dsa_sh free
        if (t > 0) load(t - 1);
        const float(*cur)[N] = stage[t & 1];
        const bool reset = rs_b && rs_b[t];
        const wkv7::LaneGrads g = wkv7::bwd_col_step(
            cS, rG, cG, i, reset, cur[R], cur[W], cur[K], cur[V], cur[Z], cur[B_],
            cur[SA], cur[DY], dsa_sh);
        const int64_t o = base + t * step;
        dr[o] = from_f32<T>(g.dr);
        dw[o] = from_f32<T>(g.dw * wkv7::ddecay(cur[W][i], cur[WRAW][i]));
        dk[o] = from_f32<T>(g.dk);
        dv[o] = from_f32<T>(g.dv);
        dz[o] = from_f32<T>(g.dz);
        db[o] = from_f32<T>(g.db);
        if (t > 0 && (reset || t % wkv7::CHUNK == 0))
            wkv7::reload_col<T>(cS, i, t, anc, s0_bh, rs_b, sa + row0, v + row0, step, lane);
        if (t > 0) {
#pragma unroll
            for (int q = 0; q < NV; ++q) stage[(t - 1) & 1][q][i] = nxt[q];
        }
    }
    if (ds0) {
        float* d = ds0 + ((int64_t)bh * N + i) * N;
#pragma unroll
        for (int j = 0; j < N; ++j) d[j] = rG[j];
    }
}

template <typename T>
int launch(int B, int T_len, int H, void* r, void* w, void* k, void* v, void* z,
           void* b, void* s0, void* resets, void* anchors, void* sa, void* dy,
           void* dsfin, void* dr, void* dw, void* dk, void* dv, void* dz, void* db,
           void* ds0, cudaStream_t stream) {
    RWKV_TRY(wkv7_bwd_kernel<T><<<B * H, N, 0, stream>>>(
        T_len, H, (const T*)r, (const T*)w, (const T*)k, (const T*)v, (const T*)z,
        (const T*)b, (const float*)s0, (const uint8_t*)resets, (const float*)anchors,
        (const float*)sa, (const T*)dy, (const float*)dsfin, (T*)dr, (T*)dw, (T*)dk,
        (T*)dv, (T*)dz, (T*)db, (float*)ds0));
    return 0;
}

}  // namespace

// r..b, dy: (B, T, H, 64) of `dtype`; s0: (B, H, 64, 64) f32 or null;
// resets: (B, T) bool or null; anchors, sa: as written by wkv7_fwd; dsfin:
// (B, H, 64, 64) f32 or null (zero); dr..db: (B, T, H, 64) of `dtype`;
// ds0: (B, H, 64, 64) f32 or null (not written). Every w_raw must be
// <= -0.5 (see wkv7_core.cuh). Returns the CUDA error of the launch.
extern "C" int wkv7_bwd(int dtype, int B, int T_len, int H, void* r, void* w,
                        void* k, void* v, void* z, void* b, void* s0, void* resets,
                        void* anchors, void* sa, void* dy, void* dsfin, void* dr,
                        void* dw, void* dk, void* dv, void* dz, void* db, void* ds0,
                        void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == DT_F32)
        return launch<float>(B, T_len, H, r, w, k, v, z, b, s0, resets, anchors, sa, dy,
                             dsfin, dr, dw, dk, dv, dz, db, ds0, st);
    if (dtype == DT_BF16)
        return launch<bf16>(B, T_len, H, r, w, k, v, z, b, s0, resets, anchors, sa, dy,
                            dsfin, dr, dw, dk, dv, dz, db, ds0, st);
    return (int)cudaErrorInvalidValue;
}
