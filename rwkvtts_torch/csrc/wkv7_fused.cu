// WKV7 with its elementwise band fused in: forward and backward
// (ops/wkv7_cuda.py::WKV7Fused).
//
// Replaces: rwkvtts_tpu/ops/wkv7_pallas.py::_fwd_kernel_fused and
// _bwd_kernel_fused (reached through _fused_fwd_call / _fused_bwd_call, the
// custom-vjp pair of wkv7_pallas_fused). Per head, with per-head
// parameters k_k, k_a, r_k, ln_w, ln_b (64 each):
//     kk    = l2norm(k_raw k_k)            (eps^2 = 1e-24 before the sqrt)
//     k_eff = k_raw (1 + (a - 1) k_a),  z = -kk,  b = kk a
//     y     = WKV7(r, w_raw, k_eff, v, z, b)   (wkv7_core.cuh, f32)
//     out   = GroupNorm_64(y) ln_w + ln_b + (sum r k_eff r_k) v
// The forward writes `out` in v's dtype and the final state; for training
// also the anchors, sa, the normalised y (xhat, f32) and three scalars a
// step (|kx|^2, 1/std of y, the bonus sum). The backward recomputes the
// prologue from the inputs, differentiates the epilogue (GroupNorm and
// bonus adjoints), runs the recurrence backward of wkv7_bwd.cu, then the
// l2norm adjoint, and gives dr, dw_raw, dk_raw, dv, da in the input dtype,
// the five per-head parameter gradients per (b, h) row (summed over the
// batch by the wrapper: no atomics, so the sums are deterministic) and
// ds0 in f32.
//
// What bounds it on this card, at the training shape (B=8, T=2048, H=16,
// bf16): the forward moves ~0.3 GB of inputs and outputs plus ~0.5 GB of
// saved f32 state (0.24 ms at 3.35 TB/s) and the backward ~1.1 GB (0.33
// ms); the arithmetic is ~3 x 64 x 64 FMAs a step forward and ~11 x 64 x
// 64 backward, 6.4 and 24 GFLOP. As for wkv7_fwd / wkv7_bwd, neither
// bounds them: each (b, h) is 2048 sequential steps in one CTA, and the
// bound is one step's latency (here also two or three block reductions)
// times T.
//
// Design: the same CTA of 64 threads per (b, h) and the same recurrence
// code as wkv7_fwd.cu (row layout) and wkv7_bwd.cu (column layout). The
// prologue runs while a step is staged: thread i computes lane i of k_eff,
// kx and the partial sums of |kx|^2 (and, backward, of the GroupNorm
// adjoint) into shared memory; after the step's barrier each thread
// finishes its own lane of z and b (or dy) and a second barrier publishes
// them. The GroupNorm statistics and the l2norm adjoint are block sums
// over the 64 lanes.
#include "wkv7_core.cuh"

namespace {

using wkv7::N;
constexpr int NWARPS = N / 32;

struct HeadParams {
    float kk, ka, rk, lw, lb;
};

__device__ __forceinline__ HeadParams head_params(int h, int i, const float* k_k,
                                                  const float* k_a, const float* r_k,
                                                  const float* ln_w, const float* ln_b) {
    const int o = h * N + i;
    return {k_k[o], k_a[o], r_k[o], ln_w[o], ln_b ? ln_b[o] : 0.f};
}

// b_i and z_i = -kk_i from the raw key, given the step's |kx|^2
__device__ __forceinline__ float kk_of(float k_raw, float kkp, float ss) {
    return (k_raw * kkp) / wkv7::l2_norm(ss);
}

template <typename T, bool SAVE>
__global__ void __launch_bounds__(N) wkv7_fused_fwd_kernel(
    int T_len, int H, float ln_eps,
    const T* __restrict__ r, const T* __restrict__ w_raw,
    const T* __restrict__ k_raw, const T* __restrict__ v, const T* __restrict__ a,
    const float* __restrict__ k_k, const float* __restrict__ k_a,
    const float* __restrict__ r_k, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b,
    const float* __restrict__ s0, const uint8_t* __restrict__ resets,
    T* __restrict__ y, float* __restrict__ s_out, float* __restrict__ anchors,
    float* __restrict__ sa_out, float* __restrict__ xhat_out, float* __restrict__ stats) {
    const int bh = blockIdx.x;
    const int bi = bh / H;
    const int h = bh - bi * H;
    const int i = threadIdx.x;
    const int lane = i & 31, warp = i >> 5;
    const HeadParams p = head_params(h, i, k_k, k_a, r_k, ln_w, ln_b);

    // Z and B_ hold kx and a while staged; the step turns them into z and b
    enum { R, W, KE, V, Z, B_, NV };
    __shared__ float stage[2][NV][N];
    __shared__ float part[2][NWARPS][2];  // [buffer][warp][|kx|^2, bonus sum]
    __shared__ float red[NWARPS];

    float S[N];
    const int64_t srow = ((int64_t)bh * N + i) * N;
#pragma unroll
    for (int j = 0; j < N; ++j) S[j] = s0 ? s0[srow + j] : 0.f;

    const int64_t step = (int64_t)H * N;
    const int64_t base = ((int64_t)bi * T_len * H + h) * N + i;

    float nxt[NV];
    auto load = [&](int t) {
        const int64_t o = base + t * step;
        const float kr = to_f32(k_raw[o]), av = to_f32(a[o]);
        nxt[R] = to_f32(r[o]);
        nxt[W] = wkv7::decay(to_f32(w_raw[o]));
        nxt[KE] = wkv7::k_eff(kr, av, p.ka);
        nxt[V] = to_f32(v[o]);
        nxt[Z] = kr * p.kk;
        nxt[B_] = av;
    };
    auto put = [&](int buf) {
#pragma unroll
        for (int q = 0; q < NV; ++q) stage[buf][q][i] = nxt[q];
        const float ss = warp_sum(nxt[Z] * nxt[Z]);
        const float c = warp_sum(nxt[R] * nxt[KE] * p.rk);
        if (lane == 0) {
            part[buf][warp][0] = ss;
            part[buf][warp][1] = c;
        }
    };
    if (T_len > 0) {
        load(0);
        put(0);
    }

    for (int t = 0; t < T_len; ++t) {
        __syncthreads();  // stage[t & 1] complete; the other buffer free
        if (t + 1 < T_len) load(t + 1);
        float(*cur)[N] = stage[t & 1];
        float ss = 0.f, c = 0.f;
#pragma unroll
        for (int q = 0; q < NWARPS; ++q) {
            ss += part[t & 1][q][0];
            c += part[t & 1][q][1];
        }
        {
            const float kk = cur[Z][i] / wkv7::l2_norm(ss);
            cur[Z][i] = -kk;
            cur[B_][i] = kk * cur[B_][i];
        }
        __syncthreads();  // z and b complete
        if (resets && resets[(int64_t)bi * T_len + t]) {
#pragma unroll
            for (int j = 0; j < N; ++j) S[j] = 0.f;
        }
        float sa, yi;
        wkv7::fwd_row_step(S, cur[V][i], cur[R], cur[W], cur[KE], cur[Z], cur[B_], sa, yi);
        // ln_x GroupNorm over the 64 lanes, then the bonus
        const float mu = block_sum<NWARPS>(yi, red) * (1.f / N);
        const float d = yi - mu;
        const float var = block_sum<NWARPS>(d * d, red) * (1.f / N);
        const float rstd = 1.f / sqrtf(var + ln_eps);
        const float xh = d * rstd;
        const int64_t o = base + t * step;
        y[o] = from_f32<T>(fmaf(xh, p.lw, p.lb) + c * cur[V][i]);
        if constexpr (SAVE) {
            sa_out[o] = sa;
            xhat_out[o] = xh;
            if (i == 0)
                *reinterpret_cast<float4*>(stats + ((int64_t)bh * T_len + t) * 4) =
                    make_float4(ss, rstd, c, 0.f);
            if ((t + 1) % wkv7::CHUNK == 0 || t + 1 == T_len) {
                float* an = anchors + (((int64_t)bh * wkv7::n_chunks(T_len) + t / wkv7::CHUNK) * N + i) * N;
#pragma unroll
                for (int j = 0; j < N; j += 4)
                    *reinterpret_cast<float4*>(an + j) = make_float4(S[j], S[j + 1], S[j + 2], S[j + 3]);
            }
        }
        if (t + 1 < T_len) put((t + 1) & 1);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) s_out[srow + j] = S[j];
}

template <typename T>
__global__ void __launch_bounds__(N) wkv7_fused_bwd_kernel(
    int T_len, int H,
    const T* __restrict__ r, const T* __restrict__ w_raw,
    const T* __restrict__ k_raw, const T* __restrict__ v, const T* __restrict__ a,
    const float* __restrict__ k_k, const float* __restrict__ k_a,
    const float* __restrict__ r_k, const float* __restrict__ ln_w,
    const float* __restrict__ s0, const uint8_t* __restrict__ resets,
    const float* __restrict__ anchors, const float* __restrict__ sa,
    const float* __restrict__ xhat, const float* __restrict__ stats,
    const T* __restrict__ dy, const float* __restrict__ dsfin,
    T* __restrict__ dr, T* __restrict__ dw, T* __restrict__ dk, T* __restrict__ dv,
    T* __restrict__ da, float* __restrict__ dparams, float* __restrict__ ds0) {
    const int bh = blockIdx.x;
    const int bi = bh / H;
    const int h = bh - bi * H;
    const int i = threadIdx.x;
    const int lane = i & 31, warp = i >> 5;
    const HeadParams p = head_params(h, i, k_k, k_a, r_k, ln_w, nullptr);

    // the recurrence's vectors, then this thread's own lane of the rest
    enum { R, W, KE, V, Z, B_, SA, DY, WRAW, KRAW, A, DOUT, XH, DXH, NV };
    __shared__ float stage[2][NV][N];
    __shared__ float part[2][NWARPS][3];  // [buffer][warp][sum dxhat, sum dxhat xhat, sum dout v]
    __shared__ float sstat[2][3];         // [buffer][|kx|^2, 1/std, bonus sum]
    __shared__ float red[NWARPS];
    __shared__ float dsa_sh[N];

    const int64_t step = (int64_t)H * N;
    const int64_t row0 = ((int64_t)bi * T_len * H + h) * N;
    const int64_t base = row0 + i;
    const int nc = wkv7::n_chunks(T_len);
    const float* anc = anchors + (int64_t)bh * nc * N * N;
    const float* s0_bh = s0 ? s0 + (int64_t)bh * N * N : nullptr;
    const uint8_t* rs_b = resets ? resets + (int64_t)bi * T_len : nullptr;
    const float* st_bh = stats + (int64_t)bh * T_len * 4;

    float cS[N], rG[N], cG[N];
    {
        const float* an = anc + (int64_t)(nc - 1) * N * N;
        const float* g = dsfin ? dsfin + (int64_t)bh * N * N : nullptr;
#pragma unroll
        for (int j = 0; j < N; ++j) {
            cS[j] = an[j * N + i];
            rG[j] = g ? g[i * N + j] : 0.f;
            cG[j] = g ? g[j * N + i] : 0.f;
        }
    }

    float nxt[NV];
    float nst[3];
    auto load = [&](int t) {
        const int64_t o = base + t * step;
        const float4 st = *reinterpret_cast<const float4*>(st_bh + (int64_t)t * 4);
        nst[0] = st.x;
        nst[1] = st.y;
        nst[2] = st.z;
        nxt[KRAW] = to_f32(k_raw[o]);
        nxt[A] = to_f32(a[o]);
        nxt[WRAW] = to_f32(w_raw[o]);
        nxt[R] = to_f32(r[o]);
        nxt[W] = wkv7::decay(nxt[WRAW]);
        nxt[KE] = wkv7::k_eff(nxt[KRAW], nxt[A], p.ka);
        nxt[V] = to_f32(v[o]);
        const float kk = kk_of(nxt[KRAW], p.kk, st.x);
        nxt[Z] = -kk;
        nxt[B_] = kk * nxt[A];
        nxt[SA] = sa[o];
        nxt[DOUT] = to_f32(dy[o]);
        nxt[XH] = xhat[o];
        nxt[DXH] = nxt[DOUT] * p.lw;
        nxt[DY] = 0.f;  // set once the step's sums are known
    };
    auto put = [&](int buf) {
#pragma unroll
        for (int q = 0; q < NV; ++q) stage[buf][q][i] = nxt[q];
        const float s1 = warp_sum(nxt[DXH]);
        const float s2 = warp_sum(nxt[DXH] * nxt[XH]);
        const float s3 = warp_sum(nxt[DOUT] * nxt[V]);
        if (lane == 0) {
            part[buf][warp][0] = s1;
            part[buf][warp][1] = s2;
            part[buf][warp][2] = s3;
        }
        if (i == 0) {
            sstat[buf][0] = nst[0];
            sstat[buf][1] = nst[1];
            sstat[buf][2] = nst[2];
        }
    };
    // this thread's lane at step u, for the recompute after a reset
    auto lane_at = [&](int u, float& wi, float& ki, float& bi_) {
        const int64_t o = base + u * step;
        const float kr = to_f32(k_raw[o]), av = to_f32(a[o]);
        wi = wkv7::decay(to_f32(w_raw[o]));
        ki = wkv7::k_eff(kr, av, p.ka);
        bi_ = kk_of(kr, p.kk, st_bh[(int64_t)u * 4]) * av;
    };

    float g_kk = 0.f, g_ka = 0.f, g_rk = 0.f, g_lw = 0.f, g_lb = 0.f;
    if (T_len > 0) {
        load(T_len - 1);
        put((T_len - 1) & 1);
    }
    for (int t = T_len - 1; t >= 0; --t) {
        __syncthreads();  // stage[t & 1] complete; the other buffer and dsa_sh free
        if (t > 0) load(t - 1);
        float(*cur)[N] = stage[t & 1];
        const int cb = t & 1;
        float m1 = 0.f, m2 = 0.f, dc = 0.f;
#pragma unroll
        for (int q = 0; q < NWARPS; ++q) {
            m1 += part[cb][q][0];
            m2 += part[cb][q][1];
            dc += part[cb][q][2];
        }
        m1 *= 1.f / N;
        m2 *= 1.f / N;
        const float ss = sstat[cb][0], rstd = sstat[cb][1], c = sstat[cb][2];
        // GroupNorm adjoint: the gradient of the pre-norm y
        cur[DY][i] = rstd * (cur[DXH][i] - m1 - cur[XH][i] * m2);
        __syncthreads();  // dy complete
        const bool reset = rs_b && rs_b[t];
        const wkv7::LaneGrads g = wkv7::bwd_col_step(
            cS, rG, cG, i, reset, cur[R], cur[W], cur[KE], cur[V], cur[Z], cur[B_],
            cur[SA], cur[DY], dsa_sh);
        // bonus adjoint
        const float ri = cur[R][i], kei = cur[KE][i], ai = cur[A][i], kri = cur[KRAW][i];
        const float douti = cur[DOUT][i];
        const float dke = g.dk + dc * ri * p.rk;
        g_rk += dc * ri * kei;
        g_lw += douti * cur[XH][i];
        g_lb += douti;
        // prologue adjoint: k_eff, b = kk a, z = -kk, then the l2norm
        const float kk = -cur[Z][i];
        const float dkk = fmaf(g.db, ai, -g.dz);
        g_ka += dke * kri * (ai - 1.f);
        const float P = block_sum<NWARPS>(dkk * kk, red);
        const float dkx = (ss < 1e-24f ? dkk : dkk - kk * P) / wkv7::l2_norm(ss);
        g_kk += dkx * kri;
        const int64_t o = base + t * step;
        dr[o] = from_f32<T>(g.dr + dc * kei * p.rk);
        dw[o] = from_f32<T>(g.dw * wkv7::ddecay(cur[W][i], cur[WRAW][i]));
        dk[o] = from_f32<T>(fmaf(dkx, p.kk, dke * fmaf(ai - 1.f, p.ka, 1.f)));
        dv[o] = from_f32<T>(g.dv + c * douti);
        da[o] = from_f32<T>(fmaf(g.db, kk, dke * kri * p.ka));
        if (t > 0 && (reset || t % wkv7::CHUNK == 0))
            wkv7::reload_col<T>(cS, i, t, anc, s0_bh, rs_b, sa + row0, v + row0, step, lane_at);
        if (t > 0) put((t - 1) & 1);
    }
    if (ds0) {
        float* d = ds0 + ((int64_t)bh * N + i) * N;
#pragma unroll
        for (int j = 0; j < N; ++j) d[j] = rG[j];
    }
    // [k_k, k_a, r_k, ln_w, ln_b] x (B * H) x N
    const int64_t plane = (int64_t)gridDim.x * N, po = (int64_t)bh * N + i;
    dparams[po] = g_kk;
    dparams[plane + po] = g_ka;
    dparams[2 * plane + po] = g_rk;
    dparams[3 * plane + po] = g_lw;
    dparams[4 * plane + po] = g_lb;
}

template <typename T>
int launch_fwd(int B, int T_len, int H, float ln_eps, void* r, void* w, void* k, void* v,
               void* a, void* k_k, void* k_a, void* r_k, void* ln_w, void* ln_b, void* s0,
               void* resets, void* y, void* s_out, void* anchors, void* sa, void* xhat,
               void* stats, cudaStream_t stream) {
    if (anchors)
        RWKV_TRY(wkv7_fused_fwd_kernel<T, true><<<B * H, N, 0, stream>>>(
            T_len, H, ln_eps, (const T*)r, (const T*)w, (const T*)k, (const T*)v,
            (const T*)a, (const float*)k_k, (const float*)k_a, (const float*)r_k,
            (const float*)ln_w, (const float*)ln_b, (const float*)s0,
            (const uint8_t*)resets, (T*)y, (float*)s_out, (float*)anchors, (float*)sa,
            (float*)xhat, (float*)stats));
    else
        RWKV_TRY(wkv7_fused_fwd_kernel<T, false><<<B * H, N, 0, stream>>>(
            T_len, H, ln_eps, (const T*)r, (const T*)w, (const T*)k, (const T*)v,
            (const T*)a, (const float*)k_k, (const float*)k_a, (const float*)r_k,
            (const float*)ln_w, (const float*)ln_b, (const float*)s0,
            (const uint8_t*)resets, (T*)y, (float*)s_out, nullptr, nullptr, nullptr,
            nullptr));
    return 0;
}

template <typename T>
int launch_bwd(int B, int T_len, int H, void* r, void* w, void* k, void* v, void* a,
               void* k_k, void* k_a, void* r_k, void* ln_w, void* s0, void* resets,
               void* anchors, void* sa, void* xhat, void* stats, void* dy, void* dsfin,
               void* dr, void* dw, void* dk, void* dv, void* da, void* dparams, void* ds0,
               cudaStream_t stream) {
    RWKV_TRY(wkv7_fused_bwd_kernel<T><<<B * H, N, 0, stream>>>(
        T_len, H, (const T*)r, (const T*)w, (const T*)k, (const T*)v, (const T*)a,
        (const float*)k_k, (const float*)k_a, (const float*)r_k, (const float*)ln_w,
        (const float*)s0, (const uint8_t*)resets, (const float*)anchors,
        (const float*)sa, (const float*)xhat, (const float*)stats, (const T*)dy,
        (const float*)dsfin, (T*)dr, (T*)dw, (T*)dk, (T*)dv, (T*)da, (float*)dparams,
        (float*)ds0));
    return 0;
}

}  // namespace

// r, w_raw, k_raw, v, a: (B, T, H, 64) of `dtype`; k_k..ln_b: (H, 64) f32;
// s0: (B, H, 64, 64) f32 or null; resets: (B, T) bool or null; y: (B, T,
// H, 64) of `dtype`; s_out: (B, H, 64, 64) f32. For training (all four
// non-null, or all null for the primal alone): anchors (B, H, ceil(T / 16),
// 64, 64), sa and xhat (B, T, H, 64), stats (B, H, T, 4), all f32.
extern "C" int wkv7_fused_fwd(int dtype, int B, int T_len, int H, float ln_eps, void* r,
                              void* w, void* k, void* v, void* a, void* k_k, void* k_a,
                              void* r_k, void* ln_w, void* ln_b, void* s0, void* resets,
                              void* y, void* s_out, void* anchors, void* sa, void* xhat,
                              void* stats, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const bool any = anchors || sa || xhat || stats, all = anchors && sa && xhat && stats;
    if (any != all) return (int)cudaErrorInvalidValue;
    if (dtype == DT_F32)
        return launch_fwd<float>(B, T_len, H, ln_eps, r, w, k, v, a, k_k, k_a, r_k, ln_w,
                                 ln_b, s0, resets, y, s_out, anchors, sa, xhat, stats, st);
    if (dtype == DT_BF16)
        return launch_fwd<bf16>(B, T_len, H, ln_eps, r, w, k, v, a, k_k, k_a, r_k, ln_w,
                                ln_b, s0, resets, y, s_out, anchors, sa, xhat, stats, st);
    return (int)cudaErrorInvalidValue;
}

// The saved tensors as written by wkv7_fused_fwd; dy: (B, T, H, 64) of
// `dtype`; dsfin: (B, H, 64, 64) f32 or null (zero); dr..da: (B, T, H, 64)
// of `dtype`; dparams: (5, B, H, 64) f32, the k_k, k_a, r_k, ln_w and ln_b
// gradients of each (b, h); ds0: (B, H, 64, 64) f32 or null (not written).
// Every w_raw must be <= -0.5 (see wkv7_core.cuh).
extern "C" int wkv7_fused_bwd(int dtype, int B, int T_len, int H, void* r, void* w,
                              void* k, void* v, void* a, void* k_k, void* k_a, void* r_k,
                              void* ln_w, void* s0, void* resets, void* anchors, void* sa,
                              void* xhat, void* stats, void* dy, void* dsfin, void* dr,
                              void* dw, void* dk, void* dv, void* da, void* dparams,
                              void* ds0, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == DT_F32)
        return launch_bwd<float>(B, T_len, H, r, w, k, v, a, k_k, k_a, r_k, ln_w, s0, resets,
                                 anchors, sa, xhat, stats, dy, dsfin, dr, dw, dk, dv, da,
                                 dparams, ds0, st);
    if (dtype == DT_BF16)
        return launch_bwd<bf16>(B, T_len, H, r, w, k, v, a, k_k, k_a, r_k, ln_w, s0, resets,
                                anchors, sa, xhat, stats, dy, dsfin, dr, dw, dk, dv, da,
                                dparams, ds0, st);
    return (int)cudaErrorInvalidValue;
}
