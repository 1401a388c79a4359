// WKV7 with its elementwise band fused in: forward and backward
// (ops/wkv7_cuda.py::WKV7Fused), in chunks of 16 steps on the tensor cores.
//
// Replaces: rwkvtts_tpu/ops/wkv7_pallas.py::_fwd_kernel_fused and
// _bwd_kernel_fused (reached through _fused_fwd_call / _fused_bwd_call, the
// custom-vjp pair of wkv7_pallas_fused). Per head, with per-head
// parameters k_k, k_a, r_k, ln_w, ln_b (64 each):
//     kk    = l2norm(k_raw k_k)            (eps^2 = 1e-24 before the sqrt)
//     k_eff = k_raw (1 + (a - 1) k_a),  z = -kk,  b = kk a
//     y     = WKV7(r, w_raw, k_eff, v, z, b)   (f32)
//     out   = GroupNorm_64(y) ln_w + ln_b + (sum r k_eff r_k) v
// The forward writes `out` in v's dtype and the final state; for training
// also the state at the end of every chunk (the anchors), nothing a step.
// The backward recomputes each chunk forward from its entry state (an
// anchor, or s0), differentiates the epilogue (GroupNorm and bonus), the
// chunk's products and the prologue, and gives dr, dw_raw, dk_raw, dv, da
// in the input dtype, the five per-head parameter gradients per (b, h) row
// (summed over the batch by the wrapper) and ds0 in f32. No atomics: two
// calls on the same inputs give the same bits.
//
// What bounds it on this card, at the training shape (B=8, T=2048, H=16,
// bf16): the forward must move ~0.47 GB (inputs, y and 268 MB of anchors:
// 0.14 ms at 3.35 TB/s) and the backward ~0.64 GB (0.19 ms); the recurrence is ~9
// and ~22 FLOP an element of the state a step (0.14 and 0.35 ms at the f32
// rate). A step-by-step kernel is bound instead by one step's dependent
// chain times T. The chunked form makes each (b, h) T / 16 chunk steps of
// a few 16 x 64 x 64 products, so what bounds it is the latency of one
// chunk: on the H100 ~9k cycles forward and ~16k backward
// (scripts/profile_wkv7_fused.py), spread over its phases, each ended by a
// barrier, and spent mostly in shared-memory fragment loads (the
// transposed ones 2-way bank-conflicted), the one-warp inverse and, in the
// saving forward, the anchors' stores.
//
// Design (the algebra and the shared phases are in wkv7_chunk.cuh): one
// CTA of 8 warps a (b, h); the prologue a thread per (step, 4 lanes); the
// cumulative decays a thread per (lane, 4 steps); the four pairwise
// matrices one tile a warp; (I - A)^{-1} by one warp; then each warp owns 8
// value rows of the state (kept in shared memory, f32) and computes their
// sa, y and update with no barrier. The GroupNorm and its adjoint are
// per-step sums over the 16 threads of a step. The next chunk's inputs
// (and, backward, its entry state, by cp.async) are fetched while the
// current one runs, kept as loaded until used. No stepping back through
// the decay: the backward recomputes, so it is exact for any decay whose
// chunk sum stays in f32's range. The bf16 instantiation rounds the
// operands of the products to TF32 once, the f32 one uses 3xTF32.
#include "wkv7_chunk.cuh"

namespace {

using namespace wkv7c;

// the prologue's raw inputs of one step, 4 lanes
struct Raw {
    float r[4], w[4], k[4], v[4], a[4];
};

// the same as loaded, unpacked by raw() (zeros past the end)
template <typename T>
struct RawBits {
    Bits4<T> r, w, k, v, a;

    __device__ __forceinline__ void load(const T* r_, const T* w_, const T* k_, const T* v_,
                                         const T* a_, int64_t o) {
        ld_bits(r, r_ + o), ld_bits(w, w_ + o), ld_bits(k, k_ + o), ld_bits(v, v_ + o);
        ld_bits(a, a_ + o);
    }
    __device__ __forceinline__ Raw raw(bool valid) const {
        Raw x;
        unpack4(r, valid, x.r), unpack4(w, valid, x.w), unpack4(k, valid, x.k);
        unpack4(v, valid, x.v), unpack4(a, valid, x.a);
        return x;
    }
};

// Write the prologue's results to the chunk's tiles (thread (t, j0)).
__device__ __forceinline__ void put_prologue(const Tiles& s, float* V, int t, int j0,
                                             const Raw& x, const Pro& p, bool rs, bool valid) {
    float q[4], z[4], b[4], lw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        z[u] = -p.kk[u];
        b[u] = p.kk[u] * x.a[u];
        q[u] = x.r[u];
        lw[u] = (rs || !valid) ? 0.f : -expf(x.w[u]);
    }
    const int o = t * LD + j0;
    st4<float>(s.QT + o, q);
    st4<float>(s.ZT + o, z);
    st4<float>(s.KT + o, p.ke);
    st4<float>(s.BT + o, b);
    st4<float>(V + o, x.v);
    st4<float>(s.LG + o, lw);
    if ((threadIdx.x & 15) == 0) s.RS[t] = rs ? 1 : 0;
}

template <typename T, bool SAVE>
__global__ void __launch_bounds__(NT, 1) wkv7_fused_fwd_kernel(
    int T_len, int H, float ln_eps,
    const T* __restrict__ r, const T* __restrict__ w_raw,
    const T* __restrict__ k_raw, const T* __restrict__ v, const T* __restrict__ a,
    const float* __restrict__ k_k, const float* __restrict__ k_a,
    const float* __restrict__ r_k, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b,
    const float* __restrict__ s0, const uint8_t* __restrict__ resets,
    T* __restrict__ y, float* __restrict__ s_out, float* __restrict__ anchors) {
    constexpr int P = Passes<T>::value;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    Tiles s;
    s.QT = sm, s.ZT = sm + VEC, s.KT = sm + 2 * VEC, s.BT = sm + 3 * VEC;
    s.Q0 = sm + 4 * VEC, s.Z0 = sm + 5 * VEC, s.BF = sm + 6 * VEC, s.KF = sm + 7 * VEC;
    s.LG = sm + 8 * VEC;
    float* V = sm + 9 * VEC;
    float* SA = sm + 10 * VEC;
    float* Y = sm + 11 * VEC;
    float* S = sm + 12 * VEC;
    float* M = S + ST;  // A, Kz, QB, QK, X
    s.DL = M + 5 * MAT;
    s.QSUM = s.DL + N;
    s.RS = reinterpret_cast<int*>(s.QSUM + 4 * N);
    s.CS = s.RS + L;

    const int bh = blockIdx.x, bi = bh / H, h = bh - bi * H;
    const int tid = threadIdx.x, w = tid >> 5;
    const int ts = tid >> 4, j0 = (tid & 15) * 4;  // the prologue / epilogue slice
    const int nc = wkv7::n_chunks(T_len);
    float kkp[4], kap[4], rkp[4], lw[4], lb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int o = h * N + j0 + u;
        kkp[u] = k_k[o], kap[u] = k_a[o], rkp[u] = r_k[o], lw[u] = ln_w[o];
        lb[u] = ln_b ? ln_b[o] : 0.f;
    }
    state_to_smem(S, s0 ? s0 + (int64_t)bh * N * N : nullptr);
    cp_async_wait_all();

    const int64_t step = (int64_t)H * N;
    const int64_t base = ((int64_t)bi * T_len * H + h) * N + j0;
    // the row of step tt, or of the last step past the end
    auto row = [&](int tt) { return base + (int64_t)min(tt, T_len - 1) * step; };
    RawBits<T> nxt;
    nxt.load(r, w_raw, k_raw, v, a, row(ts));

    for (int ci = 0; ci < nc; ++ci) {
        // prologue of step ts of the chunk; fetch the next chunk's inputs
        const int tt = ci * L + ts;
        const bool valid = tt < T_len;
        const bool rs = valid && resets && resets[(int64_t)bi * T_len + tt];
        const Raw x = nxt.raw(valid);
        if (ci + 1 < nc) nxt.load(r, w_raw, k_raw, v, a, row(tt + L));
        const Pro p = prologue(x.r, x.k, x.a, kkp, kap, rkp);
        put_prologue(s, V, ts, j0, x, p, rs, valid);
        __syncthreads();
        decay_phase(s, false);
        __syncthreads();
        pair_phase<P>(s, M);
        __syncthreads();
        // each warp: 8 value rows i0 .. i0 + 7; warp 0 inverts first.
        // rhs = z0 S^T + Kz v (ops/wkv7.py:116), y = q0 S^T + QK v + ...
        const int i0 = 8 * w;
        if (w == 0) {
            invert(M, M + 4 * MAT);
            __syncwarp();  // the whole warp again before mma.sync
        }
        float rhs[4] = {0.f, 0.f, 0.f, 0.f}, yy[4] = {0.f, 0.f, 0.f, 0.f};
        tile<P, N>(rhs, s.Z0, LD, 1, S + i0 * LD, 1, LD);
        tile<P, L>(rhs, M + MAT, LDM, 1, V + i0, LD, 1);
        tile<P, N>(yy, s.Q0, LD, 1, S + i0 * LD, 1, LD);
        tile<P, L>(yy, M + 3 * MAT, LDM, 1, V + i0, LD, 1);
        put_tile(SA, i0, rhs);
        __syncthreads();  // X complete
        {
            // sa = X rhs (:117), y += QB sa (:118-120), then the state (:129-131)
            float sa[4] = {0.f, 0.f, 0.f, 0.f};
            tile<P, L>(sa, M + 4 * MAT, LDM, 1, SA + i0, LD, 1);
            __syncwarp();
            put_tile(SA, i0, sa);
            __syncwarp();
            tile<P, L>(yy, M + 2 * MAT, LDM, 1, SA + i0, LD, 1);
            put_tile(Y, i0, yy);
            // the state's rows i0 .. i0 + 7 as four 16-column tiles (M = key
            // columns j, N = the warp's value rows), sharing the B fragments
            const bool live0 = s.CS[L - 1] == 0;
            float c[4][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int jj = 16 * mt + crow(e), ii = i0 + ccol(e);
                    c[mt][e] = live0 ? S[ii * LD + jj] * s.DL[jj] : 0.f;
                }
            const float* bf[4] = {s.BF, s.BF + 16, s.BF + 32, s.BF + 48};
            const float* kf[4] = {s.KF, s.KF + 16, s.KF + 32, s.KF + 48};
            tiles<P, L, 4>(c, bf, 1, LD, SA + i0, LD, 1);
            tiles<P, L, 4>(c, kf, 1, LD, V + i0, LD, 1);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) S[(i0 + ccol(e)) * LD + 16 * mt + crow(e)] = c[mt][e];
            if constexpr (SAVE) {
                __syncwarp();
                rows_to_global(anchors + ((int64_t)bh * nc + ci) * N * N, S, i0);
            }
        }
        __syncthreads();  // y complete
        // epilogue: ln_x GroupNorm over the 64 value lanes, then the bonus
        float yv[4], vv[4];
        ld4(Y + ts * LD + j0, yv);
        ld4(V + ts * LD + j0, vv);
        const float mu = sum16(yv[0] + yv[1] + yv[2] + yv[3]) * (1.f / N);
        float d2 = 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) d2 = fmaf(yv[u] - mu, yv[u] - mu, d2);
        const float rstd = 1.f / sqrtf(sum16(d2) * (1.f / N) + ln_eps);
        float out[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) out[u] = fmaf((yv[u] - mu) * rstd, lw[u], lb[u]) + p.cb * vv[u];
        if (valid) st4<T>(y + base + tt * step, out);
    }
    __syncthreads();
    rows_to_global(s_out + (int64_t)bh * N * N, S, 8 * w);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) wkv7_fused_bwd_kernel(
    int T_len, int H, float ln_eps,
    const T* __restrict__ r, const T* __restrict__ w_raw,
    const T* __restrict__ k_raw, const T* __restrict__ v, const T* __restrict__ a,
    const float* __restrict__ k_k, const float* __restrict__ k_a,
    const float* __restrict__ r_k, const float* __restrict__ ln_w,
    const float* __restrict__ s0, const uint8_t* __restrict__ resets,
    const float* __restrict__ anchors, const T* __restrict__ dy,
    const float* __restrict__ dsfin,
    T* __restrict__ dr, T* __restrict__ dw, T* __restrict__ dk, T* __restrict__ dv,
    T* __restrict__ da, float* __restrict__ dparams, float* __restrict__ ds0) {
    constexpr int P = Passes<T>::value;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    Tiles s;
    s.QT = sm, s.ZT = sm + VEC, s.KT = sm + 2 * VEC, s.BT = sm + 3 * VEC;
    s.Q0 = sm + 4 * VEC, s.Z0 = sm + 5 * VEC, s.BF = sm + 6 * VEC, s.KF = sm + 7 * VEC;
    s.LG = sm + 8 * VEC;  // logw, then e^g
    float* V = sm + 9 * VEC;
    float* SA = sm + 10 * VEC;
    float* DY = sm + 11 * VEC;  // y before the norm, then its gradient
    float* DO = sm + 12 * VEC;  // the upstream gradient of out
    float* U = sm + 13 * VEC;   // dsa, then u = (I - A)^{-T} dsa
    float* E = sm + 14 * VEC;   // the g_t terms of dlogw, then dlogw
    float* F = sm + 15 * VEC;   // the g_{t-1} terms
    float* DR = sm + 16 * VEC;
    float* DZ = sm + 17 * VEC;
    float* DB = sm + 18 * VEC;
    float* DKE = sm + 19 * VEC;
    float* S0b = sm + 20 * VEC;  // two entry-state buffers
    float* DSb = S0b + 2 * ST;   // dS after the chunk, and before it
    float* M = DSb + 2 * ST;     // A, Kz, QB, QK, X, dA, dKz, dQB, dQK
    s.DL = M + 9 * MAT;
    float* DDL = s.DL + N;
    s.QSUM = DDL + N;
    s.RS = reinterpret_cast<int*>(s.QSUM + 4 * N);
    s.CS = s.RS + L;
    float* CB = reinterpret_cast<float*>(s.CS + L);

    const int bh = blockIdx.x, bi = bh / H, h = bh - bi * H;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int ts = tid >> 4, j0 = (tid & 15) * 4;
    const int nc = wkv7::n_chunks(T_len);
    float kkp[4], kap[4], rkp[4], lw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int o = h * N + j0 + u;
        kkp[u] = k_k[o], kap[u] = k_a[o], rkp[u] = r_k[o], lw[u] = ln_w[o];
    }
    float g_kk[4] = {}, g_ka[4] = {}, g_rk[4] = {}, g_lw[4] = {}, g_lb[4] = {};

    const float* anc = anchors + (int64_t)bh * nc * N * N;
    const float* s0_bh = s0 ? s0 + (int64_t)bh * N * N : nullptr;
    // the entry state of chunk c
    auto entry = [&](int c) { return c > 0 ? anc + (int64_t)(c - 1) * N * N : s0_bh; };
    state_to_smem(DSb, dsfin ? dsfin + (int64_t)bh * N * N : nullptr);
    state_to_smem(S0b + ((nc - 1) & 1) * ST, entry(nc - 1));
    cp_async_wait_all();

    const int64_t step = (int64_t)H * N;
    const int64_t base = ((int64_t)bi * T_len * H + h) * N + j0;
    auto row = [&](int tt) { return base + (int64_t)min(tt, T_len - 1) * step; };
    RawBits<T> nxt;
    Bits4<T> ndo;
    nxt.load(r, w_raw, k_raw, v, a, row((nc - 1) * L + ts));
    ld_bits(ndo, dy + row((nc - 1) * L + ts));
    int cur = 0;  // DSb + cur * ST holds dS after the chunk
    for (int ci = nc - 1; ci >= 0; --ci) {
        float* S0 = S0b + (ci & 1) * ST;
        float* dS = DSb + cur * ST;
        float* dSn = DSb + (cur ^ 1) * ST;
        // the entry state fetched during the previous chunk has landed (the
        // barrier below publishes it); fetch the next one meanwhile
        cp_async_wait_all();
        if (ci > 0) state_to_smem(S0b + ((ci - 1) & 1) * ST, entry(ci - 1));
        const int tt = ci * L + ts;
        const bool valid = tt < T_len;
        const bool rs = valid && resets && resets[(int64_t)bi * T_len + tt];
        const Raw x = nxt.raw(valid);
        float dout[4];
        unpack4(ndo, valid, dout);
        if (ci > 0) {
            nxt.load(r, w_raw, k_raw, v, a, row(tt - L));
            ld_bits(ndo, dy + row(tt - L));
        }
        const Pro p = prologue(x.r, x.k, x.a, kkp, kap, rkp);
        put_prologue(s, V, ts, j0, x, p, rs, valid);
        st4<float>(DO + ts * LD + j0, dout);
        if ((tid & 15) == 0) CB[ts] = p.cb;
        __syncthreads();
        decay_phase(s, true);
        __syncthreads();
        pair_phase<P>(s, M);
        __syncthreads();
        // recompute sa and y (before the norm), 8 value rows a warp
        const int i0 = 8 * w;
        if (w == 0) {
            invert(M, M + 4 * MAT);
            __syncwarp();  // the whole warp again before mma.sync
        }
        float rhs[4] = {0.f, 0.f, 0.f, 0.f}, yy[4] = {0.f, 0.f, 0.f, 0.f};
        tile<P, N>(rhs, s.Z0, LD, 1, S0 + i0 * LD, 1, LD);
        tile<P, L>(rhs, M + MAT, LDM, 1, V + i0, LD, 1);
        tile<P, N>(yy, s.Q0, LD, 1, S0 + i0 * LD, 1, LD);
        tile<P, L>(yy, M + 3 * MAT, LDM, 1, V + i0, LD, 1);
        put_tile(SA, i0, rhs);
        __syncthreads();  // X complete
        {
            float sa[4] = {0.f, 0.f, 0.f, 0.f};
            tile<P, L>(sa, M + 4 * MAT, LDM, 1, SA + i0, LD, 1);
            __syncwarp();
            put_tile(SA, i0, sa);
            __syncwarp();
            tile<P, L>(yy, M + 2 * MAT, LDM, 1, SA + i0, LD, 1);
            put_tile(DY, i0, yy);
        }
        __syncthreads();  // y complete
        // the epilogue's adjoint: GroupNorm, bonus (thread (t, 4 lanes))
        float dc;
        {
            float yv[4];
            ld4(DY + ts * LD + j0, yv);
            const float mu = sum16(yv[0] + yv[1] + yv[2] + yv[3]) * (1.f / N);
            float d2 = 0.f, m1 = 0.f, m2 = 0.f, c = 0.f, xh[4], dxh[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) d2 = fmaf(yv[u] - mu, yv[u] - mu, d2);
            const float rstd = 1.f / sqrtf(sum16(d2) * (1.f / N) + ln_eps);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                xh[u] = (yv[u] - mu) * rstd;
                dxh[u] = dout[u] * lw[u];
                m1 += dxh[u];
                m2 = fmaf(dxh[u], xh[u], m2);
                c = fmaf(dout[u], x.v[u], c);
                g_lw[u] = fmaf(dout[u], xh[u], g_lw[u]);
                g_lb[u] += dout[u];
            }
            m1 = sum16(m1) * (1.f / N);
            m2 = sum16(m2) * (1.f / N);
            dc = sum16(c);
            float g[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) g[u] = rstd * (dxh[u] - m1 - xh[u] * m2);
            st4<float>(DY + ts * LD + j0, g);
        }
        __syncthreads();  // dy complete
        // the state gradient's chain, 8 value rows a warp: the adjoints of
        // ops/wkv7.py:116-117 and :129-131, with dS the gradient of the
        // state after the chunk: dsa = QB^T dy + bf dS^T, u = X^T dsa,
        // dv = QK^T dy + Kz^T u + kf dS^T (+ the bonus), and the gradient of
        // the entry state [c_L = 0] dS diag(e^{g_L}) + dy^T q0 + u^T z0
        {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            tile<P, L>(c, M + 2 * MAT, 1, LDM, DY + i0, LD, 1);  // QB^T dy
            tile<P, N>(c, s.BF, LD, 1, dS + i0 * LD, 1, LD);      // bf dS^T
            put_tile(U, i0, c);
            __syncwarp();
            float u[4] = {0.f, 0.f, 0.f, 0.f};
            tile<P, L>(u, M + 4 * MAT, 1, LDM, U + i0, LD, 1);    // X^T dsa
            __syncwarp();
            put_tile(U, i0, u);
            __syncwarp();
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            tile<P, L>(d, M + 3 * MAT, 1, LDM, DY + i0, LD, 1);  // QK^T dy
            tile<P, L>(d, M + MAT, 1, LDM, U + i0, LD, 1);       // Kz^T u
            tile<P, N>(d, s.KF, LD, 1, dS + i0 * LD, 1, LD);     // kf dS^T
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
                const int t = crow(e), ii = i0 + ccol(e), tg = ci * L + t;
                if (tg < T_len) {
                    const float cb = CB[t];
                    st2<T>(dv + ((int64_t)bi * T_len + tg) * step + h * N + ii,
                           fmaf(cb, DO[t * LD + ii], d[e]), fmaf(cb, DO[t * LD + ii + 1], d[e + 1]));
                }
            }
            const bool live0 = s.CS[L - 1] == 0;
            float c2[4][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int jj = 16 * mt + crow(e), ii = i0 + ccol(e);
                    c2[mt][e] = live0 ? dS[ii * LD + jj] * s.DL[jj] : 0.f;
                }
            const float* q0[4] = {s.Q0, s.Q0 + 16, s.Q0 + 32, s.Q0 + 48};
            const float* z0[4] = {s.Z0, s.Z0 + 16, s.Z0 + 32, s.Z0 + 48};
            tiles<P, L, 4>(c2, q0, 1, LD, DY + i0, LD, 1);
            tiles<P, L, 4>(c2, z0, 1, LD, U + i0, LD, 1);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int e = 0; e < 4; ++e) dSn[(i0 + ccol(e)) * LD + 16 * mt + crow(e)] = c2[mt][e];
        }
        __syncthreads();  // u complete
        // the gradients of the pairwise matrices, one tile a warp:
        // dA = u sa^T, dKz = u v^T (strict), dQB = dy sa^T, dQK = dy v^T
        {
            const int mat = w >> 1, nt = w & 1;
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            tile<P, N>(c, mat < 2 ? U : DY, LD, 1, ((mat & 1) ? V : SA) + nt * 8 * LD, 1, LD);
            float* out = M + (5 + mat) * MAT;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = crow(e), u = nt * 8 + ccol(e);
                const bool keep = (mat < 2 ? u < t : u <= t) && s.CS[t] == s.CS[u];
                out[t * LDM + u] = keep ? c[e] : 0.f;
            }
        }
        __syncthreads();
        // the gradients of qt, zt, bt, kt (the adjoint of :95-98, :108-109,
        // :113-114 and :126-127), 8 key lanes j a warp; through the decays
        // they give dr, dz, db, dk_eff and the terms of dlogw
        {
            const int jw = 8 * w;
            const float* dA = M + 5 * MAT;
            const float* dKz = M + 6 * MAT;
            const float* dQB = M + 7 * MAT;
            const float* dQK = M + 8 * MAT;
            // products that share B fragments go together: [dq, dz] over
            // S0 then BT and KT, [dbf, dkf] over dS, [db, dkt] over ZT, QT
            float qz[2][4] = {}, fk[2][4] = {}, bk[2][4] = {};
            const float* dyu[2] = {DY, U};
            tiles<P, N, 2>(qz, dyu, LD, 1, S0 + jw, LD, 1);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool m0 = s.CS[crow(e)] == 0;
                qz[0][e] = m0 ? qz[0][e] : 0.f;
                qz[1][e] = m0 ? qz[1][e] : 0.f;
            }
            const float* onb[2] = {dQB, dA};
            const float* onk[2] = {dQK, dKz};
            tiles<P, L, 2>(qz, onb, LDM, 1, s.BT + jw, LD, 1);
            tiles<P, L, 2>(qz, onk, LDM, 1, s.KT + jw, LD, 1);
            const float* sav[2] = {SA, V};
            tiles<P, N, 2>(fk, sav, LD, 1, dS + jw, LD, 1);
            const float* onz[2] = {dA, dKz};
            const float* onq[2] = {dQB, dQK};
            tiles<P, L, 2>(bk, onz, 1, LDM, s.ZT + jw, LD, 1);
            tiles<P, L, 2>(bk, onq, 1, LDM, s.QT + jw, LD, 1);
            float(&dq)[4] = qz[0];
            float(&dz)[4] = qz[1];
            float(&dbf)[4] = fk[0];
            float(&dkf)[4] = fk[1];
            float(&db)[4] = bk[0];
            float(&dkt)[4] = bk[1];
            const int cl = s.CS[L - 1];
            float ddl[2] = {0.f, 0.f};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = crow(e), jj = jw + ccol(e), o = t * LD + jj;
                const bool live = s.CS[t] == cl;
                const float dl = s.DL[jj];
                const float bt = s.BT[o], kt = s.KT[o];
                if (live) {
                    db[e] = fmaf(dbf[e], dl, db[e]);
                    dkt[e] = fmaf(dkf[e], dl, dkt[e]);
                    ddl[e & 1] += bt * dbf[e] + kt * dkf[e];
                }
                const float eg = s.LG[o], egp = t > 0 ? s.LG[o - LD] : 1.f;
                DR[o] = dq[e] * eg;
                DZ[o] = dz[e] * egp;
                DB[o] = db[e] / eg;
                DKE[o] = dkt[e] / eg;
                E[o] = dq[e] * s.QT[o] - db[e] * bt - dkt[e] * kt;
                F[o] = dz[e] * s.ZT[o];
            }
            // d e^{g_L}: the rows of bf, kf above, and the entry state's
            // decay, over the warp's 8 columns
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
                ddl[0] += __shfl_xor_sync(0xffffffffu, ddl[0], o);
                ddl[1] += __shfl_xor_sync(0xffffffffu, ddl[1], o);
            }
            float s0t = 0.f;
            if (cl == 0) {
                // lane groups on rows 2 apart: 4 (row) + column banks differ
                const int jj = jw + (lane & 7), ib = 2 * (lane >> 3);
#pragma unroll
                for (int it = 0; it < 16; ++it) {
                    const int i = 8 * (it >> 1) + ib + (it & 1);
                    s0t = fmaf(S0[i * LD + jj], dS[i * LD + jj], s0t);
                }
            }
            s0t += __shfl_xor_sync(0xffffffffu, s0t, 8);
            s0t += __shfl_xor_sync(0xffffffffu, s0t, 16);
            if (lane < 4) {
                DDL[jw + 2 * lane] = ddl[0];
                DDL[jw + 2 * lane + 1] = ddl[1];
            }
            __syncwarp();
            if (lane < 8) DDL[jw + lane] += s0t;
        }
        __syncthreads();
        // dlogw_s = sum_{t >= s} E_t + sum_{t > s} F_t (+ d e^{g_L} e^{g_L} in
        // E_{L-1}), a thread per (lane, 4 steps)
        {
            const int j = tid & (N - 1), qq = tid >> 6;
            float acc = 0.f, dl[4];
#pragma unroll
            for (int u = 3; u >= 0; --u) {
                const int t = 4 * qq + u, o = t * LD + j;
                const float e = E[o] + (t == L - 1 ? DDL[j] * s.DL[j] : 0.f);
                dl[u] = acc + e;
                acc += e + F[o];
            }
            s.QSUM[qq * N + j] = acc;
            __syncthreads();
            float off = 0.f;
#pragma unroll
            for (int x2 = 3; x2 >= 0; --x2)
                if (x2 > qq) off += s.QSUM[x2 * N + j];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int t = 4 * qq + u;
                E[t * LD + j] = (s.RS[t] || ci * L + t >= T_len) ? 0.f : dl[u] + off;
            }
        }
        __syncthreads();
        // the prologue's adjoint and the input gradients (thread (t, 4 lanes))
        {
            float gr[4], gz[4], gb[4], gke[4], glw[4];
            const int o = ts * LD + j0;
            ld4(DR + o, gr);
            ld4(DZ + o, gz);
            ld4(DB + o, gb);
            ld4(DKE + o, gke);
            ld4(E + o, glw);
            float outr[4], outw[4], outk[4], outa[4], dkk[4], pp = 0.f;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                outr[u] = fmaf(dc * p.ke[u], rkp[u], gr[u]);
                gke[u] = fmaf(dc * x.r[u], rkp[u], gke[u]);
                g_rk[u] = fmaf(dc * x.r[u], p.ke[u], g_rk[u]);
                outw[u] = -glw[u] * expf(x.w[u]);
                dkk[u] = fmaf(gb[u], x.a[u], -gz[u]);
                outa[u] = fmaf(gb[u], p.kk[u], gke[u] * x.k[u] * kap[u]);
                g_ka[u] = fmaf(gke[u] * x.k[u], x.a[u] - 1.f, g_ka[u]);
                pp = fmaf(dkk[u], p.kk[u], pp);
            }
            pp = sum16(pp);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float dkx = (p.ss < 1e-24f ? dkk[u] : dkk[u] - p.kk[u] * pp) / p.nrm;
                g_kk[u] = fmaf(dkx, x.k[u], g_kk[u]);
                outk[u] = fmaf(dkx, kkp[u], gke[u] * fmaf(x.a[u] - 1.f, kap[u], 1.f));
            }
            if (valid) {
                const int64_t go = base + tt * step;
                st4<T>(dr + go, outr);
                st4<T>(dw + go, outw);
                st4<T>(dk + go, outk);
                st4<T>(da + go, outa);
            }
        }
        cur ^= 1;
    }
    __syncthreads();
    if (ds0) rows_to_global(ds0 + (int64_t)bh * N * N, DSb + cur * ST, 8 * w);
    // the per-head parameter gradients: the 16 steps' partial sums, in a
    // fixed order
    float* part = sm;  // [16][5][64], over the chunk tiles
    st4<float>(part + (ts * 5 + 0) * N + j0, g_kk);
    st4<float>(part + (ts * 5 + 1) * N + j0, g_ka);
    st4<float>(part + (ts * 5 + 2) * N + j0, g_rk);
    st4<float>(part + (ts * 5 + 3) * N + j0, g_lw);
    st4<float>(part + (ts * 5 + 4) * N + j0, g_lb);
    __syncthreads();
    const int64_t plane = (int64_t)gridDim.x * N;
    for (int x2 = tid; x2 < 5 * N; x2 += NT) {
        const int pi = x2 / N, j = x2 - pi * N;
        float sum = 0.f;
        for (int t = 0; t < L; ++t) sum += part[(t * 5 + pi) * N + j];
        dparams[pi * plane + (int64_t)bh * N + j] = sum;
    }
}

template <typename K>
int prepare(K kernel, int floats) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     floats * (int)sizeof(float));
}

template <typename T>
int launch_fwd(int B, int T_len, int H, float ln_eps, void* r, void* w, void* k, void* v,
               void* a, void* k_k, void* k_a, void* r_k, void* ln_w, void* ln_b, void* s0,
               void* resets, void* y, void* s_out, void* anchors, cudaStream_t stream) {
    const size_t bytes = FWD_FLOATS * sizeof(float);
    if (anchors) {
        auto kern = wkv7_fused_fwd_kernel<T, true>;
        if (int err = prepare(kern, FWD_FLOATS)) return err;
        RWKV_TRY(kern<<<B * H, NT, bytes, stream>>>(
            T_len, H, ln_eps, (const T*)r, (const T*)w, (const T*)k, (const T*)v,
            (const T*)a, (const float*)k_k, (const float*)k_a, (const float*)r_k,
            (const float*)ln_w, (const float*)ln_b, (const float*)s0,
            (const uint8_t*)resets, (T*)y, (float*)s_out, (float*)anchors));
    } else {
        auto kern = wkv7_fused_fwd_kernel<T, false>;
        if (int err = prepare(kern, FWD_FLOATS)) return err;
        RWKV_TRY(kern<<<B * H, NT, bytes, stream>>>(
            T_len, H, ln_eps, (const T*)r, (const T*)w, (const T*)k, (const T*)v,
            (const T*)a, (const float*)k_k, (const float*)k_a, (const float*)r_k,
            (const float*)ln_w, (const float*)ln_b, (const float*)s0,
            (const uint8_t*)resets, (T*)y, (float*)s_out, nullptr));
    }
    return 0;
}

template <typename T>
int launch_bwd(int B, int T_len, int H, float ln_eps, void* r, void* w, void* k, void* v,
               void* a, void* k_k, void* k_a, void* r_k, void* ln_w, void* s0, void* resets,
               void* anchors, void* dy, void* dsfin, void* dr, void* dw, void* dk, void* dv,
               void* da, void* dparams, void* ds0, cudaStream_t stream) {
    auto kern = wkv7_fused_bwd_kernel<T>;
    if (int err = prepare(kern, BWD_FLOATS)) return err;
    RWKV_TRY(kern<<<B * H, NT, BWD_FLOATS * sizeof(float), stream>>>(
        T_len, H, ln_eps, (const T*)r, (const T*)w, (const T*)k, (const T*)v, (const T*)a,
        (const float*)k_k, (const float*)k_a, (const float*)r_k, (const float*)ln_w,
        (const float*)s0, (const uint8_t*)resets, (const float*)anchors, (const T*)dy,
        (const float*)dsfin, (T*)dr, (T*)dw, (T*)dk, (T*)dv, (T*)da, (float*)dparams,
        (float*)ds0));
    return 0;
}

}  // namespace

// Shared memory bytes a CTA of the forward (which = 0) or the backward (1).
extern "C" int wkv7_fused_smem_bytes(int which) {
    return (which == 0 ? FWD_FLOATS : BWD_FLOATS) * (int)sizeof(float);
}

// r, w_raw, k_raw, v, a: (B, T, H, 64) of `dtype`; k_k..ln_b: (H, 64) f32;
// s0: (B, H, 64, 64) f32 or null; resets: (B, T) bool or null; y: (B, T,
// H, 64) of `dtype`; s_out: (B, H, 64, 64) f32; anchors: (B, H, ceil(T /
// 16), 64, 64) f32, the state after every 16th step and after the last, for
// training (null for the primal alone).
extern "C" int wkv7_fused_fwd(int dtype, int B, int T_len, int H, float ln_eps, void* r,
                              void* w, void* k, void* v, void* a, void* k_k, void* k_a,
                              void* r_k, void* ln_w, void* ln_b, void* s0, void* resets,
                              void* y, void* s_out, void* anchors, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (T_len < 1) return (int)cudaErrorInvalidValue;
    if (dtype == DT_F32)
        return launch_fwd<float>(B, T_len, H, ln_eps, r, w, k, v, a, k_k, k_a, r_k, ln_w,
                                 ln_b, s0, resets, y, s_out, anchors, st);
    if (dtype == DT_BF16)
        return launch_fwd<bf16>(B, T_len, H, ln_eps, r, w, k, v, a, k_k, k_a, r_k, ln_w,
                                ln_b, s0, resets, y, s_out, anchors, st);
    return (int)cudaErrorInvalidValue;
}

// The anchors as written by wkv7_fused_fwd; dy: (B, T, H, 64) of `dtype`;
// dsfin: (B, H, 64, 64) f32 or null (zero); dr..da: (B, T, H, 64) of
// `dtype`; dparams: (5, B, H, 64) f32, the k_k, k_a, r_k, ln_w and ln_b
// gradients of each (b, h); ds0: (B, H, 64, 64) f32 or null (not written).
// Exact while a chunk's summed decay stays inside f32's exponent range
// (|sum of exp(w_raw)| over 16 steps below ~80; the model's clamp w_raw <=
// -0.5 keeps it below 9.8).
extern "C" int wkv7_fused_bwd(int dtype, int B, int T_len, int H, float ln_eps, void* r,
                              void* w, void* k, void* v, void* a, void* k_k, void* k_a,
                              void* r_k, void* ln_w, void* s0, void* resets, void* anchors,
                              void* dy, void* dsfin, void* dr, void* dw, void* dk, void* dv,
                              void* da, void* dparams, void* ds0, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (T_len < 1 || !anchors) return (int)cudaErrorInvalidValue;
    if (dtype == DT_F32)
        return launch_bwd<float>(B, T_len, H, ln_eps, r, w, k, v, a, k_k, k_a, r_k, ln_w, s0,
                                 resets, anchors, dy, dsfin, dr, dw, dk, dv, da, dparams, ds0,
                                 st);
    if (dtype == DT_BF16)
        return launch_bwd<bf16>(B, T_len, H, ln_eps, r, w, k, v, a, k_k, k_a, r_k, ln_w, s0,
                                resets, anchors, dy, dsfin, dr, dw, dk, dv, da, dparams, ds0,
                                st);
    return (int)cudaErrorInvalidValue;
}
