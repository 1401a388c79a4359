// WKV7 backward over a whole sequence (ops/wkv7_cuda.py::WKV7.backward), in
// chunks of 16 steps on the tensor cores.
//
// Replaces: rwkvtts_tpu/ops/wkv7_pallas.py::_bwd_kernel (reached through
// _bwd_call, the backward of wkv7_pallas): the reverse sweep that gives
// dr, dw_raw, dk, dv, dz, db in the input dtype and ds0 in f32, with
// resets. Like the TPU kernel it recomputes each chunk in its matrix form
// from the chunk-entry state and differentiates it; the entry states are
// the anchors wkv7_fwd.cu saved (the state after every 16th step), or s0.
// Nothing steps back through the decay, so the gradients are exact for any
// decay whose chunk sum stays in f32's range.
//
// What bounds it on this card, at the training shape (B=8, T=2048, H=16,
// bf16): the inputs, dy and the six gradients are 13 x 33.5 MB and the
// anchors 268 MB, ~0.7 GB or 0.21 ms at 3.35 TB/s; the arithmetic is
// about 22 FLOP an element of the state a step, 24 GFLOP, or 0.35 ms at
// the 67 TFLOP/s of f32 FMA. As in the fused backward (wkv7_fused.cu),
// what bounds it in practice is the latency of one chunk's chain of
// barrier-separated phases, times T / 16.
//
// Design: the fused backward without its band (no l2norm / k_eff / z / b
// prologue, no GroupNorm and bonus epilogue): z and b are inputs and the
// upstream gradient is dy itself, so y is not recomputed, only sa. One CTA
// of 8 warps a (b, h) walks the chunks from the last to the first; the
// phases are wkv7_chunk.cuh's (decays, pairwise matrices, the inverse),
// then the adjoint: dsa = QB^T dy + bf dS^T, u = (I - A)^{-T} dsa,
// dv = QK^T dy + Kz^T u + kf dS^T and the entry state's gradient, 8 value
// rows a warp with no barrier; the pairwise matrices' gradients; the
// decayed vectors' gradients and dlogw as a reverse cumsum. The next
// chunk's inputs (into a second staging buffer, by cp.async, so that they
// hold no registers) and entry state are fetched while the current one
// runs.
// The bf16 instantiation rounds the products' operands to TF32 once, the
// f32 one uses 3xTF32. No atomics: two calls give the same bits.
#include "wkv7_chunk.cuh"

namespace {

using namespace wkv7c;

// shared memory bytes of a CTA: the f32 tiles, then the step inputs of two
// chunks in their own dtype
template <typename T>
constexpr int bwd_smem_bytes() {
    return UNFUSED_BWD_FLOATS * (int)sizeof(float) + 2 * UNFUSED_BWD_INPUTS * L * N * (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) wkv7_bwd_kernel(
    int T_len, int H,
    const T* __restrict__ r, const T* __restrict__ w_raw,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ z, const T* __restrict__ b,
    const float* __restrict__ s0, const uint8_t* __restrict__ resets,
    const float* __restrict__ anchors, const T* __restrict__ dy,
    const float* __restrict__ dsfin,
    T* __restrict__ dr, T* __restrict__ dw, T* __restrict__ dk,
    T* __restrict__ dv, T* __restrict__ dz, T* __restrict__ db,
    float* __restrict__ ds0) {
    constexpr int P = Passes<T>::value;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    Tiles s;
    s.QT = sm, s.ZT = sm + VEC, s.KT = sm + 2 * VEC, s.BT = sm + 3 * VEC;
    s.Q0 = sm + 4 * VEC, s.Z0 = sm + 5 * VEC, s.BF = sm + 6 * VEC, s.KF = sm + 7 * VEC;
    s.LG = sm + 8 * VEC;  // logw, then e^g
    float* V = sm + 9 * VEC;
    float* SA = sm + 10 * VEC;
    float* DY = sm + 11 * VEC;  // the upstream gradient of y
    float* U = sm + 12 * VEC;   // dsa, then u = (I - A)^{-T} dsa
    float* E = sm + 13 * VEC;   // the g_t terms of dlogw, then dlogw
    float* F = sm + 14 * VEC;   // the g_{t-1} terms
    float* DR = sm + 15 * VEC;
    float* DZ = sm + 16 * VEC;
    float* DB = sm + 17 * VEC;
    float* DK = sm + 18 * VEC;
    float* S0b = sm + 19 * VEC;  // two entry-state buffers
    float* DSb = S0b + 2 * ST;   // dS after the chunk, and before it
    float* M = DSb + 2 * ST;     // A, Kz, QB, QK, X, dA, dKz, dQB, dQK
    s.DL = M + 9 * MAT;
    float* DDL = s.DL + N;
    s.QSUM = DDL + N;
    s.RS = reinterpret_cast<int*>(s.QSUM + 4 * N);
    s.CS = s.RS + L;
    T* RAW = reinterpret_cast<T*>(sm + UNFUSED_BWD_FLOATS);  // [2][inputs][L][N]

    const int bh = blockIdx.x, bi = bh / H, h = bh - bi * H;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int ts = tid >> 4, j0 = (tid & 15) * 4;  // the step / 4 lanes of this thread
    const int nc = wkv7::n_chunks(T_len);

    const float* anc = anchors + (int64_t)bh * nc * N * N;
    const float* s0_bh = s0 ? s0 + (int64_t)bh * N * N : nullptr;
    // the entry state of chunk c
    auto entry = [&](int c) { return c > 0 ? anc + (int64_t)(c - 1) * N * N : s0_bh; };
    const int64_t step = (int64_t)H * N;
    const int64_t base = ((int64_t)bi * T_len * H + h) * N + j0;
    // this thread's lanes of input q of the chunk in buffer c & 1
    auto raw = [&](int c, int q) {
        return RAW + (((c & 1) * UNFUSED_BWD_INPUTS + q) * L + ts) * N + j0;
    };
    const T* const src[UNFUSED_BWD_INPUTS] = {r, w_raw, k, v, z, b, dy};
    // the inputs of chunk c at this thread's step (the last step's past the
    // end: zeroed when unpacked)
    auto fetch = [&](int c) {
        const int64_t o = base + (int64_t)min(c * L + ts, T_len - 1) * step;
#pragma unroll
        for (int q = 0; q < UNFUSED_BWD_INPUTS; ++q) cp_async_lanes<T>(raw(c, q), src[q] + o);
    };
    state_to_smem(DSb, dsfin ? dsfin + (int64_t)bh * N * N : nullptr);
    state_to_smem(S0b + ((nc - 1) & 1) * ST, entry(nc - 1));
    fetch(nc - 1);
    cp_async_wait_all();

    int cur = 0;  // DSb + cur * ST holds dS after the chunk
    for (int ci = nc - 1; ci >= 0; --ci) {
        float* S0 = S0b + (ci & 1) * ST;
        float* dS = DSb + cur * ST;
        float* dSn = DSb + (cur ^ 1) * ST;
        // the entry state and the inputs fetched during the previous chunk
        // have landed (the barrier below publishes the state; each thread
        // reads only the inputs it fetched); fetch the next ones meanwhile
        cp_async_wait_all();
        if (ci > 0) state_to_smem(S0b + ((ci - 1) & 1) * ST, entry(ci - 1));
        const int tt = ci * L + ts;
        const bool valid = tt < T_len;
        const bool rs = valid && resets && resets[(int64_t)bi * T_len + tt];
        auto unpack = [&](int q, float(&x)[4]) {
            Bits4<T> bits;
            ld_bits(bits, raw(ci, q));
            unpack4(bits, valid, x);
        };
        float xr[4], xw[4], xk[4], xv[4], xz[4], xb[4], xdy[4];
        unpack(0, xr), unpack(1, xw), unpack(2, xk), unpack(3, xv);
        unpack(4, xz), unpack(5, xb), unpack(6, xdy);
        if (ci > 0) fetch(ci - 1);
        {
            float lw[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) lw[u] = (rs || !valid) ? 0.f : -expf(xw[u]);
            const int o = ts * LD + j0;
            st4<float>(s.QT + o, xr);
            st4<float>(s.ZT + o, xz);
            st4<float>(s.KT + o, xk);
            st4<float>(s.BT + o, xb);
            st4<float>(V + o, xv);
            st4<float>(DY + o, xdy);
            st4<float>(s.LG + o, lw);
            if ((tid & 15) == 0) s.RS[ts] = rs ? 1 : 0;
        }
        __syncthreads();
        decay_phase(s, true);
        __syncthreads();
        pair_phase<P>(s, M);
        __syncthreads();
        // recompute sa, 8 value rows a warp: rhs = z0 S^T + Kz v
        // (ops/wkv7.py:116), sa = X rhs (:117)
        const int i0 = 8 * w;
        if (w == 0) {
            invert(M, M + 4 * MAT);
            __syncwarp();  // the whole warp again before mma.sync
        }
        float rhs[4] = {0.f, 0.f, 0.f, 0.f};
        tile<P, N>(rhs, s.Z0, LD, 1, S0 + i0 * LD, 1, LD);
        tile<P, L>(rhs, M + MAT, LDM, 1, V + i0, LD, 1);
        put_tile(SA, i0, rhs);
        __syncthreads();  // X complete
        {
            float sa[4] = {0.f, 0.f, 0.f, 0.f};
            tile<P, L>(sa, M + 4 * MAT, LDM, 1, SA + i0, LD, 1);
            __syncwarp();
            put_tile(SA, i0, sa);
            __syncwarp();
        }
        // the state gradient's chain, 8 value rows a warp: the adjoints of
        // ops/wkv7.py:116-117 and :129-131, with dS the gradient of the
        // state after the chunk: dsa = QB^T dy + bf dS^T, u = X^T dsa,
        // dv = QK^T dy + Kz^T u + kf dS^T, and the gradient of the entry
        // state [c_L = 0] dS diag(e^{g_L}) + dy^T q0 + u^T z0
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
                if (tg < T_len)
                    st2<T>(dv + ((int64_t)bi * T_len + tg) * step + h * N + ii, d[e], d[e + 1]);
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
        __syncthreads();  // sa and u complete
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
        // they give dr, dz, db, dk and the terms of dlogw
        {
            const int jw = 8 * w;
            const float* dA = M + 5 * MAT;
            const float* dKz = M + 6 * MAT;
            const float* dQB = M + 7 * MAT;
            const float* dQK = M + 8 * MAT;
            // two passes, to bound the live accumulators: [dq, dz] over S0,
            // then BT and KT; then [dbf, dkf] over dS and [db, dkt] over ZT,
            // QT (products that share B fragments go together)
            {
                float qz[2][4] = {};
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
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int t = crow(e), o = t * LD + jw + ccol(e);
                    const float eg = s.LG[o], egp = t > 0 ? s.LG[o - LD] : 1.f;
                    DR[o] = qz[0][e] * eg;
                    DZ[o] = qz[1][e] * egp;
                    E[o] = qz[0][e] * s.QT[o];
                    F[o] = qz[1][e] * s.ZT[o];
                }
            }
            float fk[2][4] = {}, bk[2][4] = {};
            const float* sav[2] = {SA, V};
            tiles<P, N, 2>(fk, sav, LD, 1, dS + jw, LD, 1);
            const float* onz[2] = {dA, dKz};
            const float* onq[2] = {dQB, dQK};
            tiles<P, L, 2>(bk, onz, 1, LDM, s.ZT + jw, LD, 1);
            tiles<P, L, 2>(bk, onq, 1, LDM, s.QT + jw, LD, 1);
            float(&dbf)[4] = fk[0];
            float(&dkf)[4] = fk[1];
            float(&dbt)[4] = bk[0];
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
                    dbt[e] = fmaf(dbf[e], dl, dbt[e]);
                    dkt[e] = fmaf(dkf[e], dl, dkt[e]);
                    ddl[e & 1] += bt * dbf[e] + kt * dkf[e];
                }
                const float eg = s.LG[o];
                DB[o] = dbt[e] / eg;
                DK[o] = dkt[e] / eg;
                E[o] = E[o] - dbt[e] * bt - dkt[e] * kt;
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
        // the input gradients (thread (t, 4 lanes)); dw_raw = dlogw dlogw/dw_raw
        if (valid) {
            const int o = ts * LD + j0;
            float g[4], glw[4], outw[4];
            const int64_t go = base + tt * step;
            ld4(DR + o, g);
            st4<T>(dr + go, g);
            ld4(DZ + o, g);
            st4<T>(dz + go, g);
            ld4(DB + o, g);
            st4<T>(db + go, g);
            ld4(DK + o, g);
            st4<T>(dk + go, g);
            ld4(E + o, glw);
            unpack(1, g);  // w_raw, still staged
#pragma unroll
            for (int u = 0; u < 4; ++u) outw[u] = -glw[u] * expf(g[u]);
            st4<T>(dw + go, outw);
        }
        cur ^= 1;
    }
    __syncthreads();
    if (ds0) rows_to_global(ds0 + (int64_t)bh * N * N, DSb + cur * ST, 8 * w);
}

template <typename T>
int launch(int B, int T_len, int H, void* r, void* w, void* k, void* v, void* z, void* b,
           void* s0, void* resets, void* anchors, void* dy, void* dsfin, void* dr, void* dw,
           void* dk, void* dv, void* dz, void* db, void* ds0, cudaStream_t stream) {
    auto kern = wkv7_bwd_kernel<T>;
    constexpr int bytes = bwd_smem_bytes<T>();
    if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            bytes))
        return err;
    RWKV_TRY(kern<<<B * H, NT, bytes, stream>>>(
        T_len, H, (const T*)r, (const T*)w, (const T*)k, (const T*)v, (const T*)z,
        (const T*)b, (const float*)s0, (const uint8_t*)resets, (const float*)anchors,
        (const T*)dy, (const float*)dsfin, (T*)dr, (T*)dw, (T*)dk, (T*)dv, (T*)dz, (T*)db,
        (float*)ds0));
    return 0;
}

}  // namespace

// Shared memory bytes a CTA of wkv7_bwd takes for `dtype` inputs
// (ops/wkv7_cuda.py::bwd_plan).
extern "C" int wkv7_bwd_smem_bytes(int dtype) {
    return dtype == DT_F32 ? bwd_smem_bytes<float>() : bwd_smem_bytes<bf16>();
}

// r..b, dy: (B, T, H, 64) of `dtype`; s0: (B, H, 64, 64) f32 or null;
// resets: (B, T) bool or null; anchors: as written by wkv7_fwd; dsfin:
// (B, H, 64, 64) f32 or null (zero); dr..db: (B, T, H, 64) of `dtype`;
// ds0: (B, H, 64, 64) f32 or null (not written). Exact while a chunk's
// summed decay stays inside f32's exponent range (|sum of exp(w_raw)| over
// 16 steps below ~80; the model's clamp w_raw <= -0.5 keeps it below 9.8).
// Returns the CUDA error of the launch.
extern "C" int wkv7_bwd(int dtype, int B, int T_len, int H, void* r, void* w, void* k,
                        void* v, void* z, void* b, void* s0, void* resets, void* anchors,
                        void* dy, void* dsfin, void* dr, void* dw, void* dk, void* dv,
                        void* dz, void* db, void* ds0, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (T_len < 1 || !anchors) return (int)cudaErrorInvalidValue;
    if (dtype == DT_F32)
        return launch<float>(B, T_len, H, r, w, k, v, z, b, s0, resets, anchors, dy, dsfin, dr,
                             dw, dk, dv, dz, db, ds0, st);
    if (dtype == DT_BF16)
        return launch<bf16>(B, T_len, H, r, w, k, v, z, b, s0, resets, anchors, dy, dsfin, dr,
                            dw, dk, dv, dz, db, ds0, st);
    return (int)cudaErrorInvalidValue;
}
