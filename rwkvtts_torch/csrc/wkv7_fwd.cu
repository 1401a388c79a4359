// WKV7 forward over a whole sequence, in chunks of 16 steps on the tensor
// cores: the prompt prefill of every inference path, and the forward of the
// unfused training path (ops/wkv7_cuda.py::wkv7_fwd and WKV7).
//
// Replaces: rwkvtts_tpu/ops/wkv7_pallas.py::_fwd_kernel (reached through
// _fwd_call / wkv7_pallas), itself chunked (_pair_chunk). It writes y and
// the final state; for training also the state after every 16th step and
// after the last (the anchors), from which wkv7_bwd.cu recomputes each
// chunk. Nothing is saved a step.
//
// What bounds it on this card. Its state products run on the tensor cores
// in TF32 (495 TFLOP/s), where the recurrence's 9 FLOP an element of the
// state a step take less time than its bytes at every shape the paths give
// it. At the generation prefill (B=64, T=128, H=16, bf16) the six inputs and
// y are 7 x 16.8 MB and the f32 state in and out 2 x 16.8 MB, 0.15 GB or 45
// us at 3.35 TB/s (4.8 GFLOP, 10 us); in the training forward (B=8, T=2048,
// H=16) the 268 MB of anchors make it 0.15 ms. At the Cosy prefill (B=1,
// T=320, H=32) the bound is 3 us, but each (b, h) is a chain of T / 16
// dependent chunks: with 32 (b, h) on 132 SMs, one chunk's latency times
// T / 16 is what bounds it.
//
// Design: wkv7_fused.cu's chunked forward without its band (the algebra and
// the shared phases are in wkv7_chunk.cuh), one CTA of 8 warps a (b, h): z
// and b are inputs, logw = -exp(w_raw) (0 at a reset), and y leaves from the
// products' accumulators. A chunk has a key side and a value side. The key
// side: the inputs, staged in shared memory a chunk ahead by cp.async, go to
// f32 tiles; the decays; the four pairwise L x L matrices; (I - A)^{-1} by
// one warp. The value side, 8 value rows a warp: rhs = z0 S^T + Kz v and
// y = q0 S^T + QK v (the products that share an operand load it once),
// sa = X rhs, y += QB sa, stored, and the update of the warp's rows of the
// state, which stay in shared memory (leaving only as anchors). Five
// barriers a chunk. A thread takes at most 128 registers and a CTA ~100 KB
// of shared memory (bf16), so two CTAs reside on an SM, as the prefill's
// 1024 CTAs need. The bf16 instantiation rounds the products' operands to
// TF32 once, the f32 one uses 3xTF32. No atomics: every call gives the same
// bits.
#include "sm90.cuh"
#include "wkv7_chunk.cuh"

namespace {

using namespace wkv7c;

constexpr int NIN = UNFUSED_FWD_INPUTS;  // r, w_raw, k, v, z, b

// shared memory bytes of a CTA: the f32 tiles (kernel 4's forward's), then
// the step inputs of two chunks in their own dtype
template <typename T>
constexpr int fwd_smem_bytes() {
    return FWD_FLOATS * (int)sizeof(float) + 2 * NIN * L * N * (int)sizeof(T);
}

// The sequence a CTA walks: its (b, h)'s inputs, and where its steps lie in
// them and in y.
template <typename T>
struct Seq {
    const T* src[NIN];
    const uint8_t* resets;
    int T_len, bi;
    int64_t base, step;  // offset of (bi, t = 0, h, 0), stride of t

    // cp.async this thread's lanes j0 .. j0 + 3 of step ts of chunk c into
    // raw ([NIN][L][N]; the last step's past the end, zeroed by put), and
    // return the step's reset flag: a load whose value is used a chunk later
    __device__ __forceinline__ uint8_t fetch(T* raw, int c, int ts, int j0) const {
        const int tt = min(c * L + ts, T_len - 1);
        const int64_t o = base + tt * step + j0;
#pragma unroll
        for (int q = 0; q < NIN; ++q) cp_async_lanes<T>(raw + (q * L + ts) * N + j0, src[q] + o);
        return resets ? resets[(int64_t)bi * T_len + tt] : 0;
    }

    // the fetched lanes (landed) to the chunk's f32 tiles: r, k, z, b to QT,
    // KT, ZT, BT, v to V, logw to LG (0 at a reset and past the end), and
    // the step's reset flag
    __device__ __forceinline__ void put(const T* raw, const Tiles& s, float* V, int c, int ts,
                                        int j0, uint8_t flag) const {
        const bool valid = c * L + ts < T_len, rs = valid && flag;
        float in[NIN][4];
#pragma unroll
        for (int q = 0; q < NIN; ++q) {
            Bits4<T> bits;
            ld_bits(bits, raw + (q * L + ts) * N + j0);
            unpack4(bits, valid, in[q]);
        }
        float lw[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) lw[u] = (rs || !valid) ? 0.f : -expf(in[1][u]);
        const int o = ts * LD + j0;
        st4<float>(s.QT + o, in[0]);
        st4<float>(s.LG + o, lw);
        st4<float>(s.KT + o, in[2]);
        st4<float>(V + o, in[3]);
        st4<float>(s.ZT + o, in[4]);
        st4<float>(s.BT + o, in[5]);
        if (j0 == 0) s.RS[ts] = rs ? 1 : 0;
    }
};

template <typename T>
__device__ __forceinline__ Seq<T> sequence(int T_len, int H, const T* r, const T* w_raw,
                                           const T* k, const T* v, const T* z, const T* b,
                                           const uint8_t* resets) {
    const int bi = blockIdx.x / H, h = blockIdx.x - bi * H;
    return {{r, w_raw, k, v, z, b}, resets, T_len, bi, ((int64_t)bi * T_len * H + h) * N,
            (int64_t)H * N};
}

// The warp's state rows i0 .. i0 + 7 of s0 (zeros without it) into S,
// asynchronously.
__device__ __forceinline__ void state_rows(float* S, const float* s0_bh, int i0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int x = lane; x < 8 * N / 4; x += 32) {
        const int row = i0 + (x >> 4), c4 = (x & 15) * 4;
        if (s0_bh)
            cp_async16(S + row * LD + c4, s0_bh + row * N + c4);
        else
            *reinterpret_cast<float4*>(S + row * LD + c4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

template <typename T, bool SAVE>
__global__ void __launch_bounds__(NT, 2) wkv7_fwd_kernel(
    int T_len, int H,
    const T* __restrict__ r, const T* __restrict__ w_raw,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ z, const T* __restrict__ b,
    const float* __restrict__ s0, const uint8_t* __restrict__ resets,
    T* __restrict__ y, float* __restrict__ s_out, float* __restrict__ anchors) {
    constexpr int P = Passes<T>::value;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    Tiles s;
    s.QT = sm, s.ZT = sm + VEC, s.KT = sm + 2 * VEC, s.BT = sm + 3 * VEC;
    s.Q0 = sm + 4 * VEC, s.Z0 = sm + 5 * VEC, s.BF = sm + 6 * VEC, s.KF = sm + 7 * VEC;
    s.LG = sm + 8 * VEC;
    float* Vb = sm + 9 * VEC;  // v of two chunks
    float* SA = sm + 11 * VEC;
    float* S = sm + 12 * VEC;  // the state: each warp reads and writes only its rows
    float* M = S + ST;         // A, Kz, QB, QK, X
    s.DL = M + 5 * MAT;
    s.QSUM = s.DL + N;
    s.RS = reinterpret_cast<int*>(s.QSUM + 4 * N);
    s.CS = s.RS + L;
    T* RAW = reinterpret_cast<T*>(sm + FWD_FLOATS);  // [2][NIN][L][N]

    const Seq<T> q = sequence(T_len, H, r, w_raw, k, v, z, b, resets);
    const int bh = blockIdx.x, tid = threadIdx.x, i0 = 8 * (tid >> 5);  // the warp's rows
    const int ts = tid >> 4, j0 = (tid & 15) * 4;  // the step and lanes this thread moves
    const int nc = wkv7::n_chunks(T_len);
    state_rows(S, s0 ? s0 + (int64_t)bh * N * N : nullptr, i0);
    uint8_t flag = q.fetch(RAW, 0, ts, j0);

    for (int c = 0; c < nc; ++c) {
        float* V = Vb + (c & 1) * VEC;
        // this thread's inputs of chunk c (and, first, the state rows) have
        // landed: it reads only what it fetched, and the barrier below
        // publishes the tiles. Then it fetches the next chunk's.
        cp_async_wait_all();
        q.put(RAW + (c & 1) * NIN * L * N, s, V, c, ts, j0, flag);
        if (c + 1 < nc) flag = q.fetch(RAW + ((c + 1) & 1) * NIN * L * N, c + 1, ts, j0);
        __syncthreads();
        decay_phase(s, false);
        __syncthreads();
        pair_phase<P>(s, M);
        __syncthreads();
        if (tid < 32) {
            invert(M, M + 4 * MAT);
            __syncwarp();  // the whole warp again before mma.sync
        }
        // the value side of the warp's rows (ops/wkv7.py:116-120 and
        // 129-131): rhs = z0 S^T + Kz v and y = q0 S^T + QK v
        float ry[2][4] = {};
        const float* zq[2] = {s.Z0, s.Q0};
        const float* kq[2] = {M + MAT, M + 3 * MAT};
        tiles<P, N, 2>(ry, zq, LD, 1, S + i0 * LD, 1, LD);
        tiles<P, L, 2>(ry, kq, LDM, 1, V + i0, LD, 1);
        float(&yy)[4] = ry[1];
        put_tile(SA, i0, ry[0]);
        __syncthreads();  // X and the warp's rhs columns
        // sa = X rhs, y += QB sa, stored
        float sa[4] = {0.f, 0.f, 0.f, 0.f};
        tile<P, L>(sa, M + 4 * MAT, LDM, 1, SA + i0, LD, 1);
        __syncwarp();
        put_tile(SA, i0, sa);
        __syncwarp();
        tile<P, L>(yy, M + 2 * MAT, LDM, 1, SA + i0, LD, 1);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
            const int tg = c * L + crow(e);
            if (tg < T_len) st2<T>(y + q.base + tg * q.step + i0 + ccol(e), yy[e], yy[e + 1]);
        }
        // the state's rows as four 16-column tiles (M = key columns j, N =
        // the warp's value rows), sharing the B fragments
        const bool live0 = s.CS[L - 1] == 0;
        float st[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int jj = 16 * mt + crow(e), ii = i0 + ccol(e);
                st[mt][e] = live0 ? S[ii * LD + jj] * s.DL[jj] : 0.f;
            }
        const float* bf[4] = {s.BF, s.BF + 16, s.BF + 32, s.BF + 48};
        const float* kf[4] = {s.KF, s.KF + 16, s.KF + 32, s.KF + 48};
        tiles<P, L, 4>(st, bf, 1, LD, SA + i0, LD, 1);
        tiles<P, L, 4>(st, kf, 1, LD, V + i0, LD, 1);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) S[(i0 + ccol(e)) * LD + 16 * mt + crow(e)] = st[mt][e];
        if constexpr (SAVE) {
            __syncwarp();
            rows_to_global(anchors + ((int64_t)bh * nc + c) * N * N, S, i0);
        }
    }
    __syncwarp();
    rows_to_global(s_out + (int64_t)bh * N * N, S, i0);
}

template <typename T, bool SAVE>
int launch_fwd(int B, int T_len, int H, void* const (&p)[11], cudaStream_t stream) {
    constexpr int bytes = fwd_smem_bytes<T>();
    // two CTAs of ~100 KB an SM need the largest shared-memory carveout
    if (cudaError_t e = allow_smem<wkv7_fwd_kernel<T, SAVE>>(bytes, true)) return (int)e;
    RWKV_TRY(wkv7_fwd_kernel<T, SAVE><<<B * H, NT, bytes, stream>>>(
        T_len, H, (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
        (const T*)p[4], (const T*)p[5], (const float*)p[6], (const uint8_t*)p[7], (T*)p[8],
        (float*)p[9], (float*)p[10]));
    return 0;
}

template <typename T>
int launch_fwd(int B, int T_len, int H, void* const (&p)[11], cudaStream_t stream) {
    return p[10] ? launch_fwd<T, true>(B, T_len, H, p, stream)
                 : launch_fwd<T, false>(B, T_len, H, p, stream);
}

}  // namespace

// Shared memory bytes a CTA of wkv7_fwd takes for `dtype` inputs
// (ops/wkv7_cuda.py::fwd_plan).
extern "C" int wkv7_fwd_smem_bytes(int dtype) {
    return dtype == DT_F32 ? fwd_smem_bytes<float>() : fwd_smem_bytes<bf16>();
}

// r..b: (B, T, H, 64) of `dtype`; s0: (B, H, 64, 64) f32 or null; resets:
// (B, T) bool or null; y: (B, T, H, 64) of `dtype`; s_out: (B, H, 64, 64)
// f32. For training, anchors: (B, H, ceil(T / 16), 64, 64) f32, the state
// after steps 15, 31, ... and T - 1; null for the primal alone. Exact while
// a chunk's summed decay stays inside f32's exponent range (|sum of
// exp(w_raw)| over 16 steps below ~80; the model's clamp w_raw <= -0.5 keeps
// it below 9.8). Returns the CUDA error of the launch (0 on success).
extern "C" int wkv7_fwd(int dtype, int B, int T_len, int H, void* r, void* w, void* k, void* v,
                        void* z, void* b, void* s0, void* resets, void* y, void* s_out,
                        void* anchors, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    void* const p[11] = {r, w, k, v, z, b, s0, resets, y, s_out, anchors};
    if (T_len < 1) return (int)cudaErrorInvalidValue;
    if (dtype == DT_F32) return launch_fwd<float>(B, T_len, H, p, st);
    if (dtype == DT_BF16) return launch_fwd<bf16>(B, T_len, H, p, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
