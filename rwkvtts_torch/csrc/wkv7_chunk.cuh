// The chunked form of the WKV7 recurrence, for the forward (wkv7_fwd.cu),
// the training backward (wkv7_bwd.cu) and the fused training pair
// (wkv7_fused.cu). It follows ops/wkv7.py::_chunk_body (the port of
// rwkvtts_tpu/ops/wkv7.py::_chunk_body and of wkv7_pallas.py::_pair_chunk):
// per (b, h) and chunk of L = 16 steps, with c_t the count of resets up to
// t, logw_t = -exp(w_raw_t) (0 at a reset) and g its inclusive cumsum,
//     qt = r e^g, zt = z e^{g_{t-1}}, kt = k e^{-g}, bt = b e^{-g}
//     A  = zt bt^T, Kz = zt kt^T   (strictly lower, same segment)
//     QB = qt bt^T, QK = qt kt^T   (lower with the diagonal, same segment)
//     sa = (I - A)^{-1} (z0 S^T + Kz v)      z0, q0: rows with c = 0
//     y  = q0 S^T + QB sa + QK v
//     S' = [c_L = 0] S diag(e^{g_L}) + sa^T bf + v^T kf
// where bf, kf are bt, kt times e^{g_L} on the rows of the last segment.
// Rows of S are the value dim, columns the key dim.
//
// Layout: one CTA of 8 warps a (b, h). The chunk's vectors live in shared
// memory as [L][N] f32 tiles, the state as [N][N]. Every product is a
// warp's 16 x 8 tile on the tensor cores (mma.sync m16n8k8 TF32, f32
// accumulators): P = 1 rounds the operands to TF32 once, P = 3 splits each
// into a TF32 high and low part and sums three products (3xTF32, ~f32
// accuracy). (I - A)^{-1} is a forward substitution in f32 on the CUDA
// cores. Everything is in f32 from the loads on; each (b, h) walks T / L
// chunks.
#pragma once

#include "wkv7_core.cuh"

namespace wkv7c {

using wkv7::N;
constexpr int L = wkv7::CHUNK;  // the chunk is the anchor interval
constexpr int NT = 256;         // threads a CTA
constexpr int NW = NT / 32;
constexpr int LD = N + 4;       // row stride (floats) of [L][N] and [N][N] tiles
constexpr int VEC = L * LD;
constexpr int ST = N * LD;
constexpr int LDM = L + 4;      // row stride of the L x L matrices
constexpr int MAT = L * LDM;
static_assert(L == 16 && N == 64 && NW == 8, "the tiling assumes L = 16, N = 64, 8 warps");

// shared floats of each kernel: the fused forward and backward
// (ops/wkv7_cuda.py::fused_plan mirrors these), wkv7_bwd.cu's backward
// (ops/wkv7_cuda.py::bwd_plan), which also stages its 7 step inputs (r,
// w_raw, k, v, z, b, dy) of two chunks in their own dtype; wkv7_fwd.cu's
// forward (ops/wkv7_cuda.py::fwd_plan) takes FWD_FLOATS and stages its 6
// the same way
constexpr int FWD_FLOATS = 12 * VEC + ST + 5 * MAT + (N + 4 * N + 2 * L);
constexpr int BWD_FLOATS = 20 * VEC + 4 * ST + 9 * MAT + (2 * N + 4 * N + 3 * L);
constexpr int UNFUSED_BWD_FLOATS = 19 * VEC + 4 * ST + 9 * MAT + (2 * N + 4 * N + 2 * L);
constexpr int UNFUSED_BWD_INPUTS = 7;
constexpr int UNFUSED_FWD_INPUTS = 6;

// passes of each product: 1x TF32 for bf16 inputs, 3xTF32 for f32
template <typename T> struct Passes { static constexpr int value = 3; };
template <> struct Passes<bf16> { static constexpr int value = 1; };

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int P>
__device__ __forceinline__ void mma_step(float (&c)[4], const float (&a)[4], const float (&b)[2]) {
    uint32_t ah[4], bh[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) ah[e] = to_tf32(a[e]);
#pragma unroll
    for (int e = 0; e < 2; ++e) bh[e] = to_tf32(b[e]);
    if constexpr (P == 3) {
        uint32_t al[4], bl[2];
#pragma unroll
        for (int e = 0; e < 4; ++e) al[e] = to_tf32(a[e] - __uint_as_float(ah[e]));
#pragma unroll
        for (int e = 0; e < 2; ++e) bl[e] = to_tf32(b[e] - __uint_as_float(bh[e]));
        mma_tf32(c, al, bh);
        mma_tf32(c, ah, bl);
    }
    mma_tf32(c, ah, bh);
}

// NA warp tiles of 16 x 8 that share B: C_a(m, n) += sum_k A_a(m, k) B(k, n)
// for k < K, with A_a(m, k) = A_a[m am + k ak] and B(k, n) = B[k bk + n bn]
// in shared memory; B's fragments are loaded once for all of them. C is in
// the accumulator layout: c[a][e] at row g + 8 (e >> 1), column 2 q + (e &
// 1), g = lane / 4, q = lane % 4.
template <int P, int K, int NA>
__device__ __forceinline__ void tiles(float (&c)[NA][4], const float* const (&A)[NA], int am,
                                      int ak, const float* B, int bk, int bn) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    // 3xTF32 (P = 3) triples the live fragments of an unrolled step, so its
    // K loop is unrolled by 2 only: fully unrolled, the f32 backward
    // (wkv7_bwd.cu) ran out of registers and spilled
#pragma unroll (P == 3 ? 2 : 8)
    for (int k0 = 0; k0 < K; k0 += 8) {
        const float b[2] = {B[(k0 + q) * bk + g * bn], B[(k0 + q + 4) * bk + g * bn]};
#pragma unroll
        for (int x = 0; x < NA; ++x) {
            const float* a_ = A[x];
            const float a[4] = {a_[g * am + (k0 + q) * ak], a_[(g + 8) * am + (k0 + q) * ak],
                                a_[g * am + (k0 + q + 4) * ak],
                                a_[(g + 8) * am + (k0 + q + 4) * ak]};
            mma_step<P>(c[x], a, b);
        }
    }
}

// one such tile
template <int P, int K>
__device__ __forceinline__ void tile(float (&c)[4], const float* A, int am, int ak,
                                     const float* B, int bk, int bn) {
    const float* const a[1] = {A};
    tiles<P, K, 1>(*reinterpret_cast<float(*)[1][4]>(&c), a, am, ak, B, bk, bn);
}

__device__ __forceinline__ int crow(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int ccol(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }

// store a C tile (rows t, columns col0 + n) into a [L][N] tile
__device__ __forceinline__ void put_tile(float* dst, int col0, const float (&c)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[crow(e) * LD + col0 + ccol(e)] = c[e];
}

// sum over the 16 lanes of a half warp (one step's 64 lanes, 4 a thread)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// 4 lanes of one input as loaded, unpacked only where used: a load whose
// value is needed a chunk later must not stall the chunk that issues it, so
// it is neither converted nor selected on right away (callers load a valid
// row unconditionally and zero the values past the end at unpack time)
template <typename T> struct Bits4;
template <> struct Bits4<float> { float4 u; };
template <> struct Bits4<bf16> { uint2 u; };

template <typename T>
__device__ __forceinline__ void ld_bits(Bits4<T>& b, const T* p) {
    b.u = *reinterpret_cast<const decltype(b.u)*>(p);
}
__device__ __forceinline__ void unpack4(const Bits4<float>& b, bool valid, float (&f)[4]) {
    f[0] = valid ? b.u.x : 0.f, f[1] = valid ? b.u.y : 0.f;
    f[2] = valid ? b.u.z : 0.f, f[3] = valid ? b.u.w : 0.f;
}
__device__ __forceinline__ void unpack4(const Bits4<bf16>& b, bool valid, float (&f)[4]) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.u.y));
    f[0] = valid ? lo.x : 0.f, f[1] = valid ? lo.y : 0.f;
    f[2] = valid ? hi.x : 0.f, f[3] = valid ? hi.y : 0.f;
}

// 4 f32 from shared memory
__device__ __forceinline__ void ld4(const float* p, float (&f)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
}
template <typename T> __device__ __forceinline__ void st4(T* p, const float (&f)[4]);
template <> __device__ __forceinline__ void st4<float>(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
template <> __device__ __forceinline__ void st4<bf16>(bf16* p, const float (&f)[4]) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(f[0], f[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(p) = u;
}
template <typename T> __device__ __forceinline__ void st2(T* p, float a, float b);
template <> __device__ __forceinline__ void st2<float>(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void st2<bf16>(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 4 lanes of one input (8 or 16 bytes) into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void cp_async_lanes(T* dst, const T* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (sizeof(T) == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
}

// A 64 x 64 f32 state (row-major, rows of 64) into a [N][N] tile, by the
// whole CTA, asynchronously (cp_async_wait_all and a barrier before use);
// null src writes zeros.
__device__ __forceinline__ void state_to_smem(float* dst, const float* src) {
    for (int x = threadIdx.x; x < N * N / 4; x += NT) {
        const int row = x >> 4, c4 = (x & 15) * 4;
        if (src)
            cp_async16(dst + row * LD + c4, src + row * N + c4);
        else
            *reinterpret_cast<float4*>(dst + row * LD + c4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// Rows row0 .. row0 + 7 of a [N][N] tile to a row-major 64 x 64 state in
// global memory, by one warp.
__device__ __forceinline__ void rows_to_global(float* dst, const float* src, int row0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int x = lane; x < 8 * N / 4; x += 32) {
        const int row = row0 + (x >> 4), c4 = (x & 15) * 4;
        *reinterpret_cast<float4*>(dst + row * N + c4) =
            *reinterpret_cast<const float4*>(src + row * LD + c4);
    }
}

// The band's prologue for one step and 4 lanes j0 .. j0 + 3 (the thread's
// slice; the 16 threads of a step sum over its 64 lanes): kk = l2norm(k_raw
// k_k), k_eff = k_raw (1 + (a - 1) k_a), and the bonus coefficient
// cb = sum_j r k_eff r_k (ops/wkv7.py::wkv7_fused_plain).
struct Pro {
    float kk[4], ke[4], ss, nrm, cb;
};

__device__ __forceinline__ Pro prologue(const float (&r)[4], const float (&k)[4],
                                        const float (&a)[4], const float (&kkp)[4],
                                        const float (&kap)[4], const float (&rkp)[4]) {
    Pro p;
    float kx[4], ss = 0.f, cb = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        kx[u] = k[u] * kkp[u];
        ss = fmaf(kx[u], kx[u], ss);
        p.ke[u] = wkv7::k_eff(k[u], a[u], kap[u]);
        cb = fmaf(r[u] * p.ke[u], rkp[u], cb);
    }
    p.ss = sum16(ss);
    p.cb = sum16(cb);
    p.nrm = wkv7::l2_norm(p.ss);
#pragma unroll
    for (int u = 0; u < 4; ++u) p.kk[u] = kx[u] / p.nrm;
    return p;
}

// The chunk's decays, by the whole CTA (ops/wkv7.py:89-98 the segment
// counters, logw = 0 at a reset, g and the decayed vectors; :113-114 z0 and
// q0; :123-127 the live rows and bf, kf). On entry QT, ZT, KT, BT hold r, z,
// k_eff, b, LG holds logw (0 at resets and past the end) and RS the reset
// flags; on exit QT.. BT hold the decayed qt, zt, kt, bt, Q0 / Z0 their rows
// with c = 0, BF / KF bf, kf, LG e^g (when keep_eg; else untouched), DL
// e^{g_L} and CS the segment counters. One barrier inside; the caller
// synchronises before and after.
struct Tiles {
    float *QT, *ZT, *KT, *BT, *Q0, *Z0, *BF, *KF, *LG, *DL, *QSUM;
    int *RS, *CS;
};

__device__ __forceinline__ void decay_phase(const Tiles& s, bool keep_eg) {
    const int j = threadIdx.x & (N - 1), qq = threadIdx.x >> 6;
    float lw[4], part = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        lw[u] = s.LG[(4 * qq + u) * LD + j];
        part += lw[u];
    }
    s.QSUM[qq * N + j] = part;
    __syncthreads();
    float g = 0.f, tot = 0.f;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
        const float p = s.QSUM[x * N + j];
        tot += p;
        if (x < qq) g += p;
    }
    const float dl = expf(tot);
    int c = 0, cl = 0;
#pragma unroll
    for (int u = 0; u < L; ++u) {
        cl += s.RS[u];
        if (u < 4 * qq) c += s.RS[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int t = 4 * qq + u, o = t * LD + j;
        c += s.RS[t];
        const float eg_prev = expf(g);
        g += lw[u];
        const float eg = expf(g), eng = expf(-g);
        const bool m0 = c == 0, live = c == cl;
        const float qt = s.QT[o] * eg, zt = s.ZT[o] * eg_prev;
        const float kt = s.KT[o] * eng, bt = s.BT[o] * eng;
        s.QT[o] = qt, s.ZT[o] = zt, s.KT[o] = kt, s.BT[o] = bt;
        s.Q0[o] = m0 ? qt : 0.f, s.Z0[o] = m0 ? zt : 0.f;
        s.BF[o] = live ? bt * dl : 0.f, s.KF[o] = live ? kt * dl : 0.f;
        if (keep_eg) s.LG[o] = eg;
        if (j == 0) s.CS[t] = c;
    }
    if (qq == 0) s.DL[j] = dl;
}

// The four pairwise L x L matrices, one 16 x 8 tile a warp, masked
// (ops/wkv7.py:103-109 and the pair() products of :119-120): M[0] = A,
// M[1] = Kz (strict), M[2] = QB, M[3] = QK (with the diagonal).
template <int P>
__device__ __forceinline__ void pair_phase(const Tiles& s, float* M) {
    const int w = threadIdx.x >> 5, mat = w >> 1, nt = w & 1;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    tile<P, N>(c, mat < 2 ? s.ZT : s.QT, LD, 1, ((mat & 1) ? s.KT : s.BT) + nt * 8 * LD, 1, LD);
    float* out = M + mat * MAT;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int t = crow(e), u = nt * 8 + ccol(e);
        const bool keep = (mat < 2 ? u < t : u <= t) && s.CS[t] == s.CS[u];
        out[t * LDM + u] = keep ? c[e] : 0.f;
    }
}

// X = (I - A)^{-1} (ops/wkv7.py:110, there by Neumann doubling) by forward
// substitution, f32, one column a lane of lanes 0 .. 15 of the calling warp.
__device__ __forceinline__ void invert(const float* A, float* X) {
    const int col = threadIdx.x & 31;
    if (col >= L) return;
    float x[L];
#pragma unroll
    for (int t = 0; t < L; ++t) {
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int u = 0; u + 1 < t; u += 2) {
            a0 = fmaf(A[t * LDM + u], x[u], a0);
            a1 = fmaf(A[t * LDM + u + 1], x[u + 1], a1);
        }
        if (t & 1) a0 = fmaf(A[t * LDM + t - 1], x[t - 1], a0);
        // the identity's 1 at t == col (where the sum is 0: x[u] = 0 for
        // u < col) as a select, not an initial value: 16 per-lane
        // constants that a compiler hoists out of the chunk loop and
        // keeps in registers
        x[t] = t == col ? 1.f : a0 + a1;
    }
#pragma unroll
    for (int t = 0; t < L; ++t) X[t * LDM + col] = x[t];
}

}  // namespace wkv7c
