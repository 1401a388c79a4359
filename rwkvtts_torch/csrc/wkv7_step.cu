// One WKV7 decode step over a batch of per-head states, updated in place:
// the slot pool's step, once a layer at every decode step.
//
// Replaces: rwkvtts_tpu/ops/wkv7_step_pallas.py::_step_kernel (reached
// through wkv7_step_packed). Same function on the natural layout: the state
// is (B, H, 64, 64), row i the value dim and column j the key dim, not the
// TPU's head-pair lane packing (P, 64, 128), which exists only for its
// 128-lane vector registers. Per (b, h):
//     w    = exp(-exp(w_raw))
//     sa_i = sum_j S[i,j] z_j
//     S'   = S diag(w) + sa b^T + v k^T
//     y_i  = sum_j S'[i,j] r_j
// The state is read in its carry dtype (f32 or bf16), stepped in f32 in
// registers and written back in the carry dtype; y is the f32 sum rounded
// once to v's dtype, the TPU kernel's rounding point (its f32 y, then the
// wrapper's astype).
//
// What bounds it on this card: the state is read once and written once and
// nothing else is large. At the slot pool's shape (B = 96, H = 16, f32
// carry) that is 2 x 25.2 MB a layer plus 1.4 MB of bf16 vectors (six in,
// y out), ~51.7 MB: ~15.4 us at 3.35 TB/s, about half that with a bf16
// carry. The arithmetic is 7 FLOP an element (0.17 GFLOP a layer), ~2.6 us
// on the CUDA cores. So it is bound by the bytes.
//
// Design for the bytes: one CTA of 4 warps per (b, h), 1536 CTAs at the
// pool's shape; warp w owns rows 16w .. 16w+15, and lane l holds key
// columns 2l, 2l+1 of each of them, so a warp reads a state row as one
// coalesced 256-byte (f32) or 128-byte (bf16) line, and all 16 rows are
// loaded before any is used (16 loads in flight a lane). The lane's five
// key-indexed vectors (w_raw, k, z, b, r) are loaded once, the decay is
// computed in the kernel. The two row reductions (sa_i before the update,
// y_i after it) are warp shuffles; no shared memory, no block barrier.
// Each element is read and then written by the same thread, so the update
// is safe in place (s_out == s_in). No tensor cores: there is no matrix
// product here to feed them.
#include "common.cuh"

namespace {

constexpr int N = 64;          // head size
constexpr int WARPS = 4;
constexpr int ROWS = N / WARPS;  // rows a warp

__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename TS, typename TV>
__global__ void __launch_bounds__(WARPS * 32) step_kernel(
    const TS* s_in, TS* s_out, const TV* __restrict__ r, const TV* __restrict__ w_raw,
    const TV* __restrict__ k, const TV* __restrict__ v, const TV* __restrict__ z,
    const TV* __restrict__ b, TV* __restrict__ y) {
    const int bh = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j0 = 2 * lane, row0 = warp * ROWS;
    const size_t vec = (size_t)bh * N;

    float2 S[ROWS];
    const TS* src = s_in + (size_t)bh * N * N + (size_t)row0 * N + j0;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) S[i] = load2(src + (size_t)i * N);

    const float2 wr = load2(w_raw + vec + j0), kv = load2(k + vec + j0);
    const float2 zv = load2(z + vec + j0), bv = load2(b + vec + j0);
    const float2 rv = load2(r + vec + j0);
    const float w0 = expf(-expf(wr.x)), w1 = expf(-expf(wr.y));

    TS* dst = s_out + (size_t)bh * N * N + (size_t)row0 * N + j0;
    float y_mine = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        const float sa = warp_sum(S[i].x * zv.x + S[i].y * zv.y);
        const float vi = to_f32(v[vec + row0 + i]);
        const float n0 = S[i].x * w0 + sa * bv.x + vi * kv.x;
        const float n1 = S[i].y * w1 + sa * bv.y + vi * kv.y;
        store2(dst + (size_t)i * N, n0, n1);
        const float yi = warp_sum(n0 * rv.x + n1 * rv.y);
        if (lane == i) y_mine = yi;
    }
    if (lane < ROWS) y[vec + row0 + lane] = from_f32<TV>(y_mine);
}

template <typename TS, typename TV>
int launch(int BH, void* s_in, void* s_out, void* r, void* w, void* k, void* v,
           void* z, void* b, void* y, cudaStream_t st) {
    RWKV_TRY(step_kernel<TS, TV><<<BH, WARPS * 32, 0, st>>>(
        (const TS*)s_in, (TS*)s_out, (const TV*)r, (const TV*)w, (const TV*)k,
        (const TV*)v, (const TV*)z, (const TV*)b, (TV*)y));
    return 0;
}

}  // namespace

// state_dtype: the carry's (DT_F32 or DT_BF16); dtype: that of r, w_raw, k,
// v, z, b and y. BH = B * H heads of N = 64; s_out may equal s_in.
extern "C" int wkv7_step(int state_dtype, int dtype, int BH, void* s_in, void* s_out,
                         void* r, void* w, void* k, void* v, void* z, void* b,
                         void* y, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (BH <= 0) return 0;
    if (state_dtype == DT_F32 && dtype == DT_F32)
        return launch<float, float>(BH, s_in, s_out, r, w, k, v, z, b, y, st);
    if (state_dtype == DT_F32 && dtype == DT_BF16)
        return launch<float, bf16>(BH, s_in, s_out, r, w, k, v, z, b, y, st);
    if (state_dtype == DT_BF16 && dtype == DT_F32)
        return launch<bf16, float>(BH, s_in, s_out, r, w, k, v, z, b, y, st);
    if (state_dtype == DT_BF16 && dtype == DT_BF16)
        return launch<bf16, bf16>(BH, s_in, s_out, r, w, k, v, z, b, y, st);
    return (int)cudaErrorInvalidValue;
}
