// Shared helpers for the rwkvtts_torch CUDA kernels (plain C interface,
// no PyTorch headers: see rwkvtts_torch/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// dtype codes passed from Python
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
    return __float2bfloat16(x);  // round to nearest even
}

// the f32 value of x rounded to bf16 (a rounding point of the TPU kernel)
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

// unpack 8 bf16 held in a 16-byte vector
__device__ __forceinline__ void unpack8(const uint4& u, float* out) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(p[e]);
        out[2 * e] = f.x;
        out[2 * e + 1] = f.y;
    }
}

__device__ __forceinline__ uint4 pack8(const float* in) {
    uint4 u;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __floats2bfloat162_rn(in[2 * e], in[2 * e + 1]);
    return u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Sum over all threads of a block of NWARPS warps; every thread gets the
// total. `scratch` holds NWARPS floats; the call synchronises the block.
template <int NWARPS>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
    v = warp_sum(v);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // scratch may still be read by a previous call
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) t += scratch[w];
    return t;
}

#define RWKV_TRY(...)                               \
    do {                                            \
        __VA_ARGS__;                                \
        cudaError_t err_ = cudaGetLastError();      \
        if (err_ != cudaSuccess) return (int)err_;  \
    } while (0)
