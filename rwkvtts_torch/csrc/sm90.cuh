// Hopper (sm_90a) building blocks shared by the decode steps (decode_b64.cu,
// decode_b1.cu): programmatic dependent launch, mbarriers, TMA tile loads
// and their tensor maps, cluster barriers and distributed shared memory
// reads, and the launch with its attributes.
#pragma once

#include <cuda.h>  // CUtensorMap; the driver's encoder is looked up at run time

#include <atomic>
#include <mutex>
#include <vector>

#include "common.cuh"

namespace {

// Programmatic dependent launch: wait for the previous kernel of the
// stream to complete (its writes visible), and let the next one launch.
// What an earlier kernel of the chain writes is read with ld.global.cg (L2,
// not this SM's L1, which may hold a line as an earlier kernel saw it), and
// never through a `const __restrict__` pointer, which lets the compiler use
// the non-coherent path.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
}
// the box at coordinates (c0, c1, c2) of a TMA map into this CTA's shared
// memory; completes its bytes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// 16 bytes at the same shared offset in the cluster's CTA `rank`. Not
// volatile: the partial tiles stay fixed between the two cluster barriers
// (which are), so the compiler may issue these loads together.
__device__ __forceinline__ float4 ld_cluster_f4(const void* local, int rank) {
    uint32_t remote;
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
    float4 v;
    asm("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote));
    return v;
}
// The cluster barrier without release semantics: the CTAs' earlier writes
// are not made visible by it (fence.mbarrier_init orders the mbarrier
// initialisations it is used for), so it does not wait for this thread's
// memory operations in flight.
__device__ __forceinline__ void cluster_sync_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// v to the same shared offset as `local` in the cluster's CTA `rank`, as an
// asynchronous store whose 4 bytes complete on that CTA's mbarrier at the
// shared offset of `bar` (no fence: the receiver waits on its barrier)
__device__ __forceinline__ void st_async_f32(float* local, uint64_t* bar, int rank, float v) {
    uint32_t remote, rbar;
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(remote),
        "r"(__float_as_uint(v)), "r"(rbar)
        : "memory");
}

// every kernel of a chain goes out with programmatic stream serialization
// (unless pdl is false, which a profile of each kernel's own device time
// asks for), and as clusters of `cluster` CTAs where that is above 1
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int grid, int block, int smem, int cluster,
                   bool pdl, cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(block);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    cfg.attrs = pdl ? attr : attr + 1;
    cfg.numAttrs = (pdl ? 1 : 0) + (cluster > 1 ? 1 : 0);
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// cudaFuncSetAttribute(KERNEL, MaxDynamicSharedMemorySize, bytes) once per
// device and process, not before every launch. With max_shared the kernel
// also asks for the largest shared-memory carveout: an SM changes its
// L1 / shared split only when it is empty, so in a chain whose kernels
// overlap (programmatic dependent launch) every kernel asks for the same
// split.
template <auto KERNEL>
cudaError_t allow_smem(int bytes, bool max_shared = false) {
    constexpr int MAX_DEVICES = 64;
    static std::atomic<bool> done[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
    e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess && max_shared)
        e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) done[dev].store(true, std::memory_order_release);
    return e;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static const EncodeTiled fn = [] {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                             cudaEnableDefault, &q) != cudaSuccess)
            f = nullptr;
#else
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess)
            f = nullptr;
#endif
        return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
    }();
    return fn;
}

// A TMA map over a row-major (d2, d1, d0) array of 1-byte (int8) or 2-byte
// (bf16) elements whose box is `rows` rows of `row_bytes` bytes: for a tile
// of the decode_b64 product the 128-byte swizzle and 256-byte L2
// promotion, else neither (a box row is then read as its own bytes). Maps
// are kept by (address, shape, box), so each is encoded once per weight
// pack and workspace; a map holds only the address and shape, so one found
// there is right for whatever array now lies at that address with that
// shape.
int tensor_map(CUtensorMap* out, const void* base, int esize, uint64_t d0, uint64_t d1,
               uint64_t d2, int row_bytes, int rows, bool swizzle) {
    struct Entry {
        const void* base;
        int esize;
        uint64_t d0, d1, d2;
        int row_bytes, rows;
        bool swizzle;
        CUtensorMap map;
    };
    static std::mutex mu;
    static std::vector<Entry> cache;
    std::lock_guard<std::mutex> lock(mu);
    for (const Entry& e : cache)
        if (e.base == base && e.esize == esize && e.d0 == d0 && e.d1 == d1 && e.d2 == d2 &&
            e.row_bytes == row_bytes && e.rows == rows && e.swizzle == swizzle) {
            *out = e.map;
            return 0;
        }
    const EncodeTiled encode = encoder();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[3] = {d0, d1, d2};
    const cuuint64_t strides[2] = {d0 * esize, d0 * d1 * esize};
    const cuuint32_t box[3] = {(cuuint32_t)(row_bytes / esize), (cuuint32_t)rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    Entry e = {base, esize, d0, d1, d2, row_bytes, rows, swizzle, {}};
    if (encode(&e.map, esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               3, const_cast<void*>(base), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE,
               swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
               swizzle ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B : CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    if (cache.size() >= 256) cache.clear();
    cache.push_back(e);
    *out = e.map;
    return 0;
}

}  // namespace
