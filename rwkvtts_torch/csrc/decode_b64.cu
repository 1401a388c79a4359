// One RWKV-7 decode step for a batch of 64 rows, all layers.
//
// Replaces: rwkvtts_tpu/ops/decode_mega_b64.py::_mega_b64_kernel (reached
// through decode_step_mega_b64). Same arithmetic and the same rounding
// points: bf16 at acc_rkv, acc_ffn, the wd/a/g/kk rows, the xn/xx shift
// inputs, v_first, y_g, the shift states and the WKV state; f32 for the
// residual x_res and the lora-in outputs. Where decode_step_plain rounds
// a product and a sum apart, so does this file (__fmul_rn / __fadd_rn, no
// contraction into an FMA), and its norms divide by a correctly rounded
// sqrtf as the plain version's reciprocal(sqrt(.)) does.
//
// What bounds it on this card, reckoned from shapes at C = 1024, L = 24,
// B = 64: the int8 weights are 24 x (3C^2 + 4C.128 + 128.4C + C^2 + 8C^2)
// bytes = 0.33 GB, read once per step, and the bf16 WKV state is
// 24 x 64 x 16 x 64 x 64 x 2 bytes = 0.20 GB, read and written once per
// step: ~0.73 GB, or 0.22 ms at 3.35 TB/s. The products do
// 2 x 64 x 0.33 G = 42 GFLOP: 0.04 ms on the tensor cores at 989 TFLOP/s in
// bf16. So the step is bound by the bytes; what keeps it far above that
// bound is latency: 194 dependent launches, each too short to reach the
// card's rate (PERF.md, PR 6).
//
// Design. The TPU grid (L, T) carries scratch from one grid step to the
// next; CUDA blocks cannot, so the step is a chain of launches on one
// stream, 8 a layer and 8 L + 2 a step, and the activations that the TPU
// kept in VMEM live in one device workspace between launches:
//   ln_rows  LayerNorm of the 64 residual rows; for ln1/ln2 it also steps
//            the token-shift state and writes the bf16 token-shift mixes
//            that are the products' lhs (6 for time mix, 1 for FFN);
//   gemm_i8  [64 x K] bf16 x [K x N] int8 -> f32 on the tensor cores, times
//            the per-column scale (int8 is exact in bf16, so this is the TPU
//            kernel's dequant-free product). One launch carries a table of
//            up to two products: r/k/v and lora-in run as one launch;
//   glue     one CTA of 4 warps per (row b, head h): the prep elementwise
//            work, the WKV state update in place in kernel 7's layout
//            (csrc/wkv7_step.cu), GroupNorm, bonus and gate.
//
// The product, gemm_i8. A CTA owns a 128-column tile of one product and a
// piece of K (split-K). Its lhs slice, 64 x K-piece bf16 (at most 128 KB),
// is copied into shared memory once and stays there while the weight tiles
// stream past: each CTA reads its lhs once (the first version read the
// whole lhs again for every 32 columns, 4 bytes of lhs for each byte of
// weight). The weights keep the natural (L, K, N) int8 layout. Both come
// by TMA: 2-D boxes of 64 rows x 128 bytes with the 128-byte swizzle (a
// weight stage, or 64 columns of the lhs), one request each; one producer
// warp keeps a ring of up to 8 weight stages in flight, each completing an
// mbarrier, and consumers free a stage through another. Eight consumer
// warps: two on each 32 columns, taking alternate k16 steps, all 64 rows
// each. Products are mma.sync m16n8k16 (bf16 in, f32 accumulate), chosen
// over wgmma because B has to be widened from int8 anyway: wgmma would
// need the widened tile written back to shared memory in its layout, an
// extra pass and a barrier; mma.sync takes its B fragment from registers.
// The fragment is built straight from the raw int8 tile: the columns of
// mma tile e are mapped to tile columns 4j + e, so one 32-bit read of a
// weight row gives a thread its column in four mma tiles, and the widening
// is a byte permute that forms the f32 2^23 + (x + 128), one subtraction
// (exact) and a pack to bf16x2 (exact). The K pieces of a tile run as one
// thread block cluster: each CTA adds its two warp halves into an f32
// partial tile in its shared memory (second half, then first), and after
// a cluster barrier CTA p sums rows [64p/P, 64(p+1)/P) over the cluster's
// tiles in rank order through distributed shared memory, then applies the
// epilogue (bf16, lora activations, relu^2, f32, or an add into the f32
// residual). Every sum has a fixed order, so the step is deterministic:
// no float atomics.
//
// Every kernel is launched with programmatic dependent launch: what does
// not depend on the previous kernel (a product's first weight stages, the
// glue's WKV state block) is fetched before griddepcontrol.wait, nothing is
// written before it, and each kernel lets the next one launch
// (griddepcontrol.launch_dependents) once its dependent reads are done, so
// the next kernel's weight stream overlaps this one's tail.
#include "sm90.cuh"

namespace {

constexpr int NH = 64;        // head size
constexpr int LORA_PAD = 128; // every lora width padded to this
constexpr int NS = 24;        // rows of the smalls block

// smalls rows (rwkvtts_tpu/ops/decode_mega.py::_SM)
enum {
    SM_LN1_S = 0, SM_LN1_B = 1, SM_LN2_S = 2, SM_LN2_B = 3,
    SM_X_R = 4, SM_X_K = 5, SM_X_V = 6, SM_X_W = 7, SM_X_A = 8, SM_X_G = 9,
    SM_W0 = 10, SM_A0 = 11, SM_V0 = 12, SM_K_K = 13, SM_K_A = 14, SM_R_K = 15,
    SM_LN_X_S = 16, SM_LN_X_B = 17, SM_FFN_X_K = 18,
};
// lora groups, in the order of the packed lora blocks (the TPU _LH order)
enum { LG_V = 0, LG_W = 1, LG_A = 2, LG_G = 3 };
// the three kernels, as indices of decode_b64_step's launch counts
enum { K_LN = 0, K_GEMM = 1, K_GLUE = 2 };
// the five products of a layer, as indices of decode_b64_step's pieces
enum { P_RKV_LI = 0, P_LO = 1, P_OUT = 2, P_FK = 3, P_FV = 4 };

// ---------------------------------------------------------------------------
// LayerNorm over rows
// ---------------------------------------------------------------------------

constexpr int LN_THREADS = 256;
constexpr int LN_MAX_PER_THREAD = 16;  // C <= 4096

// x (rows, C) f32 -> LayerNorm(x) with f32 statistics.
// NMIX == 0: store the normalized rows in out_f32 (ln0, ln_out).
// NMIX > 0: token-shift mode (ln1, ln2): xx = shift - xn is computed from
// the old shift state, then shift = bf16(xn), and for each of the NMIX
// coefficient rows mix_j (C,) the product's lhs
// xmix[j] = bf16(bf16(xn) + bf16(xx) * mix_j), (rows, C) each.
template <int NMIX>
__global__ void __launch_bounds__(LN_THREADS) ln_rows_kernel(
    int C, float eps, const float* x,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* out_f32, bf16* shift,
    const float* __restrict__ mix, bf16* xmix) {
    __shared__ float red[LN_THREADS / 32];
    const int64_t row = (int64_t)blockIdx.x * C;
    const int64_t plane = (int64_t)gridDim.x * C;
    pdl_wait();
    float v[LN_MAX_PER_THREAD];
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < LN_MAX_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        v[e] = c < C ? __ldcg(x + row + c) : 0.f;
        s += v[e];
    }
    const float mean = block_sum<LN_THREADS / 32>(s, red) / C;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < LN_MAX_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        const float d = c < C ? v[e] - mean : 0.f;
        q = __fadd_rn(q, __fmul_rn(d, d));
    }
    const float rstd = 1.f / sqrtf(block_sum<LN_THREADS / 32>(q, red) / C + eps);
    pdl_trigger();
#pragma unroll
    for (int e = 0; e < LN_MAX_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        if (c >= C) continue;
        const float xn = __fadd_rn(__fmul_rn(__fmul_rn(v[e] - mean, rstd), scale[c]), bias[c]);
        if (NMIX == 0) {
            out_f32[row + c] = xn;
        } else {
            const float xn_b = round_bf16(xn);
            const float xx_b = round_bf16(__bfloat162float(__ldcg(shift + row + c)) - xn);
            shift[row + c] = __float2bfloat16(xn);
#pragma unroll
            for (int j = 0; j < NMIX; ++j)
                xmix[j * plane + row + c] =
                    __float2bfloat16(__fadd_rn(xn_b, __fmul_rn(xx_b, mix[j * C + c])));
        }
    }
}

// ---------------------------------------------------------------------------
// int8-weight product, 64 rows, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int GM = 64;                       // rows (the batch)
constexpr int NT = 128;                      // columns of a CTA's tile
constexpr int GK = 64;                       // K rows of a weight stage
constexpr int RING_MAX = 8;                  // weight stages in flight
constexpr int KP_MAX = 1024;                 // largest K piece (lhs 128 KB)
constexpr int KSPLIT = 2;                    // consumer warps on each 32 columns
constexpr int CONSUMERS = 4 * KSPLIT;        // warp w: columns 32 (w % 4) .., k16 steps w / 4 + 2i
constexpr int G_THREADS = (CONSUMERS + 1) * 32;  // + one producer warp
// a TMA box of 64 rows x 128 bytes with the 128-byte swizzle: a weight
// stage (64 x 128 int8) or 64 columns of the lhs (64 x 64 bf16)
constexpr int BOX = GK * 128;
constexpr int RED_LD = NT + 4;               // floats of a row of the partial tile
constexpr int RED_BYTES = GM * RED_LD * 4;
constexpr int MAX_PIECES = 8;                // portable cluster size

enum { EPI_BF16 = 0, EPI_LORA_ACT = 1, EPI_RELU2 = 2, EPI_F32 = 3, EPI_ADD_F32 = 4 };

// One product of the table: nz slices of [64 x K] x [K x N]; its CTAs are
// (slice, 128-column tile, K piece), the piece fastest.
struct Prob {
    // lhs: a TMA map over (planes, 64 rows, columns) bf16; the tile at
    // column n0 of slice z reads plane a_plane + n0 / a_group (r/k/v, the
    // lora mixes), columns z * a_zk + k
    CUtensorMap amap;
    // weights: a TMA map over (L, K, N) int8; the rows z * w_zk + k of
    // layer w_layer
    CUtensorMap wmap;
    int K, N, nz, epi;
    int ctas;                       // nz * (N / NT) * pieces
    int a_plane, a_group, a_zk, w_layer, w_zk;
    const float* s; int64_t s_z;    // (N,) per-column scale
    void* out; int ldo; int64_t o_z;
};

struct GemmLaunch {
    Prob p[2];
    int nprob, pieces, kp;          // kp = K / pieces, the same for both
};

// dynamic shared memory of a CTA for a K piece of kp rows: slack to align
// the boxes to 1024 bytes (the swizzle's period), the lhs slice, the weight
// ring, the f32 partial tile, the mbarriers
__host__ __device__ constexpr int gemm_smem_bytes(int kp) {
    return 1024 + GM * kp * 2 + (kp / GK < RING_MAX ? kp / GK : RING_MAX) * BOX + RED_BYTES +
           8 * (2 * RING_MAX + 1);
}
static_assert(gemm_smem_bytes(KP_MAX) <= 232448, "shared memory of the largest piece");

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// D += A (16 x 16, row-major fragment) x B (16 x 8, column-major fragment),
// bf16 operands, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte e of two 32-bit words of int8 weights (rows k and k + 1), widened to
// a bf16 pair (row k in the low half). With u = x ^ 0x80 = x + 128, the f32
// with bits 0x4B0000uu is 2^23 + u, so subtracting 2^23 + 128 gives x
// exactly, and an integer of [-128, 127] is exact in bf16.
template <int E>
__device__ __forceinline__ uint32_t widen_pair(uint32_t lo_x, uint32_t hi_x) {
    constexpr uint32_t sel = E | 0x7540;  // byte E, 0x00, 0x00, 0x4B
    const float lo = __int_as_float(__byte_perm(lo_x, 0x4B000000u, sel)) - 8388736.f;
    const float hi = __int_as_float(__byte_perm(hi_x, 0x4B000000u, sel)) - 8388736.f;
    return pack_bf16x2(lo, hi);
}

// the scaled sums of row m, columns n .. n + 3, through the product's
// epilogue; `old` is what an add into the residual adds to
__device__ __forceinline__ void epilogue4(const Prob& p, int z, int m, int n, float4 acc,
                                          float4 old) {
    float v[4] = {acc.x, acc.y, acc.z, acc.w};
    const int64_t o = z * p.o_z + (int64_t)m * p.ldo + n;
    if (p.epi == EPI_F32) {
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) + o) =
            make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
    if (p.epi == EPI_ADD_F32) {
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) + o) =
            make_float4(old.x + v[0], old.y + v[1], old.z + v[2], old.w + v[3]);
        return;
    }
    if (p.epi == EPI_LORA_ACT) {
        const int g = n / LORA_PAD;  // the 4 columns lie in one group
#pragma unroll
        for (int j = 0; j < 4; ++j)
            v[j] = g == LG_W ? tanhf(v[j]) : g == LG_G ? sigmoidf_(v[j]) : v[j];
    } else if (p.epi == EPI_RELU2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float t = fmaxf(round_bf16(v[j]), 0.f);
            v[j] = t * t;
        }
    }
    uint2 packed = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    *reinterpret_cast<uint2*>(reinterpret_cast<bf16*>(p.out) + o) = packed;
}

// PROD, the product's index (P_RKV_LI .. P_FV), only names the
// instantiation, so that a profile tells the products apart.
template <int PROD>
__global__ void __launch_bounds__(G_THREADS) gemm_i8_kernel(const __grid_constant__ GemmLaunch g) {
    extern __shared__ __align__(1024) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int P = g.pieces, KP = g.kp;
    const int piece = blockIdx.x % P;  // the rank in the cluster of the tile's pieces
    int tile = blockIdx.x / P;
    const bool second = g.nprob > 1 && tile >= g.p[0].ctas / P;
    const Prob& p = second ? g.p[1] : g.p[0];
    if (second) tile -= g.p[0].ctas / P;
    const int tiles_n = p.N / NT;
    const int z = tile / tiles_n, n0 = (tile % tiles_n) * NT;
    const int kb = piece * KP;
    const int stages = KP / GK, nring = min(RING_MAX, stages);
    // the scales of this thread's 4 output columns: constant, so fetched now
    const float4 sc = *reinterpret_cast<const float4*>(p.s + z * p.s_z + n0 + (tid & 31) * 4);

    // the boxes start at a multiple of 1024 bytes, where the 128-byte
    // swizzle's pattern starts: 16-byte chunk c of row r lands at c ^ (r % 8)
    unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
    unsigned char* lhs = base;                                     // [stages][BOX]
    unsigned char* ring = base + stages * BOX;                     // [nring][BOX]
    float* red = reinterpret_cast<float*>(ring + nring * BOX);     // [GM][RED_LD]
    uint64_t* bars = reinterpret_cast<uint64_t*>(ring + nring * BOX + RED_BYTES);
    uint64_t* full = bars;                 // [RING_MAX] a weight stage landed
    uint64_t* empty = bars + RING_MAX;     // [RING_MAX] a weight stage consumed
    uint64_t* lhs_bar = bars + 2 * RING_MAX;

    if (tid == 0) {
        for (int i = 0; i < nring; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], CONSUMERS);
        }
        mbar_init(lhs_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == CONSUMERS) {
        // the producer warp; lane 0 issues every copy
        const int w_row = z * p.w_zk + kb;
        auto issue = [&](int st) {
            const int slot = st % nring;
            mbar_expect_tx(&full[slot], BOX);
            tma_load(ring + slot * BOX, &p.wmap, n0, w_row + st * GK, p.w_layer, &full[slot]);
        };
        // the weights depend on no earlier kernel: the first ring fill goes
        // out before the wait for the previous kernel
        if (lane == 0)
            for (int st = 0; st < nring; ++st) issue(st);
        pdl_wait();
        if (lane == 0) {
            mbar_expect_tx(lhs_bar, GM * KP * 2);
            for (int j = 0; j < stages; ++j)
                tma_load(lhs + j * BOX, &p.amap, z * p.a_zk + kb + j * GK, 0,
                         p.a_plane + n0 / p.a_group, lhs_bar);
            for (int st = nring; st < stages; ++st) {
                mbar_wait(&empty[st % nring], (st / nring - 1) & 1);
                issue(st);
            }
        }
        __syncwarp();
    } else {
        pdl_wait();
        const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
        const int q = warp % 4, half = warp / 4;    // column group, k16 steps of a stage
        // acc[mt][e][c]: row 16 mt + gid + 8 (c >> 1), tile column
        // 32 q + 8 tig + 4 (c & 1) + e
        float acc[4][4][4] = {};
        // this thread's 4 weight bytes in a row k of a stage: chunk
        // 2 q + gid / 4, swizzled by k % 8, which is 2 tig or 2 tig + 1
        const int cb = 2 * q + (gid >> 2);
        const int w_off0 = ((cb ^ (2 * tig)) << 4) | ((gid & 3) << 2);
        const int w_off1 = ((cb ^ (2 * tig + 1)) << 4) | ((gid & 3) << 2);
        // this lane's ldmatrix row (lane & 15 of each 16-row tile; its row
        // % 8 is lane & 7) and chunk half
        const int a_row = (lane & 15) * 128, a_half = lane >> 4, a_sw = lane & 7;
        mbar_wait(lhs_bar, 0);
        for (int st = 0; st < stages; ++st) {
            const int slot = st % nring;
            mbar_wait(&full[slot], (st / nring) & 1);
            const unsigned char* wt = ring + slot * BOX + 2 * tig * 128;
            const unsigned char* at = lhs + st * BOX + a_row;
#pragma unroll
            for (int i = 0; i < GK / 16 / KSPLIT; ++i) {
                const int kk = 16 * (KSPLIT * i + half);
                const uint32_t x = 0x80808080u;
                const unsigned char* w = wt + kk * 128;
                const uint32_t u0 = *reinterpret_cast<const uint32_t*>(w + w_off0) ^ x;
                const uint32_t u1 = *reinterpret_cast<const uint32_t*>(w + 128 + w_off1) ^ x;
                const uint32_t u2 = *reinterpret_cast<const uint32_t*>(w + 8 * 128 + w_off0) ^ x;
                const uint32_t u3 = *reinterpret_cast<const uint32_t*>(w + 9 * 128 + w_off1) ^ x;
                const uint32_t b0[4] = {widen_pair<0>(u0, u1), widen_pair<1>(u0, u1),
                                        widen_pair<2>(u0, u1), widen_pair<3>(u0, u1)};
                const uint32_t b1[4] = {widen_pair<0>(u2, u3), widen_pair<1>(u2, u3),
                                        widen_pair<2>(u2, u3), widen_pair<3>(u2, u3)};
                const int a_chunk = (((kk >> 3) + a_half) ^ a_sw) << 4;
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                    uint32_t af[4];
                    ldmatrix_x4(af, at + mt * 16 * 128 + a_chunk);
#pragma unroll
                    for (int e = 0; e < 4; ++e) mma_bf16(acc[mt][e], af, b0[e], b1[e]);
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[slot]);
        }
        pdl_trigger();
        // the partial tile: the second half's sums, then the first half adds
        // its own to them (a fixed order)
        float* mine = red + 32 * q + 8 * tig;
        for (int h = KSPLIT - 1; h >= 0; --h) {
            if (half == h) {
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                    for (int r = 0; r < 2; ++r)
#pragma unroll
                        for (int j = 0; j < 2; ++j) {
                            float4* d = reinterpret_cast<float4*>(
                                mine + (16 * mt + gid + 8 * r) * RED_LD + 4 * j);
                            float4 v = make_float4(acc[mt][0][2 * r + j], acc[mt][1][2 * r + j],
                                                   acc[mt][2][2 * r + j], acc[mt][3][2 * r + j]);
                            if (h < KSPLIT - 1) {
                                const float4 o = *d;
                                v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
                            }
                            *d = v;
                        }
            }
            asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 32) : "memory");
        }
    }
    if (warp == CONSUMERS) pdl_trigger();
    // this thread's rows of the output: m = r0 + tid / 32 + 9 j; an add into
    // the residual reads them now, so that the read overlaps the barriers
    const int rows = GM / P, r0 = piece * rows, c = (tid & 31) * 4;
    constexpr int MAX_ROWS = (GM + G_THREADS / 32 - 1) / (G_THREADS / 32);
    float4 old[MAX_ROWS];
    if (p.epi == EPI_ADD_F32) {
#pragma unroll
        for (int j = 0; j < MAX_ROWS; ++j) {
            const int m = r0 + (tid >> 5) + j * (G_THREADS / 32);
            if (m < r0 + rows)
                old[j] = __ldcg(reinterpret_cast<const float4*>(
                    reinterpret_cast<const float*>(p.out) + z * p.o_z + (int64_t)m * p.ldo + n0 + c));
        }
    }
    __syncthreads();
    if (P > 1) cluster_sync();
    // CTA `piece` sums rows [r0, r0 + rows) over the cluster's partial tiles
    // in rank order, scales and stores them: thread t takes the 4 columns
    // 4 (t % 32) of every ninth row from r0 + t / 32
#pragma unroll
    for (int j = 0; j < MAX_ROWS; ++j) {
        const int m = r0 + (tid >> 5) + j * (G_THREADS / 32);
        if (m >= r0 + rows) break;
        const float* src = &red[m * RED_LD + c];
        float4 sum;
        if (P == 1) {
            sum = *reinterpret_cast<const float4*>(src);
        } else {
            float4 part[MAX_PIECES];  // all loads in flight, then the sum in order
#pragma unroll
            for (int q = 0; q < MAX_PIECES; ++q)
                if (q < P) part[q] = ld_cluster_f4(src, q);
            sum = part[0];
#pragma unroll
            for (int q = 1; q < MAX_PIECES; ++q)
                if (q < P) {
                    sum.x += part[q].x; sum.y += part[q].y;
                    sum.z += part[q].z; sum.w += part[q].w;
                }
        }
        epilogue4(p, z, m, n0 + c,
                  make_float4(sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w), old[j]);
    }
    if (P > 1) cluster_sync();  // no CTA leaves while another reads its tile
}

// ---------------------------------------------------------------------------
// Per-(row, head) glue: prep, WKV update, GroupNorm, bonus, gate
// ---------------------------------------------------------------------------

__device__ __forceinline__ float softplus_(float z) {
    // the TPU kernel's exp/log form (ops/decode_mega.py::_softplus)
    return fmaxf(z, 0.f) + logf(1.f + expf(-fabsf(z)));
}

// One CTA of GLUE_WARPS warps per (row b, head h), kernel 7's layout
// (csrc/wkv7_step.cu): warp w steps state rows 16w .. 16w + 15 (the value
// dim) and lane l holds key columns 2l, 2l + 1 of each, so a warp reads a
// state row as one coalesced 128-byte line, all 16 rows in flight before
// the first is used, and the row sums are warp shuffles. Before that,
// threads 0 .. 63 do the prep of the head's 64 channels (one each) into
// shared memory; after it, the same threads do GroupNorm, bonus and gate.
constexpr int GLUE_WARPS = 4;
constexpr int GLUE_ROWS = NH / GLUE_WARPS;  // state rows a warp

__global__ void __launch_bounds__(GLUE_WARPS * 32) glue_kernel(
    int C, int H, float ln_x_eps, int is_first,
    const bf16* acc_rkv,                // (64, 3C): r, k, v
    const float* lo_out,                // (4, 64, C): lora-out in LG order
    bf16* v_first,                      // (64, C)
    const float* __restrict__ sm,       // (NS, C) this layer's smalls
    bf16* wkv,                          // (64, H, 64, 64) this layer, in place
    bf16* y_g) {                        // (64, C)
    __shared__ float red[GLUE_WARPS];
    // key-indexed: decay, z = -kk_n, b = kk_n a, k_eff, r; value-indexed v
    __shared__ __align__(8) float swd[NH], sz[NH], sbb[NH], sk[NH], sr[NH], sv[NH], sy[NH];
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t BC = (int64_t)gridDim.x / H * C;  // 64 * C

    // the state block's rows, loaded first and before the wait for the
    // previous kernel: it was last written by this layer's glue of the
    // previous step, which every kernel since waited for. The loads bypass
    // L1 (ld.global.cg): before the wait, an L1 line of this SM may still
    // hold the block as an earlier step left it.
    unsigned* blk = reinterpret_cast<unsigned*>(wkv + ((int64_t)b * H + h) * NH * NH) +
                    warp * GLUE_ROWS * (NH / 2) + lane;
    unsigned raw[GLUE_ROWS];
#pragma unroll
    for (int i = 0; i < GLUE_ROWS; ++i) raw[i] = __ldcg(blk + i * (NH / 2));
    pdl_wait();

    // prep: thread i < 64 takes channel c = h * 64 + i
    const int i = tid;
    const bool chan = i < NH;
    const int c = h * NH + (chan ? i : 0);
    const int64_t bc = (int64_t)b * C + c;
    float r = 0.f, k_eff = 0.f, kk = 0.f, a_s = 0.f, v_s = 0.f, g_s = 0.f;
    if (chan) {
        r = __bfloat162float(__ldcg(acc_rkv + (int64_t)b * 3 * C + c));
        const float k0 = __bfloat162float(__ldcg(acc_rkv + (int64_t)b * 3 * C + C + c));
        const float v_row = __bfloat162float(__ldcg(acc_rkv + (int64_t)b * 3 * C + 2 * C + c));
        const float w_raw =
            -softplus_(-(sm[SM_W0 * C + c] + __ldcg(lo_out + LG_W * BC + bc))) - 0.5f;
        swd[i] = round_bf16(expf(-expf(w_raw)));
        const float a_row = sigmoidf_(sm[SM_A0 * C + c] + __ldcg(lo_out + LG_A * BC + bc));
        a_s = round_bf16(a_row);
        float v_eff;
        if (is_first) {
            v_eff = v_row;
            v_first[bc] = __float2bfloat16(v_eff);
        } else {
            const float vmix = sigmoidf_(sm[SM_V0 * C + c] + __ldcg(lo_out + LG_V * BC + bc));
            v_eff = __fadd_rn(v_row,
                              __fmul_rn(__bfloat162float(__ldcg(v_first + bc)) - v_row, vmix));
        }
        v_s = round_bf16(v_eff);
        g_s = round_bf16(__ldcg(lo_out + LG_G * BC + bc));
        kk = round_bf16(k0 * sm[SM_K_K * C + c]);
        k_eff = round_bf16(k0 * __fadd_rn(1.f, __fmul_rn(a_row - 1.f, sm[SM_K_A * C + c])));
    }
    pdl_trigger();
    // l2-normalize kk over the head (eps^2 = 1e-24 clamped before the sqrt)
    const float nrm = sqrtf(fmaxf(block_sum<GLUE_WARPS>(__fmul_rn(kk, kk), red), 1e-24f));
    // bonus (sum_j r k_eff r_k), used after the update
    const float s_bh = block_sum<GLUE_WARPS>(chan ? r * k_eff * sm[SM_R_K * C + c] : 0.f, red);
    if (chan) {
        const float kkn = kk * (1.f / nrm);
        sz[i] = -kkn;
        sbb[i] = kkn * a_s;
        sk[i] = k_eff;
        sr[i] = r;
        sv[i] = v_s;
    }
    __syncthreads();

    // the update, in f32: S w + sa b + v k with each product and sum
    // rounded as the plain version's separate tensor ops; y from the f32 S
    const int j0 = 2 * lane;
    const float2 wd = *reinterpret_cast<const float2*>(&swd[j0]);
    const float2 zv = *reinterpret_cast<const float2*>(&sz[j0]);
    const float2 bv = *reinterpret_cast<const float2*>(&sbb[j0]);
    const float2 kv = *reinterpret_cast<const float2*>(&sk[j0]);
    const float2 rv = *reinterpret_cast<const float2*>(&sr[j0]);
    float y_mine = 0.f;
#pragma unroll
    for (int q = 0; q < GLUE_ROWS; ++q) {
        const float2 S = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[q]));
        const float sa = warp_sum(fmaf(S.x, zv.x, S.y * zv.y));
        const float vi = sv[warp * GLUE_ROWS + q];
        const float n0 = __fadd_rn(__fadd_rn(__fmul_rn(S.x, wd.x), __fmul_rn(sa, bv.x)),
                                   __fmul_rn(vi, kv.x));
        const float n1 = __fadd_rn(__fadd_rn(__fmul_rn(S.y, wd.y), __fmul_rn(sa, bv.y)),
                                   __fmul_rn(vi, kv.y));
        __nv_bfloat162 o = __floats2bfloat162_rn(n0, n1);
        blk[q * (NH / 2)] = *reinterpret_cast<unsigned*>(&o);
        const float yq = warp_sum(fmaf(n0, rv.x, n1 * rv.y));
        if (lane == q) y_mine = yq;
    }
    if (lane < GLUE_ROWS) sy[warp * GLUE_ROWS + lane] = y_mine;
    __syncthreads();

    // GroupNorm over the head's 64 outputs, then the bonus and the gate
    const float y = chan ? sy[i] : 0.f;
    const float mean = block_sum<GLUE_WARPS>(y, red) / NH;
    const float d = chan ? y - mean : 0.f;
    const float var = block_sum<GLUE_WARPS>(__fmul_rn(d, d), red) / NH;
    if (chan) {
        const float y_n = __fadd_rn(
            __fmul_rn(__fmul_rn(d, 1.f / sqrtf(var + ln_x_eps)), sm[SM_LN_X_S * C + c]),
            sm[SM_LN_X_B * C + c]);
        y_g[bc] = __float2bfloat16(__fmul_rn(__fadd_rn(y_n, __fmul_rn(s_bh, v_s)), g_s));
    }
}

// ---------------------------------------------------------------------------
// Workspace (activations carried between launches)
// ---------------------------------------------------------------------------

struct Workspace {
    float* x_res;    // (64, C) f32 residual
    bf16* xmix;      // (6, 64, C) product lhs: mixes r, k, v, w, a, g (ffn: row 0)
    bf16* acc_rkv;   // (64, 3C)
    bf16* lora_act;  // (64, 4 * 128) activated lora-in outputs
    float* lo_out;   // (4, 64, C) lora-out outputs
    bf16* v_first;   // (64, C)
    bf16* y_g;       // (64, C)
    bf16* acc_ffn;   // (64, 4C)
};

size_t carve(void* base, int C, Workspace* ws) {
    char* p = static_cast<char*>(base);
    size_t off = 0;
    auto take = [&](size_t bytes) {
        char* q = p ? p + off : nullptr;
        off += (bytes + 255) & ~size_t(255);
        return q;
    };
    const size_t rows = GM;
    Workspace w;
    w.x_res = (float*)take(rows * C * 4);
    w.xmix = (bf16*)take(6 * rows * C * 2);
    w.acc_rkv = (bf16*)take(rows * 3 * C * 2);
    w.lora_act = (bf16*)take(rows * 4 * LORA_PAD * 2);
    w.lo_out = (float*)take(4 * rows * C * 4);
    w.v_first = (bf16*)take(rows * C * 2);
    w.y_g = (bf16*)take(rows * C * 2);
    w.acc_ffn = (bf16*)take(rows * 4 * C * 2);
    if (ws) *ws = w;
    return off;
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// A product of the table: K is cut into `pieces` of K / pieces rows.
Prob prob(int K, int N, int nz, int epi, int pieces, const CUtensorMap& amap, int a_plane,
          int a_group, int a_zk, const CUtensorMap& wmap, int w_layer, int w_zk,
          const float* s, int64_t s_z, void* out, int ldo, int64_t o_z) {
    Prob p;
    p.amap = amap;
    p.wmap = wmap;
    p.K = K; p.N = N; p.nz = nz; p.epi = epi; p.ctas = nz * (N / NT) * pieces;
    p.a_plane = a_plane; p.a_group = a_group; p.a_zk = a_zk;
    p.w_layer = w_layer; p.w_zk = w_zk;
    p.s = s; p.s_z = s_z; p.out = out; p.ldo = ldo; p.o_z = o_z;
    return p;
}

template <int PROD>
int gemm(const Prob& p0, const Prob* p1, int pieces, bool pdl, cudaStream_t stream) {
    GemmLaunch g = {};
    g.p[0] = p0;
    g.nprob = p1 ? 2 : 1;
    if (p1) g.p[1] = *p1;
    g.pieces = pieces;
    g.kp = p0.K / pieces;
    if (pieces < 1 || pieces > MAX_PIECES || (pieces & (pieces - 1)) || g.kp % GK ||
        g.kp > KP_MAX)
        return (int)cudaErrorInvalidValue;
    int ctas = 0;
    for (int i = 0; i < g.nprob; ++i) {
        const Prob& p = g.p[i];
        if (p.K != g.kp * pieces || p.N % NT || p.a_group % NT)
            return (int)cudaErrorInvalidValue;
        ctas += p.ctas;
    }
    // the largest piece's dynamic shared memory, allowed once per device
    cudaError_t e = allow_smem<gemm_i8_kernel<PROD>>(gemm_smem_bytes(KP_MAX));
    if (e != cudaSuccess) return (int)e;
    return (int)launch(gemm_i8_kernel<PROD>, ctas, G_THREADS, gemm_smem_bytes(g.kp), pieces, pdl,
                       stream, g);
}

}  // namespace

extern "C" size_t decode_b64_workspace_bytes(int C) { return carve(nullptr, C, nullptr); }

// Dynamic shared memory of a product CTA for a K piece of kp rows (the
// wrapper's launch plan checks it against the card's 227 KB).
extern "C" int decode_b64_gemm_smem_bytes(int kp) { return gemm_smem_bytes(kp); }

// One decode step. x (64, C) f32 token embeddings (pre-ln0); h_out (64, C)
// f32 (post ln_out). Packed weights as built by
// rwkvtts_torch/ops/decode_mega_b64.py::pack_mega_b64, each (L, ...)
// contiguous. att_x/ffn_x (L, 64, C) bf16 and wkv (L, 64, H, 64, 64) bf16
// are updated in place. pieces[P_RKV_LI .. P_FV] is the number of K pieces
// of each product (the wrapper's launch plan); pdl = 0 launches the chain
// without programmatic dependent launch. counts[K_LN], counts[K_GEMM],
// counts[K_GLUE] are increased by the launches of each kernel. Returns the
// first CUDA launch error (0 on success).
extern "C" int decode_b64_step(
    int L, int C, int B, float norm_eps, float ln_x_eps,
    const float* x, float* h_out, const float* ln0_s, const float* ln0_b,
    const float* lnout_s, const float* lnout_b,
    const int8_t* rkv_q, const float* rkv_s, const int8_t* li_q, const float* li_s,
    const int8_t* lo_q, const float* lo_s, const int8_t* out_q, const float* out_s,
    const int8_t* fk_q, const float* fk_s, const int8_t* fv_q, const float* fv_s,
    const float* smalls, bf16* att_x, bf16* ffn_x, bf16* wkv, void* workspace,
    const int* pieces, int pdl, int* counts, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (B != GM || C % NT || C > LN_THREADS * LN_MAX_PER_THREAD)
        return (int)cudaErrorInvalidValue;
    const int H = C / NH;
    Workspace ws;
    carve(workspace, C, &ws);
    const int64_t BC = (int64_t)GM * C;
    const int LI = 4 * LORA_PAD;
    int err;
#define LAUNCH(kind, call)                             \
    do {                                               \
        if ((err = (int)(call))) return err;           \
        ++counts[kind];                                \
    } while (0)

    // TMA maps: each weight array over (L, K, N), the lhs buffers over
    // (planes, 64, columns)
    CUtensorMap m_rkv, m_li, m_lo, m_out, m_fk, m_fv, m_xmix, m_lora, m_yg, m_ffn;
    if ((err = tensor_map(&m_rkv, rkv_q, 1, 3 * C, C, L, 128, GK, true)) ||
        (err = tensor_map(&m_li, li_q, 1, LI, C, L, 128, GK, true)) ||
        (err = tensor_map(&m_lo, lo_q, 1, C, LI, L, 128, GK, true)) ||
        (err = tensor_map(&m_out, out_q, 1, C, C, L, 128, GK, true)) ||
        (err = tensor_map(&m_fk, fk_q, 1, 4 * C, C, L, 128, GK, true)) ||
        (err = tensor_map(&m_fv, fv_q, 1, C, 4 * C, L, 128, GK, true)) ||
        (err = tensor_map(&m_xmix, ws.xmix, 2, C, GM, 6, 128, GK, true)) ||
        (err = tensor_map(&m_lora, ws.lora_act, 2, LI, GM, 1, 128, GK, true)) ||
        (err = tensor_map(&m_yg, ws.y_g, 2, C, GM, 1, 128, GK, true)) ||
        (err = tensor_map(&m_ffn, ws.acc_ffn, 2, 4 * C, GM, 1, 128, GK, true)))
        return err;

    LAUNCH(K_LN, launch(ln_rows_kernel<0>, GM, LN_THREADS, 0, 1, pdl, st, C, norm_eps, x, ln0_s,
                        ln0_b, ws.x_res, (bf16*)nullptr, (const float*)nullptr, (bf16*)nullptr));
    for (int l = 0; l < L; ++l) {
        const float* sm = smalls + (int64_t)l * NS * C;
        // ln1, the token shift and the six mixes r, k, v, w, a, g (rows
        // SM_X_R .. SM_X_G are adjacent in that order)
        LAUNCH(K_LN, launch(ln_rows_kernel<6>, GM, LN_THREADS, 0, 1, pdl, st, C, norm_eps,
                            (const float*)ws.x_res, sm + SM_LN1_S * C, sm + SM_LN1_B * C,
                            (float*)nullptr, att_x + l * BC, sm + SM_X_R * C, ws.xmix));

        // r, k, v against [W_r | W_k | W_v] (lhs planes r, k, v), and
        // lora-in, groups (v, w, a, g) of 128 columns (lhs planes v, w, a,
        // g), in one launch
        const int pr = pieces[P_RKV_LI];
        const Prob rkv = prob(C, 3 * C, 1, EPI_BF16, pr, m_xmix, 0, C, 0, m_rkv, l, 0,
                              rkv_s + (int64_t)l * 3 * C, 0, ws.acc_rkv, 3 * C, 0);
        const Prob li = prob(C, LI, 1, EPI_LORA_ACT, pr, m_xmix, 2, LORA_PAD, 0, m_li, l, 0,
                             li_s + (int64_t)l * LI, 0, ws.lora_act, LI, 0);
        LAUNCH(K_GEMM, gemm<P_RKV_LI>(rkv, &li, pr, pdl, st));
        // lora-out: 4 groups of (64 x 128) @ (128 x C)
        LAUNCH(K_GEMM, gemm<P_LO>(prob(LORA_PAD, C, 4, EPI_F32, pieces[P_LO], m_lora, 0, C,
                                       LORA_PAD, m_lo, l, LORA_PAD, lo_s + (int64_t)l * 4 * C, C,
                                       ws.lo_out, C, BC),
                                  nullptr, pieces[P_LO], pdl, st));

        LAUNCH(K_GLUE, launch(glue_kernel, GM * H, GLUE_WARPS * 32, 0, 1, pdl, st, C, H, ln_x_eps, (int)(l == 0),
                              (const bf16*)ws.acc_rkv, (const float*)ws.lo_out, ws.v_first, sm,
                              wkv + (int64_t)l * GM * H * NH * NH, ws.y_g));

        // output projection, added into the residual
        LAUNCH(K_GEMM, gemm<P_OUT>(prob(C, C, 1, EPI_ADD_F32, pieces[P_OUT], m_yg, 0, C, 0, m_out,
                                        l, 0, out_s + (int64_t)l * C, 0, ws.x_res, C, 0),
                                   nullptr, pieces[P_OUT], pdl, st));

        // ln2, the token shift and the FFN mix
        LAUNCH(K_LN, launch(ln_rows_kernel<1>, GM, LN_THREADS, 0, 1, pdl, st, C, norm_eps,
                            (const float*)ws.x_res, sm + SM_LN2_S * C, sm + SM_LN2_B * C,
                            (float*)nullptr, ffn_x + l * BC, sm + SM_FFN_X_K * C, ws.xmix));
        // FFN key with relu^2, then FFN value into the residual
        LAUNCH(K_GEMM, gemm<P_FK>(prob(C, 4 * C, 1, EPI_RELU2, pieces[P_FK], m_xmix, 0, 4 * C, 0,
                                       m_fk, l, 0, fk_s + (int64_t)l * 4 * C, 0, ws.acc_ffn,
                                       4 * C, 0),
                                  nullptr, pieces[P_FK], pdl, st));
        LAUNCH(K_GEMM, gemm<P_FV>(prob(4 * C, C, 1, EPI_ADD_F32, pieces[P_FV], m_ffn, 0, C, 0,
                                       m_fv, l, 0, fv_s + (int64_t)l * C, 0, ws.x_res, C, 0),
                                  nullptr, pieces[P_FV], pdl, st));
    }
    LAUNCH(K_LN, launch(ln_rows_kernel<0>, GM, LN_THREADS, 0, 1, pdl, st, C, norm_eps,
                        (const float*)ws.x_res, lnout_s, lnout_b, h_out, (bf16*)nullptr,
                        (const float*)nullptr, (bf16*)nullptr));
#undef LAUNCH
    return 0;
}
