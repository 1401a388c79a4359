// One RWKV-7 decode step for a batch of 64 rows, all layers.
//
// Replaces: rwkvtts_tpu/ops/decode_mega_b64.py::_mega_b64_kernel (reached
// through decode_step_mega_b64). Same arithmetic and the same rounding
// points: bf16 at acc_rkv, acc_ffn, the wd/a/g/kk rows, the xn/xx shift
// inputs, v_first, y_g, the shift states and the WKV state; f32 for the
// residual x_res and the lora-in outputs.
//
// What bounds it on this card, reckoned from shapes at C = 1024, L = 24,
// B = 64: the int8 weights are 24 x (3C^2 + 4C.128 + 128.4C + C^2 + 8C^2)
// bytes = 0.33 GB, read once per step, and the bf16 WKV state is
// 24 x 64 x 16 x 64 x 64 x 2 bytes = 0.20 GB, read and written once per
// step: ~0.73 GB, or 0.22 ms at 3.35 TB/s. The products do
// 2 x 64 x 0.33 G = 42 GFLOP: 0.04 ms on the tensor cores at 989 TFLOP/s in
// bf16, but 0.63 ms on the CUDA cores' 67 TFLOP/s of f32 FMA. So the
// products run on the tensor cores (mma.sync, bf16 in, f32 accumulate), and
// the step is bound by the bytes; the short per-layer launch chain and the
// few CTAs of the narrow products keep this first version well above that.
//
// Design. The TPU grid (L, T) carries scratch from one grid step to the
// next; CUDA blocks cannot, so the step is a short sequence of launches
// per layer on one stream, and the activations that the TPU kept in VMEM
// live in one device workspace between launches:
//   ln_rows    LayerNorm of the 64 residual rows; for ln1/ln2 it also
//              steps the token-shift state and writes the bf16 token-shift
//              mixes that are the products' lhs (6 for time mix, 1 for FFN);
//   gemm_i8    [64 x K] bf16 x [K x N] int8 -> f32 accumulate on the tensor
//              cores, times the per-column scale on the output (int8 is
//              exact in bf16, so this is the TPU kernel's dequant-free
//              product); a cp.async ring of 4 stages feeds it; column groups
//              may read different lhs planes (r/k/v, the four lora mixes);
//              the epilogue stores bf16, applies the lora activations or
//              relu^2, stores f32, or adds into the f32 residual (split K);
//   glue       one CTA of 64 threads per (row b, head h): the prep
//              elementwise work for its 64 channels, the WKV state update in
//              place (thread i keeps state row i in registers), GroupNorm,
//              the bonus term and the gate.
// Per layer: 2 ln_rows + 6 gemm_i8 + 1 glue = 9 launches; per step
// 9 L + 2. CUDA graphs, a persistent kernel, wgmma and TMA are later work.
#include "common.cuh"

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
    int C, float eps, const float* __restrict__ x,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out_f32, bf16* __restrict__ shift,
    const float* __restrict__ mix, bf16* __restrict__ xmix) {
    __shared__ float red[LN_THREADS / 32];
    const int64_t row = (int64_t)blockIdx.x * C;
    const int64_t plane = (int64_t)gridDim.x * C;
    float v[LN_MAX_PER_THREAD];
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < LN_MAX_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        v[e] = c < C ? x[row + c] : 0.f;
        s += v[e];
    }
    const float mean = block_sum<LN_THREADS / 32>(s, red) / C;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < LN_MAX_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        const float d = c < C ? v[e] - mean : 0.f;
        q += d * d;
    }
    const float rstd = rsqrtf(block_sum<LN_THREADS / 32>(q, red) / C + eps);
#pragma unroll
    for (int e = 0; e < LN_MAX_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        if (c >= C) continue;
        const float xn = (v[e] - mean) * rstd * scale[c] + bias[c];
        if (NMIX == 0) {
            out_f32[row + c] = xn;
        } else {
            const float xn_b = round_bf16(xn);
            const float xx_b = round_bf16(__bfloat162float(shift[row + c]) - xn);
            shift[row + c] = __float2bfloat16(xn);
#pragma unroll
            for (int j = 0; j < NMIX; ++j)
                xmix[j * plane + row + c] = __float2bfloat16(xn_b + xx_b * mix[j * C + c]);
        }
    }
}

// ---------------------------------------------------------------------------
// int8-weight product, 64 rows, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int GM = 64;          // rows (the batch)
constexpr int GN = 32;          // columns per CTA
constexpr int GK = 64;          // K per stage
constexpr int G_STAGES = 4;     // stages in the cp.async ring
constexpr int G_THREADS = 128;  // 4 warps; warp w owns rows 16w .. 16w + 15
constexpr int G_LD = GK + 8;    // shared row stride (bf16): fragment reads hit 32 banks
// per thread and stage: 16-byte lhs chunks and weight chunks it copies, and
// (k pair, 8 columns) weight items it widens
constexpr int A_CHUNKS = GM * GK / 8 / G_THREADS;
constexpr int W_CHUNKS = GK * GN / 16 / G_THREADS;
constexpr int W_PAIRS = GK / 2 * (GN / 8) / G_THREADS;
static_assert(A_CHUNKS * G_THREADS * 8 == GM * GK && W_CHUNKS * G_THREADS * 16 == GK * GN &&
              W_PAIRS * G_THREADS * 16 == GK * GN, "tile and thread counts");

enum { EPI_BF16 = 0, EPI_LORA_ACT = 1, EPI_RELU2 = 2, EPI_F32 = 3, EPI_ADD_F32 = 4 };

struct GemmArgs {
    int K, N, k_split;  // blockIdx.y takes K rows [y * k_split, (y + 1) * k_split)
    // lhs rows: a + z * a_z + (n0 / a_group) * a_gz + m * lda + k, so column
    // groups of a_group may read different lhs planes (r/k/v, the lora mixes)
    const bf16* a; int lda; int64_t a_z; int a_group; int64_t a_gz;
    const int8_t* w; int64_t w_z;   // (K, N) row-major
    const float* s; int64_t s_z;    // (N,) per-column scale
    void* out; int ldo; int64_t o_z;
};

struct GemmSmem {
    bf16 a[G_STAGES][GM][G_LD];     // lhs stages, [m][k]
    int8_t w8[G_STAGES][GK][GN];    // weight stages as loaded, [k][n]
    bf16 w[GN][G_LD];               // the current stage widened, [n][k]
};

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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

// [64 x K] bf16 x [K x N] int8 -> f32, times the per-column scale. A ring of
// G_STAGES stages is filled by cp.async (lhs tile and raw int8 weight tile);
// each stage's weights are widened to bf16 (exact) and transposed to [n][k]
// in shared memory, so that a B fragment is one 32-bit read.
template <int EPI>
__global__ void __launch_bounds__(G_THREADS) gemm_i8_kernel(GemmArgs p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    GemmSmem& sm = *reinterpret_cast<GemmSmem*>(smem_raw);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
    const int n0 = blockIdx.x * GN;
    const int z = blockIdx.z;
    const int kb = blockIdx.y * p.k_split;
    const int stages = (min(p.K, kb + p.k_split) - kb) / GK;
    const int8_t* w = p.w + z * p.w_z + n0;
    const bf16* a = p.a + z * p.a_z + (int64_t)(n0 / p.a_group) * p.a_gz;

    auto fetch = [&](int st) {
        if (st < stages) {
            const int slot = st % G_STAGES, k0 = kb + st * GK;
#pragma unroll
            for (int i = 0; i < A_CHUNKS; ++i) {
                const int idx = tid + i * G_THREADS;
                const int m = idx / (GK / 8), kc = idx % (GK / 8) * 8;
                cp_async16(&sm.a[slot][m][kc], a + (int64_t)m * p.lda + k0 + kc);
            }
#pragma unroll
            for (int i = 0; i < W_CHUNKS; ++i) {
                const int idx = tid + i * G_THREADS;
                const int k = idx / (GN / 16), nc = idx % (GN / 16) * 16;
                cp_async16(&sm.w8[slot][k][nc], w + (int64_t)(k0 + k) * p.N + nc);
            }
        }
        cp_async_commit();  // an empty group keeps the wait count uniform
    };

    float acc[GN / 8][4] = {};
    const int r0 = warp * 16 + gid;
#pragma unroll
    for (int st = 0; st < G_STAGES - 1; ++st) fetch(st);
    for (int st = 0; st < stages; ++st) {
        cp_async_wait<G_STAGES - 2>();  // this thread's copies of stage st landed
        __syncthreads();                // everyone's; stage st - 1 fully consumed
        fetch(st + G_STAGES - 1);       // refills the slot of stage st - 1
        const int slot = st % G_STAGES;
#pragma unroll
        for (int i = 0; i < W_PAIRS; ++i) {  // k rows 2 kp, 2 kp + 1; columns nq .. nq + 7
            const int idx = tid + i * G_THREADS;
            const int kp = idx / (GN / 8), nq = idx % (GN / 8) * 8;
            const int2 u0 = *reinterpret_cast<const int2*>(&sm.w8[slot][2 * kp][nq]);
            const int2 u1 = *reinterpret_cast<const int2*>(&sm.w8[slot][2 * kp + 1][nq]);
            const int8_t* w0 = reinterpret_cast<const int8_t*>(&u0);
            const int8_t* w1 = reinterpret_cast<const int8_t*>(&u1);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                *reinterpret_cast<uint32_t*>(&sm.w[nq + e][2 * kp]) =
                    pack_bf16x2((float)w0[e], (float)w1[e]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GK; kk += 16) {
            const int c = kk + tig * 2;
            uint32_t af[4];
            af[0] = *reinterpret_cast<const uint32_t*>(&sm.a[slot][r0][c]);
            af[1] = *reinterpret_cast<const uint32_t*>(&sm.a[slot][r0 + 8][c]);
            af[2] = *reinterpret_cast<const uint32_t*>(&sm.a[slot][r0][c + 8]);
            af[3] = *reinterpret_cast<const uint32_t*>(&sm.a[slot][r0 + 8][c + 8]);
#pragma unroll
            for (int nt = 0; nt < GN / 8; ++nt) {
                const bf16* wr = &sm.w[nt * 8 + gid][c];
                mma_bf16(acc[nt], af, *reinterpret_cast<const uint32_t*>(wr),
                         *reinterpret_cast<const uint32_t*>(wr + 8));
            }
        }
    }
    cp_async_wait<0>();

    // accumulator (nt, 2 h + j) is row r0 + 8 h, column n0 + 8 nt + 2 tig + j
    const float* s = p.s + z * p.s_z;
#pragma unroll
    for (int nt = 0; nt < GN / 8; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = r0 + 8 * h;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int n = n0 + nt * 8 + tig * 2 + j;
                float val = acc[nt][2 * h + j] * s[n];
                const int64_t o = z * p.o_z + (int64_t)m * p.ldo + n;
                if (EPI == EPI_BF16) {
                    reinterpret_cast<bf16*>(p.out)[o] = __float2bfloat16(val);
                } else if (EPI == EPI_LORA_ACT) {
                    const int g = n / LORA_PAD;
                    if (g == LG_W) val = tanhf(val);
                    else if (g == LG_G) val = sigmoidf_(val);
                    reinterpret_cast<bf16*>(p.out)[o] = __float2bfloat16(val);
                } else if (EPI == EPI_RELU2) {
                    const float t = fmaxf(round_bf16(val), 0.f);
                    reinterpret_cast<bf16*>(p.out)[o] = __float2bfloat16(t * t);
                } else if (EPI == EPI_F32) {
                    reinterpret_cast<float*>(p.out)[o] = val;
                } else {
                    atomicAdd(reinterpret_cast<float*>(p.out) + o, val);
                }
            }
        }
    }
}

// K is split into pieces of k_split rows (a multiple of GK), one per
// blockIdx.y; only EPI_ADD_F32 may take more than one piece.
template <int EPI>
int gemm(const GemmArgs& p, int nz, cudaStream_t stream) {
    if (p.N % GN || p.K % GK || p.k_split % GK || p.k_split <= 0 || p.a_group % GN)
        return (int)cudaErrorInvalidValue;
    const int pieces = (p.K + p.k_split - 1) / p.k_split;
    if (EPI != EPI_ADD_F32 && pieces != 1) return (int)cudaErrorInvalidValue;
    const int bytes = (int)sizeof(GemmSmem);  // above the 48 KB static limit
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_i8_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(p.N / GN, pieces, nz);
    RWKV_TRY(gemm_i8_kernel<EPI><<<grid, G_THREADS, bytes, stream>>>(p));
    return 0;
}

// k_split that cuts K into about `pieces` multiples of GK
int split_k(int K, int pieces) {
    const int q = K / GK / pieces;
    return GK * (q > 1 ? q : 1);
}

// ---------------------------------------------------------------------------
// Per-(row, head) glue: prep, WKV update, GroupNorm, bonus, gate
// ---------------------------------------------------------------------------

__device__ __forceinline__ float softplus_(float z) {
    // the TPU kernel's exp/log form (ops/decode_mega.py::_softplus)
    return fmaxf(z, 0.f) + logf(1.f + expf(-fabsf(z)));
}

__global__ void __launch_bounds__(NH) glue_kernel(
    int C, int H, float ln_x_eps, int is_first,
    const bf16* __restrict__ acc_rkv,   // (64, 3C): r, k, v
    const float* __restrict__ lo_out,   // (4, 64, C): lora-out in LG order
    bf16* __restrict__ v_first,         // (64, C)
    const float* __restrict__ sm,       // (NS, C) this layer's smalls
    bf16* __restrict__ wkv,             // (64, H, 64, 64) this layer, in place
    bf16* __restrict__ y_g) {           // (64, C)
    __shared__ float red[2];
    __shared__ float sz[NH], sbb[NH], sr[NH], swd[NH], sk[NH];
    __shared__ __align__(16) bf16 blk_s[NH][NH + 8];  // the (b, h) state, padded rows
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int i = threadIdx.x;
    const int c = h * NH + i;
    const int64_t bc = (int64_t)b * C + c;
    const int64_t BC = (int64_t)gridDim.x / H * C;  // 64 * C

    // the (b, h) state block (64 x 64 bf16, contiguous) is loaded first, so
    // that its latency overlaps the prep below: chunk q * 64 + i is 16 B of
    // row (q * 64 + i) / 8, so neighbouring threads read neighbouring chunks
    uint4* blk = reinterpret_cast<uint4*>(wkv + ((int64_t)b * H + h) * NH * NH);
    uint4 raw[NH / 8];
#pragma unroll
    for (int q = 0; q < NH / 8; ++q) raw[q] = blk[q * NH + i];

    const float r = __bfloat162float(acc_rkv[(int64_t)b * 3 * C + c]);
    const float k0 = __bfloat162float(acc_rkv[(int64_t)b * 3 * C + C + c]);
    const float v_row = __bfloat162float(acc_rkv[(int64_t)b * 3 * C + 2 * C + c]);

    const float w_raw = -softplus_(-(sm[SM_W0 * C + c] + lo_out[LG_W * BC + bc])) - 0.5f;
    const float wd = round_bf16(expf(-expf(w_raw)));
    const float a_row = sigmoidf_(sm[SM_A0 * C + c] + lo_out[LG_A * BC + bc]);
    const float a_s = round_bf16(a_row);
    float v_eff;
    if (is_first) {
        v_eff = v_row;
        v_first[bc] = __float2bfloat16(v_eff);
    } else {
        const float vmix = sigmoidf_(sm[SM_V0 * C + c] + lo_out[LG_V * BC + bc]);
        v_eff = v_row + (__bfloat162float(v_first[bc]) - v_row) * vmix;
    }
    const float v_s = round_bf16(v_eff);
    const float g_s = round_bf16(lo_out[LG_G * BC + bc]);
    const float kk = round_bf16(k0 * sm[SM_K_K * C + c]);
    const float k_eff = round_bf16(k0 * (1.f + (a_row - 1.f) * sm[SM_K_A * C + c]));

    // l2-normalize kk over the head (eps^2 = 1e-24 clamped before the sqrt)
    const float nrm = sqrtf(fmaxf(block_sum<2>(kk * kk, red), 1e-24f));
    const float kkn = kk * (1.f / nrm);
    sz[i] = -kkn;
    sbb[i] = kkn * a_s;
    sr[i] = r;
    swd[i] = wd;
    sk[i] = k_eff;
#pragma unroll
    for (int q = 0; q < NH / 8; ++q) {
        const int chunk = q * NH + i;
        *reinterpret_cast<uint4*>(&blk_s[chunk >> 3][(chunk & 7) * 8]) = raw[q];
    }
    __syncthreads();

    // thread i steps state row i (value dim; 64 key-dim columns) in f32
    float S[NH];
#pragma unroll
    for (int q = 0; q < NH / 8; ++q)
        unpack8(*reinterpret_cast<const uint4*>(&blk_s[i][8 * q]), S + 8 * q);
    float sa = 0.f;
#pragma unroll
    for (int j = 0; j < NH; ++j) sa = fmaf(S[j], sz[j], sa);
    float y = 0.f;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
        S[j] = fmaf(S[j], swd[j], fmaf(sa, sbb[j], v_s * sk[j]));
        y = fmaf(S[j], sr[j], y);
    }
#pragma unroll
    for (int q = 0; q < NH / 8; ++q)
        *reinterpret_cast<uint4*>(&blk_s[i][8 * q]) = pack8(S + 8 * q);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NH / 8; ++q) {
        const int chunk = q * NH + i;
        blk[chunk] = *reinterpret_cast<const uint4*>(&blk_s[chunk >> 3][(chunk & 7) * 8]);
    }

    // GroupNorm over the head's 64 outputs
    const float mean = block_sum<2>(y, red) / NH;
    const float d = y - mean;
    const float var = block_sum<2>(d * d, red) / NH;
    const float y_n = d * rsqrtf(var + ln_x_eps) * sm[SM_LN_X_S * C + c] + sm[SM_LN_X_B * C + c];
    // bonus (sum_j r k_eff r_k) v, then the gate
    const float s_bh = block_sum<2>(r * k_eff * sm[SM_R_K * C + c], red);
    y_g[bc] = __float2bfloat16((y_n + s_bh * v_s) * g_s);
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

}  // namespace

extern "C" size_t decode_b64_workspace_bytes(int C) { return carve(nullptr, C, nullptr); }

// One decode step. x (64, C) f32 token embeddings (pre-ln0); h_out (64, C)
// f32 (post ln_out). Packed weights as built by
// rwkvtts_torch/ops/decode_mega_b64.py::pack_mega_b64, each (L, ...)
// contiguous. att_x/ffn_x (L, 64, C) bf16 and wkv (L, 64, H, 64, 64) bf16
// are updated in place. counts[K_LN], counts[K_GEMM], counts[K_GLUE] are
// increased by the launches of each kernel. Returns the first CUDA launch
// error (0 on success).
extern "C" int decode_b64_step(
    int L, int C, int B, float norm_eps, float ln_x_eps,
    const float* x, float* h_out, const float* ln0_s, const float* ln0_b,
    const float* lnout_s, const float* lnout_b,
    const int8_t* rkv_q, const float* rkv_s, const int8_t* li_q, const float* li_s,
    const int8_t* lo_q, const float* lo_s, const int8_t* out_q, const float* out_s,
    const int8_t* fk_q, const float* fk_s, const int8_t* fv_q, const float* fv_s,
    const float* smalls, bf16* att_x, bf16* ffn_x, bf16* wkv, void* workspace,
    int* counts, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (B != GM || C % 128 || C > LN_THREADS * LN_MAX_PER_THREAD)
        return (int)cudaErrorInvalidValue;
    const int H = C / NH;
    Workspace ws;
    carve(workspace, C, &ws);
    const int64_t BC = (int64_t)GM * C;
    const int LI = 4 * LORA_PAD;
    int err;
#define GEMM(call)                      \
    do {                                \
        if ((err = (call))) return err; \
        ++counts[K_GEMM];               \
    } while (0)
#define LAUNCH(kind, ...)                                \
    do {                                                 \
        __VA_ARGS__;                                     \
        if ((err = (int)cudaGetLastError())) return err; \
        ++counts[kind];                                  \
    } while (0)

    LAUNCH(K_LN, ln_rows_kernel<0><<<GM, LN_THREADS, 0, st>>>(
        C, norm_eps, x, ln0_s, ln0_b, ws.x_res, nullptr, nullptr, nullptr));
    for (int l = 0; l < L; ++l) {
        const float* sm = smalls + (int64_t)l * NS * C;
        bf16* ax = att_x + l * BC;
        bf16* fx = ffn_x + l * BC;
        // ln1, the token shift and the six mixes r, k, v, w, a, g (rows
        // SM_X_R .. SM_X_G are adjacent in that order)
        LAUNCH(K_LN, ln_rows_kernel<6><<<GM, LN_THREADS, 0, st>>>(
            C, norm_eps, ws.x_res, sm + SM_LN1_S * C, sm + SM_LN1_B * C,
            nullptr, ax, sm + SM_X_R * C, ws.xmix));

        // r, k, v: one product against [W_r | W_k | W_v], lhs planes r, k, v
        GemmArgs g = {};
        g.K = C; g.N = 3 * C; g.k_split = C;
        g.a = ws.xmix; g.lda = C; g.a_group = C; g.a_gz = BC;
        g.w = rkv_q + (int64_t)l * C * 3 * C; g.s = rkv_s + (int64_t)l * 3 * C;
        g.out = ws.acc_rkv; g.ldo = 3 * C;
        GEMM(gemm<EPI_BF16>(g, 1, st));
        // lora-in, groups (v, w, a, g) of 128 columns, lhs planes v, w, a, g
        g.N = LI; g.a = ws.xmix + 2 * BC; g.a_group = LORA_PAD;
        g.w = li_q + (int64_t)l * C * LI; g.s = li_s + (int64_t)l * LI;
        g.out = ws.lora_act; g.ldo = LI;
        GEMM(gemm<EPI_LORA_ACT>(g, 1, st));
        // lora-out: 4 groups of (64 x 128) @ (128 x C)
        GemmArgs lo = {};
        lo.K = LORA_PAD; lo.N = C; lo.k_split = LORA_PAD;
        lo.a = ws.lora_act; lo.lda = LI; lo.a_z = LORA_PAD; lo.a_group = C;
        lo.w = lo_q + (int64_t)l * LI * C; lo.w_z = (int64_t)LORA_PAD * C;
        lo.s = lo_s + (int64_t)l * 4 * C; lo.s_z = C;
        lo.out = ws.lo_out; lo.ldo = C; lo.o_z = BC;
        GEMM(gemm<EPI_F32>(lo, 4, st));

        LAUNCH(K_GLUE, glue_kernel<<<GM * H, NH, 0, st>>>(
            C, H, ln_x_eps, l == 0, ws.acc_rkv, ws.lo_out, ws.v_first, sm,
            wkv + (int64_t)l * GM * H * NH * NH, ws.y_g));

        // output projection into the residual (split K, atomic adds)
        GemmArgs o = {};
        o.K = C; o.N = C; o.k_split = split_k(C, 4);
        o.a = ws.y_g; o.lda = C; o.a_group = C;
        o.w = out_q + (int64_t)l * C * C; o.s = out_s + (int64_t)l * C;
        o.out = ws.x_res; o.ldo = C;
        GEMM(gemm<EPI_ADD_F32>(o, 1, st));

        // ln2, the token shift and the FFN mix
        LAUNCH(K_LN, ln_rows_kernel<1><<<GM, LN_THREADS, 0, st>>>(
            C, norm_eps, ws.x_res, sm + SM_LN2_S * C, sm + SM_LN2_B * C,
            nullptr, fx, sm + SM_FFN_X_K * C, ws.xmix));
        // FFN key with relu^2, then FFN value into the residual
        GemmArgs fk = {};
        fk.K = C; fk.N = 4 * C; fk.k_split = C;
        fk.a = ws.xmix; fk.lda = C; fk.a_group = 4 * C;
        fk.w = fk_q + (int64_t)l * C * 4 * C; fk.s = fk_s + (int64_t)l * 4 * C;
        fk.out = ws.acc_ffn; fk.ldo = 4 * C;
        GEMM(gemm<EPI_RELU2>(fk, 1, st));
        GemmArgs fv = {};
        fv.K = 4 * C; fv.N = C; fv.k_split = split_k(4 * C, 8);
        fv.a = ws.acc_ffn; fv.lda = 4 * C; fv.a_group = C;
        fv.w = fv_q + (int64_t)l * 4 * C * C; fv.s = fv_s + (int64_t)l * C;
        fv.out = ws.x_res; fv.ldo = C;
        GEMM(gemm<EPI_ADD_F32>(fv, 1, st));
    }
    LAUNCH(K_LN, ln_rows_kernel<0><<<GM, LN_THREADS, 0, st>>>(
        C, norm_eps, ws.x_res, lnout_s, lnout_b, h_out, nullptr, nullptr, nullptr));
#undef GEMM
#undef LAUNCH
    return 0;
}
