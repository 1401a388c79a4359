// One RWKV-7 decode step for a single row (B = 1), all layers: the Cosy
// streaming LM step.
//
// Replaces: rwkvtts_tpu/ops/decode_mega.py::_mega_kernel (reached through
// decode_step_mega). Same arithmetic and the same rounding points: the
// token-shift states, the residual x_res, the r/k/v rows and the lora
// hiddens are f32; every product's lhs is rounded to bf16 (the TPU
// kernel's mm_dtype for a bf16 model; an f32 lhs is refused by the
// wrapper); tanh(w), the a and v hiddens and sigmoid(g) are rounded to
// bf16 before the bf16 lora-out product; the WKV state is written in the
// carry dtype (f32 or bf16), and y uses the updated state before that
// rounding.
//
// What bounds it on this card, reckoned from shapes at C = 2048, L = 24:
// every weight is read once a step, 12 C^2 int8 bytes (r, k, v, output,
// FFN key and value) + C x 512 int8 lora-in + 512 x C bf16 lora-out =
// 53.5 MB a layer, and the bf16 WKV state (32 x 64 x 64 x 2 bytes a layer)
// is read and written: ~1.3 GB, or ~0.39 ms at 3.35 TB/s. The products do
// 2 FLOP a weight, 2.6 GFLOP a step: 0.04 ms on the CUDA cores. So the step
// is bound by the bytes, and at B = 1 every product is a matrix-vector
// product: the tensor cores would waste 63/64 of each tile.
//
// Design. The TPU grid (L, T) carries VMEM scratch from one weight tile to
// the next; CUDA blocks cannot, so the step is a chain of launches on one
// stream, and the activations live in a small device workspace:
//   ln_mix   one CTA: LayerNorm of the residual row; for ln1 / ln2 it also
//            steps the f32 token-shift state, writes the bf16 mixes that
//            are the products' lhs (6 for the time mix, 1 for the FFN) and
//            zeroes the f32 accumulators the next products add into;
//   gemv     an int8 (or bf16) GEMV: a CTA takes 128 columns and a slice of
//            K rows (split K, so that the narrow products still put a few
//            hundred CTAs on the 132 SMs), stages its lhs slice in shared
//            memory as f32 (applying the lora activation or relu^2 on the
//            way in), streams the weights with 16-byte loads (one 128-byte
//            line a row), accumulates in f32, reduces over its row groups
//            and adds scale x sum into the f32 output with atomics;
//   glue     one CTA of 64 threads per head: the decay, a, v-residual and
//            k prep for its channels, the WKV state update in place
//            (thread i steps state row i), GroupNorm, the bonus and the
//            gate, writing the bf16 lhs of the output product.
// Per layer: ln1, rkv + lora-in (one launch, two weight matrices), lora-out,
// glue, output, ln2, FFN key, FFN value = 8 launches; 8 L + 1 a step.
// CUDA graphs or a persistent kernel, which would remove most of the launch
// gaps, are later work.
#include "common.cuh"

namespace {

constexpr int NH = 64;         // head size
constexpr int LORA_PAD = 128;  // every lora width padded to this
constexpr int NLI = 4 * LORA_PAD;
constexpr int NS = 24;         // rows of the smalls block

// smalls rows (rwkvtts_tpu/ops/decode_mega.py::_SM)
enum {
    SM_LN1_S = 0, SM_LN1_B = 1, SM_LN2_S = 2, SM_LN2_B = 3,
    SM_X_R = 4, SM_X_K = 5, SM_X_V = 6, SM_X_W = 7, SM_X_A = 8, SM_X_G = 9,
    SM_W0 = 10, SM_A0 = 11, SM_V0 = 12, SM_K_K = 13, SM_K_A = 14, SM_R_K = 15,
    SM_LN_X_S = 16, SM_LN_X_B = 17, SM_FFN_X_K = 18,
};
// lora groups, in the order of the packed lora blocks (the TPU _LH order)
enum { LG_V = 0, LG_W = 1, LG_A = 2, LG_G = 3 };
// the three kernels, as indices of decode_b1_step's launch counts
enum { K_LN = 0, K_GEMV = 1, K_GLUE = 2 };

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float softplus_(float z) {
    // the TPU kernel's exp/log form (ops/decode_mega.py::_softplus)
    return fmaxf(z, 0.f) + logf(1.f + expf(-fabsf(z)));
}

// ---------------------------------------------------------------------------
// LayerNorm of the residual row
// ---------------------------------------------------------------------------

constexpr int LN_THREADS = 512;
constexpr int LN_PER_THREAD = 8;  // C <= 4096

// Sum over the block of v; every thread gets the total.
__device__ __forceinline__ float ln_sum(float v, float* red) {
    return block_sum<LN_THREADS / 32>(v, red);
}

// v (this thread's elements of the row) -> LayerNorm(v) with two-pass f32
// statistics, in place.
__device__ __forceinline__ void ln_row(float* v, int C, float eps, const float* scale,
                                       const float* bias, float* red) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < LN_PER_THREAD; ++e) s += v[e];
    const float mean = ln_sum(s, red) / C;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < LN_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        const float d = c < C ? v[e] - mean : 0.f;
        q += d * d;
    }
    const float rstd = rsqrtf(ln_sum(q, red) / C + eps);
#pragma unroll
    for (int e = 0; e < LN_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        if (c < C) v[e] = (v[e] - mean) * rstd * scale[c] + bias[c];
    }
}

// x_in non-null (the first layer): x_res = LN(x_in; ln0) first.
// Then xn = LN(x_res; scale, bias).
// NMIX == 0: out = xn (ln_out).
// NMIX > 0: token shift: xx = shift - xn, shift = xn, and for each of the
// NMIX coefficient rows mix_j the product lhs xmix[j] = bf16(xn + xx * mix_j);
// zero[0 .. n_zero) is set to 0 (the accumulators of the products that follow).
template <int NMIX>
__global__ void __launch_bounds__(LN_THREADS) ln_mix_kernel(
    int C, float eps, const float* __restrict__ x_in, const float* __restrict__ ln0_s,
    const float* __restrict__ ln0_b, float* __restrict__ x_res,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ shift, const float* __restrict__ mix,
    bf16* __restrict__ xmix, float* __restrict__ zero, int n_zero) {
    __shared__ float red[LN_THREADS / 32];
    for (int i = threadIdx.x; i < n_zero; i += LN_THREADS) zero[i] = 0.f;
    float v[LN_PER_THREAD];
    const float* src = x_in ? x_in : x_res;
#pragma unroll
    for (int e = 0; e < LN_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        v[e] = c < C ? src[c] : 0.f;
    }
    if (x_in) {
        ln_row(v, C, eps, ln0_s, ln0_b, red);
#pragma unroll
        for (int e = 0; e < LN_PER_THREAD; ++e) {
            const int c = threadIdx.x + e * LN_THREADS;
            if (c < C) x_res[c] = v[e];
            else v[e] = 0.f;
        }
    }
    ln_row(v, C, eps, scale, bias, red);
#pragma unroll
    for (int e = 0; e < LN_PER_THREAD; ++e) {
        const int c = threadIdx.x + e * LN_THREADS;
        if (c >= C) continue;
        const float xn = v[e];
        if (NMIX == 0) {
            out[c] = xn;
        } else {
            const float xx = shift[c] - xn;
            shift[c] = xn;
#pragma unroll
            for (int j = 0; j < NMIX; ++j)
                xmix[j * C + c] = __float2bfloat16(xn + xx * mix[j * C + c]);
        }
    }
}

// ---------------------------------------------------------------------------
// Matrix-vector product with int8 (or bf16) weights
// ---------------------------------------------------------------------------

constexpr int GV_THREADS = 256;
constexpr int GV_NT = 128;     // columns per CTA: one 128-byte line of int8 a row
constexpr int GV_KMAX = 1024;  // rows of lhs a CTA stages (k_split <= this)

// how the CTA builds its lhs slice (f32 in shared memory)
enum { LHS_BF16 = 0, LHS_LORA = 1, LHS_RELU2 = 2 };

// A run of column tiles that read one weight matrix.
struct GemvSeg {
    const void* w;        // (K, ldw) row-major, this segment's column 0 at w
    int ldw;
    const float* s;       // (ldw,) per-column scale, or null for 1
    int tiles;            // column tiles of GV_NT
    int tiles_per_plane;  // LHS_BF16: consecutive tiles that share one lhs plane
    int plane0;           // LHS_BF16: the lhs plane of the segment's first tile
};

struct GemvArgs {
    int K, k_split;       // blockIdx.y takes rows [y k_split, (y + 1) k_split)
    GemvSeg seg[2];       // tiles of seg[1] follow those of seg[0] in the output
    // LHS_BF16: bf16 planes at a + plane * a_plane; LHS_LORA: f32 hiddens at
    // a + z * a_z (activation by group z); LHS_RELU2: f32 at a
    const void* a;
    int64_t a_plane, a_z;
    int64_t w_z;          // weight stride of blockIdx.z (lora-out groups)
    float* out;           // f32, out[z * o_z + n] += scale * sum
    int64_t o_z;
};

template <typename WT, int LHS>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(GemvArgs p) {
    constexpr int CPT = 16 / sizeof(WT);     // columns a thread loads at once (16 bytes)
    constexpr int TPR = GV_NT / CPT;         // threads a weight row
    constexpr int RP = GV_THREADS / TPR;     // rows a pass
    __shared__ float lhs[GV_KMAX];
    __shared__ __align__(16) float red[RP][GV_NT];

    const int tid = threadIdx.x;
    const int si = blockIdx.x < p.seg[0].tiles ? 0 : 1;
    const GemvSeg sg = p.seg[si];
    const int lt = si ? blockIdx.x - p.seg[0].tiles : blockIdx.x;  // tile in the segment
    const int n_w = lt * GV_NT;                                      // column in sg.w
    const int n_out = (si ? p.seg[0].tiles * GV_NT : 0) + n_w;       // column in out
    const int z = blockIdx.z;
    const int k0 = blockIdx.y * p.k_split;
    const int kn = min(p.k_split, p.K - k0);

    if (LHS == LHS_BF16) {
        const bf16* a = static_cast<const bf16*>(p.a) +
                        (int64_t)(sg.plane0 + lt / sg.tiles_per_plane) * p.a_plane + k0;
        for (int i = tid; i < kn; i += GV_THREADS) lhs[i] = __bfloat162float(a[i]);
    } else if (LHS == LHS_LORA) {
        const float* a = static_cast<const float*>(p.a) + z * p.a_z + k0;
        for (int i = tid; i < kn; i += GV_THREADS) {
            float v = a[i];
            if (z == LG_W) v = tanhf(v);
            else if (z == LG_G) v = sigmoidf_(v);
            lhs[i] = round_bf16(v);
        }
    } else {
        const float* a = static_cast<const float*>(p.a) + k0;
        for (int i = tid; i < kn; i += GV_THREADS) {
            const float v = fmaxf(a[i], 0.f);
            lhs[i] = round_bf16(v * v);
        }
    }
    __syncthreads();

    const int r = tid / TPR, c = (tid % TPR) * CPT;
    const WT* w = static_cast<const WT*>(sg.w) + z * p.w_z + (int64_t)k0 * sg.ldw + n_w + c;
    float acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int k = r; k < kn; k += RP) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(w + (int64_t)k * sg.ldw));
        const float a = lhs[k];
        if constexpr (sizeof(WT) == 1) {
            const int32_t* q = reinterpret_cast<const int32_t*>(&u);
#pragma unroll
            for (int j = 0; j < 16; ++j)
                acc[j] = fmaf(a, (float)(int8_t)(q[j >> 2] >> (8 * (j & 3))), acc[j]);
        } else {
            float f[8];
            unpack8(u, f);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j] = fmaf(a, f[j], acc[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) red[r][c + j] = acc[j];
    __syncthreads();
    if (tid < GV_NT) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < RP; ++i) sum += red[i][tid];
        const float sc = sg.s ? sg.s[n_w + tid] : 1.f;
        atomicAdd(p.out + z * p.o_z + n_out + tid, sum * sc);
    }
}

// Rows a CTA takes so that the grid holds about 3 CTAs an SM.
int pick_split(int K, int ctas_per_split) {
    const int target = 3 * 132;
    const int splits = (target + ctas_per_split - 1) / ctas_per_split;
    int ks = (K + splits - 1) / splits;
    ks = (ks + 31) / 32 * 32;
    if (ks > GV_KMAX) ks = GV_KMAX;
    return ks < K ? ks : K;
}

template <typename WT, int LHS>
int gemv(GemvArgs p, int nz, cudaStream_t stream) {
    const int tiles = p.seg[0].tiles + p.seg[1].tiles;
    p.k_split = pick_split(p.K, tiles * nz);
    dim3 grid(tiles, (p.K + p.k_split - 1) / p.k_split, nz);
    RWKV_TRY(gemv_kernel<WT, LHS><<<grid, GV_THREADS, 0, stream>>>(p));
    return 0;
}

// One segment: all N columns of w read lhs plane 0 (LHS_BF16) or the mode's source.
GemvSeg one_seg(const void* w, int N, const float* s) {
    return GemvSeg{w, N, s, N / GV_NT, 1 << 30, 0};
}

// ---------------------------------------------------------------------------
// Per-head glue: prep, WKV update, GroupNorm, bonus, gate
// ---------------------------------------------------------------------------

template <typename ST>
__global__ void __launch_bounds__(NH) glue_kernel(
    int C, float ln_x_eps, int is_first,
    const float* __restrict__ acc,  // (3C): r, k, v
    const float* __restrict__ lo,   // (4, C): lora-out in LG order
    float* __restrict__ v_first,    // (C)
    const float* __restrict__ sm,   // (NS, C) this layer's smalls
    ST* __restrict__ wkv,           // (H, 64, 64) this layer, rows the value dim, in place
    bf16* __restrict__ y_g) {       // (C)
    __shared__ float red[2];
    __shared__ float sz[NH], sbb[NH], sr[NH], swd[NH], sk[NH];
    __shared__ float S[NH][NH + 1];  // the head's state, f32; padded rows
    const int h = blockIdx.x, i = threadIdx.x;
    const int c = h * NH + i;
    ST* blk = wkv + (int64_t)h * NH * NH;
    // coalesced: in pass q the 64 threads read row q
#pragma unroll 8
    for (int q = 0; q < NH; ++q) S[q][i] = to_f32(blk[q * NH + i]);

    const float r = acc[c], k0 = acc[C + c], v_row = acc[2 * C + c];
    const float w_raw = -softplus_(-(sm[SM_W0 * C + c] + lo[LG_W * C + c])) - 0.5f;
    const float wd = expf(-expf(w_raw));
    const float a = sigmoidf_(sm[SM_A0 * C + c] + lo[LG_A * C + c]);
    float v;
    if (is_first) {
        v = v_row;
        v_first[c] = v;
    } else {
        const float vmix = sigmoidf_(sm[SM_V0 * C + c] + lo[LG_V * C + c]);
        v = v_row + (v_first[c] - v_row) * vmix;
    }
    const float g = lo[LG_G * C + c];
    const float kk = k0 * sm[SM_K_K * C + c];
    const float k = k0 * (1.f + (a - 1.f) * sm[SM_K_A * C + c]);
    // l2-normalize kk over the head (eps^2 = 1e-24 clamped before the sqrt)
    const float kkn = kk * (1.f / sqrtf(fmaxf(block_sum<2>(kk * kk, red), 1e-24f)));
    sz[i] = -kkn;
    sbb[i] = kkn * a;
    sr[i] = r;
    swd[i] = wd;
    sk[i] = k;
    __syncthreads();

    // thread i steps state row i in f32; y uses the updated state
    float sa = 0.f;
#pragma unroll 16
    for (int j = 0; j < NH; ++j) sa = fmaf(S[i][j], sz[j], sa);
    float y = 0.f;
#pragma unroll 16
    for (int j = 0; j < NH; ++j) {
        const float s2 = S[i][j] * swd[j] + sa * sbb[j] + v * sk[j];
        S[i][j] = s2;
        y = fmaf(s2, sr[j], y);
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < NH; ++q) blk[q * NH + i] = from_f32<ST>(S[q][i]);

    // GroupNorm over the head's 64 outputs
    const float mean = block_sum<2>(y, red) / NH;
    const float d = y - mean;
    const float var = block_sum<2>(d * d, red) / NH;
    const float y_n = d * rsqrtf(var + ln_x_eps) * sm[SM_LN_X_S * C + c] + sm[SM_LN_X_B * C + c];
    // bonus (sum_j r k r_k) v, then the gate
    const float s_bh = block_sum<2>(r * k * sm[SM_R_K * C + c], red);
    y_g[c] = __float2bfloat16((y_n + s_bh * v) * g);
}

// ---------------------------------------------------------------------------
// Workspace (activations carried between launches)
// ---------------------------------------------------------------------------

struct Workspace {
    float* x_res;    // (C) residual
    bf16* xmix;      // (6, C) product lhs: mixes r, k, v, w, a, g (FFN: plane 0)
    float* acc;      // (3C + 512 + 4C): r/k/v, lora-in hiddens, lora-out rows
    float* acc_ffn;  // (4C) FFN key
    float* v_first;  // (C)
    bf16* y_g;       // (C) lhs of the output product
};

size_t carve(void* base, int C, Workspace* ws) {
    char* p = static_cast<char*>(base);
    size_t off = 0;
    auto take = [&](size_t bytes) {
        char* q = p ? p + off : nullptr;
        off += (bytes + 255) & ~size_t(255);
        return q;
    };
    Workspace w;
    w.x_res = (float*)take((size_t)C * 4);
    w.xmix = (bf16*)take((size_t)6 * C * 2);
    w.acc = (float*)take(((size_t)7 * C + NLI) * 4);
    w.acc_ffn = (float*)take((size_t)4 * C * 4);
    w.v_first = (float*)take((size_t)C * 4);
    w.y_g = (bf16*)take((size_t)C * 2);
    if (ws) *ws = w;
    return off;
}

template <typename ST>
int step(int L, int C, float norm_eps, float ln_x_eps, const float* x, float* h_out,
         const float* ln0_s, const float* ln0_b, const float* lnout_s, const float* lnout_b,
         const int8_t* rkv_q, const float* rkv_s, const int8_t* li_q, const float* li_s,
         const bf16* lo, const int8_t* out_q, const float* out_s, const int8_t* fk_q,
         const float* fk_s, const int8_t* fv_q, const float* fv_s, const float* smalls,
         float* att_x, float* ffn_x, ST* wkv, void* workspace, int* counts, cudaStream_t st) {
    const int H = C / NH;
    Workspace ws;
    carve(workspace, C, &ws);
    float* acc_li = ws.acc + 3 * C;
    float* acc_lo = acc_li + NLI;
    const int64_t CC = (int64_t)C * C;
    int err;
#define GEMV(call)                      \
    do {                                \
        if ((err = (call))) return err; \
        ++counts[K_GEMV];               \
    } while (0)
#define LAUNCH(kind, ...)                                \
    do {                                                 \
        __VA_ARGS__;                                     \
        if ((err = (int)cudaGetLastError())) return err; \
        ++counts[kind];                                  \
    } while (0)

    for (int l = 0; l < L; ++l) {
        const float* sm = smalls + (int64_t)l * NS * C;
        // (ln0,) ln1, the token shift and the six mixes r, k, v, w, a, g
        // (rows SM_X_R .. SM_X_G are adjacent in that order); zero r/k/v,
        // the lora hiddens and the lora-out rows
        LAUNCH(K_LN, ln_mix_kernel<6><<<1, LN_THREADS, 0, st>>>(
            C, norm_eps, l == 0 ? x : nullptr, ln0_s, ln0_b, ws.x_res,
            sm + SM_LN1_S * C, sm + SM_LN1_B * C, nullptr, att_x + (int64_t)l * C,
            sm + SM_X_R * C, ws.xmix, ws.acc, 7 * C + NLI));

        // r, k, v against [W_r | W_k | W_v] (lhs planes r, k, v), then the
        // lora-in groups v, w, a, g (lhs planes 2 .. 5) in the same launch
        GemvArgs g = {};
        g.K = C;
        g.seg[0] = GemvSeg{rkv_q + 3 * CC * l, 3 * C, rkv_s + (int64_t)3 * C * l,
                           3 * C / GV_NT, C / GV_NT, 0};
        g.seg[1] = GemvSeg{li_q + (int64_t)NLI * C * l, NLI, li_s + (int64_t)NLI * l,
                           NLI / GV_NT, LORA_PAD / GV_NT, 2};
        g.a = ws.xmix; g.a_plane = C;
        g.out = ws.acc;
        GEMV((gemv<int8_t, LHS_BF16>(g, 1, st)));

        // lora-out: 4 groups of (128) @ (128 x C) bf16, lhs the activated hiddens
        GemvArgs lg = {};
        lg.K = LORA_PAD;
        lg.seg[0] = one_seg(lo + (int64_t)NLI * C * l, C, nullptr);
        lg.a = acc_li; lg.a_z = LORA_PAD;
        lg.w_z = (int64_t)LORA_PAD * C;
        lg.out = acc_lo; lg.o_z = C;
        GEMV((gemv<bf16, LHS_LORA>(lg, 4, st)));

        LAUNCH(K_GLUE, glue_kernel<ST><<<H, NH, 0, st>>>(
            C, ln_x_eps, l == 0, ws.acc, acc_lo, ws.v_first, sm,
            wkv + (int64_t)l * H * NH * NH, ws.y_g));

        // output projection, added into the residual
        GemvArgs o = {};
        o.K = C;
        o.seg[0] = one_seg(out_q + CC * l, C, out_s + (int64_t)C * l);
        o.a = ws.y_g;
        o.out = ws.x_res;
        GEMV((gemv<int8_t, LHS_BF16>(o, 1, st)));

        // ln2, the token shift and the FFN mix; zero the FFN key accumulator
        LAUNCH(K_LN, ln_mix_kernel<1><<<1, LN_THREADS, 0, st>>>(
            C, norm_eps, nullptr, nullptr, nullptr, ws.x_res, sm + SM_LN2_S * C,
            sm + SM_LN2_B * C, nullptr, ffn_x + (int64_t)l * C, sm + SM_FFN_X_K * C,
            ws.xmix, ws.acc_ffn, 4 * C));
        // FFN key, then FFN value with relu^2 on its lhs, into the residual
        GemvArgs fk = {};
        fk.K = C;
        fk.seg[0] = one_seg(fk_q + 4 * CC * l, 4 * C, fk_s + (int64_t)4 * C * l);
        fk.a = ws.xmix;
        fk.out = ws.acc_ffn;
        GEMV((gemv<int8_t, LHS_BF16>(fk, 1, st)));
        GemvArgs fv = {};
        fv.K = 4 * C;
        fv.seg[0] = one_seg(fv_q + 4 * CC * l, C, fv_s + (int64_t)C * l);
        fv.a = ws.acc_ffn;
        fv.out = ws.x_res;
        GEMV((gemv<int8_t, LHS_RELU2>(fv, 1, st)));
    }
    LAUNCH(K_LN, ln_mix_kernel<0><<<1, LN_THREADS, 0, st>>>(
        C, norm_eps, nullptr, nullptr, nullptr, ws.x_res, lnout_s, lnout_b, h_out, nullptr,
        nullptr, nullptr, nullptr, 0));
#undef GEMV
#undef LAUNCH
    return 0;
}

}  // namespace

extern "C" size_t decode_b1_workspace_bytes(int C) { return carve(nullptr, C, nullptr); }

// One decode step. x (1, C) f32 token embedding (pre-ln0); h_out (1, C) f32
// (post ln_out). Packed weights as built by
// rwkvtts_torch/ops/decode_mega.py::pack_mega, each (L, ...) contiguous.
// att_x / ffn_x (L, 1, C) f32 and wkv (L, 1, H, 64, 64) in state_dtype
// (DT_F32 or DT_BF16) are updated in place. counts[K_LN], counts[K_GEMV],
// counts[K_GLUE] are increased by the launches of each kernel. Returns the
// first CUDA launch error (0 on success).
extern "C" int decode_b1_step(
    int L, int C, int state_dtype, float norm_eps, float ln_x_eps,
    const float* x, float* h_out, const float* ln0_s, const float* ln0_b,
    const float* lnout_s, const float* lnout_b,
    const int8_t* rkv_q, const float* rkv_s, const int8_t* li_q, const float* li_s,
    const bf16* lo, const int8_t* out_q, const float* out_s,
    const int8_t* fk_q, const float* fk_s, const int8_t* fv_q, const float* fv_s,
    const float* smalls, float* att_x, float* ffn_x, void* wkv, void* workspace,
    int* counts, void* stream) {
    if (C % GV_NT || C > LN_THREADS * LN_PER_THREAD)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (state_dtype == DT_F32)
        return step<float>(L, C, norm_eps, ln_x_eps, x, h_out, ln0_s, ln0_b, lnout_s, lnout_b,
                           rkv_q, rkv_s, li_q, li_s, lo, out_q, out_s, fk_q, fk_s, fv_q, fv_s,
                           smalls, att_x, ffn_x, static_cast<float*>(wkv), workspace, counts, st);
    if (state_dtype == DT_BF16)
        return step<bf16>(L, C, norm_eps, ln_x_eps, x, h_out, ln0_s, ln0_b, lnout_s, lnout_b,
                          rkv_q, rkv_s, li_q, li_s, lo, out_q, out_s, fk_q, fk_s, fv_q, fv_s,
                          smalls, att_x, ffn_x, static_cast<bf16*>(wkv), workspace, counts, st);
    return (int)cudaErrorInvalidValue;
}
