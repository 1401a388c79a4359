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
//   gemv     the int8 matrix-vector products, one template instance a
//            product (so a profile names them). A CTA takes a tile of TB
//            bytes of every weight row (TB int8 columns: 128 for r/k/v with
//            lora-in and the FFN key, 64 for the C-wide output and FFN
//            value, so that each product has 256 CTAs or more) and a piece
//            of K of at most 64 KB; the K pieces of a tile run as one
//            thread block cluster (at most 8). A producer warp asks for the
//            CTA's whole piece, 8 KB TMA boxes into shared memory, two in
//            flight at a time, starting before the wait for the previous
//            kernel: the weights depend on nothing, so they stream while
//            the kernel before runs, and the pacing keeps the stream from
//            queueing ahead of that kernel's own latency-bound reads (more
//            in flight was slower). The compute warps build the lhs slice:
//            for r/k/v with lora-in and for the FFN key each CTA normalises
//            the residual row itself (LayerNorm over all C, ln0 first at
//            layer 0; scale, bias, old shift state and mix fetched before
//            the wait) and mixes in the token shift, so no LayerNorm runs on
//            one CTA; the CTAs of the first tile also write the normalised
//            row that becomes the shift state (a later kernel stores it,
//            once every CTA has read the old one). Then they let the next
//            kernel launch, multiply as the boxes land (int8 widened in
//            registers, f32 sums, 16 columns a thread), reduce over their
//            rows in a fixed order, and each CTA sends its sums of the
//            columns that CTA r of the cluster owns to CTA r (asynchronous
//            stores into its shared memory that complete on its mbarrier);
//            CTA r adds the pieces in rank order, scales and stores. No
//            float atomics: two calls give the same bits;
//   glue     one CTA of 8 warps a head: the lora-out product for its 64
//            channels (its four 16 KB bf16 weight blocks fetched by TMA
//            before the wait, like its WKV state rows and its smalls), the
//            decay, a, v-residual and k prep, the WKV state update in place
//            in kernel 7's layout (csrc/wkv7_step.cu: warp w steps 8 state
//            rows, lane l holds 2 key columns of each, row sums are warp
//            shuffles), GroupNorm, the bonus and the gate, writing the bf16
//            lhs of the output product;
//   ln_out   one CTA: the final LayerNorm.
// Per layer: r/k/v with lora-in (one launch, two weight matrices), glue,
// output, FFN key, FFN value = 5 launches; 5 L + 1 a step. Every kernel is
// launched with programmatic dependent launch: it waits
// (griddepcontrol.wait) before it reads what an earlier kernel wrote or
// writes anything, and lets the next kernel launch once it has read what it
// needs of the earlier kernels' output; and every kernel asks for the same
// L1 / shared split, so that an SM can hold CTAs of two kernels at once.
#include "sm90.cuh"

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
// the four products of a layer, as indices of decode_b1_step's pieces
enum { P_RKV_LI = 0, P_OUT = 1, P_FK = 2, P_FV = 3, NPROD = 4 };

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float softplus_(float z) {
    // the TPU kernel's exp/log form (ops/decode_mega.py::_softplus)
    return fmaxf(z, 0.f) + logf(1.f + expf(-fabsf(z)));
}

constexpr int RT = 256;        // threads of every kernel of the step
constexpr int RW = RT / 32;
constexpr int MAXE = 16;       // elements of a row a thread holds: C <= 4096

// The RT threads that compute synchronise alone on named barrier 1 (a
// product CTA also has a producer warp, which does not wait for them).
__device__ __forceinline__ void sync_compute() {
    asm volatile("bar.sync 1, %0;" ::"n"(RT) : "memory");
}

// the sum over the RT compute threads; every one of them gets it
__device__ __forceinline__ float compute_sum(float v, float* scratch) {
    v = warp_sum(v);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    sync_compute();  // scratch may still be read by a previous call
    if (lane == 0) scratch[warp] = v;
    sync_compute();
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < RW; ++w) t += scratch[w];
    return t;
}

struct LnStats {
    float mean, rstd;
};

// the statistics of ln_regs alone
__device__ __forceinline__ LnStats ln_stats(const float (&v)[MAXE], int C, float eps, float* red) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) s += v[e];
    const float mean = compute_sum(s, red) / C;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
        const int c = threadIdx.x + e * RT;
        const float d = c < C ? v[e] - mean : 0.f;
        q += d * d;
    }
    return {mean, rsqrtf(compute_sum(q, red) / C + eps)};
}

// v[i] for an index i known only at run time, without spilling v to memory
__device__ __forceinline__ float pick(const float (&v)[MAXE], int i) {
    float x = 0.f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) x = e == i ? v[e] : x;
    return x;
}

// LayerNorm, two-pass f32 statistics, of the C-wide row a CTA holds as
// v[e] = row[threadIdx.x + RT e] (zero past C), in place; `red` holds RW
// floats. Every CTA that normalises the same row gets the same bits.
__device__ __forceinline__ void ln_regs(float (&v)[MAXE], int C, float eps, const float* scale,
                                        const float* bias, float* red) {
    const LnStats st = ln_stats(v, C, eps, red);
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
        const int c = threadIdx.x + e * RT;
        v[e] = c < C ? (v[e] - st.mean) * st.rstd * scale[c] + bias[c] : 0.f;
    }
}

// the C-wide row at x (written by an earlier kernel) into v
__device__ __forceinline__ void load_row(float (&v)[MAXE], const float* x, int C) {
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
        const int c = threadIdx.x + e * RT;
        v[e] = c < C ? __ldcg(x + c) : 0.f;
    }
}

// ---------------------------------------------------------------------------
// The final LayerNorm
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(RT) ln_out_kernel(int C, float eps, const float* x_res,
                                                    const float* __restrict__ scale,
                                                    const float* __restrict__ bias, float* out) {
    __shared__ float red[RW];
    pdl_wait();
    pdl_trigger();
    float v[MAXE];
    load_row(v, x_res, C);
    ln_regs(v, C, eps, scale, bias, red);
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
        const int c = threadIdx.x + e * RT;
        if (c < C) out[c] = v[e];
    }
}

// ---------------------------------------------------------------------------
// Matrix-vector products with int8 weights
// ---------------------------------------------------------------------------

constexpr int BOX = 8192;       // bytes of a TMA box of weights
constexpr int PIECE_BYTES = 65536;  // weights of a CTA: all in flight at once
constexpr int MAX_BOXES = PIECE_BYTES / BOX;
constexpr int MAX_PIECES = 8;   // K pieces of a tile: a portable cluster
constexpr int IN_FLIGHT = 2;    // boxes a CTA's producer keeps in flight
constexpr int GV_THREADS = RT + 32;  // the compute threads and a producer warp

// how a CTA builds its lhs slice: bf16 read as it is, or the token-shift
// mix of a normalised row
enum { LHS_BF16 = 0, LHS_LN = 1 };
// what the sum of a column becomes
enum { EPI_F32 = 0, EPI_ADD = 1, EPI_RELU2 = 2 };

// Each product's lhs and tile: TB bytes (int8 columns) of every weight row,
// 128 for the wide products, 64 for the two C-wide ones (output, FFN
// value), so that each has 256 CTAs or more in clusters of at most 8
template <int PROD> struct Prod {
    static constexpr int lhs = LHS_BF16, TB = 64;
};
template <> struct Prod<P_RKV_LI> { static constexpr int lhs = LHS_LN, TB = 128; };
template <> struct Prod<P_FK> { static constexpr int lhs = LHS_LN, TB = 128; };

// dynamic shared memory of a CTA whose tile is tb bytes wide, for a K
// piece of kp rows: slack to align the boxes to 128 bytes, the weight boxes,
// the lhs slice (f32), the warps' column sums, the cluster's partial sums
// of this CTA's columns, the mbarriers (the boxes', the partial sums')
__host__ __device__ constexpr int gemv_smem_bytes(int tb, int kp) {
    return 128 + kp * tb + kp * 4 + RW * tb * 4 + tb * 4 + 8 * (MAX_BOXES + 1);
}

// A run of column tiles that read one weight matrix of the (L, K, N) stack
// `wmap`.
struct Seg {
    CUtensorMap wmap;
    int layer;
    int tiles;           // column tiles
    const float* s;      // (N,) per-column scale
    // the lhs plane of a tile: plane0 + tile / tiles_per_plane (LHS_BF16:
    // the bf16 row a + plane * C; LHS_LN: the mix row mix + plane * C)
    int plane0, tiles_per_plane;
    const bf16* a;
    void* out;           // column n at out + n
    int epi;
};

// LHS_LN: the lhs of a tile whose plane is p, at row k, is
// bf16(xn_k + (shift_k - xn_k) mix[p C + k]) with xn = LN(x; s, b), and x
// itself LN(x; ln0) where ln0_s is set (layer 0)
struct LnMix {
    const float* x;
    const float* ln0_s;
    const float* ln0_b;
    float* x_res;        // layer 0: the first tile's CTAs write LN(x; ln0) here
    const float* s;
    const float* b;
    const float* shift;  // the token-shift state before the step
    const float* mix;
    float* xn;           // the first tile's CTAs write xn here: the new shift state
    float eps;
};

struct GemvLaunch {
    Seg seg[2];          // the tiles of seg[1] follow those of seg[0]
    int nseg, C, pieces, kp;
    LnMix ln;
    // the first tile's CTAs copy C floats src -> dst, a slice a piece
    const float* copy_src;
    float* copy_dst;
};

// old: EPI_ADD's value of out[n] before the kernel
__device__ __forceinline__ void epilogue(const Seg& sg, int n, float v, float old) {
    if (sg.epi == EPI_F32) {
        static_cast<float*>(sg.out)[n] = v;
    } else if (sg.epi == EPI_ADD) {
        static_cast<float*>(sg.out)[n] = old + v;
    } else {
        const float t = fmaxf(v, 0.f);
        static_cast<bf16*>(sg.out)[n] = __float2bfloat16(t * t);
    }
}

// acc[j] += a * w[j] for the 16 int8 bytes u of one weight row
__device__ __forceinline__ void row_fma(float (&acc)[16], const uint4& u, float a) {
    const uint32_t q[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                           u.w ^ 0x80808080u};
    // byte e of q, x + 128 for the int8 x, as the f32 2^23 + x + 128: minus
    // 2^23 + 128 it is x exactly
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const float f = __int_as_float(__byte_perm(q[j >> 2], 0x4B000000u, (j & 3) | 0x7540));
        acc[j] = fmaf(a, f - 8388736.f, acc[j]);
    }
}

template <int PROD>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(const __grid_constant__ GemvLaunch g) {
    constexpr int TB = Prod<PROD>::TB;     // bytes and int8 columns of a tile row
    constexpr int TPR = TB / 16;           // threads a row, 16 bytes each
    constexpr int RPP = RT / TPR;          // rows a pass
    constexpr int BOX_ROWS = BOX / TB;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* wt = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
    const int P = g.pieces, KP = g.kp, nbox = KP / BOX_ROWS, C = g.C;
    float* lhs = reinterpret_cast<float*>(wt + KP * TB);  // [KP]
    float* red = lhs + KP;                                 // [warps][TB]
    float* inbox = red + RW * TB;                          // [pieces][TB / pieces]
    uint64_t* bars = reinterpret_cast<uint64_t*>(inbox + TB);  // [MAX_BOXES]
    uint64_t* sumbar = bars + MAX_BOXES;                   // the cluster's partial sums

    const int tid = threadIdx.x;
    const int piece = blockIdx.x % P, tile = blockIdx.x / P;  // piece: the rank in the cluster
    const bool second = g.nseg > 1 && tile >= g.seg[0].tiles;
    const Seg& sg = second ? g.seg[1] : g.seg[0];
    const int lt = second ? tile - g.seg[0].tiles : tile;
    const int n0 = lt * TB, k0 = piece * KP;
    const int plane = sg.plane0 + lt / sg.tiles_per_plane;

    if (tid == RT) {
        for (int b = 0; b < nbox; ++b) mbar_init(&bars[b], 1);
        // the partial sums of this CTA's columns: TB floats from the cluster
        mbar_init(sumbar, 1);
        mbar_expect_tx(sumbar, TB * 4);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every CTA of the cluster has its partial-sum barrier before any other
    // CTA stores to it; the weights are asked for after this barrier, which
    // then has no copies in flight to wait for
    if (P > 1) cluster_sync_relaxed();
    else __syncthreads();
    if (tid >= RT) {
        // the producer warp. The weights depend on no earlier kernel: the
        // whole piece is asked for before the wait for the previous kernel,
        // IN_FLIGHT boxes at a time, so that a flood of them does not queue
        // ahead of the reads on the earlier kernels' critical paths
        if (tid == RT)
            for (int b = 0; b < nbox; ++b) {
                if (b >= IN_FLIGHT) mbar_wait(&bars[b - IN_FLIGHT], 0);
                mbar_expect_tx(&bars[b], BOX);
                tma_load(wt + b * BOX, &sg.wmap, n0, k0 + b * BOX_ROWS, sg.layer, &bars[b]);
            }
        return;
    }
    // LHS_LN: what no earlier kernel of the step writes, fetched before the
    // wait too: the LayerNorm's scale and bias, the old shift state and the
    // mix at this thread's rows of the piece, c1 + RT e (the rows of the
    // piece that are tid modulo RT)
    constexpr int PE = Prod<PROD>::lhs == LHS_LN ? (PIECE_BYTES / TB + RT - 1) / RT : 1;
    const LnMix& m = g.ln;
    const int c1 = k0 + (tid - k0 % RT + RT) % RT;
    float ps[PE], pb[PE], psh[PE], pmx[PE];
    if (Prod<PROD>::lhs == LHS_LN)
#pragma unroll
        for (int e = 0; e < PE; ++e) {
            const int c = c1 + RT * e;
            if (c < k0 + KP) {
                ps[e] = m.s[c], pb[e] = m.b[c], psh[e] = __ldcg(m.shift + c);
                pmx[e] = m.mix[(int64_t)plane * C + c];
            }
        }
    pdl_wait();
    // this CTA's columns of the output: an add into the residual reads
    // them now, out of the tail
    const int per = TB / P;
    float old = 0.f;
    if (sg.epi == EPI_ADD && tid < per)
        old = __ldcg(static_cast<const float*>(sg.out) + n0 + piece * per + tid);
    if (tile == 0 && g.copy_dst) {
        const int n = C / P;
        for (int i = piece * n + tid; i < (piece + 1) * n; i += RT)
            g.copy_dst[i] = __ldcg(g.copy_src + i);
    }
    if (Prod<PROD>::lhs == LHS_BF16) {
        const bf16* a = sg.a + (int64_t)plane * C + k0;
        for (int i = tid; i < KP; i += RT) lhs[i] = __bfloat162float(__ldcg(a + i));
    } else {
        float v[MAXE];
        load_row(v, m.x, C);
        if (m.ln0_s) {
            ln_regs(v, C, m.eps, m.ln0_s, m.ln0_b, red);
            if (tile == 0)
#pragma unroll
                for (int e = 0; e < MAXE; ++e) {
                    const int c = tid + e * RT;
                    if (c >= k0 && c < k0 + KP) m.x_res[c] = v[e];
                }
        }
        const LnStats st = ln_stats(v, C, m.eps, red);
#pragma unroll
        for (int e = 0; e < PE; ++e) {
            const int c = c1 + RT * e;  // v[c / RT]
            if (c < k0 + KP) {
                const float xn = (pick(v, c / RT) - st.mean) * st.rstd * ps[e] + pb[e];
                lhs[c - k0] = round_bf16(xn + (psh[e] - xn) * pmx[e]);
                if (tile == 0) m.xn[c] = xn;
            }
        }
    }
    sync_compute();
    // the next kernel launches, and asks for its weights, once every CTA
    // has read what it needs of the earlier kernels' output: the tail below
    // touches no device memory but the stores of the result
    pdl_trigger();

    // thread t: rows t / TPR + RPP i of each box, 16 bytes of each at
    // column (t % TPR) * 16
    const int r = tid / TPR, cb = (tid % TPR) * 16;
    float acc[16] = {};
    for (int b = 0; b < nbox; ++b) {
        mbar_wait(&bars[b], 0);
        const unsigned char* w = wt + b * BOX + r * TB + cb;
#pragma unroll
        for (int i = 0; i < BOX_ROWS / RPP; ++i) {
            const uint4 u = *reinterpret_cast<const uint4*>(w + i * RPP * TB);
            row_fma(acc, u, lhs[b * BOX_ROWS + r + RPP * i]);
        }
    }
    // the warp's rows (lanes TPR apart) in a fixed order, then the 8 warps'
    // sums of each column in order
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int o = TPR; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    const int lane = tid & 31, warp = tid >> 5;
    if (lane < TPR)
#pragma unroll
        for (int j = 0; j < 16; ++j) red[warp * TB + lane * 16 + j] = acc[j];
    sync_compute();
    float sum = 0.f;
    if (tid < TB)
#pragma unroll
        for (int w = 0; w < RW; ++w) sum += red[w * TB + tid];
    if (P == 1) {
        if (tid < TB) epilogue(sg, n0 + tid, sum * sg.s[n0 + tid], old);
        return;
    }
    // the K pieces of the tile are one cluster: CTA r sums columns
    // [r TB / P, (r + 1) TB / P); each CTA stores its sums of them into CTA
    // r's shared memory (distributed shared memory, asynchronous stores that
    // complete on CTA r's barrier), and CTA r adds them up in rank order,
    // scales and stores
    if (tid < TB) {
        const int r = tid / per;
        st_async_f32(inbox + piece * per + tid % per, sumbar, r, sum);
    }
    if (tid < per) {
        mbar_wait(sumbar, 0);
        float s = 0.f;
        for (int q = 0; q < P; ++q) s += inbox[q * per + tid];
        const int n = n0 + piece * per + tid;
        epilogue(sg, n, s * sg.s[n], old);
    }
}

// ---------------------------------------------------------------------------
// Per-head glue: lora-out, prep, WKV update, GroupNorm, bonus, gate
// ---------------------------------------------------------------------------

constexpr int GLUE_ROWS = NH / RW;              // state rows a warp
constexpr int LO_ROW = 2 * NH;                  // bytes of a head's 64 bf16 columns
constexpr int LO_BOX = LORA_PAD * LO_ROW;       // a group's 128 rows of them

// dynamic shared memory of a glue CTA: slack to align the boxes, the four
// lora-out weight boxes, the activated hiddens, the lora-out half sums, the
// six per-channel vectors and y, the reduction scratch, the mbarrier
__host__ __device__ constexpr int glue_smem_bytes() {
    return 128 + 4 * LO_BOX + 4 * (NLI + 2 * 4 * NH + 7 * NH + RW) + 8;
}

struct GlueArgs {
    CUtensorMap lomap;   // lora-out (L, 512, C) bf16, boxes of 128 rows x 64 columns
    int layer, C, is_first;
    float ln_x_eps;
    const float* acc;    // (3C) r, k, v
    const float* li_h;   // (512) lora-in hiddens
    float* v_first;      // (C)
    const float* sm;     // (NS, C) this layer's smalls
    void* wkv;           // (H, 64, 64) this layer, rows the value dim, in place
    bf16* y_g;           // (C) lhs of the output product
    const float* xn;     // (C) the normalised row of ln1, the new att_x
    float* att_x;        // (C) this layer's token-shift state
};

__device__ __forceinline__ float2 ld_pair(const float* p) {
    return __ldcg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
    return __bfloat1622float2(__ldcg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void st_pair(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename ST>
__global__ void __launch_bounds__(RT) glue_kernel(const __grid_constant__ GlueArgs g) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* wl = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
    float* lh = reinterpret_cast<float*>(wl + 4 * LO_BOX);  // [512]
    float* lop = lh + NLI;                                   // [2 halves][4 groups][64]
    float* swd = lop + 2 * 4 * NH;                           // key-indexed: decay,
    float* sz = swd + NH;                                    // z = -kk_n,
    float* sbb = sz + NH;                                    // b = kk_n a,
    float* sk = sbb + NH;                                    // k_eff, r;
    float* sr = sk + NH;
    float* sv = sr + NH;                                     // value-indexed v, y
    float* sy = sv + NH;
    float* red = sy + NH;                                    // [RW]
    uint64_t* bar = reinterpret_cast<uint64_t*>(red + RW);

    const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int C = g.C;
    if (tid == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        mbar_expect_tx(bar, 4 * LO_BOX);
        for (int z = 0; z < 4; ++z)
            tma_load(wl + z * LO_BOX, &g.lomap, h * NH, z * LORA_PAD, g.layer, bar);
    }
    // this warp's state rows, before the wait for the previous kernel: the
    // block was last written by this layer's glue of the previous step,
    // which every kernel since waited for; read past L1 (ld.global.cg),
    // where a line may still hold it as an earlier step left it
    ST* blk = static_cast<ST*>(g.wkv) + (int64_t)h * NH * NH;
    const int row0 = warp * GLUE_ROWS, j0 = 2 * lane;
    float2 S[GLUE_ROWS];
#pragma unroll
    for (int q = 0; q < GLUE_ROWS; ++q) S[q] = ld_pair(blk + (row0 + q) * NH + j0);
    // and thread i < 64's channel c = h * 64 + i: its smalls and, after the
    // first layer, v_first (written by the first layer's glue, which the
    // previous kernel waited for)
    const int i = tid;
    const bool chan = i < NH;
    const int c = h * NH + (chan ? i : 0);
    const float* sm = g.sm;
    float w0 = 0.f, a0 = 0.f, v0 = 0.f, k_k = 0.f, k_a = 0.f, r_k = 0.f, lx_s = 0.f, lx_b = 0.f;
    float vf = 0.f;
    if (chan) {
        w0 = sm[SM_W0 * C + c], a0 = sm[SM_A0 * C + c], v0 = sm[SM_V0 * C + c];
        k_k = sm[SM_K_K * C + c], k_a = sm[SM_K_A * C + c], r_k = sm[SM_R_K * C + c];
        lx_s = sm[SM_LN_X_S * C + c], lx_b = sm[SM_LN_X_B * C + c];
        if (!g.is_first) vf = __ldcg(g.v_first + c);
    }
    pdl_wait();
    float r = 0.f, k0 = 0.f, v_row = 0.f, xn = 0.f;
    if (chan) {
        r = __ldcg(g.acc + c), k0 = __ldcg(g.acc + C + c), v_row = __ldcg(g.acc + 2 * C + c);
        xn = __ldcg(g.xn + c);
    }

    // the lora-in hiddens, activated (tanh for w, sigmoid for g) and
    // rounded to bf16
    for (int j = tid; j < NLI; j += RT) {
        float x = __ldcg(g.li_h + j);
        const int z = j / LORA_PAD;
        if (z == LG_W) x = tanhf(x);
        else if (z == LG_G) x = sigmoidf_(x);
        lh[j] = round_bf16(x);
    }
    __syncthreads();
    pdl_trigger();  // every read of the earlier kernels' output is done
    mbar_wait(bar, 0);
    {
        // lora-out of the head's 64 channels: thread (group z, half of K,
        // column pair) sums 64 rows, even and odd rows apart; the halves
        // are added in order below
        const int z = tid >> 6, half = (tid >> 5) & 1;
        const unsigned char* w = wl + z * LO_BOX + half * 64 * LO_ROW + lane * 4;
        const float* a = lh + z * LORA_PAD + half * 64;
        float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll 16
        for (int kr = 0; kr < 64; ++kr) {
            const float2 f =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + kr * LO_ROW));
            s0[kr & 1] = fmaf(a[kr], f.x, s0[kr & 1]);
            s1[kr & 1] = fmaf(a[kr], f.y, s1[kr & 1]);
        }
        st_pair(lop + (half * 4 + z) * NH + j0, s0[0] + s0[1], s1[0] + s1[1]);
    }
    __syncthreads();

    // prep of channel c
    auto lora = [&](int z) { return lop[z * NH + i] + lop[(4 + z) * NH + i]; };
    float k = 0.f, kk = 0.f, a = 0.f, v = 0.f, gate = 0.f, wd = 0.f;
    if (chan) {
        const float w_raw = -softplus_(-(w0 + lora(LG_W))) - 0.5f;
        wd = expf(-expf(w_raw));
        a = sigmoidf_(a0 + lora(LG_A));
        if (g.is_first) {
            v = v_row;
            g.v_first[c] = v;
        } else {
            const float vmix = sigmoidf_(v0 + lora(LG_V));
            v = v_row + (vf - v_row) * vmix;
        }
        gate = lora(LG_G);
        kk = k0 * k_k;
        k = k0 * (1.f + (a - 1.f) * k_a);
        // the token-shift state, now that every product of ln1 has read it
        g.att_x[c] = xn;
    }
    // l2-normalize kk over the head (eps^2 = 1e-24 clamped before the sqrt)
    const float nrm = sqrtf(fmaxf(block_sum<RW>(kk * kk, red), 1e-24f));
    // bonus (sum_j r k r_k), used after the update
    const float s_bh = block_sum<RW>(chan ? r * k * r_k : 0.f, red);
    if (chan) {
        const float kkn = kk * (1.f / nrm);
        swd[i] = wd;
        sz[i] = -kkn;
        sbb[i] = kkn * a;
        sk[i] = k;
        sr[i] = r;
        sv[i] = v;
    }
    __syncthreads();

    // the update in f32, S w + sa b + v k; y from the updated S
    const float2 wd2 = make_float2(swd[j0], swd[j0 + 1]), z2 = make_float2(sz[j0], sz[j0 + 1]);
    const float2 b2 = make_float2(sbb[j0], sbb[j0 + 1]), k2 = make_float2(sk[j0], sk[j0 + 1]);
    const float2 r2 = make_float2(sr[j0], sr[j0 + 1]);
    float y_mine = 0.f;
#pragma unroll
    for (int q = 0; q < GLUE_ROWS; ++q) {
        const float sa = warp_sum(fmaf(S[q].x, z2.x, S[q].y * z2.y));
        const float vi = sv[row0 + q];
        const float n0 = S[q].x * wd2.x + sa * b2.x + vi * k2.x;
        const float n1 = S[q].y * wd2.y + sa * b2.y + vi * k2.y;
        st_pair(blk + (row0 + q) * NH + j0, n0, n1);
        const float yq = warp_sum(fmaf(n0, r2.x, n1 * r2.y));
        if (lane == q) y_mine = yq;
    }
    if (lane < GLUE_ROWS) sy[row0 + lane] = y_mine;
    __syncthreads();

    // GroupNorm over the head's 64 outputs, then the bonus and the gate
    const float y = chan ? sy[i] : 0.f;
    const float mean = block_sum<RW>(y, red) / NH;
    const float d = chan ? y - mean : 0.f;
    const float var = block_sum<RW>(d * d, red) / NH;
    if (chan) {
        const float y_n = d * rsqrtf(var + g.ln_x_eps) * lx_s + lx_b;
        g.y_g[c] = __float2bfloat16((y_n + s_bh * v) * gate);
    }
}

// ---------------------------------------------------------------------------
// Workspace (activations carried between launches)
// ---------------------------------------------------------------------------

struct Workspace {
    float* x_res;    // (C) residual
    float* acc;      // (3C) r, k, v
    float* li_h;     // (512) lora-in hiddens
    bf16* acc_ffn;   // (4C) relu(FFN key)^2, the lhs of the FFN value
    float* v_first;  // (C)
    bf16* y_g;       // (C) lhs of the output product
    float* xn1;      // (C) LN1 of the residual: the next att_x
    float* xn2;      // (C) LN2 of the residual: the next ffn_x
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
    w.acc = (float*)take((size_t)3 * C * 4);
    w.li_h = (float*)take((size_t)NLI * 4);
    w.acc_ffn = (bf16*)take((size_t)4 * C * 2);
    w.v_first = (float*)take((size_t)C * 4);
    w.y_g = (bf16*)take((size_t)C * 2);
    w.xn1 = (float*)take((size_t)C * 4);
    w.xn2 = (float*)take((size_t)C * 4);
    if (ws) *ws = w;
    return off;
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

Seg seg(const CUtensorMap& wmap, int layer, int tiles, const float* s, int plane0,
        int tiles_per_plane, const bf16* a, void* out, int epi) {
    Seg q;
    q.wmap = wmap;
    q.layer = layer; q.tiles = tiles; q.s = s;
    q.plane0 = plane0; q.tiles_per_plane = tiles_per_plane; q.a = a;
    q.out = out; q.epi = epi;
    return q;
}

// one product: K rows cut into `pieces`, run as a cluster; s1 is a second
// matrix in the same launch (lora-in beside r/k/v); ln the LayerNorm of an
// LHS_LN product; copy_* the first tile's copy
template <int PROD>
int gemv(const Seg& s0, const Seg* s1, int C, int K, int pieces, const LnMix* ln,
         const float* copy_src, float* copy_dst, bool pdl, cudaStream_t stream) {
    constexpr int TB = Prod<PROD>::TB;
    GemvLaunch g = {};
    g.seg[0] = s0;
    g.nseg = s1 ? 2 : 1;
    if (s1) g.seg[1] = *s1;
    g.C = C;
    g.pieces = pieces;
    g.kp = K / pieces;
    if (pieces < 1 || pieces > MAX_PIECES || K % pieces || g.kp % (BOX / TB) ||
        g.kp * TB > PIECE_BYTES || C % pieces || (Prod<PROD>::lhs == LHS_LN) != (ln != nullptr))
        return (int)cudaErrorInvalidValue;
    if (ln) g.ln = *ln;
    g.copy_src = copy_src;
    g.copy_dst = copy_dst;
    const int tiles = s0.tiles + (s1 ? s1->tiles : 0);
    cudaError_t e = allow_smem<gemv_kernel<PROD>>(gemv_smem_bytes(TB, PIECE_BYTES / TB), true);
    if (e != cudaSuccess) return (int)e;
    return (int)launch(gemv_kernel<PROD>, tiles * pieces, GV_THREADS, gemv_smem_bytes(TB, g.kp),
                       pieces, pdl, stream, g);
}

template <typename ST>
int step(int L, int C, float norm_eps, float ln_x_eps, const float* x, float* h_out,
         const float* ln0_s, const float* ln0_b, const float* lnout_s, const float* lnout_b,
         const int8_t* rkv_q, const float* rkv_s, const int8_t* li_q, const float* li_s,
         const bf16* lo, const int8_t* out_q, const float* out_s, const int8_t* fk_q,
         const float* fk_s, const int8_t* fv_q, const float* fv_s, const float* smalls,
         float* att_x, float* ffn_x, ST* wkv, void* workspace, const int* pieces, bool pdl,
         int* counts, cudaStream_t st) {
    const int H = C / NH;
    Workspace ws;
    carve(workspace, C, &ws);
    int err;
#define LAUNCH(kind, call)                   \
    do {                                     \
        if ((err = (int)(call))) return err; \
        ++counts[kind];                      \
    } while (0)

    // TMA maps over each weight stack (L, rows, N): 8 KB boxes of a tile's
    // width (the lora-out: a group's 128 rows of a head's 64 columns), no
    // swizzle
    constexpr int WIDE = Prod<P_RKV_LI>::TB, NARROW = Prod<P_OUT>::TB;
    static_assert(Prod<P_FK>::TB == WIDE && Prod<P_FV>::TB == NARROW, "tile widths");
    CUtensorMap m_rkv, m_li, m_lo, m_out, m_fk, m_fv;
    if ((err = tensor_map(&m_rkv, rkv_q, 1, 3 * C, C, L, WIDE, BOX / WIDE, false)) ||
        (err = tensor_map(&m_li, li_q, 1, NLI, C, L, WIDE, BOX / WIDE, false)) ||
        (err = tensor_map(&m_lo, lo, 2, C, NLI, L, LO_ROW, LORA_PAD, false)) ||
        (err = tensor_map(&m_out, out_q, 1, C, C, L, NARROW, BOX / NARROW, false)) ||
        (err = tensor_map(&m_fk, fk_q, 1, 4 * C, C, L, WIDE, BOX / WIDE, false)) ||
        (err = tensor_map(&m_fv, fv_q, 1, C, 4 * C, L, NARROW, BOX / NARROW, false)))
        return err;
    constexpr int GLUE_SMEM = glue_smem_bytes();
    if ((err = (int)allow_smem<ln_out_kernel>(0, true)) ||
        (err = (int)allow_smem<glue_kernel<ST>>(GLUE_SMEM, true)))
        return err;
    const int T = C / WIDE, TN = C / NARROW;  // tiles of a C-wide int8 row
    for (int l = 0; l < L; ++l) {
        const float* sm = smalls + (int64_t)l * NS * C;
        // r, k, v against [W_r | W_k | W_v] (mix planes r, k, v), then the
        // lora-in groups v, w, a, g (planes 2 .. 5, rows SM_X_R .. SM_X_G
        // are adjacent in that order), on ln1 (ln0 first at layer 0)
        const LnMix ln1 = {l == 0 ? x : ws.x_res, l == 0 ? ln0_s : nullptr, ln0_b, ws.x_res,
                           sm + SM_LN1_S * C, sm + SM_LN1_B * C, att_x + (int64_t)l * C,
                           sm + SM_X_R * C, ws.xn1, norm_eps};
        const Seg rkv = seg(m_rkv, l, 3 * T, rkv_s + (int64_t)3 * C * l, 0, T, nullptr, ws.acc,
                            EPI_F32);
        const Seg li = seg(m_li, l, NLI / WIDE, li_s + (int64_t)NLI * l, 2, LORA_PAD / WIDE,
                           nullptr, ws.li_h, EPI_F32);
        LAUNCH(K_GEMV, gemv<P_RKV_LI>(rkv, &li, C, C, pieces[P_RKV_LI], &ln1, nullptr, nullptr,
                                      pdl, st));
        GlueArgs ga;
        ga.lomap = m_lo;
        ga.layer = l; ga.C = C; ga.is_first = l == 0; ga.ln_x_eps = ln_x_eps;
        ga.acc = ws.acc; ga.li_h = ws.li_h; ga.v_first = ws.v_first; ga.sm = sm;
        ga.wkv = wkv + (int64_t)l * H * NH * NH; ga.y_g = ws.y_g;
        ga.xn = ws.xn1; ga.att_x = att_x + (int64_t)l * C;
        LAUNCH(K_GLUE, launch(glue_kernel<ST>, H, RT, GLUE_SMEM, 1, pdl, st, ga));
        // output projection, added into the residual
        LAUNCH(K_GEMV, gemv<P_OUT>(seg(m_out, l, TN, out_s + (int64_t)C * l, 0, TN, ws.y_g,
                                       ws.x_res, EPI_ADD),
                                   nullptr, C, C, pieces[P_OUT], nullptr, nullptr, nullptr, pdl,
                                   st));
        // FFN key on ln2 and its mix, relu^2 into bf16
        const LnMix ln2 = {ws.x_res, nullptr, nullptr, nullptr, sm + SM_LN2_S * C,
                           sm + SM_LN2_B * C, ffn_x + (int64_t)l * C, sm + SM_FFN_X_K * C,
                           ws.xn2, norm_eps};
        LAUNCH(K_GEMV, gemv<P_FK>(seg(m_fk, l, 4 * T, fk_s + (int64_t)4 * C * l, 0, 4 * T,
                                      nullptr, ws.acc_ffn, EPI_RELU2),
                                  nullptr, C, C, pieces[P_FK], &ln2, nullptr, nullptr, pdl, st));
        // FFN value into the residual; the new ffn_x, now that the FFN key
        // has read the old one
        LAUNCH(K_GEMV, gemv<P_FV>(seg(m_fv, l, TN, fv_s + (int64_t)C * l, 0, TN, ws.acc_ffn,
                                      ws.x_res, EPI_ADD),
                                  nullptr, C, 4 * C, pieces[P_FV], nullptr, ws.xn2,
                                  ffn_x + (int64_t)l * C, pdl, st));
    }
    LAUNCH(K_LN, launch(ln_out_kernel, 1, RT, 0, 1, pdl, st, C, norm_eps,
                        (const float*)ws.x_res, lnout_s, lnout_b, h_out));
#undef LAUNCH
    return 0;
}

}  // namespace

// Bytes of the step's workspace at width C.
extern "C" size_t decode_b1_workspace_bytes(int C) { return carve(nullptr, C, nullptr); }

// Dynamic shared memory of a product CTA whose tile is tb bytes wide, for a
// K piece of kp rows (kp > 0), or of a glue CTA (kp = 0); the wrapper's
// launch plan checks them against the card's 227 KB.
extern "C" int decode_b1_smem_bytes(int tb, int kp) {
    return kp > 0 ? gemv_smem_bytes(tb, kp) : glue_smem_bytes();
}

// One decode step. x (1, C) f32 token embedding (pre-ln0); h_out (1, C) f32
// (post ln_out). Packed weights as built by
// rwkvtts_torch/ops/decode_mega.py::pack_mega, each (L, ...) contiguous.
// att_x / ffn_x (L, 1, C) f32 and wkv (L, 1, H, 64, 64) in state_dtype
// (DT_F32 or DT_BF16) are updated in place. pieces[P_RKV_LI .. P_FV] is the
// number of K pieces of each product (the wrapper's launch plan); pdl = 0
// launches the chain without programmatic dependent launch. counts[K_LN],
// counts[K_GEMV], counts[K_GLUE] are increased by the launches of each
// kernel. Returns the first CUDA launch error (0 on success).
extern "C" int decode_b1_step(
    int L, int C, int state_dtype, float norm_eps, float ln_x_eps,
    const float* x, float* h_out, const float* ln0_s, const float* ln0_b,
    const float* lnout_s, const float* lnout_b,
    const int8_t* rkv_q, const float* rkv_s, const int8_t* li_q, const float* li_s,
    const bf16* lo, const int8_t* out_q, const float* out_s,
    const int8_t* fk_q, const float* fk_s, const int8_t* fv_q, const float* fv_s,
    const float* smalls, float* att_x, float* ffn_x, void* wkv, void* workspace,
    const int* pieces, int pdl, int* counts, void* stream) {
    if (C % 128 || C > RT * MAXE) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (state_dtype == DT_F32)
        return step<float>(L, C, norm_eps, ln_x_eps, x, h_out, ln0_s, ln0_b, lnout_s, lnout_b,
                           rkv_q, rkv_s, li_q, li_s, lo, out_q, out_s, fk_q, fk_s, fv_q, fv_s,
                           smalls, att_x, ffn_x, static_cast<float*>(wkv), workspace, pieces,
                           pdl != 0, counts, st);
    if (state_dtype == DT_BF16)
        return step<bf16>(L, C, norm_eps, ln_x_eps, x, h_out, ln0_s, ln0_b, lnout_s, lnout_b,
                          rkv_q, rkv_s, li_q, li_s, lo, out_q, out_s, fk_q, fk_s, fv_q, fv_s,
                          smalls, att_x, ffn_x, static_cast<bf16*>(wkv), workspace, pieces,
                          pdl != 0, counts, st);
    return (int)cudaErrorInvalidValue;
}
