// Windowed max-log-MAP SISO of the LTE PCCC constituent code, for sm_90a,
// with float32 metrics or with 16-bit (bfloat16) metrics.
//
// Replaces the Pallas kernel srslte_tpu/ops/tdec_pallas.py _siso_kernel (via
// siso_from_windows), in float32 and in its bfloat16 run (SUB_BF16), together
// with its window glue (prepare_windows, prepare_windows_roll,
// prepare_beta_init, take_windows).
//
// The function.  8-state RSC, g0 = 1+D^2+D^3 (feedback), g1 = 1+D+D^3.  Each
// window covers the positions wL-T .. wL+L+T-1 of its code block: L outputs
// with T-step training halos on both sides.  The alpha recursion runs forward
// and the beta recursion backward in ONE merged loop of T+L steps, split at
// half = (L + 2T - 1)/2 + 1: each side stores its metrics on its first half
// of the window and, on the second half, completes the LLR of a position from
// the other side's stored metrics.  Window 0 starts exactly in state 0, the
// last window's beta starts from the tail termination (beta_init), positions
// outside [0, K) carry the metrics through unchanged.  In 16 bits both metric
// vectors are re-pinned to state 0 (M[s] - M[0]) after every step, inactive
// ones included, since bfloat16's 8 mantissa bits cannot hold metrics that
// grow over L + 2T steps; the last window's beta starts from the cast tail
// beta, not normalised before its first step.
//
// What bounds it on an H100.  The function moves 3 values per trellis
// position (two inputs, one output), so bytes bound it: 0.0294 ms at the DL
// path's shape (B 1408, K 5824) in float32, 0.0147 ms in 16 bits.  What holds
// the kernel far above that is the chain of T + L dependent steps of every
// window, the room on chip (only windows whose histories fit in shared
// memory are in flight) and the shuffles and shared-memory accesses that
// every state of every step costs.
//
// The design.
// - One lane per trellis state: a group of 8 lanes of a warp decodes one
//   window (float32) or two windows packed in __nv_bfloat162 (16 bits, the
//   counterpart of the TPU's packed bf16 tile), 4 groups per warp, one warp
//   per block.  Alpha takes its two predecessors ((s & 3) << 1) | b by
//   __shfl_sync, beta its two successors succ0(s) and succ0(s) ^ 4.
// - The histories stay on chip, in shared memory, holding only what is read
//   back: alpha for steps [T, half) and beta for [half, T+L), L x 8 metric
//   words per group, laid out [step][group][state] so that a warp touches 32
//   consecutive words.  The side that reaches a position second reads the
//   history at the lane's own state (beta side) or its two successors (alpha
//   side), with no shuffle.  Nothing goes through device memory but the
//   inputs and the output.
// - The inputs are staged: each lane loads one step of a chunk of 8, two
//   chunks ahead of the steps (the permutation index one chunk earlier
//   still), and puts the step's gammas into a ring in shared memory at the
//   start of its chunk; a lane reads the two gammas of its branches there by
//   its parity bit, without a select.  The systematic value of a position,
//   gathered through `perm`, is loaded once and kept for the second side.
// - The LLRs of 8 steps are finished together: each lane collects its
//   state's two branch sums per step, and a transposed reduction over the
//   group (7 shuffles per quantity per 8 steps) leaves step j's maxima in
//   lane j, which writes 8 consecutive outputs.
// - Every lane takes part in every shuffle: a group or a bfloat16 half past
//   the last window computes on zeros and writes nothing.  A bfloat16 pair may
//   span two code blocks, or window 0 and a last window: its init, its live
//   mask and its carry-through are per half, and the carry-through is a bitwise
//   select per half, not an arithmetic blend.
// - Operations are adds, subtractions and max only, each operand pair as in
//   the plain PyTorch version (m = max_s(A[s] + (B[n] + g))); a max over states
//   is exact in any order, and every bfloat16 op (__hadd2, __hsub2, __hmax2)
//   rounds each half once, so both kernels equal their plain version by value.
//
// Measured by chip_smoke.py and srslte_tpu_torch/ops/siso_variants.py on an
// NVIDIA H100 80GB HBM3 at 700 W, L 256, T 32: 96 registers per thread in
// float32 without perm and 118-120 with it, 120-124 in 16 bits, no spill;
// 37,888 shared bytes per block (history 32 KB, systematic buffer 4 KB,
// gamma ring 1 KB); 6 resident blocks per SM, so 24 windows per SM in
// float32 and 48 in 16 bits; at the DL path's shape 11 % of the byte bound
// in float32 and 7 % in 16 bits, 1.5-1.6 times slower with the resident
// blocks halved.  Without the systematic buffer the kernel is 2-5 % slower
// (faster without perm, slower with it); a fast path that skips the live
// mask where a whole chunk is live gained at most 2 % in float32 and nothing
// in 16 bits, so it is not kept.  See ops/tdec_cuda.py for the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e9f;
constexpr int LANES = 8;          // one lane per trellis state
constexpr int GROUPS = 4;         // groups per block: one warp
constexpr int MAX_SMEM = 232448;  // shared memory a block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

// Closed forms of the trellis (state s = s0*4 + s1*2 + s2, s0 newest).
// Into state sp, dropping bit b: predecessor, input bit, parity bit.
__host__ __device__ constexpr int pred_state(int sp, int b) { return ((sp & 3) << 1) | b; }
__host__ __device__ constexpr int pred_u(int sp, int b) { return ((sp >> 2) ^ sp ^ b) & 1; }
__host__ __device__ constexpr int pred_p(int sp, int b) { return ((sp >> 2) ^ (sp >> 1) ^ b) & 1; }
// From state s with input 0: next state and parity; input 1 flips bit 2 of
// the next state and the parity.
__host__ __device__ constexpr int succ0(int s) { return (s >> 1) | (((s ^ (s >> 1)) & 1) << 2); }
__host__ __device__ constexpr int par0(int s) { return ((s >> 1) ^ (s >> 2)) & 1; }

// A lane's metric word V holds kWin windows' metrics of one state, each an
// element E as the tensors store it.
template <typename V>
struct Ops;

template <>
struct Ops<float> {
    using E = float;
    static constexpr int kWin = 1;
    static constexpr bool kNorm = false;
    static __device__ __forceinline__ E elem(float x) { return x; }
    static __device__ __forceinline__ float zero() { return 0.0f; }
    static __device__ __forceinline__ float add(float a, float b) { return a + b; }
    static __device__ __forceinline__ float sub(float a, float b) { return a - b; }
    static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
    static __device__ __forceinline__ float shfl(float v, int src) {
        return __shfl_sync(FULL, v, src, LANES);
    }
    static __device__ __forceinline__ float shfl_xor(float v, int m) {
        return __shfl_xor_sync(FULL, v, m, LANES);
    }
    static __device__ __forceinline__ float sel(bool c, float a, float b) { return c ? a : b; }
    // bit h of `take` set: window h takes a, else keeps b
    static __device__ __forceinline__ float pick(unsigned take, float a, float b) {
        return (take & 1u) ? a : b;
    }
    static __device__ __forceinline__ float make(const E (&e)[1]) { return e[0]; }
    static __device__ __forceinline__ E part(float v, int) { return v; }
};

template <>
struct Ops<__nv_bfloat162> {
    using V = __nv_bfloat162;
    using E = __nv_bfloat16;
    static constexpr int kWin = 2;
    static constexpr bool kNorm = true;
    static __device__ __forceinline__ E elem(float x) { return __float2bfloat16_rn(x); }
    static __device__ __forceinline__ V zero() { return __float2bfloat162_rn(0.0f); }
    static __device__ __forceinline__ unsigned bits(V v) {
        unsigned u;
        memcpy(&u, &v, 4);
        return u;
    }
    static __device__ __forceinline__ V word(unsigned u) {
        V v;
        memcpy(&v, &u, 4);
        return v;
    }
    static __device__ __forceinline__ V add(V a, V b) { return __hadd2(a, b); }
    static __device__ __forceinline__ V sub(V a, V b) { return __hsub2(a, b); }
    static __device__ __forceinline__ V max(V a, V b) { return __hmax2(a, b); }
    static __device__ __forceinline__ V shfl(V v, int src) {
        return word(__shfl_sync(FULL, bits(v), src, LANES));
    }
    static __device__ __forceinline__ V shfl_xor(V v, int m) {
        return word(__shfl_xor_sync(FULL, bits(v), m, LANES));
    }
    static __device__ __forceinline__ V sel(bool c, V a, V b) { return word(c ? bits(a) : bits(b)); }
    static __device__ __forceinline__ V pick(unsigned take, V a, V b) {
        const unsigned m = ((take & 1u) ? 0x0000ffffu : 0u) | ((take & 2u) ? 0xffff0000u : 0u);
        return word((bits(a) & m) | (bits(b) & ~m));
    }
    static __device__ __forceinline__ V make(const E (&e)[2]) { return __halves2bfloat162(e[0], e[1]); }
    static __device__ __forceinline__ E part(V v, int h) { return h ? __high2bfloat16(v) : __low2bfloat16(v); }
};

// The two gammas of a step as a lane reads them, g0 on its branch with input
// bit 0 and g1 on its branch with input bit 1, chosen by the parity bit q of
// the input-0 branch: q = 1 reads (pr, sa), q = 0 reads (0, sa + pr).
template <typename V>
struct Pair {
    V g0, g1;
};

constexpr int CHUNK = LANES;  // steps per chunk: lane j stages step j of each chunk
constexpr int DEPTH = 2;      // chunks of inputs in flight ahead of the steps

// Dynamic shared bytes of one block, per group: the history, L steps of 8
// metric words; the systematic words of the L window positions; the input
// ring, 2 sides x CHUNK steps x 2 Pairs.
__host__ __device__ inline size_t smem_bytes_for(int L, int word) {
    return (size_t)GROUPS * word * ((size_t)L * LANES + L + 2 * CHUNK * 4);
}

// One block: GROUPS groups of LANES lanes; group g of block x holds the
// windows n = (x * GROUPS + g) * kWin + h, h < kWin, of the B * W windows
// (n = b * W + w).  Dynamic shared memory: the history [L][GROUPS][LANES]
// of metric words, the systematic buffer [L][GROUPS], the input ring
// [2 sides][CHUNK][GROUPS][2] of Pairs.
//
// The T + L merged steps run in chunks of CHUNK, aligned so that a chunk
// starts at i0 = LT - half, the first step at which both sides finish LLRs.
// At the start of a chunk, each lane j puts the gammas of step j of the
// chunk (loaded DEPTH chunks earlier, the permutation one chunk before that)
// into the ring, and issues the loads of a later chunk.  Every window
// position in [T, T+L) is read by both sides, first before i0 and again
// after it: the systematic value, gathered through `perm`, is loaded from
// device memory the first time and kept in the systematic buffer for the
// second.  Before i0 the steps store the histories (from step T on); from i0
// on they collect, per lane, the branch sums of both sides' LLRs, and at the
// end of a chunk a transposed reduction over the group's lanes leaves the
// two maxima of step j's LLR in lane j, which writes it.
template <typename V, bool EXT, bool PERM>
__global__ void __launch_bounds__(LANES * GROUPS)
siso_kernel(const typename Ops<V>::E* __restrict__ sys, const typename Ops<V>::E* __restrict__ par,
            const typename Ops<V>::E* __restrict__ beta_init, const int* __restrict__ perm,
            typename Ops<V>::E* __restrict__ out, int B, int K, int L, int T) {
    using O = Ops<V>;
    using E = typename O::E;
    constexpr int NW = O::kWin;
    extern __shared__ __align__(16) unsigned char smem[];
    V* hist = reinterpret_cast<V*>(smem);
    V* sysb = hist + (size_t)L * GROUPS * LANES;
    Pair<V>* ring = reinterpret_cast<Pair<V>*>(sysb + (size_t)L * GROUPS);

    const int W = (K + L - 1) / L;
    const int N = B * W;  // the launch checks that it fits
    const int LT = L + 2 * T;
    const int S = T + L;                // merged loop steps
    const int half = (LT - 1) / 2 + 1;  // first t the alpha side finishes
    const int i0 = LT - half;           // first step of both LLRs: half, or half - 1 for LT odd
    const int lane = threadIdx.x & (LANES - 1);  // the lane's trellis state
    const int g = threadIdx.x / LANES;
    const E ez = O::elem(0.0f);
    const V zero = O::zero();

    // ---- the group's windows, per half: window steps [lo, hi) are live
    int lo[NW], hi[NW], rowk[NW], base[NW];
    V A, Bm;
    {
        E a0[NW], b0[NW];
#pragma unroll
        for (int h = 0; h < NW; ++h) {
            const int n = ((int)blockIdx.x * GROUPS + g) * NW + h;
            const bool valid = n < N;
            const int b = valid ? n / W : 0;
            const int w = valid ? n % W : 0;
            base[h] = w * L - T;  // position of window step 0
            rowk[h] = b * K;
            lo[h] = valid ? (base[h] < 0 ? -base[h] : 0) : 0;
            hi[h] = valid ? (K - base[h] < LT ? K - base[h] : LT) : 0;
            a0[h] = (valid && w == 0 && lane != 0) ? O::elem(NEG) : ez;
            b0[h] = (valid && w == W - 1) ? beta_init[(size_t)b * LANES + lane] : ez;
        }
        A = O::make(a0);
        Bm = O::make(b0);
    }
    auto live = [&](int h, int t) { return t >= lo[h] && t < hi[h]; };
    auto live_mask = [&](int t) {
        unsigned m = 0;
#pragma unroll
        for (int h = 0; h < NW; ++h) m |= (unsigned)live(h, t) << h;
        return m;
    };
    // the systematic value of position t comes from device memory, not from
    // the systematic buffer: alpha before half, beta from i0 on (see above)
    auto gather_a = [&](int ta) { return ta < half; };
    auto gather_b = [&](int tb) { return tb >= i0; };

    // ---- input pipeline: lane j stages steps ta = c + j (alpha side) and
    // tb = LT - 1 - ta (beta side) of the chunk starting at step c.  The
    // registers hold the inputs of the next DEPTH chunks and the systematic
    // index of the one after, so a load has DEPTH chunks of steps to arrive.
    struct Staged {
        E a_sa[NW], a_pr[NW], b_sa[NW], b_pr[NW];
    };
    Staged X[DEPTH];
    int qa[NW], qb[NW];  // systematic index (after `perm`) of the chunk being fetched, or -1
    auto fetch_index = [&](int c) {
        const int ta = c + lane, tb = LT - 1 - ta;
#pragma unroll
        for (int h = 0; h < NW; ++h) {
            const int pa = base[h] + ta, pb = base[h] + tb;
            qa[h] = live(h, ta) && gather_a(ta) ? (PERM ? __ldg(perm + pa) : pa) : -1;
            qb[h] = live(h, tb) && gather_b(tb) ? (PERM ? __ldg(perm + pb) : pb) : -1;
        }
    };
    auto fetch_data = [&](int c, Staged& x) {
        const int ta = c + lane, tb = LT - 1 - ta;
#pragma unroll
        for (int h = 0; h < NW; ++h) {
            x.a_sa[h] = qa[h] >= 0 ? sys[rowk[h] + qa[h]] : ez;
            x.a_pr[h] = live(h, ta) ? par[rowk[h] + base[h] + ta] : ez;
            x.b_sa[h] = qb[h] >= 0 ? sys[rowk[h] + qb[h]] : ez;
            x.b_pr[h] = live(h, tb) ? par[rowk[h] + base[h] + tb] : ez;
        }
    };
    const int cs0 = (i0 % CHUNK) ? i0 % CHUNK - CHUNK : 0;  // first chunk start, in (-CHUNK, 0]
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
        fetch_index(cs0 + d * CHUNK);
        fetch_data(cs0 + d * CHUNK, X[d]);
    }
    fetch_index(cs0 + DEPTH * CHUNK);
    // start of the chunk at step c: its gammas into the ring (and the
    // systematic values read again later into the buffer), the loads of the
    // chunk DEPTH ahead issued
    auto refill = [&](int c) {
        __syncwarp();  // the group is done with the ring's last chunk
        const int ta = c + lane, tb = LT - 1 - ta;
        V sa_a = O::make(X[0].a_sa), sa_b = O::make(X[0].b_sa);
        const V pr_a = O::make(X[0].a_pr), pr_b = O::make(X[0].b_pr);
        if (!gather_a(ta) && ta < S) sa_a = sysb[(ta - T) * GROUPS + g];
        if (!gather_b(tb) && tb >= T) sa_b = sysb[(tb - T) * GROUPS + g];
        if (ta < i0) {  // a step before i0: keep what the other side reads after it
            if (ta >= T) sysb[(ta - T) * GROUPS + g] = sa_a;
            if (tb >= half && tb < S) sysb[(tb - T) * GROUPS + g] = sa_b;
        }
        Pair<V>* ea = ring + ((size_t)lane * GROUPS + g) * 2;
        Pair<V>* eb = ring + ((size_t)(CHUNK + lane) * GROUPS + g) * 2;
        ea[0] = Pair<V>{pr_a, sa_a};
        ea[1] = Pair<V>{zero, O::add(sa_a, pr_a)};
        eb[0] = Pair<V>{pr_b, sa_b};
        eb[1] = Pair<V>{zero, O::add(sa_b, pr_b)};
        __syncwarp();  // the ring, the buffer and the histories so far are visible to the group
#pragma unroll
        for (int d = 0; d + 1 < DEPTH; ++d) X[d] = X[d + 1];
        fetch_data(c + DEPTH * CHUNK, X[DEPTH - 1]);
        fetch_index(c + (DEPTH + 1) * CHUNK);
    };

    // Per-lane trellis constants.  Alpha: of the two branches into state s,
    // the one with input bit 0 comes from pred_state(s, u0), the one with
    // input bit 1 from pred_state(s, u0 ^ 1), and qa is the parity of the
    // first.  Beta: from s, input 0 goes to succ0(s) and input 1 to
    // succ0(s) ^ 4, and qb = par0(s).  A Pair index 0 holds q = 1's gammas.
    const int u0 = ((lane >> 2) ^ lane) & 1;
    const int ps0 = pred_state(lane, u0), ps1 = pred_state(lane, u0 ^ 1);
    const int ia_q = pred_p(lane, u0) ? 0 : 1;
    const int sn0 = succ0(lane), sn1 = succ0(lane) ^ 4;
    const int ib_q = par0(lane) ? 0 : 1;
    V* hist_g = hist + (size_t)g * LANES;
    constexpr int HSTRIDE = GROUPS * LANES;  // one step of the history

    // One merged step i (chunk slot k): alpha at ta = i (A holds the metrics
    // BEFORE position ta), beta at tb = LT-1-i (Bm holds the metrics AFTER
    // position tb).  Before i0 (LLR false): from step T on, alpha stores its
    // history of steps [T, half) and beta its history of [half, T+L).  From
    // i0 on (LLR true): both sides collect the branch sums of their LLR from
    // the other side's history; where LT is odd, step i0 = half - 1 still
    // stores alpha's last history word, and its alpha LLR is not written.
    V ma0[CHUNK], ma1[CHUNK], mb0[CHUNK], mb1[CHUNK];  // slots past a short last chunk: unused
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) ma0[k] = ma1[k] = mb0[k] = mb1[k] = zero;
    auto step = [&](int i, int k, auto llr) {
        constexpr bool LLR = decltype(llr)::value;
        const int ta = i;
        const int tb = LT - 1 - i;
        const Pair<V>* ea = ring + ((size_t)k * GROUPS + g) * 2;
        const Pair<V>* eb = ring + ((size_t)(CHUNK + k) * GROUPS + g) * 2;
        const Pair<V> ga = ea[ia_q];
        const Pair<V> gb = eb[ib_q];

        if (LLR ? ta < half : i >= T) hist_g[(ta - T) * HSTRIDE + lane] = A;
        if (!LLR && i >= T) hist_g[(tb - T) * HSTRIDE + lane] = Bm;

        const V na = O::max(O::add(O::shfl(A, ps0), ga.g0), O::add(O::shfl(A, ps1), ga.g1));
        const V r0 = O::add(O::shfl(Bm, sn0), gb.g0);
        const V r1 = O::add(O::shfl(Bm, sn1), gb.g1);
        if (LLR) {
            // alpha side: beta history of ta, at the lane's two successors
            const V* bh = hist_g + (ta - T) * HSTRIDE;
            const Pair<V> gl = ea[ib_q];
            ma0[k] = O::add(A, O::add(bh[sn0], gl.g0));
            ma1[k] = O::add(A, O::add(bh[sn1], gl.g1));
            // beta side: alpha history of tb, at the lane's own state
            const V ah = hist_g[(tb - T) * HSTRIDE + lane];
            mb0[k] = O::add(ah, r0);
            mb1[k] = O::add(ah, r1);
        }
        A = O::pick(live_mask(ta), na, A);
        Bm = O::pick(live_mask(tb), O::max(r0, r1), Bm);
        if (O::kNorm) {  // M[s] - M[0]: state 0 exactly 0, from the group's lane 0
            A = O::sub(A, O::shfl(A, 0));
            Bm = O::sub(Bm, O::shfl(Bm, 0));
        }
    };

    // max over the group's 8 lanes of x[j], left in lane j: three halvings,
    // each lane keeping the half of its slots that its lane bit selects
    auto xpose_max = [&](const V (&x)[CHUNK]) {
        const bool b2 = lane & 4, b1 = lane & 2, b0 = lane & 1;
        V y[4], z[2];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            y[k] = O::max(O::sel(b2, x[k + 4], x[k]), O::shfl_xor(O::sel(b2, x[k], x[k + 4]), 4));
#pragma unroll
        for (int k = 0; k < 2; ++k)
            z[k] = O::max(O::sel(b1, y[k + 2], y[k]), O::shfl_xor(O::sel(b1, y[k], y[k + 2]), 2));
        return O::max(O::sel(b0, z[1], z[0]), O::shfl_xor(O::sel(b0, z[0], z[1]), 1));
    };
    // the LLRs of the chunk at step c (n steps of it): lane j writes step j's
    auto finish = [&](int c, int n) {
        V la = O::sub(xpose_max(ma1), xpose_max(ma0));
        V lb = O::sub(xpose_max(mb1), xpose_max(mb0));
        if (EXT) {  // the lane's own step's systematic values, in its ring slots
            la = O::sub(la, ring[((size_t)lane * GROUPS + g) * 2].g1);
            lb = O::sub(lb, ring[((size_t)(CHUNK + lane) * GROUPS + g) * 2].g1);
        }
        const int ta = c + lane, tb = LT - 1 - ta;
#pragma unroll
        for (int h = 0; h < NW; ++h) {
            if (lane < n && ta >= half && live(h, ta)) out[rowk[h] + base[h] + ta] = O::part(la, h);
            if (lane < n && live(h, tb)) out[rowk[h] + base[h] + tb] = O::part(lb, h);
        }
    };

    using Hist = std::integral_constant<bool, false>;
    using Llr = std::integral_constant<bool, true>;
#pragma unroll 1
    for (int c = cs0; c < i0; c += CHUNK) {
        refill(c);
        if (c < 0) {
            for (int k = -c; k < CHUNK; ++k) step(c + k, k, Hist());
        } else {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) step(c + k, k, Hist());
        }
    }
#pragma unroll 1
    for (int c = i0; c < S; c += CHUNK) {
        refill(c);
        if (c + CHUNK > S) {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k)
                if (c + k < S) step(c + k, k, Llr());
            finish(c, S - c);
        } else {
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) step(c + k, k, Llr());
            finish(c, CHUNK);
        }
    }
}

// The shared-memory ceiling raised to what a block may use, and the SM's
// shared memory / L1 split set to the most shared memory, so that as many
// blocks are resident as their histories allow.
template <typename F>
cudaError_t set_attributes(F kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

template <typename V, bool EXT, bool PERM>
int launch_one(const typename Ops<V>::E* sys, const typename Ops<V>::E* par,
               const typename Ops<V>::E* beta_init, const int* perm, typename Ops<V>::E* out,
               int B, int K, int L, int T, int blocks, int smem, cudaStream_t st) {
    auto kernel = siso_kernel<V, EXT, PERM>;
    // the attributes are set once per device for this instance
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!raised[dev]) {
        err = set_attributes(kernel);
        if (err != cudaSuccess) return (int)err;
        raised[dev] = true;
    }
    kernel<<<blocks, LANES * GROUPS, smem, st>>>(sys, par, beta_init, perm, out, B, K, L, T);
    return (int)cudaGetLastError();
}

// The launch plan comes from the caller (ops/tdec_cuda.py siso_plan); it is
// checked against the shape and this kernel's layout here, and a plan that
// does not cover every window with as few blocks as it can, or whose shared
// bytes per block are not exactly what the layout uses, is refused with
// cudaErrorInvalidValue.
template <typename V>
int launch(const typename Ops<V>::E* sys, const typename Ops<V>::E* par,
           const typename Ops<V>::E* beta_init, const int* perm, typename Ops<V>::E* out,
           int B, int K, int L, int T, int blocks, int smem, int emit_ext, void* stream) {
    constexpr int NW = Ops<V>::kWin;
    if (B < 1 || K < 1 || L < 1 || T < 0) return (int)cudaErrorInvalidValue;
    const long long N = (long long)B * ((K + L - 1) / L);
    if (N + GROUPS * NW >= (1LL << 31) || (long long)B * K >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if ((long long)blocks * GROUPS * NW < N || (long long)(blocks - 1) * GROUPS * NW >= N ||
        (size_t)smem != smem_bytes_for(L, (int)sizeof(V)) || smem > MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (emit_ext) {
        if (perm) return launch_one<V, true, true>(sys, par, beta_init, perm, out, B, K, L, T, blocks, smem, st);
        return launch_one<V, true, false>(sys, par, beta_init, perm, out, B, K, L, T, blocks, smem, st);
    }
    if (perm) return launch_one<V, false, true>(sys, par, beta_init, perm, out, B, K, L, T, blocks, smem, st);
    return launch_one<V, false, false>(sys, par, beta_init, perm, out, B, K, L, T, blocks, smem, st);
}

template <typename V>
int blocks_per_sm(int emit_ext, int perm, int smem, int* result) {
    auto k = emit_ext ? (perm ? siso_kernel<V, true, true> : siso_kernel<V, true, false>)
                      : (perm ? siso_kernel<V, false, true> : siso_kernel<V, false, false>);
    cudaError_t err = set_attributes(k);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(result, k, LANES * GROUPS, smem);
}

}  // namespace

extern "C" int siso_windowed_launch(const float* sys, const float* par, const float* beta_init,
                                    const int* perm, float* out, int B, int K, int L, int T,
                                    int blocks, int smem, int emit_ext, void* stream) {
    return launch<float>(sys, par, beta_init, perm, out, B, K, L, T, blocks, smem, emit_ext,
                         stream);
}

extern "C" int siso_windowed_bf16_launch(const __nv_bfloat16* sys, const __nv_bfloat16* par,
                                         const __nv_bfloat16* beta_init, const int* perm,
                                         __nv_bfloat16* out, int B, int K, int L, int T,
                                         int blocks, int smem, int emit_ext, void* stream) {
    return launch<__nv_bfloat162>(sys, par, beta_init, perm, out, B, K, L, T, blocks, smem,
                                  emit_ext, stream);
}

// Resident blocks per SM of one kernel instance at `smem` dynamic shared
// bytes, as the runtime computes it (the occupancy the launch plan gets).
extern "C" int siso_windowed_blocks_per_sm(int bf16, int emit_ext, int perm, int smem,
                                           int* result) {
    return bf16 ? blocks_per_sm<__nv_bfloat162>(emit_ext, perm, smem, result)
                : blocks_per_sm<float>(emit_ext, perm, smem, result);
}
