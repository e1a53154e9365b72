// Windowed max-log-MAP SISO of the LTE PCCC constituent code, for sm_90a,
// with float32 metrics or with 16-bit (bfloat16) metrics.
//
// 8-state RSC, g0 = 1+D^2+D^3 (feedback), g1 = 1+D+D^3.  One thread decodes
// one window of L positions with T-step training halos on both sides:
// positions wL-T .. wL+L+T-1 of code block b.  The alpha recursion runs
// forward and the beta recursion backward in ONE merged loop of T+L steps;
// the LLR of a position is written by whichever recursion reaches it second,
// from the other recursion's stored metrics.  The 8 alpha and 8 beta metrics
// stay in registers; the two metric histories live in a scratch tensor laid
// out [step][state][window], so the 32 threads of a warp touch neighbouring
// addresses.  Inputs are read straight from the [B, K] tensors, the
// systematic stream through an optional permutation (the QPP interleave).
//
// Window 0 starts exactly in state 0, the last window's beta starts from the
// tail termination (beta_init), positions outside [0, K) carry the metrics
// through unchanged.
//
// The 16-bit variant replaces the bfloat16 run of the TPU kernel
// (srslte_tpu/ops/tdec_pallas.py _siso_kernel with dtype=bfloat16, and its
// window glue prepare_windows / prepare_windows_roll / prepare_beta_init /
// take_windows / siso_from_windows).  It is the same kernel templated on the
// metric type: bfloat16 inputs, metrics, histories and output, and after
// each step's select both metric vectors are re-pinned to state 0
// (M[s] - M[0], state 0 exactly 0), since bfloat16's 8 mantissa bits cannot
// hold metrics that grow over L + 2T steps.  The last window's beta starts
// from the cast tail beta, not normalised before its first step.  Every
// operation is one bfloat16 intrinsic (__hadd, __hsub, __hmax), each
// rounded once, so the result equals a plain version written with PyTorch
// bfloat16 tensor ops, one op per op.  One window per thread, as in the
// float32 kernel: the scratch history is half the bytes; two windows per
// thread in __nv_bfloat162 (the counterpart of the TPU's packed (16, 128)
// tile) is later work, since the kernel is bound by the latency of its
// dependent steps and its history traffic, not by instruction count.
//
// The arithmetic is adds, subtractions and max only, in the order of the
// plain PyTorch version (m = max_s(A[s] + (B[n] + g))), so no
// multiply-add contraction can change a result and the outputs agree with
// the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;

// The metric type's operations; kNorm re-pins the metrics to state 0 after
// every step.
template <typename M>
struct Ops;

template <>
struct Ops<float> {
    static constexpr bool kNorm = false;
    static __device__ __forceinline__ float zero() { return 0.0f; }
    static __device__ __forceinline__ float neg() { return NEG; }
    static __device__ __forceinline__ float add(float a, float b) { return a + b; }
    static __device__ __forceinline__ float sub(float a, float b) { return a - b; }
    static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
};

template <>
struct Ops<__nv_bfloat16> {
    using M = __nv_bfloat16;
    static constexpr bool kNorm = true;
    static __device__ __forceinline__ M zero() { return __float2bfloat16_rn(0.0f); }
    static __device__ __forceinline__ M neg() { return __float2bfloat16_rn(NEG); }
    static __device__ __forceinline__ M add(M a, M b) { return __hadd(a, b); }
    static __device__ __forceinline__ M sub(M a, M b) { return __hsub(a, b); }
    static __device__ __forceinline__ M max(M a, M b) { return __hmax(a, b); }
};

// Closed forms of the trellis (state s = s0*4 + s1*2 + s2, s0 newest).
// Into state sp, dropping bit b: predecessor, input bit, parity bit.
__host__ __device__ constexpr int pred_state(int sp, int b) { return ((sp & 3) << 1) | b; }
__host__ __device__ constexpr int pred_u(int sp, int b) { return ((sp >> 2) ^ sp ^ b) & 1; }
__host__ __device__ constexpr int pred_p(int sp, int b) { return ((sp >> 2) ^ (sp >> 1) ^ b) & 1; }
// From state s with input 0: next state and parity; input 1 flips bit 2 of
// the next state and the parity.
__host__ __device__ constexpr int succ0(int s) { return (s >> 1) | (((s ^ (s >> 1)) & 1) << 2); }
__host__ __device__ constexpr int par0(int s) { return ((s >> 1) ^ (s >> 2)) & 1; }

// gamma by (u << 1) | p: 0, pr, sa, sa + pr
template <typename M>
struct Gamma {
    M g[4];
    __device__ Gamma(M sa, M pr) : g{Ops<M>::zero(), pr, sa, Ops<M>::add(sa, pr)} {}
};

template <typename M>
__device__ __forceinline__ void alpha_step(const M (&A)[8], const Gamma<M>& gm, M (&out)[8]) {
    using O = Ops<M>;
#pragma unroll
    for (int sp = 0; sp < 8; ++sp) {
        const M ra = O::add(A[pred_state(sp, 0)], gm.g[(pred_u(sp, 0) << 1) | pred_p(sp, 0)]);
        const M rb = O::add(A[pred_state(sp, 1)], gm.g[(pred_u(sp, 1) << 1) | pred_p(sp, 1)]);
        out[sp] = O::max(ra, rb);
    }
}

template <typename M>
__device__ __forceinline__ void beta_branches(const M (&Bm)[8], const Gamma<M>& gm,
                                              M (&r0)[8], M (&r1)[8]) {
    using O = Ops<M>;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        r0[s] = O::add(Bm[succ0(s)], gm.g[par0(s)]);
        r1[s] = O::add(Bm[succ0(s) ^ 4], gm.g[2 | (par0(s) ^ 1)]);
    }
}

template <typename M>
__device__ __forceinline__ M llr_of(const M (&A)[8], const M (&r0)[8], const M (&r1)[8]) {
    using O = Ops<M>;
    M m0 = O::add(A[0], r0[0]);
    M m1 = O::add(A[0], r1[0]);
#pragma unroll
    for (int s = 1; s < 8; ++s) {
        m0 = O::max(m0, O::add(A[s], r0[s]));
        m1 = O::max(m1, O::add(A[s], r1[s]));
    }
    return O::sub(m1, m0);
}

// M[s] - M[0] for every s: state 0 becomes exactly 0.
template <typename M>
__device__ __forceinline__ void pin_state0(M (&X)[8]) {
    using O = Ops<M>;
    const M x0 = X[0];
#pragma unroll
    for (int s = 0; s < 8; ++s) X[s] = O::sub(X[s], x0);
}

template <typename M, bool EXT, bool PERM>
__global__ void __launch_bounds__(128)
siso_kernel(const M* __restrict__ sys, const M* __restrict__ par,
            const M* __restrict__ beta_init, const int* __restrict__ perm,
            M* __restrict__ out, M* __restrict__ a_hist, M* __restrict__ b_hist,
            int B, int K, int W, int L, int T) {
    using O = Ops<M>;
    const size_t N = (size_t)B * W;
    const size_t n = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const int b = (int)(n / W);
    const int w = (int)(n % W);
    const M* sys_b = sys + (size_t)b * K;
    const M* par_b = par + (size_t)b * K;
    M* out_b = out + (size_t)b * K;

    const int LT = L + 2 * T;
    const int S = T + L;                  // merged loop steps
    const int half = (LT - 1) / 2 + 1;    // first t the alpha side finishes
    const int base = w * L - T;           // position of window step 0

    M A[8], Bm[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        A[s] = (s != 0 && w == 0) ? O::neg() : O::zero();
        Bm[s] = (w == W - 1) ? beta_init[(size_t)b * 8 + s] : O::zero();
    }

    for (int i = 0; i < S; ++i) {
        const int t_a = i;
        const int t_b = LT - 1 - i;
        const int pa = base + t_a;
        const int pb = base + t_b;
        const bool live_a = pa >= 0 && pa < K;
        const bool live_b = pb >= 0 && pb < K;
        M sa_a = O::zero(), pr_a = O::zero(), sa_b = O::zero(), pr_b = O::zero();
        if (live_a) {
            sa_a = sys_b[PERM ? perm[pa] : pa];
            pr_a = par_b[pa];
        }
        if (live_b) {
            sa_b = sys_b[PERM ? perm[pb] : pb];
            pr_b = par_b[pb];
        }

        // ---- alpha at t_a: A holds the metrics BEFORE position t_a
        if (t_a < half) {
#pragma unroll
            for (int s = 0; s < 8; ++s) a_hist[((size_t)t_a * 8 + s) * N + n] = A[s];
        }
        const Gamma<M> ga(sa_a, pr_a);
        M ra[8];
        alpha_step(A, ga, ra);
        if (t_a >= half) {  // beta history of t_a is complete: finish its LLR
            M Bh[8], r0[8], r1[8];
#pragma unroll
            for (int s = 0; s < 8; ++s) Bh[s] = b_hist[((size_t)(t_a - half) * 8 + s) * N + n];
            beta_branches(Bh, ga, r0, r1);
            const M llr = llr_of(A, r0, r1);
            if (live_a) out_b[pa] = EXT ? O::sub(llr, sa_a) : llr;
        }
        if (live_a) {
#pragma unroll
            for (int s = 0; s < 8; ++s) A[s] = ra[s];
        }
        if (O::kNorm) pin_state0(A);

        // ---- beta at t_b: Bm holds the metrics AFTER position t_b
        if (t_b >= half && t_b < S) {
#pragma unroll
            for (int s = 0; s < 8; ++s) b_hist[((size_t)(t_b - half) * 8 + s) * N + n] = Bm[s];
        }
        const Gamma<M> gb(sa_b, pr_b);
        M r0[8], r1[8];
        beta_branches(Bm, gb, r0, r1);
        if (t_b >= T && t_b < half) {  // alpha history of t_b is complete
            M Ah[8];
#pragma unroll
            for (int s = 0; s < 8; ++s) Ah[s] = a_hist[((size_t)t_b * 8 + s) * N + n];
            const M llr = llr_of(Ah, r0, r1);
            if (live_b) out_b[pb] = EXT ? O::sub(llr, sa_b) : llr;
        }
        if (live_b) {
#pragma unroll
            for (int s = 0; s < 8; ++s) Bm[s] = O::max(r0[s], r1[s]);
        }
        if (O::kNorm) pin_state0(Bm);
    }
}

// scratch holds (T + L) * 8 * B * W metrics: the alpha history of steps
// [0, half) followed by the beta history of steps [half, T + L).
template <typename M>
int launch(const M* sys, const M* par, const M* beta_init, const int* perm, M* out,
           M* scratch, int B, int K, int L, int T, int emit_ext, void* stream) {
    const int W = (K + L - 1) / L;
    const size_t N = (size_t)B * W;
    const int half = (L + 2 * T - 1) / 2 + 1;
    M* a_hist = scratch;
    M* b_hist = scratch + (size_t)half * 8 * N;
    const int threads = 128;
    const unsigned blocks = (unsigned)((N + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    if (emit_ext) {
        if (perm) siso_kernel<M, true, true><<<blocks, threads, 0, st>>>(sys, par, beta_init, perm, out, a_hist, b_hist, B, K, W, L, T);
        else siso_kernel<M, true, false><<<blocks, threads, 0, st>>>(sys, par, beta_init, perm, out, a_hist, b_hist, B, K, W, L, T);
    } else {
        if (perm) siso_kernel<M, false, true><<<blocks, threads, 0, st>>>(sys, par, beta_init, perm, out, a_hist, b_hist, B, K, W, L, T);
        else siso_kernel<M, false, false><<<blocks, threads, 0, st>>>(sys, par, beta_init, perm, out, a_hist, b_hist, B, K, W, L, T);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int siso_windowed_launch(const float* sys, const float* par, const float* beta_init,
                                    const int* perm, float* out, float* scratch,
                                    int B, int K, int L, int T, int emit_ext, void* stream) {
    return launch<float>(sys, par, beta_init, perm, out, scratch, B, K, L, T, emit_ext, stream);
}

extern "C" int siso_windowed_bf16_launch(const __nv_bfloat16* sys, const __nv_bfloat16* par,
                                         const __nv_bfloat16* beta_init, const int* perm,
                                         __nv_bfloat16* out, __nv_bfloat16* scratch,
                                         int B, int K, int L, int T, int emit_ext, void* stream) {
    return launch<__nv_bfloat16>(sys, par, beta_init, perm, out, scratch, B, K, L, T, emit_ext,
                                 stream);
}
