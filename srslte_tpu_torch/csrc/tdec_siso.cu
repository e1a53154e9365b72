// Windowed max-log-MAP SISO of the LTE PCCC constituent code, for sm_90a.
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
// The arithmetic is adds, subtractions and max only, in the order of the
// plain PyTorch version (m = max_s(A[s] + (B[n] + g))), so no
// multiply-add contraction can change a result and float32 outputs agree
// with the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;

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
struct Gamma {
    float g[4];
    __device__ Gamma(float sa, float pr) : g{0.0f, pr, sa, sa + pr} {}
};

__device__ __forceinline__ void alpha_step(const float (&A)[8], const Gamma& gm, float (&out)[8]) {
#pragma unroll
    for (int sp = 0; sp < 8; ++sp) {
        const float ra = A[pred_state(sp, 0)] + gm.g[(pred_u(sp, 0) << 1) | pred_p(sp, 0)];
        const float rb = A[pred_state(sp, 1)] + gm.g[(pred_u(sp, 1) << 1) | pred_p(sp, 1)];
        out[sp] = fmaxf(ra, rb);
    }
}

__device__ __forceinline__ void beta_branches(const float (&Bm)[8], const Gamma& gm,
                                              float (&r0)[8], float (&r1)[8]) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        r0[s] = Bm[succ0(s)] + gm.g[par0(s)];
        r1[s] = Bm[succ0(s) ^ 4] + gm.g[2 | (par0(s) ^ 1)];
    }
}

__device__ __forceinline__ float llr_of(const float (&A)[8], const float (&r0)[8],
                                        const float (&r1)[8]) {
    float m0 = A[0] + r0[0];
    float m1 = A[0] + r1[0];
#pragma unroll
    for (int s = 1; s < 8; ++s) {
        m0 = fmaxf(m0, A[s] + r0[s]);
        m1 = fmaxf(m1, A[s] + r1[s]);
    }
    return m1 - m0;
}

template <bool EXT, bool PERM>
__global__ void __launch_bounds__(128)
siso_kernel(const float* __restrict__ sys, const float* __restrict__ par,
            const float* __restrict__ beta_init, const int* __restrict__ perm,
            float* __restrict__ out, float* __restrict__ a_hist, float* __restrict__ b_hist,
            int B, int K, int W, int L, int T) {
    const size_t N = (size_t)B * W;
    const size_t n = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const int b = (int)(n / W);
    const int w = (int)(n % W);
    const float* sys_b = sys + (size_t)b * K;
    const float* par_b = par + (size_t)b * K;
    float* out_b = out + (size_t)b * K;

    const int LT = L + 2 * T;
    const int S = T + L;                  // merged loop steps
    const int half = (LT - 1) / 2 + 1;    // first t the alpha side finishes
    const int base = w * L - T;           // position of window step 0

    float A[8], Bm[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        A[s] = (s != 0 && w == 0) ? NEG : 0.0f;
        Bm[s] = (w == W - 1) ? beta_init[(size_t)b * 8 + s] : 0.0f;
    }

    for (int i = 0; i < S; ++i) {
        const int t_a = i;
        const int t_b = LT - 1 - i;
        const int pa = base + t_a;
        const int pb = base + t_b;
        const bool live_a = pa >= 0 && pa < K;
        const bool live_b = pb >= 0 && pb < K;
        float sa_a = 0.0f, pr_a = 0.0f, sa_b = 0.0f, pr_b = 0.0f;
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
        const Gamma ga(sa_a, pr_a);
        float ra[8];
        alpha_step(A, ga, ra);
        if (t_a >= half) {  // beta history of t_a is complete: finish its LLR
            float Bh[8], r0[8], r1[8];
#pragma unroll
            for (int s = 0; s < 8; ++s) Bh[s] = b_hist[((size_t)(t_a - half) * 8 + s) * N + n];
            beta_branches(Bh, ga, r0, r1);
            const float llr = llr_of(A, r0, r1);
            if (live_a) out_b[pa] = EXT ? llr - sa_a : llr;
        }
        if (live_a) {
#pragma unroll
            for (int s = 0; s < 8; ++s) A[s] = ra[s];
        }

        // ---- beta at t_b: Bm holds the metrics AFTER position t_b
        if (t_b >= half && t_b < S) {
#pragma unroll
            for (int s = 0; s < 8; ++s) b_hist[((size_t)(t_b - half) * 8 + s) * N + n] = Bm[s];
        }
        const Gamma gb(sa_b, pr_b);
        float r0[8], r1[8];
        beta_branches(Bm, gb, r0, r1);
        if (t_b >= T && t_b < half) {  // alpha history of t_b is complete
            float Ah[8];
#pragma unroll
            for (int s = 0; s < 8; ++s) Ah[s] = a_hist[((size_t)t_b * 8 + s) * N + n];
            const float llr = llr_of(Ah, r0, r1);
            if (live_b) out_b[pb] = EXT ? llr - sa_b : llr;
        }
        if (live_b) {
#pragma unroll
            for (int s = 0; s < 8; ++s) Bm[s] = fmaxf(r0[s], r1[s]);
        }
    }
}

}  // namespace

// scratch holds (T + L) * 8 * B * W floats: the alpha history of steps
// [0, half) followed by the beta history of steps [half, T + L).
extern "C" int siso_windowed_launch(const float* sys, const float* par, const float* beta_init,
                                    const int* perm, float* out, float* scratch,
                                    int B, int K, int L, int T, int emit_ext, void* stream) {
    const int W = (K + L - 1) / L;
    const size_t N = (size_t)B * W;
    const int half = (L + 2 * T - 1) / 2 + 1;
    float* a_hist = scratch;
    float* b_hist = scratch + (size_t)half * 8 * N;
    const int threads = 128;
    const unsigned blocks = (unsigned)((N + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    if (emit_ext) {
        if (perm) siso_kernel<true, true><<<blocks, threads, 0, st>>>(sys, par, beta_init, perm, out, a_hist, b_hist, B, K, W, L, T);
        else siso_kernel<true, false><<<blocks, threads, 0, st>>>(sys, par, beta_init, perm, out, a_hist, b_hist, B, K, W, L, T);
    } else {
        if (perm) siso_kernel<false, true><<<blocks, threads, 0, st>>>(sys, par, beta_init, perm, out, a_hist, b_hist, B, K, W, L, T);
        else siso_kernel<false, false><<<blocks, threads, 0, st>>>(sys, par, beta_init, perm, out, a_hist, b_hist, B, K, W, L, T);
    }
    return (int)cudaGetLastError();
}
