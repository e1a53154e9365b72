// Batched soft Viterbi decoder for the LTE K=7 rate-1/3 convolutional code
// (generators 133/171/165 octal, 64 states), for sm_90a.
//
// One thread decodes one candidate.  Its 64 path metrics are indexed only by
// compile-time constants, so they stay in registers; the 64 decisions of a
// step are packed into one 64-bit word in a scratch tensor laid out
// [step][candidate]; the traceback is integer arithmetic on that word.
//
// Semantics: radix-2 add-compare-select without metric normalisation; the
// decision is (b > a), so a tie keeps predecessor A = 2j; the end state is the
// FIRST maximum; traceback pred = (s mod 32) * 2 + bit, emitted bit
// u = (s >= 32).  Tail-biting repeats the input 3 times from a uniform start
// and emits the middle copy; otherwise state 0 is pinned at the start.
//
// Branch metrics are sums of +-y built with negations and adds only, in the
// order (+-y0 + +-y1) + +-y2, the same as the plain PyTorch version, so no
// multiply-add contraction can change a result and every tie falls the same
// way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;

__host__ __device__ constexpr int parity(int x) {
    x ^= x >> 4;
    x ^= x >> 2;
    x ^= x >> 1;
    return x & 1;
}

// Coded bits (o0 o1 o2 packed MSB first) on the branch into state sp from
// its predecessor ((sp & 31) << 1) | b; the register is (u << 6) | pred with
// u = sp >> 5.
__host__ __device__ constexpr int branch_code(int sp, int b) {
    const int reg = ((sp >> 5) << 6) | ((sp & 31) << 1) | b;
    return (parity(reg & 0133) << 2) | (parity(reg & 0171) << 1) | parity(reg & 0165);
}

__global__ void __launch_bounds__(32)
viterbi_kernel(const float* __restrict__ llr, uint8_t* __restrict__ bits,
               unsigned long long* __restrict__ dec, int B, int len, int reps,
               int emit_lo, int known_start) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= B) return;
    const float* x = llr + (size_t)c * 3 * len;
    const int T = reps * len;

    float m[64], nm[64];
#pragma unroll
    for (int s = 0; s < 64; ++s) m[s] = (known_start && s != 0) ? NEG : 0.0f;

    int tt = 0;  // t mod len
    for (int t = 0; t < T; ++t) {
        const float y0 = x[3 * tt], y1 = x[3 * tt + 1], y2 = x[3 * tt + 2];
        if (++tt == len) tt = 0;
        float g[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            g[k] = (((k & 4) ? y0 : -y0) + ((k & 2) ? y1 : -y1)) + ((k & 1) ? y2 : -y2);
        unsigned lo = 0, hi = 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const float ma = m[2 * j], mb = m[2 * j + 1];
            const float a0 = ma + g[branch_code(j, 0)];
            const float b0 = mb + g[branch_code(j, 1)];
            nm[j] = fmaxf(a0, b0);
            lo |= (unsigned)(b0 > a0) << j;
            const float a1 = ma + g[branch_code(j + 32, 0)];
            const float b1 = mb + g[branch_code(j + 32, 1)];
            nm[j + 32] = fmaxf(a1, b1);
            hi |= (unsigned)(b1 > a1) << j;
        }
#pragma unroll
        for (int s = 0; s < 64; ++s) m[s] = nm[s];
        dec[(size_t)t * B + c] = ((unsigned long long)hi << 32) | lo;
    }

    float best = m[0];
    int state = 0;
#pragma unroll
    for (int s = 1; s < 64; ++s) {
        if (m[s] > best) {
            best = m[s];
            state = s;
        }
    }

    uint8_t* out = bits + (size_t)c * len;
    for (int t = T - 1; t >= 0; --t) {
        if (t >= emit_lo && t < emit_lo + len) out[t - emit_lo] = (uint8_t)(state >> 5);
        const int bit = (int)((dec[(size_t)t * B + c] >> state) & 1ULL);
        state = ((state & 31) << 1) | bit;
    }
}

}  // namespace

// dec is scratch of reps * len * B 64-bit words.
extern "C" int viterbi_launch(const float* llr, uint8_t* bits, unsigned long long* dec,
                              int B, int len, int tail_biting, void* stream) {
    const int reps = tail_biting ? 3 : 1;
    const int emit_lo = tail_biting ? len : 0;
    const int threads = 32;
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    viterbi_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        llr, bits, dec, B, len, reps, emit_lo, tail_biting ? 0 : 1);
    return (int)cudaGetLastError();
}
