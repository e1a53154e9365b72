// Batched soft Viterbi decoder for the LTE K=7 rate-1/3 convolutional code
// (generators 133/171/165 octal, 64 states), for sm_90a.
//
// Replaces the Pallas kernel srslte_tpu/ops/viterbi_pallas.py _viterbi_kernel
// (reached through viterbi_decode_pallas).
//
// The function.  Radix-2 add-compare-select without metric normalisation:
// new state sp takes a = m[2j] + g[code A] and b = m[2j+1] + g[code B],
// j = sp & 31, keeps max(a, b) and decides (b > a), so a tie keeps
// predecessor A; the end state is the FIRST maximum; the traceback is
// pred = (s & 31) << 1 | bit and emits u = s >> 5.  Tail-biting repeats the
// input 3 times from a uniform start and emits the middle copy; otherwise
// state 0 is pinned at the start (-1e9 elsewhere).  Branch metrics are sums
// of +-y built with negations and adds only, in the order
// (+-y0 + +-y1) + +-y2, as in the plain PyTorch version, so no multiply-add
// contraction can change a result and every tie falls the same way.
//
// What bounds it on an H100.  Operations: about 270 per candidate and
// trellis step (the bound's count) against 12 input bytes.  At the DL path's
// shape (the PDCCH blind search, 2304 candidates of 44 bits, 17-18 warps on
// every SM) the SMs' issue of each step's instructions is the limit; at the
// UL path's (128 long CQIs of 38 bits, one warp on each of 128 SMs) it is
// the latency of each candidate's chain of 3 len dependent steps (a
// shuffle, an add and a max), then the traceback's chain of 2 len steps.
//
// The design.
// - One warp per candidate, one warp per block (the blocks spread evenly
//   over the SMs).  Lane l holds the metrics of states l and l + 32.  Both
//   need m[2l] and m[2l+1]; the code's butterfly makes all four of their
//   branch metrics +-G for one G = g[code(l, 0)] (every generator has its
//   first and last tap, so flipping the input bit or the oldest register bit
//   flips all three coded bits, and g[7 - c] = -g[c] exactly).  A step is
//   then 2 shuffles, 4 adds and 2 max instead of 64 serial
//   add-compare-selects.
// - Two shuffles per step move the 64 metrics.  Lane l keeps its pair as
//   (P, Q) = (m[l], m[l+32]) on even lanes and (m[l+32], m[l]) on odd ones;
//   shuffle 1 reads P from lane (2l & 31) | (l >= 16) and shuffle 2 reads Q
//   from lane (2l & 31) | (l < 16), which gives every lane m[2l] and m[2l+1]
//   (swapped on lanes l >= 16).  The lane's sign of G absorbs both the
//   parity and the swap, so the chain from step to step is a shuffle, an add
//   and a max; which side is A only decides which side the decision reads.
// - Branch metrics are staged once per candidate: lane t & 31 reads step t's
//   three LLRs from device memory and writes its 8 metrics into shared
//   memory, and step 0's again after the last, so that the load one step
//   ahead needs no wrap-around; a step is then one shared load per lane, the
//   same for the three tail-biting copies.
// - Decisions by __ballot_sync: b > a is max(a, b) != a, one select and one
//   compare; the two ballot words of a step are regrouped into the words of
//   the low and high states (one logic operation each) and kept in shared
//   memory, 8 bytes per step, only for the steps the traceback walks (in
//   tail-biting, not those of the first copy).  Lane 0 stores them one step
//   late, so the in-order issue never holds the next step's shuffles behind
//   the vote.  Nothing goes through device memory but the LLRs and the bits.
// - The end state is a warp reduction over (metric, state) that keeps the
//   lower state on ties: the first maximum, as the sequential scan's.
// - The traceback stops at the first emitted step; its chain is one 64-bit
//   shift and one logic operation per step, the decision words are loaded
//   ahead of it, and the warp stores 32 bits at once.
//
// Shared memory per candidate: 32 (len + 1) bytes of branch metrics and 8
// bytes a step of decisions (2 len steps in tail-biting, len otherwise).
// The launch geometry comes from the caller (ops/viterbi_cuda.py
// viterbi_plan), which this file's launch checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CANDIDATES = 1;  // warps, one candidate each, per block
constexpr int MAX_SMEM = 232448;  // dynamic shared bytes a block may use on sm_90

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

// Decision steps kept for the traceback.
__host__ __device__ inline int dec_steps(int len, int tail_biting) {
    return tail_biting ? 2 * len : len;
}

struct Keep {
    static constexpr bool value = true;
};
struct Drop {
    static constexpr bool value = false;
};

// Decision words, then the branch metrics of len + 1 steps (the last a copy
// of step 0, for the load one step ahead at the end of a copy).
__host__ __device__ inline size_t smem_per_candidate(int len, int tail_biting) {
    return (size_t)8 * dec_steps(len, tail_biting) + (size_t)32 * (len + 1);
}

__global__ void __launch_bounds__(32 * CANDIDATES)
viterbi_kernel(const float* __restrict__ llr, uint8_t* __restrict__ bits, int B, int len,
               int tail_biting) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = blockIdx.x * CANDIDATES + warp;
    if (c >= B) return;  // a whole warp: no shuffle is left short
    const int D = dec_steps(len, tail_biting);
    unsigned char* mine = smem + (size_t)warp * smem_per_candidate(len, tail_biting);
    uint2* dec = reinterpret_cast<uint2*>(mine);  // [D] (low, high) decision words
    float* gt = reinterpret_cast<float*>(mine + (size_t)8 * D);  // [len + 1][8] branch metrics

    // Stage the branch metrics of every step, and step 0's again after the
    // last: lane t & 31 loads step t's three LLRs and writes its 8 metrics.
    const float* x = llr + (size_t)c * 3 * len;
#pragma unroll 4
    for (int t = lane; t <= len; t += 32) {
        const int u = t < len ? t : 0;
        const float y0 = __ldg(x + 3 * u), y1 = __ldg(x + 3 * u + 1), y2 = __ldg(x + 3 * u + 2);
        const float s[4] = {-y0 + -y1, -y0 + y1, y0 + -y1, y0 + y1};  // k >> 1
#pragma unroll
        for (int k = 0; k < 8; ++k) gt[8 * t + k] = s[k >> 1] + ((k & 1) ? y2 : -y2);
    }
    __syncwarp();

    const bool odd = lane & 1, upper = lane >= 16;
    const int src1 = ((2 * lane) & 31) | (upper ? 1 : 0);
    const int src2 = ((2 * lane) & 31) | (upper ? 0 : 1);
    // H = +-G: the parity and the swap each flip it
    const int kh = branch_code(lane, 0) ^ ((odd != upper) ? 7 : 0);
    float P = (tail_biting || lane == 0) ? 0.0f : NEG;
    float Q = tail_biting ? 0.0f : NEG;

    // One trellis step on input step i, whose branch metric H is already
    // loaded; the next step's is loaded first, ahead of the chain.  Keep()
    // also takes the step's decisions: b > a is max(a, b) != a (no NaN; -0
    // equals 0), and a is x on lanes l < 16, y on lanes l >= 16.  Lane 0
    // stores them at *d one step later, so that the next step's shuffles
    // never wait on the vote.
    float H = gt[kh];
    const bool first = lane == 0;
    // the even lanes' mask, as a register: each regrouped word is then one
    // 3-input logic operation
    const unsigned even = __ballot_sync(FULL, !odd);
    unsigned bp = 0, bq = 0;
    uint2* pending = dec;
    auto step = [&](int i, auto keep, uint2* d) {
        const float h = H;
        H = gt[8 * (i + 1) + kh];
        const float r1 = __shfl_sync(FULL, P, src1);
        const float r2 = __shfl_sync(FULL, Q, src2);
        const float xp = r1 + h, yp = r2 - h, xq = r1 - h, yq = r2 + h;
        P = fmaxf(xp, yp);
        Q = fmaxf(xq, yq);
        if (decltype(keep)::value) {
            // bit l of bp is the decision of state l (even l) or l + 32
            // (odd l): regrouped into the low and high states' words
            if (first) *pending = make_uint2((bp & even) | (bq & ~even), (bq & even) | (bp & ~even));
            bp = __ballot_sync(FULL, P != (upper ? yp : xp));
            bq = __ballot_sync(FULL, Q != (upper ? yq : xq));
            pending = d;
        }
    };

    if (tail_biting) {  // the first copy only brings the metrics to a start
#pragma unroll 4
        for (int i = 0; i < len; ++i) step(i, Drop(), dec);
    }
    for (int r = 0; r < D; r += len) {
#pragma unroll 4
        for (int i = 0; i < len; ++i) step(i, Keep(), dec + r + i);
    }
    if (first) *pending = make_uint2((bp & even) | (bq & ~even), (bq & even) | (bp & ~even));

    // The end state: the first maximum over the 64 states.
    const float lo = odd ? Q : P, hi = odd ? P : Q;  // states lane, lane + 32
    float best = lo;
    int state = lane;
    if (hi > lo) {
        best = hi;
        state = lane + 32;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const int os = __shfl_xor_sync(FULL, state, off);
        if (ob > best || (ob == best && os < state)) {
            best = ob;
            state = os;
        }
    }
    __syncwarp();  // the decision words are seen by every lane

    // Traceback from the last step to the first emitted one (step 0 of dec:
    // the middle copy in tail-biting).  The chain is a 64-bit shift and a
    // logic operation per step; the bits of 32 steps gather in one register
    // and go out in one store.
    const unsigned long long* dec64 = reinterpret_cast<const unsigned long long*>(dec);
    uint8_t* out = bits + (size_t)c * len;
    for (int base = (D - 1) & ~31; base >= 0; base -= 32) {
        unsigned acc = 0;  // bit k: the bit of step base + k
        const int top = min(base + 31, D - 1);
#pragma unroll 8
        for (int d = top; d >= base; --d) {
            acc = (acc << 1) | (unsigned)(state >> 5);
            state = ((state << 1) & 62) | (int)((dec64[d] >> state) & 1ull);
        }
        if (base + lane < len) out[base + lane] = (uint8_t)((acc >> lane) & 1u);
    }
}

cudaError_t set_attributes() {
    return cudaFuncSetAttribute(viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                MAX_SMEM);
}

}  // namespace

// The launch plan comes from the caller (ops/viterbi_cuda.py viterbi_plan);
// a plan whose blocks do not cover every candidate with as few blocks as
// they can, or whose shared bytes per block are not exactly what the layout
// uses, is refused with cudaErrorInvalidValue.
extern "C" int viterbi_launch(const float* llr, uint8_t* bits, int B, int len, int tail_biting,
                              int blocks, int smem, void* stream) {
    if (B < 1 || len < 1 || (long long)B * 3 * len >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if ((long long)blocks * CANDIDATES < B || (long long)(blocks - 1) * CANDIDATES >= B ||
        (size_t)smem != CANDIDATES * smem_per_candidate(len, tail_biting) || smem > MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    // the shared-memory ceiling is raised once per device
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!raised[dev]) {
        err = set_attributes();
        if (err != cudaSuccess) return (int)err;
        raised[dev] = true;
    }
    viterbi_kernel<<<blocks, 32 * CANDIDATES, smem, (cudaStream_t)stream>>>(
        llr, bits, B, len, tail_biting ? 1 : 0);
    return (int)cudaGetLastError();
}

// Resident blocks per SM at `smem` dynamic shared bytes, as the runtime
// computes it (a measurement aid; launches nothing).
extern "C" int viterbi_blocks_per_sm(int smem, int* result) {
    cudaError_t err = set_attributes();
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(result, viterbi_kernel,
                                                              32 * CANDIDATES, smem);
}
