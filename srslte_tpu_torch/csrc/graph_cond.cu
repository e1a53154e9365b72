// Conditional nodes in a CUDA graph under capture: the card's side of
// `utils/jit.py` `cond`, the counterpart of `jax.lax.cond`
// (srslte_tpu/phy/phch/dlsch.py:271-284 picks the DL-SCH cascade's branches
// with it).  It replaces no Pallas kernel: the JAX package compiles
// `lax.cond` into one device program, and this is how one CUDA graph holds
// both branches.
//
// cond_begin_if, called while `capturing` is captured into a graph: a
// conditional handle of that graph, a one-thread kernel on `capturing` that
// sets the handle from the bool at `pred` (negated if `negate`), an IF node
// after it, and `body` (another stream) captured into the node's body graph
// until cond_end_if.  The capture of `capturing` continues after the node,
// so what follows runs after the body.  On replay the kernel reads the
// predicate on the card and the node runs its body only where it holds: no
// host read.  Bodies nest (the capturing stream of an inner one is the body
// stream of the outer).  Allocations inside a body are the caller's to route
// to the graph's memory pool.
//
// What bounds it.  One byte read and one handle written per node and
// replay: the launch of the one-thread kernel (a few microseconds of the
// card's launch latency inside a graph), nothing the memory or the SMs set.

#include <cuda_runtime.h>

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* pred,
                                       int negate) {
    cudaGraphSetConditional(handle, (*pred ? 1u : 0u) ^ (negate ? 1u : 0u));
}

extern "C" int cond_begin_if(void* capturing, const void* pred, int negate, void* body,
                             int mode) {
    cudaStream_t s = (cudaStream_t)capturing;
    cudaStreamCaptureStatus status;
    unsigned long long id = 0;
    cudaGraph_t graph = nullptr;
    const cudaGraphNode_t* deps = nullptr;
    size_t ndeps = 0;
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &ndeps);
    if (err != cudaSuccess) return (int)err;
    if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureUnmatched;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return (int)err;
    set_conditional_kernel<<<1, 1, 0, s>>>(handle, (const bool*)pred, negate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // the node depends on what the stream's capture would run next after
    // the kernel
    err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &ndeps);
    if (err != cudaSuccess) return (int)err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body, params.conditional.phGraph_out[0],
                                              nullptr, nullptr, 0, (cudaStreamCaptureMode)mode);
}

extern "C" int cond_end_if(void* body) {
    cudaGraph_t g = nullptr;  // the node's body graph, which the node owns
    return (int)cudaStreamEndCapture((cudaStream_t)body, &g);
}

// cudaStreamCaptureMode's values, for the caller
extern "C" int cond_capture_mode(const char* name) {
    if (name[0] == 'g') return (int)cudaStreamCaptureModeGlobal;
    if (name[0] == 't') return (int)cudaStreamCaptureModeThreadLocal;
    return (int)cudaStreamCaptureModeRelaxed;
}
