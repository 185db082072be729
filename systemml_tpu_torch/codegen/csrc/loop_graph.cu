// Device-side loop control for CUDA graphs: the WHILE and IF conditional
// nodes that a fused loop region (runtime/loopfuse.py) is captured into,
// and the one kernel that drives them, set_cond.
//
// No Pallas counterpart. The JAX package lowers a DML loop to
// lax.while_loop / lax.cond / lax.fori_loop (systemml_tpu/runtime/
// loopfuse.py: _trace_while, _trace_if, _trace_for) and XLA evaluates the
// loop condition on the TPU itself. A CUDA graph has no such primitive
// until CUDA 12.3/12.4: a conditional node whose body graph runs while (or
// if) a 32-bit handle value is non-zero, the value set from device code by
// cudaGraphSetConditional. set_cond reads a 0-d predicate tensor the
// captured body computed and sets the handle, so a loop's trip count is
// decided on the card with no host round trip.
//
// Bound: set_cond reads one scalar and writes nothing to device memory; its
// time is a launch's fixed cost inside the graph (a few microseconds), not
// bytes or operations. What the design does about it: one thread, no
// shared memory, and it runs once per iteration beside the body's kernels.
//
// How a node is made (the host functions below; plain C, loaded by
// ctypes, so that nvcc builds this file in seconds):
//   1. smtorch_lg_begin_node on the stream S that is capturing the
//      enclosing graph: creates a conditional handle in that graph,
//      captures set_cond(handle, pred) on S (the entry test), adds the
//      conditional node after it, makes the node S's only capture
//      dependency, and begins capturing the body stream B into the node's
//      body graph;
//   2. the caller captures the body on B (torch ops, the port's kernels);
//   3. smtorch_lg_end_node captures set_cond(handle, pred') on B for a
//      WHILE node (the test after each iteration) and ends B's capture.
// Nested loops nest the same way: a body stream that is capturing is the
// S of an inner node. The whole region is one graph, instantiated once and
// launched with one cudaGraphLaunch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <cstdio>

#if CUDART_VERSION < 12040
#error "conditional graph nodes need CUDA 12.4 or later"
#endif

namespace {

// dtype codes: 0 bool/uint8, 1 float, 2 double, 3 int64, 4 int32
template <typename T>
__global__ void set_cond(cudaGraphConditionalHandle handle, const T* pred,
                         int negate) {
  const bool v = pred[0] != T(0);
  cudaGraphSetConditional(handle, (v != (negate != 0)) ? 1u : 0u);
}

cudaError_t launch_set_cond(cudaStream_t s, cudaGraphConditionalHandle h,
                            const void* pred, int dtype, int negate) {
  switch (dtype) {
    case 0:
      set_cond<uint8_t><<<1, 1, 0, s>>>(h, (const uint8_t*)pred, negate);
      break;
    case 1:
      set_cond<float><<<1, 1, 0, s>>>(h, (const float*)pred, negate);
      break;
    case 2:
      set_cond<double><<<1, 1, 0, s>>>(h, (const double*)pred, negate);
      break;
    case 3:
      set_cond<long long><<<1, 1, 0, s>>>(h, (const long long*)pred, negate);
      break;
    case 4:
      set_cond<int><<<1, 1, 0, s>>>(h, (const int*)pred, negate);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The capture API took edge data in CUDA 12.3 (the *_v2/_v3 names) and
// folded it into the plain names in CUDA 13.
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* st,
                         cudaGraph_t* g, const cudaGraphNode_t** deps,
                         size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, st, nullptr, g, deps, nullptr, n);
#else
  return cudaStreamGetCaptureInfo(s, st, nullptr, g, deps, n);
#endif
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t g,
                     const cudaGraphNode_t* deps, size_t n,
                     cudaGraphNodeParams* p) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, g, deps, nullptr, n, p);
#else
  return cudaGraphAddNode(node, g, deps, n, p);
#endif
}

cudaError_t set_deps(cudaStream_t s, cudaGraphNode_t* node) {
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(s, node, nullptr, 1,
                                             cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(s, node, 1,
                                             cudaStreamSetCaptureDependencies);
#endif
}

}  // namespace

extern "C" {

// The CUDA runtime this library was built against and the driver's.
int smtorch_lg_versions(int* runtime, int* driver) {
  cudaError_t e = cudaRuntimeGetVersion(runtime);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDriverGetVersion(driver);
}

// Begins capturing `stream` into a new graph. mode: 0 global, 1 thread
// local, 2 relaxed (cudaStreamCaptureMode).
int smtorch_lg_capture_begin(void* stream, int mode) {
  return (int)cudaStreamBeginCapture((cudaStream_t)stream,
                                     (cudaStreamCaptureMode)mode);
}

// Ends the capture of `stream`; *graph receives the graph.
int smtorch_lg_capture_end(void* stream, void** graph) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaStreamEndCapture((cudaStream_t)stream, &g);
  *graph = (void*)g;
  return (int)e;
}

// Step 1 above. type 0 = IF, 1 = WHILE. The entry test reads `pred` (dtype
// code as set_cond's) on `stream`; negate 1 tests pred == 0 (an else
// branch). *handle receives the conditional handle for smtorch_lg_end_node.
int smtorch_lg_begin_node(void* stream, void* body_stream, int type,
                          const void* pred, int dtype, int negate,
                          unsigned long long* handle) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus st;
  cudaGraph_t g = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t e = capture_info(s, &st, &g, &deps, &n);
  if (e != cudaSuccess) return (int)e;
  if (st != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (e != cudaSuccess) return (int)e;
  e = launch_set_cond(s, h, pred, dtype, negate);
  if (e != cudaSuccess) return (int)e;
  e = capture_info(s, &st, &g, &deps, &n);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  e = add_node(&node, g, deps, n, &p);
  if (e != cudaSuccess) return (int)e;
  e = set_deps(s, &node);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                    p.conditional.phGraph_out[0], nullptr,
                                    nullptr, 0, cudaStreamCaptureModeRelaxed);
  if (e != cudaSuccess) return (int)e;
  *handle = (unsigned long long)h;
  return 0;
}

// Step 3 above: for a WHILE node (type 1) the test after each iteration
// reads `pred` on the body stream; then the body's capture ends.
int smtorch_lg_end_node(void* body_stream, int type, unsigned long long handle,
                        const void* pred, int dtype) {
  cudaStream_t b = (cudaStream_t)body_stream;
  if (type == 1) {
    cudaError_t e = launch_set_cond(b, (cudaGraphConditionalHandle)handle,
                                    pred, dtype, 0);
    if (e != cudaSuccess) return (int)e;
  }
  cudaGraph_t g = nullptr;
  return (int)cudaStreamEndCapture(b, &g);
}

// Instantiates `graph`. On a failure *result receives the
// cudaGraphInstantiateResult, *node_type the cudaGraphNodeType of the
// node at fault (-1: none named) and `name` (of `cap` bytes) the kernel's
// name where that node is a kernel, its bytes where it is an allocation.
int smtorch_lg_instantiate(void* graph, void** exec, int* result,
                           int* node_type, char* name, int cap) {
  cudaGraphExec_t x = nullptr;
  cudaGraphInstantiateParams p = {};
  cudaError_t e = cudaGraphInstantiateWithParams(&x, (cudaGraph_t)graph,
                                                 &p);
  *exec = (void*)x;
  *result = (int)p.result_out;
  *node_type = -1;
  name[0] = 0;
  if (e != cudaSuccess && p.errNode_out != nullptr) {
    cudaGraphNodeType t;
    if (cudaGraphNodeGetType(p.errNode_out, &t) == cudaSuccess) {
      *node_type = (int)t;
      cudaKernelNodeParams kp = {};
      const char* fn = nullptr;
      if (t == cudaGraphNodeTypeKernel &&
          cudaGraphKernelNodeGetParams(p.errNode_out, &kp) == cudaSuccess &&
          cudaFuncGetName(&fn, kp.func) == cudaSuccess && fn != nullptr) {
        snprintf(name, cap, "%s", fn);
      } else if (t == cudaGraphNodeTypeMemAlloc) {
        cudaMemAllocNodeParams ap = {};
        if (cudaGraphMemAllocNodeGetParams(p.errNode_out, &ap) ==
            cudaSuccess) {
          snprintf(name, cap, "%zu bytes", ap.bytesize);
        }
      }
    }
  }
  cudaGetLastError();
  return (int)e;
}

int smtorch_lg_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// Nodes of a graph, its conditional nodes' bodies not included.
int smtorch_lg_num_nodes(void* graph, unsigned long long* n) {
  size_t k = 0;
  cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &k);
  *n = k;
  return (int)e;
}

// Ends the capture of `stream` if it is capturing (a region whose capture
// raised); destroy 1 destroys the graph it gives (the region's own, not a
// conditional node's body). The capture's error is cleared, not returned.
int smtorch_lg_abort(void* stream, int destroy) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus st = cudaStreamCaptureStatusNone;
  cudaError_t e = cudaStreamIsCapturing(s, &st);
  if (e != cudaSuccess) return (int)e;
  if (st == cudaStreamCaptureStatusNone) return 0;
  cudaGraph_t g = nullptr;
  cudaStreamEndCapture(s, &g);
  if (destroy && g) cudaGraphDestroy(g);
  cudaGetLastError();
  return 0;
}

// A new non-blocking stream on the current device, of its own: torch's
// streams come from a pool of 32 per device, which parfor's worker lanes
// and their capture streams would share (a capture on one then takes in
// another lane's work).
int smtorch_lg_stream_create(void** stream) {
  cudaStream_t s = nullptr;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream = (void*)s;
  return (int)e;
}

int smtorch_lg_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) {
    cudaError_t f = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = f;
  }
  return (int)e;
}

}  // extern "C"
