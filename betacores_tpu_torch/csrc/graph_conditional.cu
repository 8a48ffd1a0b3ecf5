// Conditional "if" nodes in a CUDA graph that PyTorch is capturing: the
// data-dependent exit of the captured Newton refit (inference/laplace.py,
// through utils/graphs.py::run_if), which the reference writes as a
// lax.while_loop. It replaces no TPU kernel: XLA lowers the reference's
// while loop to a device-side loop, and this gives a captured CUDA graph the
// same exit, decided on the device with no host read.
//
// graph_if_begin adds, at the point the capture has reached, a one-thread
// kernel that sets the node's condition from a device flag, and the node
// itself; it then ends the stream's capture sequence and begins one that
// captures into the node's body graph, on the same stream. graph_if_end
// ends the body's sequence and begins one that captures into the enclosing
// graph again, after the node. The body stays on the capturing stream, so
// the libraries it calls find their handles and workspaces of that stream.
// Nodes nest: a body may open another. The caller (utils/graphs.py::
// capture) routes the stream's allocations to the graph's memory pool for
// the whole capture, since each restart is a new capture sequence.
//
// Bound: latency. A skipped node costs the setter kernel and the node's
// evaluation on the device; a taken one, those and its body.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// The graph `stream` is capturing into and the nodes the next one depends on.
cudaError_t capture_point(cudaStream_t stream, cudaGraph_t* graph,
                          const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, nullptr,
                                             n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive) {
    err = cudaErrorIllegalState;
  }
  return err;
}

}  // namespace

extern "C" {

// Loads the setter kernel, so that no capture loads it. Returns the
// cudaError_t.
int graph_conditional_init() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, set_condition);
}

// Opens an "if" node on the graph `stream` is capturing, on the 1-byte bool
// at `flag` (device memory), and moves the stream's capture into its body.
// `graph_out` and `node_out` receive what graph_if_end takes. Returns the
// cudaError_t (0 on success).
int graph_if_begin(void* stream, const void* flag, void** graph_out, void** node_out) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_point(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition<<<1, 1, 0, s>>>(handle, (const bool*)flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_point(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];

  cudaGraph_t ended;
  err = cudaStreamEndCapture(s, &ended);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph(s, body, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeGlobal);
  if (err != cudaSuccess) return (int)err;
  *graph_out = (void*)graph;
  *node_out = (void*)node;
  return 0;
}

// Closes the body graph_if_begin opened: the stream captures into `graph`
// again, after `node`. Returns the cudaError_t.
int graph_if_end(void* stream, void* graph, void* node) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(s, &body);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t after = (cudaGraphNode_t)node;
  return (int)cudaStreamBeginCaptureToGraph(s, (cudaGraph_t)graph, &after, nullptr, 1,
                                            cudaStreamCaptureModeGlobal);
}

}  // extern "C"
