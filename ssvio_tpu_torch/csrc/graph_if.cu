// IF nodes in a CUDA graph under stream capture: the capture's next node
// becomes a conditional node whose body a second stream then captures,
// and a one-thread kernel before it sets the node's condition from a bool
// on the device. Bound with ctypes by ops/cuda_if.py, which also routes
// the body's allocations to a memory pool of its own.
//
// Signatures: CUDA 13 gives cudaStreamGetCaptureInfo, cudaGraphAddNode and
// cudaStreamUpdateCaptureDependencies the edge data that CUDA 12.3-12.9
// name _v3 / _v2; conditional nodes need 12.4 (memcpy and memset nodes in
// their bodies included).

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "conditional nodes need CUDA 12.4 or later"
#endif

#if CUDART_VERSION >= 13000
#define SSVIO_CAPTURE_INFO cudaStreamGetCaptureInfo
#define SSVIO_ADD_NODE cudaGraphAddNode
#define SSVIO_UPDATE_DEPS cudaStreamUpdateCaptureDependencies
#else
#define SSVIO_CAPTURE_INFO cudaStreamGetCaptureInfo_v3
#define SSVIO_ADD_NODE cudaGraphAddNode_v2
#define SSVIO_UPDATE_DEPS cudaStreamUpdateCaptureDependencies_v2
#endif

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// Append to `outer`'s capture a kernel that reads `*pred`, then an IF node
// on it; make the node the dependency of what `outer` captures next, and
// start capturing `body` into the node's body graph. Returns a cudaError_t.
extern "C" int ssvio_if_begin(cudaStream_t outer, const bool* pred,
                              cudaStream_t body) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  const cudaGraphEdgeData* edges;
  size_t n_deps;
  cudaError_t err = SSVIO_CAPTURE_INFO(outer, &status, nullptr, &graph,
                                       &deps, &edges, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, outer>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = SSVIO_CAPTURE_INFO(outer, &status, nullptr, &graph, &deps, &edges,
                           &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = SSVIO_ADD_NODE(&node, graph, deps, edges, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = SSVIO_UPDATE_DEPS(outer, &node, nullptr, 1,
                          cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

// End the capture of an IF node's body (the node owns the graph).
extern "C" int ssvio_if_end(cudaStream_t body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(body, &graph);
}

extern "C" const char* ssvio_if_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
