// CUDA-graph IF nodes for a stream capture: JAX's device-side lax.cond and
// lax.while_loop inside a captured frame (utils/cuda_graph.py:when).
//
// PyTorch before 2.13 has no call that captures into a conditional node,
// so the capture builds its own through the CUDA runtime (conditional
// nodes need CUDA 12.4):
//
//   kicp_if_begin(stream, pred, body): on `stream`, which is capturing, a
//     1-thread kernel copies the device bool *pred into a new conditional
//     handle of the graph being captured; then an IF node on that handle,
//     after the kernel, becomes the stream's only dependency, and `body`
//     starts capturing into the node's body graph.
//   kicp_if_end(body): ends the body's capture.
//
// Every replay runs the kernel, which sets the handle from the predicate's
// value at that point of the replay, and the IF node runs its body graph
// only where the handle is nonzero.  A body may open IF nodes of its own
// (on its own stream): its capture is a stream capture like any other.
// The handle is created without cudaGraphCondAssignDefault: the kernel
// sets it before every run of the node, so no value carries over.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_handle(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int kicp_if_begin(void* stream, const bool* pred, void* body) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_if_handle<<<1, 1, 0, st>>>(handle, pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the kernel's node is now the capture's dependency
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  e = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph, &deps,
                               &num_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(st, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int kicp_if_end(void* body) {
  cudaGraph_t graph = nullptr;  // the IF node's body graph, which it owns
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}
