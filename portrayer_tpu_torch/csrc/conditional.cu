// Conditional (IF) nodes in a CUDA graph being captured: the port's
// counterpart of the JAX package's lax.switch inside one compiled program
// (portrayer_tpu/ops/trace.py, round_r's switch over the dead branch and
// the slice variants).  Not a port of a TPU kernel: the TPU program picks
// its branch in XLA's control flow, here the graph picks it on the device.
//
// cond_if_begin, called while `stream` captures, records on it a one-thread
// kernel that sets a new conditional handle to (*sel == value), then an IF
// node on that handle, and starts capturing `body` into the node's body
// graph; the caller records the branch on `body` and ends it with
// cond_if_end.  At each replay the kernel reads sel where the graph reaches
// it, and the body runs only when the handle is set.  Each run of the
// kernel adds one to *count (its launch count, read with the sweep's).
//
// Bound: one 8-byte read and one 8-byte add; the node's launch latency,
// a few microseconds, is all its cost.

#include <cuda_runtime.h>

__global__ void set_if_equal(cudaGraphConditionalHandle handle, const long long* sel,
                             long long value, unsigned long long* count) {
  cudaGraphSetConditional(handle, *sel == value ? 1u : 0u);
  *count += 1;
}

extern "C" int cond_if_begin(cudaStream_t stream, const long long* sel, long long value,
                             unsigned long long* count, cudaStream_t body) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  set_if_equal<<<1, 1, 0, stream>>>(handle, sel, value, count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                       nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int cond_if_end(cudaStream_t body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(body, &graph);
}
