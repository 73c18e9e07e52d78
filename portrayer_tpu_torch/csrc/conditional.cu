// Conditional (IF) and WHILE nodes in a CUDA graph being captured: the
// port's counterparts of the JAX package's lax.switch and lax.scan inside
// one compiled program (portrayer_tpu/ops/trace.py, round_r's switch over
// the dead branch and the slice variants, and the scan over the tail of
// equal capacity).  Not a port of a TPU kernel: the TPU program branches
// and loops in XLA's control flow, here the graph does it on the device.
//
// cond_if_begin, called while `stream` captures, records on it a one-thread
// kernel that sets a new conditional handle to (*sel == value), then an IF
// node on that handle, and starts capturing `body` into the node's body
// graph; the caller records the branch on `body` and ends it with
// cond_if_end.  At each replay the kernel reads sel where the graph reaches
// it, and the body runs only when the handle is set.  Each run of the
// kernel adds one to *count (its launch count, read with the sweep's).
//
// cond_while_begin records the step kernel once (step 0: it sets a new
// handle to (*live > 0 && *index < end), so that the loop may run no
// iteration), then a WHILE node on that handle, and starts capturing
// `body` into its body graph; cond_while_end records the step kernel
// (step 1) at the end of the body, where it adds one to *index and sets
// the handle again, and ends the capture.  The node runs its body while
// the handle is set.  Each run of the step kernel adds one to *count.
//
// The handles are made on the graph that `stream` captures into: the
// root graph, or the body of the node that holds this one.  The bodies
// are captured on streams that cond_stream_create makes outside
// PyTorch's pool of streams, which hands its streams out in turn and
// would in time hand out the stream a graph is being captured on.
//
// stamp_time records a one-thread kernel on `stream` (a node of the graph
// when `stream` captures) that writes the device's %globaltimer, in ns, to
// table[*row * n_cols + col (+ *col_at)]: the time at which the stream, or
// a replay of the graph, reaches it.  The program's spans read it.
//
// Bound: each kernel reads and writes a few 8-byte words; the node's
// launch latency, a few microseconds, is all its cost.

#include <cuda_runtime.h>

__global__ void set_if_equal(cudaGraphConditionalHandle handle, const long long* sel,
                             long long value, unsigned long long* count) {
  cudaGraphSetConditional(handle, *sel == value ? 1u : 0u);
  *count += 1;
}

__global__ void while_step(cudaGraphConditionalHandle handle, long long* index, long long end,
                           const long long* live, long long step, unsigned long long* count) {
  long long r = *index + step;
  *index = r;
  cudaGraphSetConditional(handle, (*live > 0 && r < end) ? 1u : 0u);
  *count += 1;
}

// A new handle on the graph that `stream` captures into, and that graph.
static cudaError_t new_handle(cudaStream_t stream, cudaGraph_t* graph,
                              cudaGraphConditionalHandle* handle) {
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;
  return cudaGraphConditionalHandleCreate(handle, *graph, 0, 0);
}

// After the kernel that sets `handle`: a conditional node of `type` on it,
// the capture of `stream` continued after the node, and the capture of
// `body` begun into the node's body graph.
static cudaError_t add_node(cudaStream_t stream, cudaGraphConditionalHandle handle,
                            cudaGraphConditionalNodeType type, cudaStream_t body) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                       nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int cond_if_begin(cudaStream_t stream, const long long* sel, long long value,
                             unsigned long long* count, cudaStream_t body) {
  cudaGraph_t graph;
  cudaGraphConditionalHandle handle;
  cudaError_t e = new_handle(stream, &graph, &handle);
  if (e != cudaSuccess) return e;
  set_if_equal<<<1, 1, 0, stream>>>(handle, sel, value, count);
  return add_node(stream, handle, cudaGraphCondTypeIf, body);
}

extern "C" int cond_if_end(cudaStream_t body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(body, &graph);
}

extern "C" int cond_while_begin(cudaStream_t stream, long long* index, long long end,
                                const long long* live, unsigned long long* count,
                                cudaStream_t body, unsigned long long* handle_out) {
  cudaGraph_t graph;
  cudaGraphConditionalHandle handle;
  cudaError_t e = new_handle(stream, &graph, &handle);
  if (e != cudaSuccess) return e;
  *handle_out = handle;
  while_step<<<1, 1, 0, stream>>>(handle, index, end, live, 0, count);
  return add_node(stream, handle, cudaGraphCondTypeWhile, body);
}

extern "C" int cond_while_end(cudaStream_t body, unsigned long long handle, long long* index,
                              long long end, const long long* live,
                              unsigned long long* count) {
  while_step<<<1, 1, 0, body>>>(handle, index, end, live, 1, count);
  cudaError_t e = cudaGetLastError();
  cudaGraph_t graph;
  cudaError_t ended = cudaStreamEndCapture(body, &graph);
  return e != cudaSuccess ? e : ended;
}

__global__ void stamp_now(long long* table, const long long* row, long long n_cols,
                          long long col, const long long* col_at) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  long long c = col + (col_at != nullptr ? *col_at : 0);
  table[*row * n_cols + c] = (long long)t;
}

extern "C" int stamp_time(cudaStream_t stream, long long* table, const long long* row,
                          long long n_cols, long long col, const long long* col_at) {
  stamp_now<<<1, 1, 0, stream>>>(table, row, n_cols, col, col_at);
  return cudaGetLastError();
}

extern "C" int cond_stream_create(cudaStream_t* out) {
  return cudaStreamCreateWithFlags(out, cudaStreamNonBlocking);
}
