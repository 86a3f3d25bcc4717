// The device loop's while node for Hopper (sm_90a): the port's counterpart
// of XLA keeping `lax.while_loop` on the device (the decoders' loops,
// warp_rnnt_tpu/models/decoding.py:119, warp_rnnt_tpu/models/beam_search.py:
// 298).  No TPU kernel replaces this: on the TPU the loop is XLA's while.
//
// `utils/device_loop.py` captures one round of the loop (UNROLL masked
// steps, then the round's tail, which writes the loop's cond and count into
// a two-int status buffer) as a torch CUDA graph.  device_loop_build makes
// a graph of one conditional node of type while (CUDA 12.3+), whose body
// is that round as a child graph followed by loop_continue_kernel; the
// kernel sets the node's condition to
//
//     status[0] != 0 && status[1] < bound[0]
//
// so the card runs round after round with no host read between them, and
// stops on its own when cond is false or the count has reached the loop's
// bound (a faulty loop then stops on the device; the host, which reads the
// status once after the launch, raises).  The handle's default launch value
// is 1, so a launch runs one round even where cond is false at entry: the
// rounds are masked, so that round leaves the state bit for bit, as the
// eager loop's first round does.
//
// What bounds it: one launch of one thread a round, reading 12 bytes; its
// cost is the node's scheduling, not the kernel.
//
// A conditional body takes kernel, memset, device-to-device memcpy, empty,
// child-graph and conditional nodes only: device_loop_nodes counts a
// graph's nodes by kind (child graphs walked) so that the caller can refuse
// a round that holds another kind before it builds.
//
// Plain C interface (ctypes): handles and pointers as 64-bit integers;
// every entry returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

#if CUDART_VERSION < 12030
#error "device_loop.cu needs CUDA 12.3 or later (conditional graph nodes)"
#endif

namespace {

template <typename T>
T ptr(long long v) {
  return reinterpret_cast<T>(static_cast<intptr_t>(v));
}

// Slots of device_loop_nodes' counts past the node types' own values.
constexpr int kOtherType = 30;  // a type this header does not name
constexpr int kHostCopy = 31;   // a memcpy node that is not device to device

bool device_memory(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();  // so that no later launch check reports it
    return false;
  }
  return a.type == cudaMemoryTypeDevice;
}

cudaError_t count_nodes(cudaGraph_t g, long long* counts) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> nodes(n);
  e = cudaGraphGetNodes(g, nodes.data(), &n);
  if (e != cudaSuccess) return e;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(node, &t);
    if (e != cudaSuccess) return e;
    int slot = static_cast<int>(t);
    if (slot < 0 || slot >= kOtherType) slot = kOtherType;
    if (t == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p = {};
      e = cudaGraphMemcpyNodeGetParams(node, &p);
      if (e != cudaSuccess) return e;
      const bool device =
          p.srcArray == nullptr && p.dstArray == nullptr &&
          (p.kind == cudaMemcpyDeviceToDevice ||
           (p.kind == cudaMemcpyDefault && device_memory(p.srcPtr.ptr) &&
            device_memory(p.dstPtr.ptr)));
      if (!device) slot = kHostCopy;
    }
    ++counts[slot];
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(node, &child);
      if (e != cudaSuccess) return e;
      e = count_nodes(child, counts);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

// out[0] programmatic edges of g (a launch that may start before the one
// it depends on has ended), out[1] all its edges.
cudaError_t count_edges(cudaGraph_t g, long long* out) {
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &n);
#else
  cudaError_t e = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
#endif
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(g, from.data(), to.data(), data.data(), &n);
#else
  e = cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &n);
#endif
  if (e != cudaSuccess) return e;
  long long programmatic = 0;
  for (size_t i = 0; i < n; ++i) {
    programmatic += data[i].type == cudaGraphDependencyTypeProgrammatic;
  }
  out[0] = programmatic;
  out[1] = static_cast<long long>(n);
  return cudaSuccess;
}

}  // namespace

// One thread, once a round, after the round's tail: go on while the
// round's cond holds and the count is under the loop's bound.
__global__ void loop_continue_kernel(const int* status, const int* bound,
                                     cudaGraphConditionalHandle handle) {
  cudaGraphSetConditional(handle, status[0] != 0 && status[1] < bound[0]);
}

// counts[k] (k < 32, zeroed by the caller): the nodes of `graph` (a raw
// cudaGraph_t) and of its child graphs, by cudaGraphNodeType; slot 30 a
// type past those, slot 31 a memcpy node that is not device to device.
extern "C" int device_loop_nodes(long long graph, long long* counts) {
  return static_cast<int>(count_nodes(ptr<cudaGraph_t>(graph), counts));
}

// The loop's executable graph: one while node whose body is `round_graph`
// (a torch CUDAGraph's raw_cuda_graph(), cloned as a child graph) then
// loop_continue_kernel on `status` (2 ints: cond, count) and `bound` (1
// int), both device pointers that outlive the exec.  *exec_out receives
// the cudaGraphExec_t; edges[0], edges[1] the programmatic and all edges
// of the body's round as built (the child graph's clone).
extern "C" int device_loop_build(long long round_graph, long long status,
                                 long long bound, long long* exec_out,
                                 long long* edges) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphExec_t exec = nullptr;
  do {
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, g, 1,
                                         cudaGraphCondAssignDefault);
    if (e != cudaSuccess) break;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    cudaGraphNode_t cond;
#if CUDART_VERSION >= 13000
    e = cudaGraphAddNode(&cond, g, nullptr, nullptr, 0, &cp);
#else
    e = cudaGraphAddNode(&cond, g, nullptr, 0, &cp);
#endif
    if (e != cudaSuccess) break;
    cudaGraph_t body = cp.conditional.phGraph_out[0];
    cudaGraphNode_t round;
    e = cudaGraphAddChildGraphNode(&round, body, nullptr, 0,
                                   ptr<cudaGraph_t>(round_graph));
    if (e != cudaSuccess) break;
    const int* status_p = ptr<const int*>(status);
    const int* bound_p = ptr<const int*>(bound);
    void* args[] = {&status_p, &bound_p, &handle};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(loop_continue_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    cudaGraphNode_t cont;
    e = cudaGraphAddKernelNode(&cont, body, &round, 1, &kp);
    if (e != cudaSuccess) break;
    cudaGraph_t clone;
    e = cudaGraphChildGraphNodeGetGraph(round, &clone);
    if (e != cudaSuccess) break;
    e = count_edges(clone, edges);
    if (e != cudaSuccess) break;
    e = cudaGraphInstantiate(&exec, g, 0);
  } while (false);
  cudaGraphDestroy(g);
  if (e != cudaSuccess) return static_cast<int>(e);
  *exec_out = static_cast<long long>(reinterpret_cast<intptr_t>(exec));
  return 0;
}

// One whole loop: the while node's exec on `stream`.
extern "C" int device_loop_launch(long long exec, long long stream) {
  return static_cast<int>(cudaGraphLaunch(ptr<cudaGraphExec_t>(exec),
                                          ptr<cudaStream_t>(stream)));
}

extern "C" int device_loop_destroy(long long exec) {
  return static_cast<int>(cudaGraphExecDestroy(ptr<cudaGraphExec_t>(exec)));
}

extern "C" const char* device_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
