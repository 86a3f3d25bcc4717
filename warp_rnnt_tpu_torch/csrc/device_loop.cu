// The device loop's while node for Hopper (sm_90a): the port's counterpart
// of XLA keeping `lax.while_loop` on the device (the decoders' loops,
// warp_rnnt_tpu/models/decoding.py:119, warp_rnnt_tpu/models/beam_search.py:
// 298).  No TPU kernel replaces this: on the TPU the loop is XLA's while.
//
// `utils/device_loop.py` captures one round of the loop (UNROLL masked
// steps, then the round's tail, which writes the loop's cond and count into
// the first two ints of a three-int status buffer) as a torch CUDA graph.
// device_loop_build makes a graph of one conditional node of type while
// (CUDA 12.3+), whose body is that round as a child graph followed by
// loop_continue_kernel;
// device_loop_capture adds the same node to a graph a stream is capturing
// (a compiled step's: a whole decode or streaming chunk, the loop among
// its other work, one graph launch).  The kernel counts the round in
// status[2] (the rounds a launch ran, read back with the status) and sets
// the node's condition to
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
// What bounds it: one launch of one thread a round, reading 12 bytes and
// writing 4; its cost is the node's scheduling, not the kernel.
//
// A conditional body takes kernel, memset, device-to-device memcpy, empty,
// child-graph and conditional nodes only: device_loop_nodes counts a
// graph's nodes by kind (child graphs walked) so that the caller can refuse
// a round that holds another kind before it builds, and count the
// conditional nodes of a compiled step's graph; device_loop_kernel_names
// names a graph's kernel nodes, so that a replay's launches are counted
// from the graph it runs (a round's nodes times the rounds it ran).
//
// Plain C interface (ctypes): handles and pointers as 64-bit integers;
// every entry returns a cudaError_t (0 on success).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <string>
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

// libcuda's entry ``name`` as the runtime's headers declare it, looked up
// once through the runtime.
template <typename Fn>
cudaError_t driver_entry(const char* name, Fn* fn) {
  if (*fn != nullptr) return cudaSuccess;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, CUDART_VERSION,
                                                   cudaEnableDefault, &q);
  if (e != cudaSuccess) return e;
  if (q != cudaDriverEntryPointSuccess) return cudaErrorSymbolNotFound;
  *fn = reinterpret_cast<Fn>(p);
  return cudaSuccess;
}

// A node's type by libcuda's cuGraphNodeGetType: the runtime's
// cudaGraphNodeGetType fails (cudaErrorUnknown) on a conditional node,
// whose type the driver gives (CUDA 12.9).  The driver's and the runtime's
// node types share their values.
cudaError_t node_type(cudaGraphNode_t node, cudaGraphNodeType* t) {
  static CUresult (*fn)(CUgraphNode, CUgraphNodeType*) = nullptr;
  cudaError_t e = driver_entry("cuGraphNodeGetType", &fn);
  if (e != cudaSuccess) return e;
  CUgraphNodeType ct;
  if (fn(reinterpret_cast<CUgraphNode>(node), &ct) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  *t = static_cast<cudaGraphNodeType>(ct);
  return cudaSuccess;
}

// A kernel node's function name (mangled) by libcuda: the node may have
// been captured by another runtime (torch's, another library's), whose
// host stubs this one does not know.
cudaError_t kernel_name(cudaGraphNode_t node, const char** name) {
  static CUresult (*params)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*) = nullptr;
  static CUresult (*of_func)(const char**, CUfunction) = nullptr;
  static CUresult (*of_kernel)(const char**, CUkernel) = nullptr;
  cudaError_t e = driver_entry("cuGraphKernelNodeGetParams", &params);
  if (e != cudaSuccess) return e;
  CUDA_KERNEL_NODE_PARAMS p = {};
  if (params(reinterpret_cast<CUgraphNode>(node), &p) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  CUresult r;
  if (p.func != nullptr) {
    e = driver_entry("cuFuncGetName", &of_func);
    if (e != cudaSuccess) return e;
    r = of_func(name, p.func);
  } else {  // a kernel the node names by its CUkernel alone
    e = driver_entry("cuKernelGetName", &of_kernel);
    if (e != cudaSuccess) return e;
    r = of_kernel(name, p.kern);
  }
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t graph_nodes(cudaGraph_t g, std::vector<cudaGraphNode_t>* nodes) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return e;
  nodes->resize(n);
  return cudaGraphGetNodes(g, nodes->data(), &n);
}

// The names of g's kernel nodes and of its child graphs' (not a
// conditional node's body), one a line.
cudaError_t kernel_names(cudaGraph_t g, std::string* out) {
  std::vector<cudaGraphNode_t> nodes;
  cudaError_t e = graph_nodes(g, &nodes);
  if (e != cudaSuccess) return e;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType t;
    e = node_type(node, &t);
    if (e != cudaSuccess) return e;
    if (t == cudaGraphNodeTypeKernel) {
      const char* name = nullptr;
      e = kernel_name(node, &name);
      if (e != cudaSuccess) return e;
      out->append(name).push_back('\n');
    } else if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(node, &child);
      if (e == cudaSuccess) e = kernel_names(child, out);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

cudaError_t count_nodes(cudaGraph_t g, long long* counts) {
  std::vector<cudaGraphNode_t> nodes;
  cudaError_t e = graph_nodes(g, &nodes);
  if (e != cudaSuccess) return e;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType t;
    e = node_type(node, &t);
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

// One thread, once a round, after the round's tail: count the round, and
// go on while the round's cond holds and the count is under the loop's
// bound.
__global__ void loop_continue_kernel(int* status, const int* bound,
                                     cudaGraphConditionalHandle handle) {
  status[2] += 1;
  cudaGraphSetConditional(handle, status[0] != 0 && status[1] < bound[0]);
}

// counts[k] (k < 32, zeroed by the caller): the nodes of `graph` (a raw
// cudaGraph_t) and of its child graphs, by cudaGraphNodeType; slot 30 a
// type past those, slot 31 a memcpy node that is not device to device.
extern "C" int device_loop_nodes(long long graph, long long* counts) {
  return static_cast<int>(count_nodes(ptr<cudaGraph_t>(graph), counts));
}

// The names of the kernel nodes of `graph` (a raw cudaGraph_t) and of its
// child graphs, not of a conditional node's body: one a line, mangled.
// *size receives the text's bytes; the text goes to out[0, cap) only where
// it fits (the caller asks again with a larger buffer where it did not).
extern "C" int device_loop_kernel_names(long long graph, char* out,
                                        long long cap, long long* size) {
  std::string text;
  cudaError_t e = kernel_names(ptr<cudaGraph_t>(graph), &text);
  if (e != cudaSuccess) return static_cast<int>(e);
  *size = static_cast<long long>(text.size());
  if (*size <= cap) std::memcpy(out, text.data(), text.size());
  return 0;
}

// Adds to `g`, after the `n` nodes `deps` (their edges' data `data`, or
// nullptr for default edges), one conditional node of type while whose
// handle is assigned 1 at every launch of `g`; its body is `round_graph`
// (a torch CUDAGraph's raw_cuda_graph(), cloned as a child graph) then
// loop_continue_kernel on `status` (3 ints: cond, count, rounds run) and
// `bound` (1 int), both device pointers that outlive every exec of `g`.  *node_out
// receives the node; edges[0], edges[1] the programmatic and all edges of
// the body's round as built (the child graph's clone).
cudaError_t add_while_node(cudaGraph_t g, const cudaGraphNode_t* deps,
                           const cudaGraphEdgeData* data, size_t n,
                           long long round_graph, long long status,
                           long long bound, cudaGraphNode_t* node_out,
                           long long* edges) {
  cudaGraphConditionalHandle handle;
  cudaError_t e = cudaGraphConditionalHandleCreate(
      &handle, g, 1, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(node_out, g, deps, data, n, &cp);
#else
  e = cudaGraphAddNode_v2(node_out, g, deps, data, n, &cp);
#endif
  if (e != cudaSuccess) return e;
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  cudaGraphNode_t round;
  e = cudaGraphAddChildGraphNode(&round, body, nullptr, 0,
                                 ptr<cudaGraph_t>(round_graph));
  if (e != cudaSuccess) return e;
  int* status_p = ptr<int*>(status);
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
  if (e != cudaSuccess) return e;
  cudaGraph_t clone;
  e = cudaGraphChildGraphNodeGetGraph(round, &clone);
  if (e != cudaSuccess) return e;
  return count_edges(clone, edges);
}

// The loop's executable graph: one while node (add_while_node) alone in a
// graph of its own.  *exec_out receives the cudaGraphExec_t.
extern "C" int device_loop_build(long long round_graph, long long status,
                                 long long bound, long long* exec_out,
                                 long long* edges) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t node;
  e = add_while_node(g, nullptr, nullptr, 0, round_graph, status, bound,
                     &node, edges);
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, g, 0);
  cudaGraphDestroy(g);
  if (e != cudaSuccess) return static_cast<int>(e);
  *exec_out = static_cast<long long>(reinterpret_cast<intptr_t>(exec));
  return 0;
}

// The while node (add_while_node) added to the graph that `stream` is
// capturing now, after the capture's current dependencies (with their
// edges' data), and made the capture's one dependency, so that what the
// stream captures next runs after the whole loop.  The capturing graph's
// launches then run the loop, its handle reset to 1 at each.  Returns
// cudaErrorIllegalState where `stream` is not capturing.
extern "C" int device_loop_capture(long long stream, long long round_graph,
                                   long long status, long long bound) {
  cudaStream_t s = ptr<cudaStream_t>(stream);
  cudaStreamCaptureStatus capturing;
  cudaGraph_t g = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  const cudaGraphEdgeData* data = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &capturing, nullptr, &g, &deps,
                                           &data, &n);
#else
  cudaError_t e = cudaStreamGetCaptureInfo_v3(s, &capturing, nullptr, &g,
                                              &deps, &data, &n);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
  if (capturing != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorIllegalState);
  }
  cudaGraphNode_t node;
  long long edges[2];
  e = add_while_node(g, deps, data, n, round_graph, status, bound, &node,
                     edges);
  if (e != cudaSuccess) return static_cast<int>(e);
#if CUDART_VERSION >= 13000
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  return static_cast<int>(e);
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
