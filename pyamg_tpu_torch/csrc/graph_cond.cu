// Conditional CUDA-graph nodes for the port's device-stopped solves
// (pyamg_tpu_torch/_graph.py).  The JAX package runs a solve as one
// compiled program whose loop is a lax.while_loop on the device
// (pyamg_tpu/multilevel.py: _get_accel_run, _get_standalone_run,
// _get_ds_refined_run); here the loop is a CUDA graph built from graphs
// that PyTorch captured (one per step, kept as raw cudaGraph_t) and
// conditional nodes:
//
//   * a WHILE node runs its body while a flag tensor says "go on" and a
//     trip counter is below its limit: a one-thread kernel before the
//     node and one at the end of its body set the node's condition from
//     the two tensors (cudaGraphSetConditional);
//   * an IF node with an ELSE body (CUDA 12.8) picks one of two bodies by
//     the trip counter: ((count + 1) % every == 0), the CG loop's
//     every-8th true residual;
//   * a SWITCH node (CUDA 12.8) runs body k of n when a device index holds
//     k (none when it is out of range): GMRES's Arnoldi step and update,
//     one graph for each step count j;
//   * the same one-thread kernels tally, in device memory, the trips each
//     body ran, which the host reads once after the replay (it applies
//     the steps' launch counts that many times).
//
// Steps enter a graph as child-graph nodes (cloned; the caller keeps the
// PyTorch graphs alive, since they own the memory the steps use).  Every
// node depends on the one added before it in the same graph: the graphs
// are chains.  A plain C ABI, bound with ctypes; each entry point returns
// a cudaError_t (0 on success).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#if CUDART_VERSION < 12080
#error "graph_cond.cu needs CUDA 12.8 (IF nodes with an ELSE body, SWITCH nodes)"
#endif

namespace {

// go on while the stop flag is clear and the trips are below the limit;
// at the end of a body (tally not null) count the trip that ran
__global__ void set_while(cudaGraphConditionalHandle h, const bool* stop,
                          const int32_t* count, int limit, int32_t* tally) {
  if (tally) ++*tally;
  cudaGraphSetConditional(h, (!*stop && *count < limit) ? 1u : 0u);
}

// the IF side (body 0) on every trip whose count + 1 is a multiple of
// `every`, else the ELSE side (body 1); tally[side] counts the side taken
__global__ void set_every(cudaGraphConditionalHandle h, const int32_t* count,
                          int every, int32_t* tally) {
  const bool then = (*count + 1) % every == 0;
  ++tally[then ? 0 : 1];
  cudaGraphSetConditional(h, then ? 1u : 0u);
}

// body `*index` of a SWITCH node of n bodies; tally[k] counts body k
__global__ void set_switch(cudaGraphConditionalHandle h, const int32_t* index,
                           int n, int32_t* tally) {
  const int32_t k = *index;
  if (k >= 0 && k < n) ++tally[k];
  cudaGraphSetConditional(h, (k >= 0 && k < n) ? static_cast<unsigned>(k)
                                               : static_cast<unsigned>(n));
}

// the probe's bodies: body k writes k + 1
__global__ void write_value(int32_t* out, int v) { *out = v; }

__global__ void zero(int32_t* p, int n) {
  for (int i = 0; i < n; ++i) p[i] = 0;
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t g,
                       cudaGraphNode_t dep, void* fn, void** args) {
  cudaKernelNodeParams p = {};
  p.func = fn;
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, g, dep ? &dep : nullptr, dep ? 1 : 0,
                                &p);
}

cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t g,
                            cudaGraphNode_t dep,
                            cudaGraphConditionalHandle h,
                            cudaGraphConditionalNodeType type,
                            unsigned int size, cudaGraph_t* bodies) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type;
  p.conditional.size = size;
  cudaError_t rc = cudaGraphAddNode(node, g, dep ? &dep : nullptr,
                                    dep ? 1 : 0, &p);
  if (rc != cudaSuccess) return rc;
  for (unsigned int i = 0; i < size; ++i)
    bodies[i] = p.conditional.phGraph_out[i];
  return cudaSuccess;
}

}  // namespace

extern "C" {

int pyamg_graph_new(cudaGraph_t* g) { return cudaGraphCreate(g, 0); }

int pyamg_graph_free(cudaGraph_t g) { return cudaGraphDestroy(g); }

// a kernel setting the n counters at p to 0, after `dep`
int pyamg_graph_zero(cudaGraph_t g, cudaGraphNode_t dep, int32_t* p, int n,
                     cudaGraphNode_t* node) {
  void* args[] = {&p, &n};
  return add_kernel(node, g, dep, reinterpret_cast<void*>(zero), args);
}

// a child-graph node running (a clone of) `child` after `dep`
int pyamg_graph_child(cudaGraph_t g, cudaGraphNode_t dep, cudaGraph_t child,
                      cudaGraphNode_t* node) {
  return cudaGraphAddChildGraphNode(node, g, dep ? &dep : nullptr,
                                    dep ? 1 : 0, child);
}

// After `dep`: a kernel setting the condition from (stop, count, limit),
// then a WHILE node.  Returns its handle and its (empty) body; the caller
// fills the body and closes it with pyamg_graph_while_close.
int pyamg_graph_while(cudaGraph_t g, cudaGraphNode_t dep, const bool* stop,
                      const int32_t* count, int limit,
                      cudaGraphConditionalHandle* handle, cudaGraph_t* body,
                      cudaGraphNode_t* node) {
  cudaError_t rc = cudaGraphConditionalHandleCreate(handle, g, 0, 0);
  if (rc != cudaSuccess) return rc;
  cudaGraphNode_t set;
  int32_t* no_tally = nullptr;
  void* args[] = {handle, &stop, &count, &limit, &no_tally};
  rc = add_kernel(&set, g, dep, reinterpret_cast<void*>(set_while), args);
  if (rc != cudaSuccess) return rc;
  return add_conditional(node, g, set, *handle, cudaGraphCondTypeWhile, 1,
                         body);
}

// The last node of a WHILE body (after `dep`): count the trip in *tally
// and set the condition for the next trip, from the same tensors.
int pyamg_graph_while_close(cudaGraph_t body, cudaGraphNode_t dep,
                            cudaGraphConditionalHandle handle,
                            const bool* stop, const int32_t* count,
                            int limit, int32_t* tally,
                            cudaGraphNode_t* node) {
  void* args[] = {&handle, &stop, &count, &limit, &tally};
  return add_kernel(node, body, dep, reinterpret_cast<void*>(set_while),
                    args);
}

// After `dep`: a kernel picking the side from (count, every) and counting
// it in tally[0] (IF side) or tally[1], then an IF node with an ELSE body.
// Returns the two (empty) bodies, IF side first.
int pyamg_graph_every(cudaGraph_t g, cudaGraphNode_t dep,
                      const int32_t* count, int every, int32_t* tally,
                      cudaGraph_t* then_body, cudaGraph_t* else_body,
                      cudaGraphNode_t* node) {
  cudaGraphConditionalHandle h;
  cudaError_t rc = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (rc != cudaSuccess) return rc;
  cudaGraphNode_t set;
  void* args[] = {&h, &count, &every, &tally};
  rc = add_kernel(&set, g, dep, reinterpret_cast<void*>(set_every), args);
  if (rc != cudaSuccess) return rc;
  cudaGraph_t bodies[2];
  rc = add_conditional(node, g, set, h, cudaGraphCondTypeIf, 2, bodies);
  if (rc != cudaSuccess) return rc;
  *then_body = bodies[0];
  *else_body = bodies[1];
  return cudaSuccess;
}

// After `dep`: a kernel picking body *index (counting it in tally[k]),
// then a SWITCH node of n bodies.  Returns the n (empty) bodies in
// `bodies`.
int pyamg_graph_switch(cudaGraph_t g, cudaGraphNode_t dep,
                       const int32_t* index, int n, int32_t* tally,
                       cudaGraph_t* bodies, cudaGraphNode_t* node) {
  cudaGraphConditionalHandle h;
  cudaError_t rc = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (rc != cudaSuccess) return rc;
  cudaGraphNode_t set;
  void* args[] = {&h, &index, &n, &tally};
  rc = add_kernel(&set, g, dep, reinterpret_cast<void*>(set_switch), args);
  if (rc != cudaSuccess) return rc;
  return add_conditional(node, g, set, h, cudaGraphCondTypeSwitch,
                         static_cast<unsigned int>(n), bodies);
}

// an empty node in `g` after `dep` (the body of a branch with no step)
int pyamg_graph_empty(cudaGraph_t g, cudaGraphNode_t dep,
                      cudaGraphNode_t* node) {
  return cudaGraphAddEmptyNode(node, g, dep ? &dep : nullptr, dep ? 1 : 0);
}

// The switch probe: a graph of one SWITCH node of 3 bodies, body k
// writing k + 1 into *out, launched for the index 0, 1, 2 and 3 (none);
// the four values land in got[0..3] and the tally of the three bodies in
// tally[0..2].  Device pointers; the caller reads them after a
// synchronise.  Returns the first CUDA error, else 0.
int pyamg_graph_switch_probe(int32_t* index, int32_t* out, int32_t* got,
                             int32_t* tally, cudaStream_t stream) {
  cudaGraph_t g;
  cudaError_t rc = cudaGraphCreate(&g, 0);
  if (rc != cudaSuccess) return rc;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t node;
  cudaGraph_t bodies[3];
  rc = static_cast<cudaError_t>(
      pyamg_graph_switch(g, nullptr, index, 3, tally, bodies, &node));
  for (int k = 0; k < 3 && rc == cudaSuccess; ++k) {
    cudaGraphNode_t w;
    int v = k + 1;
    void* args[] = {&out, &v};
    rc = add_kernel(&w, bodies[k], nullptr,
                    reinterpret_cast<void*>(write_value), args);
  }
  if (rc == cudaSuccess) rc = cudaGraphInstantiate(&exec, g, 0);
  for (int k = 0; k < 4 && rc == cudaSuccess; ++k) {
    rc = cudaMemsetAsync(out, 0, sizeof(int32_t), stream);
    if (rc == cudaSuccess)
      rc = cudaMemcpyAsync(index, &k, sizeof(int32_t),
                           cudaMemcpyHostToDevice, stream);
    if (rc == cudaSuccess) rc = cudaGraphLaunch(exec, stream);
    if (rc == cudaSuccess)
      rc = cudaMemcpyAsync(got + k, out, sizeof(int32_t),
                           cudaMemcpyDeviceToDevice, stream);
    if (rc == cudaSuccess) rc = cudaStreamSynchronize(stream);
  }
  if (exec != nullptr) cudaGraphExecDestroy(exec);
  cudaGraphDestroy(g);
  return rc;
}

// The nodes of `g` by type (cudaGraphNodeType, counts[0..n)), the child
// graphs' nodes included: what a refused node holds.
int pyamg_graph_node_types(cudaGraph_t g, int32_t* counts, int n) {
  size_t num = 0;
  cudaError_t rc = cudaGraphGetNodes(g, nullptr, &num);
  if (rc != cudaSuccess || num == 0) return rc;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[num];
  rc = cudaGraphGetNodes(g, nodes, &num);
  for (size_t i = 0; i < num && rc == cudaSuccess; ++i) {
    cudaGraphNodeType type;
    rc = cudaGraphNodeGetType(nodes[i], &type);
    if (rc != cudaSuccess) break;
    if (static_cast<int>(type) < n) ++counts[static_cast<int>(type)];
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      rc = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (rc == cudaSuccess)
        rc = static_cast<cudaError_t>(pyamg_graph_node_types(child, counts, n));
    }
  }
  delete[] nodes;
  return rc;
}

// The kernel names on both sides of every memory allocation or free
// node of `g` (in the order the nodes were added, which is the order they
// were captured), into out (len bytes, ';'-separated): what put them
// there.  Names through the driver (cuGraphKernelNodeGetParams,
// cuFuncGetName), "?" where it gives none.
int pyamg_graph_alloc_context(cudaGraph_t g, char* out, int len) {
  typedef CUresult (*Params)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);
  typedef CUresult (*FuncName)(const char**, CUfunction);
  Params params = nullptr;
  FuncName func_name = nullptr;
  cudaDriverEntryPointQueryResult q;
  cudaGetDriverEntryPoint("cuGraphKernelNodeGetParams",
                          reinterpret_cast<void**>(&params),
                          cudaEnableDefault, &q);
  cudaGetDriverEntryPoint("cuFuncGetName",
                          reinterpret_cast<void**>(&func_name),
                          cudaEnableDefault, &q);
  size_t num = 0;
  cudaError_t rc = cudaGraphGetNodes(g, nullptr, &num);
  if (rc != cudaSuccess) return rc;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[num + 1];
  rc = cudaGraphGetNodes(g, nodes, &num);
  auto name = [&](size_t i) -> const char* {
    if (i >= num || !params || !func_name) return "?";
    cudaGraphNodeType t;
    if (cudaGraphNodeGetType(nodes[i], &t) != cudaSuccess ||
        t != cudaGraphNodeTypeKernel)
      return "(not a kernel)";
    CUDA_KERNEL_NODE_PARAMS p = {};
    const char* nm = nullptr;
    if (params(reinterpret_cast<CUgraphNode>(nodes[i]), &p) != CUDA_SUCCESS ||
        !p.func || func_name(&nm, p.func) != CUDA_SUCCESS || !nm)
      return "?";
    return nm;
  };
  int used = 0;
  out[0] = 0;
  for (size_t i = 0; i < num && rc == cudaSuccess; ++i) {
    cudaGraphNodeType t;
    rc = cudaGraphNodeGetType(nodes[i], &t);
    if (rc != cudaSuccess) break;
    if (t != cudaGraphNodeTypeMemAlloc && t != cudaGraphNodeTypeMemFree)
      continue;
    int w = snprintf(out + used, len - used, "%s %zu of %zu after %.120s "
                     "before %.120s; ",
                     t == cudaGraphNodeTypeMemAlloc ? "alloc" : "free", i,
                     num, i ? name(i - 1) : "-", name(i + 1));
    if (w < 0 || used + w >= len) break;
    used += w;
  }
  delete[] nodes;
  return rc;
}

int pyamg_graph_instantiate(cudaGraphExec_t* exec, cudaGraph_t g) {
  return cudaGraphInstantiate(exec, g, 0);
}

int pyamg_graph_launch(cudaGraphExec_t exec, cudaStream_t stream) {
  return cudaGraphLaunch(exec, stream);
}

int pyamg_graph_exec_free(cudaGraphExec_t exec) {
  return cudaGraphExecDestroy(exec);
}

}  // extern "C"
