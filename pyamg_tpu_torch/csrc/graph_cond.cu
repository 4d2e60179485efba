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
//   * the same one-thread kernels tally, in device memory, the trips each
//     body ran, which the host reads once after the replay (it applies
//     the steps' launch counts that many times).
//
// Steps enter a graph as child-graph nodes (cloned; the caller keeps the
// PyTorch graphs alive, since they own the memory the steps use).  Every
// node depends on the one added before it in the same graph: the graphs
// are chains.  A plain C ABI, bound with ctypes; each entry point returns
// a cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

#if CUDART_VERSION < 12080
#error "graph_cond.cu needs CUDA 12.8 (IF nodes with an ELSE body)"
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
