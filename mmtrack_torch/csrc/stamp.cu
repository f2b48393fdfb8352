// The device end of the port's tracing spans (mmtrack_torch/utils/profiling.py).
//
// Replaces no TPU kernel. One thread stores the card's global nanosecond
// timer (%globaltimer) into a slot of an int64 buffer. The slot is fixed
// when the stamp is launched, so a stamp captured into a CUDA graph is
// rewritten by every replay of the graph, in stream order with the kernels
// around it. Bound by launch latency: one 8-byte store.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* slots, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[slot] = (long long)t;
}

}  // namespace

extern "C" int mmt_stamp(void* slots, int slot, void* stream) {
  if (slot < 0) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)slots, slot);
  return (int)cudaGetLastError();
}
