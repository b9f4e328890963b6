// The grid barrier of the port's cooperative launches (greedy.cu's grid
// layout, lstm.cu's VJP grid layout), and the per-chunk readiness counters
// that take its place in lstm.cu's forward grid layout. A launch holds
// every block at once (the cooperative launch refuses otherwise), so a
// block may wait for all others: `bar` is a counter in global memory,
// zeroed by the caller, that counts arrivals over the whole launch.
#pragma once

#include <cuda_runtime.h>

namespace {

// This block's arrival, made by one thread after every thread whose stores
// the others must see has passed a block (or named) barrier: the fence
// orders those stores, which that barrier made visible to this thread,
// before the arrival.
__device__ __forceinline__ void grid_arrive(unsigned* bar) {
  __threadfence();
  atomicAdd(bar, 1u);
}

// Wait (one thread) until `target` arrivals have been counted. The fences
// order the others' stores before what this block reads next, through L2
// (ld.cg, cp.async.cg) or by the bulk copies of the async proxy, which the
// caller then issues (fence.proxy.async). A wait of seconds means a block
// that never arrives, and the kernel ends with an error instead of hanging
// the card.
__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned target) {
  unsigned seen;
  const long long t0 = clock64();
  for (;;) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(bar) : "memory");
    if ((int)(seen - target) >= 0) break;
    if (clock64() - t0 > 4000000000LL) __trap();
  }
  __threadfence();
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The readiness counters of the listener's forward grid layout
// (lstm.cu::fwd_grid_produce): one counter a chunk of a direction's h,
// zeroed by the caller, that each block writing into the chunk raises by
// one a step once its stores of the step's h are made: one thread, after a
// block barrier that gathered the others' stores, with release semantics
// (which order those stores before the count).
__device__ __forceinline__ void chunk_publish(unsigned* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

// Wait (a warp, each lane its own chunk's counter and target; 0: no wait)
// until chunk `bit` of the warp's is ready → the bits of the warp's chunks
// found ready on the way. Lane c's acquire orders chunk c's writers'
// stores before its own later operations; the warp barrier after the
// ballot orders those before the other lanes' (the ballot alone orders no
// memory), so before the issuing lane's bulk copy of the chunk, once that
// lane has fenced (a fence and the proxy fence: the copies read through
// the async proxy). A wait of seconds ends the kernel with an error, as
// grid_wait's.
__device__ __forceinline__ unsigned chunks_wait(const unsigned* counter, unsigned target, int bit) {
  const long long t0 = clock64();
  for (;;) {
    unsigned seen = target;
    if (target != 0) asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    const unsigned ok = __ballot_sync(0xffffffffu, (int)(seen - target) >= 0);
    if ((ok >> bit) & 1) {
      __syncwarp();
      return ok;
    }
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}

// Every block of the grid arrives, then waits until all have; `epoch`
// counts the barriers this block has passed. Thread 0 arrives and waits,
// so it is the thread that issues the block's bulk copies afterwards.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& epoch) {
  __syncthreads();
  epoch += 1;
  if (threadIdx.x == 0) {
    grid_arrive(bar);
    grid_wait(bar, epoch * gridDim.x);
  }
  __syncthreads();
}

}  // namespace
