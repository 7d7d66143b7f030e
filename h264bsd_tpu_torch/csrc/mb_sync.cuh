// Dependency machinery of the single-launch MB kernels (K1 in
// deblock_wf.cu, K2 in intra_list.cu, K7 in intra_wf.cu): tickets, per-MB
// done flags or per-row progress counters, and a bounded spin.
//
// Tickets. A block takes its work item from a counter in device memory
// (atomicAdd by thread 0, broadcast through shared memory), not from
// blockIdx. Items are handed out in order, so an item is only waited on
// once its ticket has been taken, by a block that is already running.
// Whatever order the hardware schedules the blocks in, and at any grid
// size, the lowest unfinished item has all its dependencies done and
// runs: the kernel cannot deadlock on a correct dependency rule.
//
// Flags. One int per MB, 0 until the MB is done (K7: one int per MB row,
// the number of its MBs done). The producer's threads meet at a barrier
// after their plane stores, and thread 0 stores the flag with release
// semantics (a device-scope fence, then the store). A waiter loads the
// flag with acquire semantics, and its block (K7: its warp 0) meets at a
// barrier before reading the planes, which it reads with L2-only loads
// (__ldcg), so no stale L1 line can feed it.
//
// Bounded spin. A wait backs off with __nanosleep and traps after
// MB_SPIN_LIMIT_NS of wall-clock time (%globaltimer, which also runs
// while the context is time-sliced out), so a dependency bug becomes a
// launch failure (raised at the next synchronization) instead of hanging
// the card. A trap ends the process's whole CUDA context, not only this
// kernel: the caller cannot catch it and go on decoding.
//
// The scratch (flags or counters, and the ticket) is allocated and
// zeroed by the wrapper before every launch; the entry points allocate
// nothing.

#pragma once

#include <cstdint>

#include <cuda/atomic>

// far above any legitimate wait: a whole 1080p frame's chain takes ~1 ms
#define MB_SPIN_LIMIT_NS 2000000000ull

__device__ __forceinline__ uint64_t mb_clock_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The block's ticket. Called once per block, by every thread; `slot` is
// a __shared__ int.
__device__ __forceinline__ int mb_take_ticket(int* counter, int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1);
  __syncthreads();
  return *slot;
}

// Called by one thread: returns once `*counter` >= `value`. The caller's
// block (or warp) meets at a barrier afterwards, before it reads what
// the counter guards.
__device__ __forceinline__ void mb_wait_at_least(const int* counter,
                                                 int value) {
  cuda::atomic_ref<int, cuda::thread_scope_device> f(
      *const_cast<int*>(counter));
  if (f.load(cuda::memory_order_acquire) >= value) return;
  const uint64_t t0 = mb_clock_ns();
  unsigned ns = 16;
  while (f.load(cuda::memory_order_acquire) < value) {
    __nanosleep(ns);
    if (ns < 128) ns <<= 1;
    if (mb_clock_ns() - t0 > MB_SPIN_LIMIT_NS) __trap();
  }
}

// Called by one thread: returns once `flag` is set.
__device__ __forceinline__ void mb_wait(const int* flag) {
  mb_wait_at_least(flag, 1);
}

// Called by every thread of the block after its last plane store: sets
// `*counter` to `value` once all of them are visible device-wide. The
// barrier orders every thread's stores before thread 0's release, which
// is cumulative (the pattern of cooperative groups' grid sync).
__device__ __forceinline__ void mb_publish(int* counter, int value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> f(*counter);
    f.store(value, cuda::memory_order_release);
  }
}

__device__ __forceinline__ void mb_signal(int* flag) { mb_publish(flag, 1); }
