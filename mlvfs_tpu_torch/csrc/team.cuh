// The threads of a block that work on one item together: a block may run
// one item with all its threads, or several items at once, one per team of
// NT threads, each team joined by a named barrier of its own, so that one
// team's barriers do not wait for another's work.

#pragma once

#include <cuda_runtime.h>

template <int NT>
struct Team {
  static_assert(NT % 32 == 0, "a team is whole warps");
  int tid;  // the thread's index in its team, 0 .. NT - 1
  int bar;  // 0: the team is the whole block (__syncthreads()); else named barrier 1..15

  __device__ __forceinline__ void sync() const {
    if (bar == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(NT) : "memory");
    }
  }
};

// The whole block of NT threads as one team.
template <int NT>
__device__ __forceinline__ Team<NT> block_team() {
  return Team<NT>{(int)threadIdx.x, 0};
}

// Team k = threadIdx.x / NT of a block split into teams of NT threads.
template <int NT>
__device__ __forceinline__ Team<NT> split_team() {
  return Team<NT>{(int)threadIdx.x % NT, 1 + (int)threadIdx.x / NT};
}
