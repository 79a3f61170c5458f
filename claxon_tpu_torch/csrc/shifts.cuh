// Logical shifts with XLA semantics, shared by the port's bit readers
// (entropy.cu, entropy_delta.cu, rice.cu): an amount of 32 or more, taken
// as unsigned (so a negative one too), gives 0.

#pragma once

__device__ __forceinline__ unsigned shl(unsigned v, int s) {
  return (unsigned)s >= 32u ? 0u : v << s;
}
__device__ __forceinline__ unsigned shr(unsigned v, int s) {
  return (unsigned)s >= 32u ? 0u : v >> s;
}
