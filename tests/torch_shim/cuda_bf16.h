// A stand-in for <cuda_bf16.h> that lets g++ compile the kernel bodies for
// the CPU (tests/test_torch_shim.py): the bfloat16 type as its 16 bits, and
// its exact widening to float (a bfloat16 is a float32's upper half).
#pragma once

#include <stdint.h>
#include <string.h>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.bits << 16;
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}
