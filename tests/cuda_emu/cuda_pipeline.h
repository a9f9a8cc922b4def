// cp.async primitives for the CPU stand-in of cuda_runtime.h: the copy is
// made at once, commit and wait do nothing
#pragma once
#include "cuda_runtime.h"
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n) { std::memcpy(d, s, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
