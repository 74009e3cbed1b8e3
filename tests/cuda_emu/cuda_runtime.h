// A CPU stand-in for the CUDA runtime pieces that csrc/stem.cu uses, so the
// kernel's index math compiles with g++ and runs here: one std::thread per
// CUDA thread, std::barrier for __syncthreads and for the warp collectives
// (emu.cpp emulates ldmatrix and mma.sync lane by lane). Test support for
// tests/test_torch_stem_emulated.py only.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
#define __align__(x)
#define __restrict__

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
  cudaDevAttrMultiProcessorCount = 16,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
};
struct dim3 { unsigned x = 0, y = 0, z = 0; };
extern thread_local dim3 threadIdx;
extern dim3 blockIdx, gridDim;
extern unsigned char* g_smem;
extern int g_sms;

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// an H100's opt-in shared memory per block; a few SMs keep the grid small
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 232448 : g_sms;
  return cudaSuccess;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, int smem) {
  *n = std::min(233472 / (smem + 1024), 32);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
void __syncthreads();
inline size_t __cvta_generic_to_shared(const void* p) { return static_cast<const unsigned char*>(p) - g_smem; }

struct uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline unsigned __umulhi(unsigned a, unsigned b) { return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32); }
template <class T> T __ldg(const T* p) { return *p; }

void emu_ldmatrix(uint32_t addr, int nmat, uint32_t* r);
void emu_mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1);
