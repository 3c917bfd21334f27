// The value levels of multi-scale deformable attention, as the forward
// (msdeform_fwd.cu) and backward (msdeform_bwd.cu) kernels of B1 take them:
// a table passed by value to the kernel, filled and checked on the host;
// and the 16-byte corner loads both kernels issue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MSDEFORM_MAX_LEVELS 4

struct LevelTable {
  int H[MSDEFORM_MAX_LEVELS];
  int W[MSDEFORM_MAX_LEVELS];
  int start[MSDEFORM_MAX_LEVELS];
  // sy[lq][lv] = Hv / Hq and sx[lq][lv] = Wv / Wq, rounded to fp32 the way
  // the reference does (python float -> fp32)
  float sy[MSDEFORM_MAX_LEVELS][MSDEFORM_MAX_LEVELS];
  float sx[MSDEFORM_MAX_LEVELS][MSDEFORM_MAX_LEVELS];
};

// Fill `lv` from the host int32 array of L (H, W) pairs; cudaSuccess, or
// cudaErrorInvalidValue when a level is empty, the levels do not cover Len,
// or an element offset (a corner lies up to one row and one pixel past the
// corner (y0, x0) of a pixel of the map) would not fit an int.
static inline cudaError_t msdeform_level_table(const int* shapes, int L, int Len, int M, int D,
                                               LevelTable* lv) {
  if (L < 1 || L > MSDEFORM_MAX_LEVELS) return cudaErrorInvalidValue;
  int start = 0, max_w = 0;
  for (int l = 0; l < L; ++l) {
    lv->H[l] = shapes[2 * l];
    lv->W[l] = shapes[2 * l + 1];
    if (lv->H[l] < 1 || lv->W[l] < 1) return cudaErrorInvalidValue;
    lv->start[l] = start;
    start += lv->H[l] * lv->W[l];
    max_w = lv->W[l] > max_w ? lv->W[l] : max_w;
  }
  if (start != Len || ((long)Len + max_w + 2) * M * D > 2147483647L) return cudaErrorInvalidValue;
  for (int a = 0; a < L; ++a)
    for (int l = 0; l < L; ++l) {
      lv->sy[a][l] = (float)((double)lv->H[l] / (double)lv->H[a]);
      lv->sx[a][l] = (float)((double)lv->W[l] / (double)lv->W[a]);
    }
  return cudaSuccess;
}

// The level g whose grid holds query q (the queries are the concatenated
// level grids in the clamped form).
__device__ __forceinline__ int msdeform_query_level(const LevelTable& lv, int L, int q) {
  int g = 0;
#pragma unroll
  for (int k = 1; k < MSDEFORM_MAX_LEVELS; ++k)
    if (k < L && q >= lv.start[k]) g = k;
  return g;
}

// 16-byte read-only loads under a predicate: the destination keeps its zeros
// where `on` is false and nothing is read. Written as predicated
// instructions, not branches, so that a point's four corner loads stay in
// one basic block and go out together.
__device__ __forceinline__ float4 ldg16_if(const float* p, bool on) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  asm("{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %5, 0;\n\t"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w)
      : "l"(p), "r"((int)on));
  return v;
}

__device__ __forceinline__ uint4 ldg16_if(const __nv_bfloat16* p, bool on) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  asm("{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %5, 0;\n\t"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
      : "l"(p), "r"((int)on));
  return v;
}
