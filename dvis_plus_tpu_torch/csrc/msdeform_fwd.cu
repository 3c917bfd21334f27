// Multi-scale deformable attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel dvis_plus_tpu/ops/msdeform_pallas.py::
// _window_kernel (driven by deform_sample_window / _local_forward) and the
// XLA gather op dvis_plus_tpu/ops/msdeform.py::ms_deform_attn. One kernel
// covers both forms:
//   radius <  0: the exact op (grid_sample bilinear, zero padding,
//                align_corners=False, weighted sum over levels and points);
//   radius >= 0: the same math after clamping every sampling location to
//                +-radius value-level pixels around the query's reference
//                point (the spec is _local_exact_oracle). Queries must then
//                be the concatenated level grids, so the kernel derives each
//                query's level and grid cell from its index.
//
// The TPU kernel built a dense selection matrix and ran it through the MXU
// only because a TPU gathers slowly. A GPU gathers natively, so this kernel
// reads the four bilinear corners of every sample directly.
//
// Layout: value (B, Len, M, D) fp32 or bf16; loc (B, Lq, M, L, P, 2) fp32;
// attn (B, Lq, M, L, P) fp32; out (B, Lq, M*D) fp32.
//
// Mapping: one block per (batch, query); thread c of the block owns channel
// c = m*D + d of the M*D output channels, so the D lanes of a head read each
// corner's D contiguous values in one coalesced transaction. The block first
// stages its query's M*L*P locations and weights in shared memory.
//
// Bound: gathered bytes, 4 corners x D x itemsize per sample (512 B per
// sample and head at D=32 fp32). At the R50 encoder shapes the value tensor
// (5 frames x 6300 tokens x 256 channels x 4 B = 32 MB) fits the 50 MB L2, so
// the corner reads are mostly L2 hits. Tensor cores, TMA and shared-memory
// staging of the value window are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float load_value(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void msdeform_fwd_kernel(const T* __restrict__ value,
                                    const float* __restrict__ loc,
                                    const float* __restrict__ attn,
                                    float* __restrict__ out, int Len, int Lq,
                                    int M, int D, int L, int P,
                                    LevelTable lv, int radius) {
  extern __shared__ float smem[];  // [2*S locations | S weights]
  const int S = M * L * P;
  const long bq = blockIdx.x;  // b * Lq + q
  const int b = (int)(bq / Lq);
  const int q = (int)(bq % Lq);

  const float* loc_q = loc + bq * (long)S * 2;
  const float* attn_q = attn + bq * (long)S;
  for (int i = threadIdx.x; i < 2 * S; i += blockDim.x) smem[i] = loc_q[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) smem[2 * S + i] = attn_q[i];
  __syncthreads();

  const int c = threadIdx.x;
  if (c >= M * D) return;
  const int m = c / D;

  // query level and grid cell, for the clamp
  int lq = 0;
  float qi = 0.f, qj = 0.f;
  if (radius >= 0) {
    for (int l = 1; l < L; ++l)
      if (q >= lv.start[l]) lq = l;
    const int r = q - lv.start[lq];
    qi = (float)(r / lv.W[lq]);
    qj = (float)(r % lv.W[lq]);
  }
  const float R = (float)radius;
  const long MD = (long)M * D;

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int H = lv.H[l];
    const int W = lv.W[l];
    const float Hf = (float)H;
    const float Wf = (float)W;
    const T* vbase = value + ((long)b * Len + lv.start[l]) * MD + c;
    float lo_x = 0.f, hi_x = 0.f, lo_y = 0.f, hi_y = 0.f;
    if (radius >= 0) {
      const float ry = __fmul_rn(qi + 0.5f, lv.sy[lq][l]);
      const float rx = __fmul_rn(qj + 0.5f, lv.sx[lq][l]);
      lo_y = __fsub_rn(ry, R);
      hi_y = __fadd_rn(ry, R);
      lo_x = __fsub_rn(rx, R);
      hi_x = __fadd_rn(rx, R);
    }
    for (int p = 0; p < P; ++p) {
      const int s = (m * L + l) * P + p;
      // explicit round-to-nearest ops: no FMA contraction, so the pixel
      // coordinates round exactly as the reference's separate mul and sub
      float x = __fsub_rn(__fmul_rn(smem[2 * s], Wf), 0.5f);
      float y = __fsub_rn(__fmul_rn(smem[2 * s + 1], Hf), 0.5f);
      if (radius >= 0) {
        // clamp, then round-trip through normalized coordinates exactly as
        // _local_exact_oracle hands the clamped locations to the exact op
        x = fminf(fmaxf(x, lo_x), hi_x);
        y = fminf(fmaxf(y, lo_y), hi_y);
        x = __fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(x, 0.5f), Wf), Wf), 0.5f);
        y = __fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(y, 0.5f), Hf), Hf), 0.5f);
      }
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      // the whole sample lies outside the zero-padded level (also drops NaN)
      if (!(x0f >= -1.f && x0f < Wf && y0f >= -1.f && y0f < Hf)) continue;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const float wx1 = x - x0f;
      const float wx0 = 1.f - wx1;
      const float wy1 = y - y0f;
      const float wy0 = 1.f - wy1;
      float v = 0.f;
      if (y0 >= 0) {
        const T* row = vbase + (long)y0 * W * MD;
        if (x0 >= 0) v += wy0 * wx0 * load_value(row + (long)x0 * MD);
        if (x0 + 1 < W) v += wy0 * wx1 * load_value(row + (long)(x0 + 1) * MD);
      }
      if (y0 + 1 < H) {
        const T* row = vbase + (long)(y0 + 1) * W * MD;
        if (x0 >= 0) v += wy1 * wx0 * load_value(row + (long)x0 * MD);
        if (x0 + 1 < W) v += wy1 * wx1 * load_value(row + (long)(x0 + 1) * MD);
      }
      acc += smem[2 * S + s] * v;
    }
  }
  out[bq * MD + c] = acc;
}

extern "C" {

// Launches on `stream` and returns cudaGetLastError(); the caller raises on
// a non-zero code. shapes: host int32 array of 2*L (H, W) pairs.
int msdeform_fwd(const void* value, int value_is_bf16, const void* loc,
                 const void* attn, void* out, int B, int Len, int Lq, int M,
                 int D, int L, int P, const int* shapes, int radius,
                 void* stream) {
  if (L < 1 || L > MSDEFORM_MAX_LEVELS || M * D > 1024 || M * D < 1)
    return (int)cudaErrorInvalidValue;
  LevelTable lv;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.H[l] = shapes[2 * l];
    lv.W[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.H[l] * lv.W[l];
  }
  for (int a = 0; a < L; ++a)
    for (int l = 0; l < L; ++l) {
      lv.sy[a][l] = (float)((double)lv.H[l] / (double)lv.H[a]);
      lv.sx[a][l] = (float)((double)lv.W[l] / (double)lv.W[a]);
    }
  const int threads = ((M * D + 31) / 32) * 32;
  const size_t smem = (size_t)3 * M * L * P * sizeof(float);
  const dim3 grid((unsigned)((long)B * Lq));
  cudaStream_t st = (cudaStream_t)stream;
  if (value_is_bf16) {
    msdeform_fwd_kernel<__nv_bfloat16><<<grid, threads, smem, st>>>(
        (const __nv_bfloat16*)value, (const float*)loc, (const float*)attn,
        (float*)out, Len, Lq, M, D, L, P, lv, radius);
  } else {
    msdeform_fwd_kernel<float><<<grid, threads, smem, st>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (float*)out, Len, Lq, M, D, L, P, lv, radius);
  }
  return (int)cudaGetLastError();
}

const char* msdeform_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
