// Multi-scale deformable attention, backward, for NVIDIA Hopper (sm_90a).
//
// The gradient of kernel B1 (msdeform_fwd.cu) with respect to its three
// inputs. The JAX package has no backward TPU kernel: it differentiates the
// plain forms through XLA (dvis_plus_tpu/ops/msdeform.py::ms_deform_attn,
// and dvis_plus_tpu/ops/msdeform_pallas.py::_local_bwd, which takes the
// gradient of _local_exact_oracle). So this kernel is held against autograd
// of the port's plain twin (ops/msdeform.py::ms_deform_attn_torch), for both
// forms:
//   radius <  0: the exact op;
//   radius >= 0: the locations clamped to +-radius value-level pixels
//                around the query's reference point first. A coordinate the
//                clamp moved gets no gradient; one that lies exactly on the
//                clamp's bound gets half (torch.maximum / torch.minimum give
//                each argument half of the gradient on a tie, as JAX's do).
//
// For one sample (query q, head m, level l, point p) with attention weight
// a, bilinear weights w_c of its four corners c (0 for a corner outside the
// level, the twin's valid mask) and the output's gradient g (D channels):
//   grad_value[corner c, m, :]   += a * w_c * g           (scattered)
//   grad_attn[q, m, l, p]         = g . sample
//   grad_loc[q, m, l, p, x]       = a * g . d sample / d x * W   (and y, H)
// where sample = sum_c w_c v_c, so d sample / d x = (1 - wy1) (v01 - v00) +
// wy1 (v11 - v10) and d sample / d y = (1 - wx1) (v10 - v00) + wx1 (v11 -
// v01), each v_c read as 0 where the corner lies outside.
//
// Layout: value (B, Len, M, D) fp32 or bf16; loc (B, Lq, M, L, P, 2) fp32;
// attn (B, Lq, M, L, P) fp32 or bf16; grad_out (B, Lq, M*D) in value's type.
// Outputs: grad_value (B, Len, M, D) fp32, zeroed by the caller (the wrapper
// rounds it once to value's type); grad_loc like loc; grad_attn like attn.
//
// What bounds it on this card: the bytes each tensor moves once (value,
// locations, weights and grad_out read; the three gradients written: 1.86
// GB at the training encoder's (40, 7560, 8, 32) fp32) and, beyond them,
// the scattered additions of grad_value: 4 corners x D channels a sample,
// which go to L2 as atomics. The design is the simple one:
//
// - One warp per (batch element, query, head). Lane i owns channels i,
//   i + 32, ... of the head (D <= 256), so a corner's D values are read
//   once, in one coalesced load a warp at D = 32 fp32, and its D gradients
//   added with one coalesced atomic instruction.
// - The warp's L * P samples' locations and weights are read once, a lane
//   a sample, and handed to every lane by shuffles; each lane recomputes
//   the pixel coordinates, the clamp and the corner weights exactly as the
//   forward does (explicit round-to-nearest operations).
// - Three warp reductions a sample (butterfly shuffles) give g . sample and
//   the two location derivatives; lane 0 writes the sample's gradients.
// - grad_value is summed with fp32 atomicAdd: the order of the additions
//   changes from run to run, so its bits may too (tests hold it to 1e-5 of
//   the largest gradient).
// Staging the value window in shared memory, and pre-reducing the atomics
// of neighbouring queries there, is a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msdeform_levels.cuh"

#define MSDEFORM_BWD_THREADS 256
#define MSDEFORM_BWD_MAX_CH 8  // channels a lane: D <= 256

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The gradient factor of min(max(x, lo), hi) with respect to x, as
// torch.maximum and torch.minimum give it: 1 inside, 0 where clamped, half
// on each tie.
__device__ __forceinline__ float clamp_grad(float x, float lo, float hi) {
  const float f_lo = x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
  const float t = fmaxf(x, lo);
  const float f_hi = t < hi ? 1.f : (t == hi ? 0.5f : 0.f);
  return f_lo * f_hi;
}

template <typename T>
__global__ void __launch_bounds__(MSDEFORM_BWD_THREADS)
msdeform_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const void* __restrict__ attn, int attn_is_bf16,
                    const T* __restrict__ grad_out, float* __restrict__ grad_value,
                    float* __restrict__ grad_loc, void* __restrict__ grad_attn, int B, int Len,
                    int Lq, int M, int D, int L, int P, LevelTable lv, int radius) {
  const int lane = threadIdx.x & 31;
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= (long)B * Lq * M) return;  // the whole warp leaves together
  const int m = (int)(warp % M);
  const long bq = warp / M;  // b * Lq + q
  const int q = (int)(bq % Lq);
  const int b = (int)(bq / Lq);
  const int MD = M * D;
  const int LP = L * P;

  float g[MSDEFORM_BWD_MAX_CH];
  const T* go = grad_out + bq * MD + (long)m * D;
#pragma unroll
  for (int k = 0; k < MSDEFORM_BWD_MAX_CH; ++k) {
    const int c = lane + 32 * k;
    g[k] = c < D ? to_float(go[c]) : 0.f;
  }
  const T* vb = value + (long)b * Len * MD + (long)m * D;
  float* gvb = grad_value + (long)b * Len * MD + (long)m * D;
  const long s0 = warp * LP;  // this warp's first sample
  const float R = (float)radius;
  const int g_level = radius >= 0 ? msdeform_query_level(lv, L, q) : 0;

  for (int base = 0; base < LP; base += 32) {
    // a lane a sample: its location and weight, read once
    float my_x = 0.f, my_y = 0.f, my_a = 0.f;
    if (base + lane < LP) {
      const long s = s0 + base + lane;
      const float2 xy = ((const float2*)loc)[s];
      my_x = xy.x;
      my_y = xy.y;
      my_a = attn_is_bf16 ? __bfloat162float(((const __nv_bfloat16*)attn)[s])
                          : ((const float*)attn)[s];
    }
    const int n = min(32, LP - base);
    for (int j = 0; j < n; ++j) {
      const int r = base + j;  // l * P + p
      const int l = r / P;
      const float xn = __shfl_sync(0xffffffffu, my_x, j);
      const float yn = __shfl_sync(0xffffffffu, my_y, j);
      const float a = __shfl_sync(0xffffffffu, my_a, j);
      const int H = lv.H[l];
      const int W = lv.W[l];
      const float Hf = (float)H;
      const float Wf = (float)W;
      float x = __fsub_rn(__fmul_rn(xn, Wf), 0.5f);
      float y = __fsub_rn(__fmul_rn(yn, Hf), 0.5f);
      float fx = 1.f, fy = 1.f;  // the clamp's gradient factors
      if (radius >= 0) {
        const int cell = q - lv.start[g_level];
        const int ci = cell / lv.W[g_level];
        const float qi = (float)ci;
        const float qj = (float)(cell - ci * lv.W[g_level]);
        const float ry = __fmul_rn(qi + 0.5f, lv.sy[g_level][l]);
        const float rx = __fmul_rn(qj + 0.5f, lv.sx[g_level][l]);
        const float xlo = __fsub_rn(rx, R), xhi = __fadd_rn(rx, R);
        const float ylo = __fsub_rn(ry, R), yhi = __fadd_rn(ry, R);
        fx = clamp_grad(x, xlo, xhi);
        fy = clamp_grad(y, ylo, yhi);
        x = fminf(fmaxf(x, xlo), xhi);
        y = fminf(fmaxf(y, ylo), yhi);
        x = __fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(x, 0.5f), Wf), Wf), 0.5f);
        y = __fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(y, 0.5f), Hf), Hf), 0.5f);
      }
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      float sa = 0.f, sx = 0.f, sy = 0.f;  // this lane's parts of the three dot products
      // else every corner lies outside the zero-padded level (or the
      // location is NaN): no gradient at all
      const bool inside = x0f >= -1.f && x0f < Wf && y0f >= -1.f && y0f < Hf;
      if (inside) {
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        const float wx1 = x - x0f;
        const float wx0 = 1.f - wx1;
        const float wy1 = y - y0f;
        const float wy0 = 1.f - wy1;
        const bool left = x0 >= 0, right = x0 + 1 < W;
        const bool top = y0 >= 0, bottom = y0 + 1 < H;
        const bool on00 = top && left, on01 = top && right;
        const bool on10 = bottom && left, on11 = bottom && right;
        const long o00 = (long)(lv.start[l] + y0 * W + x0) * MD;
        const long o01 = o00 + MD;
        const long o10 = o00 + (long)W * MD;
        const long o11 = o10 + MD;
        const float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;
#pragma unroll
        for (int k = 0; k < MSDEFORM_BWD_MAX_CH; ++k) {
          const int c = lane + 32 * k;
          if (32 * k >= D) break;  // the same for every lane
          const bool ch = c < D;
          const float v00 = (ch && on00) ? to_float(vb[o00 + c]) : 0.f;
          const float v01 = (ch && on01) ? to_float(vb[o01 + c]) : 0.f;
          const float v10 = (ch && on10) ? to_float(vb[o10 + c]) : 0.f;
          const float v11 = (ch && on11) ? to_float(vb[o11 + c]) : 0.f;
          const float gk = g[k];
          sa = fmaf(gk, w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11, sa);
          sx = fmaf(gk, wy0 * (v01 - v00) + wy1 * (v11 - v10), sx);
          sy = fmaf(gk, wx0 * (v10 - v00) + wx1 * (v11 - v01), sy);
          const float ga = a * gk;
          if (ch && ga != 0.f) {
            if (on00) atomicAdd(gvb + o00 + c, w00 * ga);
            if (on01) atomicAdd(gvb + o01 + c, w01 * ga);
            if (on10) atomicAdd(gvb + o10 + c, w10 * ga);
            if (on11) atomicAdd(gvb + o11 + c, w11 * ga);
          }
        }
      }
      sa = warp_sum(sa);
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      if (lane == 0) {
        const long s = s0 + r;
        // d loc_x: the twin's chain x = loc * W - 0.5 (clamped form: x =
        // loc * Wv - 0.5, clamp, loc' = (x + 0.5) / Wv, x' = loc' * W - 0.5,
        // here with Wv = W)
        float gx = __fmul_rn(a * sx, Wf);
        float gy = __fmul_rn(a * sy, Hf);
        if (radius >= 0) {
          gx = __fmul_rn(__fdiv_rn(gx, Wf), Wf) * fx;
          gy = __fmul_rn(__fdiv_rn(gy, Hf), Hf) * fy;
        }
        ((float2*)grad_loc)[s] = make_float2(gx, gy);
        if (attn_is_bf16)
          ((__nv_bfloat16*)grad_attn)[s] = __float2bfloat16_rn(sa);
        else
          ((float*)grad_attn)[s] = sa;
      }
    }
  }
}

extern "C" {

// Launches on `stream` and returns the CUDA error code; the caller raises on
// a non-zero code. grad_value: fp32 (B, Len, M, D), zeroed. shapes: host
// int32 array of L (H, W) pairs, the value levels.
int msdeform_bwd(const void* value, int value_is_bf16, const void* loc, const void* attn,
                 int attn_is_bf16, const void* grad_out, void* grad_value, void* grad_loc,
                 void* grad_attn, int B, int Len, int Lq, int M, int D, int L, int P,
                 const int* shapes, int radius, void* stream) {
  if (M < 1 || D < 1 || D > 32 * MSDEFORM_BWD_MAX_CH || P < 1 || B < 1 || Lq < 1 ||
      (radius >= 0 && Lq != Len))
    return (int)cudaErrorInvalidValue;
  LevelTable lv;
  const cudaError_t bad = msdeform_level_table(shapes, L, Len, M, D, &lv);
  if (bad != cudaSuccess) return (int)bad;
  const long warps = (long)B * Lq * M;
  const long blocks = (warps * 32 + MSDEFORM_BWD_THREADS - 1) / MSDEFORM_BWD_THREADS;
  if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (value_is_bf16)
    msdeform_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, MSDEFORM_BWD_THREADS, 0, st>>>(
        (const __nv_bfloat16*)value, (const float*)loc, attn, attn_is_bf16,
        (const __nv_bfloat16*)grad_out, (float*)grad_value, (float*)grad_loc, grad_attn, B, Len, Lq,
        M, D, L, P, lv, radius);
  else
    msdeform_bwd_kernel<float><<<(unsigned)blocks, MSDEFORM_BWD_THREADS, 0, st>>>(
        (const float*)value, (const float*)loc, attn, attn_is_bf16, (const float*)grad_out,
        (float*)grad_value, (float*)grad_loc, grad_attn, B, Len, Lq, M, D, L, P, lv, radius);
  return (int)cudaGetLastError();
}

}  // extern "C"
