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
//                point (the spec is _local_exact_oracle). The queries are
//                then the concatenated level grids.
//
// The TPU kernel built a dense selection matrix and ran it through the MXU
// only because a TPU gathers slowly. A GPU gathers natively, so this kernel
// reads the four bilinear corners of every sample directly.
//
// Layout: value (B, Len, M, D) fp32 or bf16; loc (B, Lq, M, L, P, 2) fp32;
// attn (B, Lq, M, L, P) fp32 or bf16; out (B, Lq, M*D) in value's type (fp32
// sums in registers, one rounding at the store).
//
// What bounds it on this card: not the bytes each tensor moves once, but the
// gathered bytes, 4 corners x D x itemsize per sample and head (one 128-byte
// line per corner at D = 32 fp32 or D = 64 bf16): 1.55 GB a call at the
// 480x640 encoder shape against 100.8 MB moved once. They come out of L1 and
// L2 (the value tensor fits L2), and the kernel is bound by the latency of
// those reads: what pays is many threads an SM (32 registers a thread, a
// small tile's worth of shared memory a block), reuse in L1, and no
// instruction spent twice. On an NVIDIA H100 80GB HBM3 at 700 W it gathers
// 8 to 13 TB/s at the models' shapes (chip_smoke.py, PERF.md), more than
// device memory could give. The design:
//
// - A block of 256 threads takes a short run of consecutive queries (2 at
//   the models' shapes: runs of 1 to 4 are within 6 % of each other, 8 are
//   up to 20 % slower, 16 up to 70 %; PERF.md). The queries are row-major
//   grids, so consecutive blocks, which share an SM, take neighbouring
//   queries, which sample neighbouring pixels: the SM touches a compact
//   window of the value map and L1 serves repeated corners. 2 x 4 patches
//   of a grid read the same time as runs of 8 at every main shape, so the
//   kernel keeps runs, which need to know nothing of where the queries lie
//   unless radius >= 0.
// - Phase 1, once per (query, head, level, point): one thread computes the
//   pixel coordinates, the clamp, the floor, the four corner weights (0 for
//   a corner outside the level) and the element offset of the top-left
//   corner, and leaves them with the attention weight in shared memory (24
//   bytes a sample). The explicit round-to-nearest operations keep the
//   order of the reference's separate multiplies and subtractions.
// - Phase 2: a thread owns VEC = 16 bytes of one head's channels (4 fp32 or
//   8 bf16) of one query and reads each corner with one 16-byte read-only
//   load; a head of 32 fp32 or 64 bf16 channels is 8 lanes, a warp serves 4
//   heads of a query. A corner whose weight is 0 is not read. Locations,
//   weights and the output pass through with streaming loads and stores, so
//   that L1 keeps value lines.
// - The scalar instantiation (VEC = 1) takes every shape the vector one
//   cannot: a head whose row is not a multiple of 16 bytes, or a value
//   tensor that does not start on a 16-byte boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msdeform_levels.cuh"

#define MSDEFORM_THREADS 256
#define MSDEFORM_SAMPLE_BYTES 24  // float4 corner weights + attention weight + int offset
#define MSDEFORM_MAX_SMEM (48 * 1024)  // what a block gets without asking for more

// VEC channels of one head: how they are read, accumulated and stored.
template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 4> {
  typedef float4 raw;
  static __device__ __forceinline__ raw load_if(const float* p, bool on) { return ldg16_if(p, on); }
  static __device__ __forceinline__ void fma(float* acc, float w, raw v) {
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
  }
  static __device__ __forceinline__ void store(float* p, const float* acc) {
    __stcs((float4*)p, make_float4(acc[0], acc[1], acc[2], acc[3]));
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  typedef uint4 raw;
  static __device__ __forceinline__ raw load_if(const __nv_bfloat16* p, bool on) {
    return ldg16_if(p, on);
  }
  // a bf16 is the upper half of an fp32: two of them per 32-bit word, the
  // lower address in the lower half
  static __device__ __forceinline__ void fma2(float* acc, float w, unsigned u) {
    acc[0] = fmaf(w, __uint_as_float(u << 16), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(u & 0xffff0000u), acc[1]);
  }
  static __device__ __forceinline__ void fma(float* acc, float w, raw v) {
    fma2(acc, w, v.x);
    fma2(acc + 2, w, v.y);
    fma2(acc + 4, w, v.z);
    fma2(acc + 6, w, v.w);
  }
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&h);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* acc) {
    __stcs((uint4*)p, make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                                 pack2(acc[4], acc[5]), pack2(acc[6], acc[7])));
  }
};

template <>
struct Pack<float, 1> {
  typedef float raw;
  static __device__ __forceinline__ raw load_if(const float* p, bool on) {
    return on ? __ldg(p) : 0.f;
  }
  static __device__ __forceinline__ void fma(float* acc, float w, raw v) {
    acc[0] = fmaf(w, v, acc[0]);
  }
  static __device__ __forceinline__ void store(float* p, const float* acc) { *p = acc[0]; }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  typedef float raw;
  static __device__ __forceinline__ raw load_if(const __nv_bfloat16* p, bool on) {
    return on ? __bfloat162float(*p) : 0.f;
  }
  static __device__ __forceinline__ void fma(float* acc, float w, raw v) {
    acc[0] = fmaf(w, v, acc[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* acc) {
    *p = __float2bfloat16_rn(acc[0]);
  }
};

// Eight blocks an SM: 32 registers a thread (the kernel waits on gathered
// reads; occupancy is what hides them). A block takes queries
// blockIdx.x * TQ .. + TQ - 1 of batch element blockIdx.y; its shared memory
// is TQ * M * L * P * MSDEFORM_SAMPLE_BYTES.
template <typename T, int VEC>
__global__ void __launch_bounds__(MSDEFORM_THREADS, 8)
msdeform_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const void* __restrict__ attn, int attn_is_bf16,
                    T* __restrict__ out, int Len, int Lq, int M, int D, int L,
                    int P, LevelTable lv, int TQ, int radius) {
  typedef Pack<T, VEC> pack;
  extern __shared__ float4 smem[];
  const int LP = L * P;
  const int S = M * LP;
  float4* sw = smem;                  // [TQ * S] bilinear weights of the four corners
  float* sa = (float*)(sw + TQ * S);  // [TQ * S] attention weight
  int* soff = (int*)(sa + TQ * S);    // [TQ * S] element offset of corner (y0, x0)

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.y;
  const int q0 = (int)blockIdx.x * TQ;
  const int nq = min(TQ, Lq - q0);  // the last run may be short

  // phase 1: every sample of the run, once
  const float R = (float)radius;
  for (int t = tid; t < nq * S; t += nthreads) {
    const int ql = t / S;
    const int r = t - ql * S;  // (m * L + l) * P + p
    const int q = q0 + ql;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    int off = 0;
    const int m = r / LP;
    const int l = (r - m * LP) / P;
    const long si = ((long)b * Lq + q) * S + r;
    const float2 xy = __ldcs((const float2*)loc + si);
    const float a = attn_is_bf16 ? __bfloat162float(((const __nv_bfloat16*)attn)[si])
                                 : __ldcs((const float*)attn + si);
    const int H = lv.H[l];
    const int W = lv.W[l];
    const float Hf = (float)H;
    const float Wf = (float)W;
    // explicit round-to-nearest ops: no FMA contraction, so the pixel
    // coordinates round exactly as the reference's separate mul and sub
    float x = __fsub_rn(__fmul_rn(xy.x, Wf), 0.5f);
    float y = __fsub_rn(__fmul_rn(xy.y, Hf), 0.5f);
    if (radius >= 0) {
      // the queries are the level grids: the query is cell (qi, qj) of
      // level g. Clamp, then round-trip through normalized coordinates
      // exactly as _local_exact_oracle hands the clamped locations to the
      // exact op
      const int g = msdeform_query_level(lv, L, q);
      const int cell = q - lv.start[g];
      const int ci = cell / lv.W[g];
      const float qi = (float)ci;
      const float qj = (float)(cell - ci * lv.W[g]);
      const float ry = __fmul_rn(qi + 0.5f, lv.sy[g][l]);
      const float rx = __fmul_rn(qj + 0.5f, lv.sx[g][l]);
      x = fminf(fmaxf(x, __fsub_rn(rx, R)), __fadd_rn(rx, R));
      y = fminf(fmaxf(y, __fsub_rn(ry, R)), __fadd_rn(ry, R));
      x = __fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(x, 0.5f), Wf), Wf), 0.5f);
      y = __fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(y, 0.5f), Hf), Hf), 0.5f);
    }
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    // else the whole sample lies outside the zero-padded level (or is NaN);
    // a sample of weight 0 reads nothing either
    if (a != 0.f && x0f >= -1.f && x0f < Wf && y0f >= -1.f && y0f < Hf) {
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const float wx1 = x - x0f;
      const float wx0 = 1.f - wx1;
      const float wy1 = y - y0f;
      const float wy0 = 1.f - wy1;
      const bool left = x0 >= 0, right = x0 + 1 < W;
      const bool top = y0 >= 0, bottom = y0 + 1 < H;
      w.x = (top && left) ? wy0 * wx0 : 0.f;
      w.y = (top && right) ? wy0 * wx1 : 0.f;
      w.z = (bottom && left) ? wy1 * wx0 : 0.f;
      w.w = (bottom && right) ? wy1 * wx1 : 0.f;
      off = ((lv.start[l] + y0 * W + x0) * M + m) * D;
    }
    sw[t] = w;
    sa[t] = a;
    soff[t] = off;
  }
  __syncthreads();

  // phase 2: work item = VEC channels of one head of one query of the run
  const int CPG = D / VEC;  // items per (query, head)
  const int MD = M * D;
  const T* vb = value + (long)b * Len * MD;
  for (int wi = tid; wi < nq * M * CPG; wi += nthreads) {
    const int grp = wi / CPG;  // ql * M + m
    const int c = (wi - grp * CPG) * VEC;
    const int ql = grp / M;
    const int q = q0 + ql;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    const int s0 = grp * LP;
    for (int l = 0; l < L; ++l) {
      const int row = lv.W[l] * MD;  // one pixel down
      // not unrolled: more points in flight a thread were no faster than
      // more threads an SM (timed at 1, 2 and 4)
#pragma unroll 1
      for (int p = 0; p < P; ++p) {
        const int s = s0 + l * P + p;
        const float4 w = sw[s];
        const int o = soff[s] + c;
        // the loads first, so that all four are in flight together
        const typename pack::raw v00 = pack::load_if(vb + o, w.x != 0.f);
        const typename pack::raw v01 = pack::load_if(vb + o + MD, w.y != 0.f);
        const typename pack::raw v10 = pack::load_if(vb + o + row, w.z != 0.f);
        const typename pack::raw v11 = pack::load_if(vb + o + row + MD, w.w != 0.f);
        const float a = sa[s];
        if (sizeof(T) == 4) {
          // fp32 values: the bilinear sample first, then its attention
          // weight, the order of the reference op (and of this kernel since
          // its first version, so a model's fp32 outputs keep their bits)
          float v[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] = 0.f;
          pack::fma(v, w.x, v00);
          pack::fma(v, w.y, v01);
          pack::fma(v, w.z, v10);
          pack::fma(v, w.w, v11);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = fmaf(a, v[k], acc[k]);
        } else {
          // bf16 values round their output to bf16 anyway: the attention
          // weight is folded into the corner weights, which saves a thread
          // VEC registers and VEC operations a sample
          pack::fma(acc, a * w.x, v00);
          pack::fma(acc, a * w.y, v01);
          pack::fma(acc, a * w.z, v10);
          pack::fma(acc, a * w.w, v11);
        }
      }
    }
    pack::store(out + ((long)b * Lq + q) * MD + (grp - ql * M) * D + c, acc);
  }
}

template <typename T, int VEC>
static cudaError_t launch(const void* value, const float* loc, const void* attn,
                          int attn_is_bf16, void* out, int B, int Len, int Lq, int M,
                          int D, int L, int P, const LevelTable& lv, int TQ, int radius,
                          cudaStream_t st) {
  const dim3 grid((unsigned)((Lq + TQ - 1) / TQ), (unsigned)B);
  const size_t smem = (size_t)TQ * M * L * P * MSDEFORM_SAMPLE_BYTES;
  msdeform_fwd_kernel<T, VEC><<<grid, MSDEFORM_THREADS, smem, st>>>(
      (const T*)value, loc, attn, attn_is_bf16, (T*)out, Len, Lq, M, D, L, P, lv, TQ, radius);
  return cudaGetLastError();
}

extern "C" {

// Launches on `stream` and returns the CUDA error code; the caller raises on
// a non-zero code. shapes: host int32 array of L (H, W) pairs, the value
// levels. queries: how many consecutive queries a block takes. vector != 0
// takes the 16-byte instantiation.
int msdeform_fwd(const void* value, int value_is_bf16, const void* loc, const void* attn,
                 int attn_is_bf16, void* out, int B, int Len, int Lq, int M, int D, int L,
                 int P, const int* shapes, int queries, int vector, int radius, void* stream) {
  if (L < 1 || L > MSDEFORM_MAX_LEVELS || M < 1 || D < 1 || P < 1 || B < 1 || B > 65535 ||
      Lq < 1 || queries < 1 || (radius >= 0 && Lq != Len) ||
      (long)queries * M * L * P * MSDEFORM_SAMPLE_BYTES > MSDEFORM_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const int itemsize = value_is_bf16 ? 2 : 4;
  if (vector && ((D * itemsize) % 16 != 0 || (uintptr_t)value % 16 != 0 || (uintptr_t)out % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  LevelTable lv;
  const cudaError_t bad = msdeform_level_table(shapes, L, Len, M, D, &lv);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t st = (cudaStream_t)stream;
  const float* locf = (const float*)loc;
  cudaError_t rc;
  if (value_is_bf16) {
    rc = vector ? launch<__nv_bfloat16, 8>(value, locf, attn, attn_is_bf16, out, B, Len, Lq, M, D,
                                           L, P, lv, queries, radius, st)
                : launch<__nv_bfloat16, 1>(value, locf, attn, attn_is_bf16, out, B, Len, Lq, M, D,
                                           L, P, lv, queries, radius, st);
  } else {
    rc = vector ? launch<float, 4>(value, locf, attn, attn_is_bf16, out, B, Len, Lq, M, D, L, P,
                                   lv, queries, radius, st)
                : launch<float, 1>(value, locf, attn, attn_is_bf16, out, B, Len, Lq, M, D, L, P,
                                   lv, queries, radius, st);
  }
  return (int)rc;
}

const char* msdeform_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
