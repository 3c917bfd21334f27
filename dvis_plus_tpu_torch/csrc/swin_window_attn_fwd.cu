// Swin window attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel dvis_plus_tpu/ops/swin_window_attn.py::
// _kernel (driven by fused_window_attention) and the default fp32-softmax
// window attention of dvis_plus_tpu/models/backbones/swin.py::
// WindowAttention. Per (window w, head h):
//
//   out = softmax(q k^T * scale + bias[h] [+ mask[w % nW]]) v
//
// Scores, the bias and mask adds and the softmax are fp32 (bias and mask
// are fp32 inputs); p is rounded to v's dtype, P.V accumulates in fp32 and
// is written in q's dtype.
//
// Layout: q/k/v (B_, N, C) fp32 or bf16 with heads as column slices of
// C = H * 32, given by a window stride and a row stride each (last dim
// contiguous), so the three may be strided views of one (B_, N, 3C) qkv
// output; bias (H, N, N) fp32; mask (nW, N, N) fp32 or null; out (B_, N, C)
// contiguous, q's dtype.
//
// Mapping: one block per (window, head), 8 warps. The block stages the
// head's K and V slices (N x 32 each) in shared memory as fp32: K rows
// padded to 33 words, so the 32 lanes reading 32 different keys at one
// channel hit 32 banks; V rows unpadded, since there the lanes read 32
// channels of one key. Each warp then takes query rows in turn: lane j
// holds the scores of keys j, j+32, ... (KPL of them, N <= 32 * KPL) in
// registers, the query row is broadcast one channel at a time by shuffles,
// the softmax reduces with warp shuffles, and for P.V lane d owns output
// channel d and receives each probability by shuffle. The 144 x 144 bias
// and mask rows are read straight from global memory (L2), coalesced.
//
// Bound: shared-memory reads and shuffles, one shared read per FMA of the two
// products (2 N^2 Dh per window and head) plus one shuffle per FMA of P.V,
// on CUDA cores: about a quarter of the fp32 FMA rate. At Swin-L stage 0
// (480x640 input, 5 frames: 700 windows x 6 heads, N = 144) that is 5.6 G
// FMAs per call. Tensor cores (mma / wgmma on bf16 tiles), TMA staging and
// several heads per block are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SWIN_DH 32
#define SWIN_THREADS 256
#define SWIN_MAX_KPL 6
#define SWIN_SMEM_LIMIT (48 * 1024)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// round to the storage type T and back (p is rounded to v's dtype)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int KPL>
__global__ void __launch_bounds__(SWIN_THREADS)
swin_window_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, long long qs0, long long qs1,
                        long long ks0, long long ks1, long long vs0,
                        long long vs1, const float* __restrict__ bias,
                        const float* __restrict__ mask, int nW,
                        T* __restrict__ out, int N, int H, float scale) {
  extern __shared__ float smem[];
  float* k_s = smem;                      // [N][SWIN_DH + 1]
  float* v_s = smem + N * (SWIN_DH + 1);  // [N][SWIN_DH]
  const long long w = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int C = H * SWIN_DH;

  const T* kw = k + w * ks0 + h * SWIN_DH;
  const T* vw = v + w * vs0 + h * SWIN_DH;
  for (int i = threadIdx.x; i < N * SWIN_DH; i += blockDim.x) {
    const int r = i / SWIN_DH;
    const int d = i % SWIN_DH;
    k_s[r * (SWIN_DH + 1) + d] = to_float(kw[r * ks1 + d]);
    v_s[r * SWIN_DH + d] = to_float(vw[r * vs1 + d]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const float* bias_h = bias + (long long)h * N * N;
  const float* mask_w = mask ? mask + (w % nW) * N * N : nullptr;
  const T* qw = q + w * qs0 + h * SWIN_DH;
  T* ow = out + w * N * C + h * SWIN_DH;

  for (int row = threadIdx.x >> 5; row < N; row += nwarps) {
    const float q_d = to_float(qw[row * qs1 + lane]);
    float s[KPL];
#pragma unroll
    for (int i = 0; i < KPL; ++i) s[i] = 0.f;
#pragma unroll
    for (int d = 0; d < SWIN_DH; ++d) {
      const float qv = __shfl_sync(0xffffffffu, q_d, d);
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int j = min(lane + 32 * i, N - 1);  // lanes past N compute a dummy
        s[i] = fmaf(qv, k_s[j * (SWIN_DH + 1) + d], s[i]);
      }
    }

    // scale, bias, mask: separately rounded ops, as the reference's
    // attn * scale + bias [+ mask]
    const float* brow = bias_h + (long long)row * N;
    const float* mrow = mask_w ? mask_w + (long long)row * N : nullptr;
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = lane + 32 * i;
      if (j < N) {
        float x = __fadd_rn(__fmul_rn(s[i], scale), brow[j]);
        if (mrow) x = __fadd_rn(x, mrow[j]);
        s[i] = x;
        m = fmaxf(m, x);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = lane + 32 * i;
      s[i] = j < N ? expf(s[i] - m) : 0.f;
      sum += s[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < KPL; ++i) s[i] = round_to(s[i] / sum, q);

    // P.V: lane d owns output channel d
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
#pragma unroll
      for (int src = 0; src < 32; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[i], src);
        const int j = 32 * i + src;  // the same for every lane
        if (j < N) acc = fmaf(p, v_s[j * SWIN_DH + lane], acc);
      }
    }
    store_as(ow + (long long)row * C + lane, acc);
  }
}

template <typename T, int KPL>
static void launch(const void* q, const void* k, const void* v, long long qs0,
                   long long qs1, long long ks0, long long ks1, long long vs0,
                   long long vs1, const float* bias, const float* mask, int nW,
                   void* out, int B_, int N, int H, float scale, size_t smem,
                   cudaStream_t st) {
  swin_window_attn_kernel<T, KPL><<<(unsigned)((long long)B_ * H), SWIN_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, qs0, qs1, ks0, ks1, vs0, vs1,
      bias, mask, nW, (T*)out, N, H, scale);
}

template <typename T>
static void dispatch(int kpl, const void* q, const void* k, const void* v,
                     long long qs0, long long qs1, long long ks0, long long ks1,
                     long long vs0, long long vs1, const float* bias,
                     const float* mask, int nW, void* out, int B_, int N, int H,
                     float scale, size_t smem, cudaStream_t st) {
#define SWIN_CASE(K)                                                          \
  case K:                                                                     \
    launch<T, K>(q, k, v, qs0, qs1, ks0, ks1, vs0, vs1, bias, mask, nW, out, \
                 B_, N, H, scale, smem, st);                                  \
    break;
  switch (kpl) {
    SWIN_CASE(1)
    SWIN_CASE(2)
    SWIN_CASE(3)
    SWIN_CASE(4)
    SWIN_CASE(5)
    SWIN_CASE(6)
  }
#undef SWIN_CASE
}

extern "C" {

// Launches on `stream` and returns cudaGetLastError(); the caller raises on
// a non-zero code. Strides are in elements. mask may be null (nW ignored).
int swin_window_attn_fwd(const void* q, const void* k, const void* v,
                         long long qs0, long long qs1, long long ks0,
                         long long ks1, long long vs0, long long vs1,
                         const void* bias, const void* mask, int nW, void* out,
                         int is_bf16, int B_, int N, int H, void* stream) {
  const size_t smem = (size_t)N * (2 * SWIN_DH + 1) * sizeof(float);
  const int kpl = (N + 31) / 32;
  if (B_ < 1 || N < 1 || H < 1 || kpl > SWIN_MAX_KPL || smem > SWIN_SMEM_LIMIT ||
      (long long)B_ * H > 0x7fffffffLL || (mask && (nW < 1 || B_ % nW)))
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)SWIN_DH));
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    dispatch<__nv_bfloat16>(kpl, q, k, v, qs0, qs1, ks0, ks1, vs0, vs1,
                            (const float*)bias, (const float*)mask, nW, out, B_,
                            N, H, scale, smem, st);
  else
    dispatch<float>(kpl, q, k, v, qs0, qs1, ks0, ks1, vs0, vs1,
                    (const float*)bias, (const float*)mask, nW, out, B_, N, H,
                    scale, smem, st);
  return (int)cudaGetLastError();
}

const char* swin_window_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
