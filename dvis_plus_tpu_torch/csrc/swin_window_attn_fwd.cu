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
// is written in q's dtype. (The bf16 kernel rounds exp(x - max) to bf16 and
// divides the fp32 output by the fp32 row sum: the same relative rounding of
// p, one division per output instead of one per probability.)
//
// Layout: q/k/v (B_, N, C) fp32 or bf16 with heads as column slices of
// C = H * 32, given by a window stride and a row stride each (last dim
// contiguous), so the three may be strided views of one (B_, N, 3C) qkv
// output; bias (H, N, N) fp32; mask (nW, N, N) fp32 or null; out (B_, N, C)
// contiguous, q's dtype.
//
// Two kernels, one entry point:
//
// swin_window_attn_kernel (fp32 inputs): CUDA cores, one block per (window,
// head), 8 warps. The block stages the head's K and V slices (N x 32 each)
// in shared memory as fp32: K rows padded to 33 words, so the 32 lanes
// reading 32 different keys at one channel hit 32 banks; V rows unpadded,
// since there the lanes read 32 channels of one key. Each warp then takes
// query rows in turn: lane j holds the scores of keys j, j+32, ... (KPL of
// them, N <= 32 * KPL) in registers, the query row is broadcast one channel
// at a time by shuffles, the softmax reduces with warp shuffles, and for P.V
// lane d owns output channel d and receives each probability by shuffle.
// Bias and mask rows are read from global memory (L2), coalesced. It is the
// parity path (it agrees with the plain version bit for bit) and is bound
// by shared-memory reads and shuffles at about a quarter of the fp32 rate.
//
// swin_window_attn_mma_kernel (bf16 inputs): the serving path. At bf16 the
// op is bound by bytes, not operations: at Swin-L stage 0 (480x640 input, 5
// frames: 700 windows x 6 heads, N = 144) q, k, v, out are 155 MB against
// 11 GFLOP, so the design is about bytes in flight and about not reading
// the bias again (a head's bias is 83 KB of fp32, more than twice one
// window's q, k, v, out), and the tensor cores only get the arithmetic out
// of the way.
// - Persistent grid: one block per SM (9 warps) walks a contiguous range of
//   the H x B_ (head, window) items, head-major, so every stage of the
//   network fills the card (Swin-L's stage 2 has only 1,440 items) and a
//   block stays on one head for as long as it can. The head's bias lives in
//   shared memory as fp32 and is loaded again only when the block's range
//   crosses into the next head.
// - q, k, v of an item (N rows x 64 bytes each) arrive as bf16 by 16-byte
//   cp.async into a ring of stages, up to NST - 1 items ahead of the
//   one being computed; rows past N are zero-filled. Nothing is converted
//   in shared memory. Rows are padded to 80 bytes, so the 8 row addresses
//   of an ldmatrix fall into different banks.
// - Both products run on tensor cores through warp-level mma.sync m16n8k16
//   (bf16 in, fp32 accumulate), not wgmma: 144 = 9 x 16, so nine 16-row
//   strips cover a window with no padding, one strip per warp, where wgmma's
//   64-row tiles would pad 144 rows to 192; and at 11 GFLOP a third of the
//   tensor-core peak is already below the byte bound. Per strip S = Q K^T
//   stays in accumulator fragments; scale, bias (shared memory, row stride
//   = 8 mod 32 words so the fragment reads are conflict-free) and mask
//   (global memory, L2-resident, 8-byte loads) are added in fp32 in that
//   layout; keys past N score -inf; the softmax reduces over the 4 lanes of
//   a quad; the bf16-rounded P is repacked in registers into A fragments and
//   never touches shared memory; O = P V accumulates in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

#define SWIN_DH 32
#define SWIN_THREADS 256
#define SWIN_MAX_KPL 6
#define SWIN_SMEM_LIMIT (48 * 1024)

// ---------------------------------------------------------------------------
// CUDA-core kernel (fp32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
// round to the storage type T and back (p is rounded to v's dtype)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

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

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16)
// ---------------------------------------------------------------------------

using namespace hopper;

#define SWM_WARPS 9
#define SWM_THREADS (32 * SWM_WARPS)
#define SWM_ROW 40             // padded bf16 row of a staged tile: 80 bytes
#define SWM_SMEM_MAX 232448    // what one block may ask for

// words of a bias row in shared memory for KS 16-key steps: = 8 or 24 mod 32
__host__ __device__ constexpr int swm_bias_stride(int ks) { return 16 * ks + 8; }
// bytes of one staged tile (q, k or v of one item)
__host__ __device__ constexpr int swm_tile_bytes(int ks) { return 16 * ks * SWM_ROW * 2; }

static size_t swm_smem_bytes(int N, int ks, int nst) {
  return (size_t)N * swm_bias_stride(ks) * sizeof(float) + (size_t)nst * 3 * swm_tile_bytes(ks);
}

// what the entry point was given (strides in elements; mask may be null)
struct SwmArgs {
  const __nv_bfloat16* src[3];  // q, k, v
  long long s0[3], s1[3];       // their window and row strides
  const float* bias;
  const float* mask;
  int nW;
  __nv_bfloat16* out;
  int B_, N, H;
  float scale;
};

// KS: 16-key steps that cover a window (N <= 16 KS); NST: ring stages;
// MASKED: a shift mask is added (mask != null)
template <int KS, int NST, bool MASKED>
__global__ void __launch_bounds__(SWM_THREADS, 1)
swin_window_attn_mma_kernel(const SwmArgs a) {
  const int B_ = a.B_, N = a.N, H = a.H;
  const float scale = a.scale;
  constexpr int ROWS = 16 * KS;            // staged rows of a tile
  constexpr int BS = swm_bias_stride(KS);  // words of a bias row
  constexpr int TILE = ROWS * SWM_ROW;     // elements of a staged tile
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* bias_s = reinterpret_cast<float*>(smem_raw);  // [N][BS]
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(bias_s + (size_t)N * BS);  // [NST][3][TILE]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // this thread's rows of a 16-row strip: g and g + 8
  const int t4 = lane & 3;  // its columns of an 8-wide block: 2 t4 and 2 t4 + 1
  const int C = H * SWIN_DH;
  const int strips = (N + 15) >> 4;
  const bool mask_vec = (N & 1) == 0;  // rows of the mask are 8-byte aligned
  const bool ragged = N != 16 * KS;     // the padded width holds keys past N

  // this block's contiguous range of head-major items: item = h * B_ + w
  // (H * B_ < 2^31, the entry point checks)
  const long long total = (long long)H * B_;
  const int first = (int)(total * blockIdx.x / gridDim.x);
  const int n_items = (int)(total * (blockIdx.x + 1) / gridDim.x) - first;

  // q, k, v of item `it` -> stage `st`, 16 bytes a copy, rows past N zero
  auto stage_item = [&](int it, int st) {
    const int h = (first + it) / B_;
    const long long w = (first + it) % B_;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const __nv_bfloat16* base = a.src[x] + w * a.s0[x] + h * SWIN_DH;
      __nv_bfloat16* dst = tiles + ((size_t)st * 3 + x) * TILE;
      for (int i = threadIdx.x; i < ROWS * 4; i += SWM_THREADS) {
        const int r = i >> 2;
        const int c8 = (i & 3) * 8;
        const bool valid = r < N;
        cp_async16(dst + r * SWM_ROW + c8, base + (valid ? r : 0) * a.s1[x] + c8, valid);
      }
    }
  };

  for (int it = 0; it < NST - 1; ++it) {  // fill the ring
    if (it < n_items) stage_item(it, it);
    cp_async_commit();  // one group per item, empty or not
  }

  int cur_h = -1;
  for (int it = 0; it < n_items; ++it) {
    const int h = (first + it) / B_;
    const long long w = (first + it) % B_;
    // the stage of item it + NST - 1 and the bias were read last by item
    // it - 1, and the block-wide sync that ended that item stands between
    if (it + NST - 1 < n_items) stage_item(it + NST - 1, (it + NST - 1) % NST);
    const bool new_head = h != cur_h;
    if (new_head) {  // its bias, once for all its windows in this block's range
      const float* bh = a.bias + (long long)h * N * N;
      if ((N & 3) == 0) {  // rows are 16-byte multiples: copy by chunks of 4 words
        const int chunks = N >> 2;
        for (int i = threadIdx.x; i < N * chunks; i += SWM_THREADS) {
          const int r = i / chunks, c4 = (i - r * chunks) * 4;
          cp_async16(bias_s + r * BS + c4, bh + r * N + c4, true);
        }
      } else {
        for (int i = threadIdx.x; i < N * N; i += SWM_THREADS)
          bias_s[(i / N) * BS + i % N] = bh[i];
      }
      cur_h = h;
    }
    cp_async_commit();  // one group per iteration, empty or not
    if (new_head)
      cp_async_wait<0>();  // the bias rode in the newest group: drain them all
    else
      cp_async_wait<NST - 1>();  // this item's group has landed
    __syncthreads();

    const __nv_bfloat16* Qs = tiles + (size_t)(it % NST) * 3 * TILE;
    const __nv_bfloat16* Ks = Qs + TILE;
    const __nv_bfloat16* Vs = Ks + TILE;
    const float* mask_w = MASKED ? a.mask + (w % a.nW) * N * N : nullptr;
    __nv_bfloat16* ow = a.out + w * N * C + h * SWIN_DH + 2 * t4;

    for (int strip = warp; strip < strips; strip += SWM_WARPS) {
      // Q as A fragments of the 2 k-steps of 16 channels (see ldmatrix in
      // hopper.cuh: lanes 0-15 address the rows of the left 8 channels,
      // lanes 16-31 those of the right 8)
      uint32_t qf[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4(qf[ks], Qs + (strip * 16 + (lane & 15)) * SWM_ROW + ks * 16 + (lane >> 4) * 8);

      // S = Q K^T in blocks of 8 keys: one ldmatrix x4 over the 4 channel
      // chunks of keys 8 n .. 8 n + 7 gives b0, b1 of both k-steps
      // (fragments are fetched NB blocks ahead of the products that use
      // them, and the two dependent products of a block stand NB apart)
      constexpr int NB = (2 * KS) % 6 == 0 ? 6 : 4;
      float s[2 * KS][4];
#pragma unroll
      for (int n0 = 0; n0 < 2 * KS; n0 += NB) {
        uint32_t kf[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j)
          ldmatrix_x4(kf[j], Ks + ((n0 + j) * 8 + (lane & 7)) * SWM_ROW + (lane >> 3) * 8);
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_bf16_init(s[n0 + j], qf[0], kf[j][0], kf[j][1]);
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_bf16(s[n0 + j], qf[1], kf[j][2], kf[j][3]);
      }

      // scale, bias, mask in fp32 on the fragments: s[n][0..1] is row g,
      // s[n][2..3] row g + 8, keys 8 n + 2 t4 and + 1. Rows past N are
      // computed on clamped addresses and never written.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = min(strip * 16 + g + 8 * r, N - 1);
        const float* brow = bias_s + row * BS + 2 * t4;
        float2 mv[2 * KS];  // the row's mask values, fetched together
        if (MASKED) {
          const float* mrow = mask_w + (long long)row * N + 2 * t4;
#pragma unroll
          for (int n = 0; n < 2 * KS; ++n) {
            const int col = n * 8 + 2 * t4;
            mv[n] = make_float2(0.f, 0.f);
            if (mask_vec) {
              if (col < N) mv[n] = __ldg(reinterpret_cast<const float2*>(mrow + n * 8));
            } else {
              if (col < N) mv[n].x = __ldg(mrow + n * 8);
              if (col + 1 < N) mv[n].y = __ldg(mrow + n * 8 + 1);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 2 * KS; ++n) {
          const int col = n * 8 + 2 * t4;
          const float2 bv = *reinterpret_cast<const float2*>(brow + n * 8);
          float x0 = s[n][2 * r] * scale + bv.x;
          float x1 = s[n][2 * r + 1] * scale + bv.y;
          if (MASKED) {
            x0 += mv[n].x;
            x1 += mv[n].y;
          }
          if (ragged) {  // keys past N score -inf
            x0 = col < N ? x0 : -INFINITY;
            x1 = col + 1 < N ? x1 : -INFINITY;
          }
          s[n][2 * r] = x0;
          s[n][2 * r + 1] = x1;
          mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
        }
      }
      // p = exp(x - max), rounded to bf16 for the product; the row sums are
      // taken in fp32 before the rounding and divide the output
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mx2 = mx[r] * 1.4426950408889634f;
#pragma unroll
        for (int n = 0; n < 2 * KS; ++n) {
          s[n][2 * r] = fast_exp2(fmaf(s[n][2 * r], 1.4426950408889634f, -mx2));
          s[n][2 * r + 1] = fast_exp2(fmaf(s[n][2 * r + 1], 1.4426950408889634f, -mx2));
          sum[r] += s[n][2 * r] + s[n][2 * r + 1];
        }
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        sum[r] = 1.f / sum[r];
      }
      // P as A fragments of KS k-steps of 16 keys: key blocks 2 kk, 2 kk + 1
      uint32_t pf[KS][4];
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(s[n][0], s[n][1]);
        pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
      }

      // O = P V in 4 blocks of 8 channels: V is stored [key][channel], so
      // ldmatrix.trans; one x4 on keys 16 kk .. 16 kk + 15 at channel blocks
      // 2 np, 2 np + 1 gives b0, b1 of both
      float o[4][4];
      // (the fragments of k-step kk + 1 are fetched before the products of kk)
      uint32_t vf[2][2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(vf[0][np], Vs + (lane & 15) * SWM_ROW + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk + 1 < KS) {
#pragma unroll
          for (int np = 0; np < 2; ++np)
            ldmatrix_x4_trans(vf[(kk + 1) & 1][np], Vs + ((kk + 1) * 16 + (lane & 15)) * SWM_ROW +
                                                        np * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (kk == 0) {
            mma_bf16_init(o[2 * np], pf[kk], vf[kk & 1][np][0], vf[kk & 1][np][1]);
            mma_bf16_init(o[2 * np + 1], pf[kk], vf[kk & 1][np][2], vf[kk & 1][np][3]);
          } else {
            mma_bf16(o[2 * np], pf[kk], vf[kk & 1][np][0], vf[kk & 1][np][1]);
            mma_bf16(o[2 * np + 1], pf[kk], vf[kk & 1][np][2], vf[kk & 1][np][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = strip * 16 + g + 8 * r;
        if (row < N) {
          __nv_bfloat16* orow = ow + (long long)row * C;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            *reinterpret_cast<uint32_t*>(orow + n * 8) =
                pack_bf16(o[n][2 * r] * sum[r], o[n][2 * r + 1] * sum[r]);
        }
      }
    }
    __syncthreads();  // the stage and the bias may be overwritten
  }
  cp_async_wait<0>();
}

template <int KS, int NST, bool MASKED>
static cudaError_t launch_mma_as(const SwmArgs& a, cudaStream_t st) {
  auto kernel = swin_window_attn_mma_kernel<KS, NST, MASKED>;
  // the allowance is the most a block may ask for, so it holds for every N
  static int state[kMaxDevices];
  int sms = 0;
  const cudaError_t err = allow_smem_once(kernel, SWM_SMEM_MAX, state, &sms);
  if (err != cudaSuccess) return err;
  // a persistent grid: one block per SM, or per item where there are fewer
  const long long items = (long long)a.B_ * a.H;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kernel<<<grid, SWM_THREADS, swm_smem_bytes(a.N, KS, NST), st>>>(a);
  return cudaSuccess;
}

template <int KS, int NST>
static cudaError_t launch_mma(const SwmArgs& a, cudaStream_t st) {
  return a.mask ? launch_mma_as<KS, NST, true>(a, st) : launch_mma_as<KS, NST, false>(a, st);
}

extern "C" {

// Launches on `stream` and returns cudaGetLastError(); the caller raises on
// a non-zero code. Strides are in elements. mask may be null (nW ignored).
// bf16 takes the tensor-core kernel (q, k, v 16-byte aligned in their base
// and strides; bias 16-byte aligned where N % 4 == 0, mask 8-byte aligned
// where N is even), fp32 the CUDA-core one.
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
  if (is_bf16) {
    // the bias is copied 16 bytes at a time where its rows allow it (N % 4 ==
    // 0) and the mask is read 8 bytes at a time (N even)
    if (((N & 3) == 0 && (uintptr_t)bias % 16) || (mask && (N & 1) == 0 && (uintptr_t)mask % 8))
      return (int)cudaErrorMisalignedAddress;
    const SwmArgs a = {{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v},
                       {qs0, ks0, vs0}, {qs1, ks1, vs1}, (const float*)bias, (const float*)mask,
                       nW, (__nv_bfloat16*)out, B_, N, H, scale};
    // windows of up to 64, 144 and 192 (padded) tokens, each with the deepest
    // ring that fits beside the bias
    const cudaError_t err = N <= 64    ? launch_mma<4, 3>(a, st)
                            : N <= 144 ? launch_mma<9, 3>(a, st)
                                       : launch_mma<12, 1>(a, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    dispatch<float>(kpl, q, k, v, qs0, qs1, ks0, ks1, vs0, vs1,
                    (const float*)bias, (const float*)mask, nW, out, B_, N, H,
                    scale, smem, st);
  }
  return (int)cudaGetLastError();
}

const char* swin_window_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
