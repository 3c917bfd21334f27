// Blockwise (flash) self-attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel behind dvis_plus_tpu/ops/flash_attn.py::
// flash_self_attention (the library Pallas flash attention it pads and
// masks for). Per (batch b, head h):
//
//   out = softmax(q k^T * scale) v
//
// in one pass over blocks of keys with a running row max and row sum, so
// the (L, L) scores never reach device memory. Scores, softmax and both
// accumulations are fp32; p is rounded to v's dtype before P.V; the output
// is written in q's dtype. Keys past L are masked in the kernel, so L may be
// any length: nothing is padded and there are no segment ids.
//
// Layout: q/k/v (B, L, H, 64) fp32 or bf16, given by a batch stride and a
// row stride each, with the heads as column slices of H * 64 contiguous
// channels, so the three may be strided views of one (B, L, 3 * H * 64) qkv
// output; out (B, L, H * 64) contiguous in q's dtype. Pointers and strides
// must allow 4-element vector loads (the wrapper checks).
//
// Two kernels, one entry point:
//
// flash_attn_simt_kernel (fp32 inputs): CUDA cores. One block of 256 threads
// takes 64 query rows of one (b, h) and walks the keys 64 at a time. Q, K, V
// tiles and P are staged in shared memory with rows padded to 68 words.
// The threads form a 16 x 16 grid: thread (ty, tx) owns score rows
// ty + 16 i and keys tx + 16 j (i, j < 4), then output rows ty + 16 i and
// channels 4 tx .. 4 tx + 3. With that assignment every shared read is a
// 16-byte vector: the 8 lanes of a read phase hit 8 different 4-bank groups
// (row stride 68 = 4 mod 32) or one address (broadcast), so the two products
// run at 8 vector reads per 64 FMAs without bank conflicts. The 16 lanes
// that share a row sit in one half warp, so the row max and sum reduce by
// shuffles and P needs only a warp-level sync before P.V.
//
// flash_attn_mma_kernel (bf16 inputs): tensor cores through warp-level
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). One block of 4 warps takes
// 64 query rows (16 per warp) and walks the keys 64 at a time; the K and V
// tiles are staged as bf16 in shared memory (rows padded to 72 elements, so
// the 8 row addresses of an ldmatrix fall in different banks) by cp.async,
// double buffered. Q lives in registers as A fragments, S = Q K^T and
// O += P V keep their accumulators in registers, the softmax runs on the
// accumulator fragments (row max and sum over the 4 lanes of a quad), and
// the bf16-rounded P is repacked in registers from the accumulator layout
// into the A-fragment layout, so P never touches shared memory.
//
// Bound: operations. 4 * B * H * L^2 * 64 FLOPs per call against
// 4 * B * L * H * 64 elements of q, k, v, out: at ViT-L serving size
// (B, L, H) = (5, 3681, 16) that is 277 GFLOP over 151 MB in bf16, far above
// the card's ratio of FLOP/s to bytes/s. The SIMT kernel is held to the
// fp32 CUDA-core rate, the mma kernel to the bf16 tensor-core rate. wgmma
// and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_DH 64
#define FA_BM 64
#define FA_BN 64

// ---------------------------------------------------------------------------
// SIMT kernel
// ---------------------------------------------------------------------------

#define FA_LD 68  // padded fp32 row
#define FA_SIMT_THREADS 256
#define FA_SIMT_SMEM (4 * FA_BM * FA_LD * (int)sizeof(float))

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// rows [row0, row0 + 64) of one head (64 channels) -> dst[64][FA_LD];
// rows at or past L are zero
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0, int L) {
#pragma unroll
  for (int i = 0; i < (FA_BM * FA_DH / 4) / FA_SIMT_THREADS; ++i) {
    const int idx = threadIdx.x + i * FA_SIMT_THREADS;
    const int r = idx >> 4;
    const int c4 = (idx & 15) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L) x = load4(src + (long long)(row0 + r) * row_stride + c4);
    store4(dst + r * FA_LD + c4, x);
  }
}

__global__ void __launch_bounds__(FA_SIMT_THREADS, 2)
flash_attn_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, long long qs0, long long qs1,
                       long long ks0, long long ks1, long long vs0,
                       long long vs1, float* __restrict__ out, int L, int H,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + FA_BM * FA_LD;
  float* Vs = Ks + FA_BN * FA_LD;
  float* Ps = Vs + FA_BN * FA_LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int row0 = blockIdx.x * FA_BM;
  const float* qh = q + (long long)b * qs0 + h * FA_DH;
  const float* kh = k + (long long)b * ks0 + h * FA_DH;
  const float* vh = v + (long long)b * vs0 + h * FA_DH;

  load_tile(Qs, qh, qs1, row0, L);

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += FA_BN) {
    __syncthreads();  // the previous tile's K and V are consumed
    load_tile(Ks, kh, ks1, k0, L);
    load_tile(Vs, vh, vs1, k0, L);
    __syncthreads();

    // S = Q K^T: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < FA_DH; d += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(Qs + (ty + 16 * i) * FA_LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = load4(Ks + (tx + 16 * j) * FA_LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bb[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bb[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bb[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bb[j].w, s[i][j]);
        }
    }

    // online softmax over this tile's keys; keys at or past L score -inf
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < L) ? s[i][j] * scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // every tile holds at least one key below L, so m_new is finite
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(ty + 16 * i) * FA_LD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha;
    }
    __syncwarp();  // a P row is written and read by the 16 lanes of one half warp

    // O += P V: rows ty + 16 i, channels 4 tx .. 4 tx + 3
#pragma unroll 4
    for (int kk = 0; kk < FA_BN; kk += 4) {
      float4 p4[4], v4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = load4(Ps + (ty + 16 * i) * FA_LD + kk);
#pragma unroll
      for (int c = 0; c < 4; ++c) v4[c] = load4(Vs + (kk + c) * FA_LD + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc[4] = {p4[i].x, p4[i].y, p4[i].z, p4[i].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o[i][0] = fmaf(pc[c], v4[c].x, o[i][0]);
          o[i][1] = fmaf(pc[c], v4[c].y, o[i][1]);
          o[i][2] = fmaf(pc[c], v4[c].z, o[i][2]);
          o[i][3] = fmaf(pc[c], v4[c].w, o[i][3]);
        }
      }
    }
    __syncwarp();  // P is consumed before the next tile overwrites it
  }

  float* oh = out + (long long)b * L * H * FA_DH + h * FA_DH + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < L) {
      const float inv = 1.f / l[i];
      store4(oh + (long long)row * H * FA_DH,
             make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv));
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16)
// ---------------------------------------------------------------------------

#define FA_MMA_THREADS 128
#define FA_LDH 72  // padded bf16 row: 144 bytes, an odd number of 16-byte chunks
#define FA_MMA_TILE (FA_BN * FA_LDH)  // elements of one staged tile
// Q tile + 2 stages x (K tile + V tile)
#define FA_MMA_SMEM (5 * FA_MMA_TILE * (int)sizeof(__nv_bfloat16))

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  const int bytes = valid ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_src) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_src);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_src) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_src);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D (16x8 fp32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<const uint32_t*>(&x);
}

// 64 rows x 64 channels of bf16 -> dst[64][FA_LDH] by 16-byte cp.async;
// rows at or past L are zero-filled
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int row0, int L) {
#pragma unroll
  for (int i = 0; i < (FA_BN * FA_DH / 8) / FA_MMA_THREADS; ++i) {
    const int idx = threadIdx.x + i * FA_MMA_THREADS;
    const int r = idx >> 3;
    const int c8 = (idx & 7) * 8;
    const bool valid = row0 + r < L;
    const __nv_bfloat16* g = src + (long long)(valid ? row0 + r : 0) * row_stride + c8;
    cp_async16(dst + r * FA_LDH + c8, g, valid);
  }
}

__global__ void __launch_bounds__(FA_MMA_THREADS)
flash_attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, long long qs0, long long qs1,
                      long long ks0, long long ks1, long long vs0, long long vs1,
                      __nv_bfloat16* __restrict__ out, int L, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* KVs = Qs + FA_MMA_TILE;  // stage s: K at 2 s, V at 2 s + 1

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int row0 = blockIdx.x * FA_BM;
  const __nv_bfloat16* qh = q + (long long)b * qs0 + h * FA_DH;
  const __nv_bfloat16* kh = k + (long long)b * ks0 + h * FA_DH;
  const __nv_bfloat16* vh = v + (long long)b * vs0 + h * FA_DH;

  const int n_tiles = (L + FA_BN - 1) / FA_BN;
  stage_tile(Qs, qh, qs1, row0, L);
  stage_tile(KVs, kh, ks1, 0, L);
  stage_tile(KVs + FA_MMA_TILE, vh, vs1, 0, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q as A fragments: 4 k-steps of 16 channels for this warp's 16 rows.
  // ldmatrix x4: lanes 0-15 give the rows of the left 8 channels, lanes
  // 16-31 the rows of the right 8, so r[0..3] = (rows 0-7, k 0-7),
  // (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) = a0..a3
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * FA_LDH + ks * 16 + (lane >> 4) * 8);

  // this thread's two rows: g = lane / 4 and g + 8; its columns in an
  // 8-wide block: 2 (lane % 4) and + 1
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FA_BN;
    const __nv_bfloat16* Ks = KVs + (t & 1) * 2 * FA_MMA_TILE;
    const __nv_bfloat16* Vs = Ks + FA_MMA_TILE;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other stage
      __nv_bfloat16* Kn = KVs + ((t + 1) & 1) * 2 * FA_MMA_TILE;
      stage_tile(Kn, kh, ks1, k0 + FA_BN, L);
      stage_tile(Kn + FA_MMA_TILE, vh, vs1, k0 + FA_BN, L);
      cp_async_commit();
    }

    // S = Q K^T for 8 blocks of 8 keys. B fragment of block n, k-step ks:
    // b0 = K[n*8 + lane/4][ks*16 + 2*(lane%4) ..], b1 the same at + 8
    // channels. One ldmatrix x4 on K rows n*8 .. n*8+7 at channel chunks
    // (2 ks, 2 ks + 1, 2 ks + 2, 2 ks + 3) gives b0, b1 of k-steps ks, ks + 1.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (n * 8 + (lane & 7)) * FA_LDH + kp * 32 + (lane >> 3) * 8);
        mma_bf16(s[n], qf[2 * kp], kf[0], kf[1]);
        mma_bf16(s[n], qf[2 * kp + 1], kf[2], kf[3]);
      }
    }

    // online softmax on the fragments: s[n][0..1] row g, s[n][2..3] row g + 8
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = k0 + n * 8 + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = (col + (e & 1) < L) ? s[n][e] * scale : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);  // finite: the tile has a key below L
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
    // P (bf16) as A fragments of 4 k-steps of 16 keys: blocks 2 kk, 2 kk + 1
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[n][e] - m[e >> 1]);
        psum[e >> 1] += p[e];
      }
      // a0 = (row g, k 0-7), a1 = (row g + 8, k 0-7), a2 = (row g, k 8-15),
      // a3 = (row g + 8, k 8-15)
      pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V for 8 blocks of 8 channels. B fragment of block n, k-step kk:
    // b0 = V[kk*16 + 2*(lane%4) .. + 1][n*8 + lane/4], b1 at keys + 8: V is
    // stored [key][channel], so ldmatrix.trans. One x4 on keys kk*16 ..
    // kk*16 + 15 (lanes 0-15 address rows) at channel blocks n, n + 1 (lanes
    // 16-31) gives b0, b1 of block n and b0, b1 of block n + 1.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (kk * 16 + (lane & 15)) * FA_LDH + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pf[kk], vf[2], vf[3]);
      }
    }

    if (t + 1 < n_tiles) cp_async_wait<0>();
    __syncthreads();  // the next stage has landed; this one may be overwritten
  }

  const int g = lane >> 2;
  __nv_bfloat16* oh = out + (long long)b * L * H * FA_DH + h * FA_DH + 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row < L) {
      const float inv = 1.f / l[r];
      __nv_bfloat16* orow = oh + (long long)row * H * FA_DH;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t packed = pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
        *reinterpret_cast<uint32_t*>(orow + n * 8) = packed;
      }
    }
  }
}

extern "C" {

// Launches on `stream` and returns cudaGetLastError(); the caller raises on
// a non-zero code. Strides are in elements. bf16 takes the tensor-core
// kernel, fp32 the CUDA-core one.
int flash_attn_fwd(const void* q, const void* k, const void* v, long long qs0,
                   long long qs1, long long ks0, long long ks1, long long vs0,
                   long long vs1, void* out, int is_bf16, int B, int L, int H,
                   int Dh, float scale, void* stream) {
  if (B < 1 || L < 1 || H < 1 || Dh != FA_DH || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((L + FA_BM - 1) / FA_BM), (unsigned)(B * H));
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(flash_attn_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, FA_MMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_attn_mma_kernel<<<grid, FA_MMA_THREADS, FA_MMA_SMEM, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, qs0, qs1,
        ks0, ks1, vs0, vs1, (__nv_bfloat16*)out, L, H, scale);
  } else {
    err = cudaFuncSetAttribute(flash_attn_simt_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, FA_SIMT_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_attn_simt_kernel<<<grid, FA_SIMT_THREADS, FA_SIMT_SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, qs0, qs1, ks0, ks1, vs0, vs1,
        (float*)out, L, H, scale);
  }
  return (int)cudaGetLastError();
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
