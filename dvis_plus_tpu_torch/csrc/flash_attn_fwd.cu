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
// in bytes must be multiples of 16 (vector loads, tensor maps; the wrapper
// checks).
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
// flash_attn_wgmma_kernel (bf16 inputs): Hopper's warpgroup matrix multiply
// fed by the Tensor Memory Accelerator (the pieces are in hopper.cuh). One
// block takes 128 query rows of one (b, h) and has three warpgroups behind
// one top-level branch:
// - the producer gives its registers away (setmaxnreg) and one of its
//   threads starts TMA loads: the Q tile once, then K and V tiles of 128
//   keys x 64 channels (16 KB each) into a ring of FW_STAGES stages. Each
//   stage has a "full" mbarrier, completed by the TMA unit's byte count, and
//   an "empty" one, on which the 8 consumer warps arrive when their products
//   on the stage have finished. The tensor maps are 3-D over each tensor's
//   (H * 64, L, B) view with its own strides, so q, k, v need no copy; boxes
//   are 64 channels x 128 rows, 128-byte swizzled, and rows past L read as
//   zero, which is all the padding there is.
// - two consumer warpgroups of 64 query rows each. S = Q K^T is four
//   wgmma m64n128k16 with Q and K read from the swizzled tiles through
//   matrix descriptors; the softmax runs on the fp32 accumulator fragments
//   in base 2 with the scale folded into one multiply-add (row max and sum over
//   the 4 lanes of a quad), keys at or past L masked in the last tile only;
//   the bf16-rounded P is repacked in registers into A fragments, and
//   O += P V is eight wgmma m64n64k16 with A from registers and V read
//   [key][channel] as an MN-major B operand (the instruction's transpose
//   bit), so V is neither transposed nor copied. The loop is software
//   pipelined: a warpgroup starts S of tile t + 1 and P V of tile t back to
//   back, waits for S only, and takes the softmax of tile t + 1 while the
//   tensor cores run P V of tile t (at Dh = 64 the softmax's exponentials
//   cost the special-function units about what the two products cost the
//   tensor cores, so the two have to overlap); the other warpgroup's
//   products fill what is left.
// Rows at or past L are not written.
//
// Bound: operations. 4 * B * H * L^2 * 64 FLOPs per call against
// 4 * B * L * H * 64 elements of q, k, v, out: at ViT-L serving size
// (B, L, H) = (5, 3681, 16) that is 277 GFLOP over 151 MB in bf16, far above
// the card's ratio of FLOP/s to bytes/s. The SIMT kernel is held to the
// fp32 CUDA-core rate, the wgmma kernel to the bf16 tensor-core rate:
// wgmma is the only instruction that reaches it, and TMA keeps the copies
// out of the computing warps' instruction streams and registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
// Tensor-core kernel (bf16): wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

using namespace hopper;

#define FW_BM 128                     // query rows of a block: 64 per consumer warpgroup
#define FW_BN 128                     // keys of a tile
#define FW_STAGES 4                   // K/V ring
#define FW_THREADS 384                // producer warpgroup + 2 consumer warpgroups
#define FW_TILE (FW_BN * FA_DH * 2)   // bytes of one staged tile (Q, K or V): 16 KB
#define FW_CONSUMER_WARPS 8
// Q + ring of (K, V) + barriers, plus the slack to align the tiles to 1024
#define FW_SMEM ((1 + 2 * FW_STAGES) * FW_TILE + 1024 + 128)

__global__ void __launch_bounds__(FW_THREADS, 1)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        __nv_bfloat16* __restrict__ out, int L, int H, float scale_log2e) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte-swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + FW_TILE;
  uint8_t* Vs = Ks + FW_STAGES * FW_TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + FW_STAGES * FW_TILE);
  uint64_t* full = q_full + 1;          // [FW_STAGES]: K and V of the stage have landed
  uint64_t* empty = full + FW_STAGES;   // [FW_STAGES]: every consumer warp is done with it

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int row0 = blockIdx.x * FW_BM;
  const int n_tiles = (L + FW_BN - 1) / FW_BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, FW_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The two roles never meet again (no block-wide sync below): with one
  // top-level branch the register reallocation takes effect.
  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, FW_TILE);
      tma_load_3d(Qs, &map_q, q_full, h * FA_DH, row0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % FW_STAGES;
        // round r of a stage waits for the consumers' release of round r - 1;
        // in round 0 the parity-1 wait on a fresh barrier passes at once
        mbar_wait(empty + s, ((t / FW_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, 2 * FW_TILE);
        tma_load_3d(Ks + s * FW_TILE, &map_k, full + s, h * FA_DH, t * FW_BN, b);
        tma_load_3d(Vs + s * FW_TILE, &map_v, full + s, h * FA_DH, t * FW_BN, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x - 128;
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;   // this thread's rows of its warp's 16: g and g + 8
    const int t4 = lane & 3;   // its columns of an 8-wide block: 2 t4 and 2 t4 + 1

    const uint64_t q_desc = smem_desc_sw128(smem_u32(Qs) + wg * (FW_TILE / 2));
    // running row max (of the raw scores) and this thread's share of the row
    // sum: the 4 lanes of a quad hold one row and are added up at the end
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // sc[4 j + e]: row g + 8 (e / 2), key 8 j + 2 t4 + e % 2 of the tile, first
    // the raw scores, then the probabilities
    float sc[64];
    // P (bf16) as A fragments of 8 k-steps of 16 keys: key blocks 2 kk, 2 kk + 1;
    // a0 = (row g, keys 0-7), a1 = (row g + 8, keys 0-7), a2 = (row g, keys
    // 8-15), a3 = (row g + 8, keys 8-15)
    uint32_t pf[8][4];
    float alpha[2];

    // sc = Q K_t^T: 64 rows x 128 keys, 4 k-steps of 16 channels (asynchronous)
    auto start_qk = [&](int t) {
      const uint64_t k_desc = smem_desc_sw128(smem_u32(Ks + (t % FW_STAGES) * FW_TILE));
#pragma unroll
      for (int kk = 0; kk < FA_DH / 16; ++kk)
        wgmma_m64n128k16_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
      wgmma_commit();
    };
    // o += P V_t: 64 rows x 64 channels, 8 k-steps of 16 keys (asynchronous);
    // V is stored [key][channel], the MN-major form of a B operand
    auto start_pv = [&](int t) {
      const uint64_t v_desc = smem_desc_sw128(smem_u32(Vs + (t % FW_STAGES) * FW_TILE));
#pragma unroll
      for (int kk = 0; kk < FW_BN / 16; ++kk)
        wgmma_m64n64k16_rs(o, pf[kk], v_desc + kk * (16 * 128 >> 4), 1);
      wgmma_commit();
    };
    // online softmax of tile t on the accumulator fragments, in base 2 with
    // the scale folded into the exponent's multiply-add: raw scores in sc ->
    // probabilities in sc; m, l and alpha (the old sums' correction) updated
    auto softmax = [&](int t) {
      const int k0 = t * FW_BN;
      if (k0 + FW_BN > L) {  // the last tile: keys at or past L score -inf
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= L) sc[i] = -INFINITY;
      }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
      float ms[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        // every tile starts below L, so it holds a real key and m_new is finite
        const float m_new = fmaxf(m[r], tmax[r]);
        alpha[r] = fast_exp2((m[r] - m_new) * scale_log2e);
        m[r] = m_new;
        ms[r] = m_new * scale_log2e;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2e, -ms[(i >> 1) & 1]));
        psum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(sc[4 * j + 0], sc[4 * j + 1]);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };

    // Software pipeline: while the tensor cores run P_t V_t, this warpgroup
    // takes the softmax of tile t + 1, whose scores were started just before.
    mbar_wait(q_full, 0);
    mbar_wait(full, 0);
    wgmma_fence();
    start_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    pack_p();
    for (int t = 0; t + 1 < n_tiles; ++t) {
      mbar_wait(full + (t + 1) % FW_STAGES, ((t + 1) / FW_STAGES) & 1);
      fence_regs(sc);
      fence_regs(o);
      wgmma_fence();
      start_qk(t + 1);
      start_pv(t);
      wgmma_wait<1>();  // the scores of tile t + 1 are there; P_t V_t runs on
      fence_regs(sc);
      softmax(t + 1);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty + t % FW_STAGES);  // this warp is done with tile t
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }
    fence_regs(o);
    wgmma_fence();
    start_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }

    __nv_bfloat16* oh = out + (long long)b * L * H * FA_DH + h * FA_DH + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + wg * 64 + warp * 16 + g + 8 * r;
      if (row < L) {
        const float inv = 1.f / l[r];
        __nv_bfloat16* orow = oh + (long long)row * H * FA_DH;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

extern "C" {

// Launches on `stream` and returns 0, a CUDA runtime error code, or
// hopper::kTensorMapError plus libcuda's code when a tensor map could not
// be encoded; the caller raises on a non-zero code. Strides are in elements.
// bf16 takes the tensor-core kernel, fp32 the CUDA-core one.
int flash_attn_fwd(const void* q, const void* k, const void* v, long long qs0,
                   long long qs1, long long ks0, long long ks1, long long vs0,
                   long long vs1, void* out, int is_bf16, int B, int L, int H,
                   int Dh, float scale, void* stream) {
  if (B < 1 || L < 1 || H < 1 || Dh != FA_DH || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (is_bf16) {
    // the kernel takes the row max of the raw scores, so the scale must not
    // turn their order round
    if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
    static int allowed[kMaxDevices];
    err = allow_smem_once(flash_attn_wgmma_kernel, FW_SMEM, allowed);
    if (err != cudaSuccess) return (int)err;
    // one map per tensor over its (H * 64, L, B) view: the three have
    // different bases and may have different strides. Rows past L of a box
    // read as zero.
    CUtensorMap maps[3];
    const void* base[3] = {q, k, v};
    const long long strides[3][2] = {{qs1, qs0}, {ks1, ks0}, {vs1, vs0}};
    for (int i = 0; i < 3; ++i) {
      const int rc = encode_bf16_3d_sw128(&maps[i], base[i], (uint64_t)H * FA_DH, (uint64_t)L,
                                          (uint64_t)B, (uint64_t)strides[i][0] * 2,
                                          (uint64_t)strides[i][1] * 2, FW_BN);
      if (rc) return rc;
    }
    const dim3 grid((unsigned)((L + FW_BM - 1) / FW_BM), (unsigned)(B * H));
    flash_attn_wgmma_kernel<<<grid, FW_THREADS, FW_SMEM, st>>>(
        maps[0], maps[1], maps[2], (__nv_bfloat16*)out, L, H, scale * 1.4426950408889634f);
  } else {
    static int allowed[kMaxDevices];
    err = allow_smem_once(flash_attn_simt_kernel, FA_SIMT_SMEM, allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((L + FA_BM - 1) / FA_BM), (unsigned)(B * H));
    flash_attn_simt_kernel<<<grid, FA_SIMT_THREADS, FA_SIMT_SMEM, st>>>(
        (const float*)q, (const float*)k, (const float*)v, qs0, qs1, ks0, ks1, vs0, vs1,
        (float*)out, L, H, scale);
  }
  return (int)cudaGetLastError();
}

const char* flash_attn_error_string(int code) {
  if (code >= kTensorMapError) return "cuTensorMapEncodeTiled failed (code - 100000 is its CUresult)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
