// Multi-scale deformable attention, backward, for NVIDIA Hopper (sm_90a).
//
// The gradient of kernel B1 (msdeform_fwd.cu) with respect to its three
// inputs. The JAX package has no backward TPU kernel: it differentiates the
// plain forms through XLA (dvis_plus_tpu/ops/msdeform.py::ms_deform_attn,
// and dvis_plus_tpu/ops/msdeform_pallas.py::_local_bwd, which takes the
// gradient of _local_exact_oracle). So this code is held against autograd
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
// Outputs: grad_value (B, Len, M, D) in value's type (fp32 sums, one
// rounding at the store; every element written once, so no zero fill);
// grad_loc like loc; grad_attn like attn.
//
// What bounds it on this card. The bytes each tensor moves once are 1.626
// GB at the training encoder's (40, 7560, 8, 32) fp32 (three levels), 0.485
// ms at 3.35 TB/s. Beyond them the backward does the forward's gather again
// (four corners x D channels a sample, 14.9 GB there, out of L1 and L2, for
// the dot products with g) and a scatter of as many additions (3.7 G there)
// into grad_value, which is what costs. On an NVIDIA H100 80GB HBM3 at 700 W
// (tools/b1_backward_ablation.py, chip_smoke.py --b1-backward; PERF.md):
// - the first version (one warp a query and head, its lanes the channels,
//   each addition an fp32 atomic to device memory) took 11.6 ms; without its
//   atomics 8.2, without its shuffles 10.7, without both 7.6. The gather,
//   one sample at a time a warp at 109 registers, cost most; the L2 atomics
//   3.4 ms; the shuffles 0.9;
// - a shared-memory fp32 atomicAdd is a compare-and-swap loop on this card
//   (ATOMS.CAST.SPIN). Summing the value gradient in a shared-memory window
//   with it took 12.1 ms: neighbouring samples hit the same pixels, and the
//   retries serialise (the initialisation's offsets, which share the most
//   corners, were slower still).
// So the additions are never atomic on floats. The design, 1 + 1 + L
// launches a call on the caller's stream:
//
// 1. msdeform_bwd_sample_kernel: grad_attn and grad_loc, a gather shaped as
//    the forward is. A block of 256 threads takes a run of queries; one
//    thread a sample computes the pixel coordinates, the clamp and its
//    gradient factors, the floor, the corner mask and the offset once, into
//    shared memory (the forward's phase 1, with the explicit
//    round-to-nearest operations). Then a thread owns 16 bytes of a head's
//    channels (4 fp32 or 8 bf16) of one query and reads each corner with
//    one 16-byte load; the three dot products of a sample are summed over
//    the head's 8 lanes in 3 shuffle steps each, 4 samples a warp at once
//    (9 shuffles for 4 samples, not 18 for one). The scalar instantiation (a
//    thread a channel) takes every other row width and alignment.
// 2. msdeform_bwd_sort_kernel: a counting sort of each (batch element, head,
//    level)'s samples by the cell of their corners (shared-memory integer
//    atomics, which are native), into 16-byte records (weight, fractions,
//    query) and each cell's first place.
// 3. msdeform_bwd_value_kernel, a launch a level: a block holds a band of
//    the level's rows, all D channels of a head, in shared memory as fp32;
//    G lanes take a cell, sum a * w_c * g over its samples for its four
//    corners in registers, and add the four sums to the band with plain
//    read-modify-writes, the cells in four passes by the parity of their row
//    and column so that no two lanes write one element at once. The bands
//    tile the level, every element of grad_value is written once, rounded
//    once to the value's type: no zero fill, no rounding pass. The order of
//    a cell's samples varies from run to run, so grad_value's bits may too
//    (tests hold it to 1e-5 of the largest gradient).
// What bounds the result: the gather of (1), as the forward is bound; the
// sort's scattered 16-byte records; and the value gradient's reads of g, a
// 128-byte row a sample at the training shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msdeform_levels.cuh"

#define MSDEFORM_BWD_THREADS 256         // the sample-gradient kernel's block
#define MSDEFORM_BWD_SAMPLE_BYTES 20     // its shared memory a sample: float4 + int
#define MSDEFORM_BWD_SAMPLE_SMEM (48 * 1024)
#define MSDEFORM_BWD_SORT_THREADS 1024   // the sort kernel's block
#define MSDEFORM_BWD_VALUE_THREADS 1024  // the value-gradient kernel's block
#define MSDEFORM_BWD_BATCH 4             // samples of a cell whose loads go out together
// what a block may ask for: the card's 232,448 bytes less a kilobyte for the
// kernel's static shared memory
#define MSDEFORM_BWD_MAX_SMEM (232448 - 1024)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The gradient factor of min(max(x, lo), hi) with respect to x, as
// torch.maximum and torch.minimum give it: 1 inside, 0 where clamped, half
// on each tie.
__device__ __forceinline__ float clamp_grad(float x, float lo, float hi) {
  const float f_lo = x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
  const float t = fmaxf(x, lo);
  const float f_hi = t < hi ? 1.f : (t == hi ? 0.5f : 0.f);
  return f_lo * f_hi;
}

// One sample's bilinear footprint at value level l, computed exactly as the
// forward does (explicit round-to-nearest operations, so a coordinate falls
// on the twin's side of a pixel boundary and of the clamp).
struct Footprint {
  int x0, y0;      // the top-left corner (-1 where it lies left of / above the level)
  float wx1, wy1;  // the fractions; 0 where the sample reaches no corner
  float fx, fy;    // the clamp's gradient factors (1 in the exact form)
  bool inside;     // some corner lies in the level (false for a NaN location)
};

__device__ __forceinline__ Footprint footprint(float2 xy, const LevelTable& lv, int L, int l,
                                               int q, int radius) {
  const float Hf = (float)lv.H[l];
  const float Wf = (float)lv.W[l];
  float x = __fsub_rn(__fmul_rn(xy.x, Wf), 0.5f);
  float y = __fsub_rn(__fmul_rn(xy.y, Hf), 0.5f);
  Footprint f;
  f.fx = f.fy = 1.f;
  if (radius >= 0) {
    // the queries are the level grids: query q is cell (qi, qj) of level g
    const float R = (float)radius;
    const int g = msdeform_query_level(lv, L, q);
    const int cell = q - lv.start[g];
    const int ci = cell / lv.W[g];
    const float qi = (float)ci;
    const float qj = (float)(cell - ci * lv.W[g]);
    const float ry = __fmul_rn(qi + 0.5f, lv.sy[g][l]);
    const float rx = __fmul_rn(qj + 0.5f, lv.sx[g][l]);
    const float xlo = __fsub_rn(rx, R), xhi = __fadd_rn(rx, R);
    const float ylo = __fsub_rn(ry, R), yhi = __fadd_rn(ry, R);
    f.fx = clamp_grad(x, xlo, xhi);
    f.fy = clamp_grad(y, ylo, yhi);
    x = fminf(fmaxf(x, xlo), xhi);
    y = fminf(fmaxf(y, ylo), yhi);
    x = __fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(x, 0.5f), Wf), Wf), 0.5f);
    y = __fsub_rn(__fmul_rn(__fdiv_rn(__fadd_rn(y, 0.5f), Hf), Hf), 0.5f);
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  f.inside = x0f >= -1.f && x0f < Wf && y0f >= -1.f && y0f < Hf;
  f.x0 = f.inside ? (int)x0f : 0;
  f.y0 = f.inside ? (int)y0f : 0;
  f.wx1 = f.inside ? x - x0f : 0.f;
  f.wy1 = f.inside ? y - y0f : 0.f;
  return f;
}

// ---------------------------------------------------------------------------
// 1. grad_attn and grad_loc
// ---------------------------------------------------------------------------

// VEC channels of one head as floats: read under a predicate.
template <typename T, int VEC>
struct Chunk;

template <>
struct Chunk<float, 4> {
  static __device__ __forceinline__ void load_if(const float* p, bool on, float* v) {
    const float4 x = ldg16_if(p, on);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};

template <>
struct Chunk<__nv_bfloat16, 8> {
  // a bf16 is the upper half of an fp32: two of them per 32-bit word, the
  // lower address in the lower half
  static __device__ __forceinline__ void split(unsigned u, float* v) {
    v[0] = __uint_as_float(u << 16);
    v[1] = __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ void load_if(const __nv_bfloat16* p, bool on, float* v) {
    const uint4 x = ldg16_if(p, on);
    split(x.x, v);
    split(x.y, v + 2);
    split(x.z, v + 4);
    split(x.w, v + 6);
  }
};

template <typename T>
struct Chunk<T, 1> {
  static __device__ __forceinline__ void load_if(const T* p, bool on, float* v) {
    v[0] = on ? to_float(__ldg(p)) : 0.f;
  }
};

// The flags word of a sample: bit c (0..3) set where corner c (00, 01, 10,
// 11) lies in the level; bits 4-5 and 6-7 the clamp's factors fx and fy in
// halves (0, 1 or 2).
__device__ __forceinline__ int sample_flags(const Footprint& f, int H, int W) {
  if (!f.inside) return 0;
  const bool left = f.x0 >= 0, right = f.x0 + 1 < W;
  const bool top = f.y0 >= 0, bottom = f.y0 + 1 < H;
  return (int)(top && left) | (int)(top && right) << 1 | (int)(bottom && left) << 2 |
         (int)(bottom && right) << 3 | (int)(2.f * f.fx) << 4 | (int)(2.f * f.fy) << 6;
}

// A block of MSDEFORM_BWD_THREADS takes queries blockIdx.x * TQ .. + TQ - 1
// of batch element blockIdx.y; G lanes (a power of two <= 32) share one
// (query, head) and each owns D / VEC / G chunks of VEC channels. Shared
// memory: TQ * M * L * P * MSDEFORM_BWD_SAMPLE_BYTES.
template <typename T, int VEC, bool ONE_CHUNK>
__global__ void __launch_bounds__(MSDEFORM_BWD_THREADS, 4)
msdeform_bwd_sample_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                           const void* __restrict__ attn, int attn_is_bf16,
                           const T* __restrict__ grad_out, float* __restrict__ grad_loc,
                           void* __restrict__ grad_attn, int Len, int Lq, int M, int D, int L,
                           int P, LevelTable lv, int TQ, int G, int radius) {
  extern __shared__ float4 smem[];
  const int LP = L * P;
  const int S = M * LP;
  float4* srec = smem;                 // [TQ * S] (wx1, wy1, a, flags)
  int* soff = (int*)(srec + TQ * S);   // [TQ * S] element offset of corner (y0, x0)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = (int)blockIdx.x * TQ;
  const int nq = min(TQ, Lq - q0);
  const int MD = M * D;

  // phase 1: every sample of the run, once
  for (int t = tid; t < nq * S; t += MSDEFORM_BWD_THREADS) {
    const int ql = t / S;
    const int r = t - ql * S;  // (m * L + l) * P + p
    const int q = q0 + ql;
    const int m = r / LP;
    const int l = (r - m * LP) / P;
    const long si = ((long)b * Lq + q) * S + r;
    const float2 xy = __ldcs((const float2*)loc + si);
    const float a = attn_is_bf16 ? __bfloat162float(((const __nv_bfloat16*)attn)[si])
                                 : __ldcs((const float*)attn + si);
    const Footprint f = footprint(xy, lv, L, l, q, radius);
    const int flags = sample_flags(f, lv.H[l], lv.W[l]);
    srec[t] = make_float4(f.wx1, f.wy1, a, __int_as_float(flags));
    soff[t] = flags ? ((lv.start[l] + f.y0 * lv.W[l] + f.x0) * M + m) * D : 0;
  }
  __syncthreads();

  // phase 2: work item = G lanes of one (query, head); the loop runs whole
  // warps, so that the group reductions' shuffles see every lane
  const int lane = tid & 31;
  const int CPG = D / VEC;
  const int nch = ONE_CHUNK ? 1 : CPG / G;  // chunks a lane
  const int items = nq * M * G;
  const T* vb = value + (long)b * Len * MD;
  for (int w0 = tid - lane; w0 < items; w0 += MSDEFORM_BWD_THREADS) {
    const int wi = w0 + lane;
    const bool active = wi < items;
    const int grp = active ? wi / G : 0;  // ql * M + m
    const int j = wi - (wi / G) * G;
    const int ql = grp / M;
    const int m = grp - ql * M;
    const int q = q0 + ql;
    const T* go = grad_out + ((long)b * Lq + q) * MD + m * D;
    float g1[VEC];  // this lane's chunk of g when it has one
    if (ONE_CHUNK) Chunk<T, VEC>::load_if(go + j * VEC, active, g1);
    const int s0 = grp * LP;
    for (int l = 0; l < L; ++l) {
      const int row = lv.W[l] * MD;  // one pixel down
      const float Wf = (float)lv.W[l];
      const float Hf = (float)lv.H[l];
#pragma unroll 1
      for (int p = 0; p < P; ++p) {
        const int s = s0 + l * P + p;
        const float4 rec = srec[s];
        const int flags = active ? __float_as_int(rec.w) : 0;
        const int o = soff[s];
        const float wx1 = rec.x, wy1 = rec.y, wx0 = 1.f - wx1, wy0 = 1.f - wy1;
        float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;  // g . v_c over this lane's channels
        for (int k = 0; k < nch; ++k) {
          const int c = (j + G * k) * VEC;
          float gv[VEC], v00[VEC], v01[VEC], v10[VEC], v11[VEC];
          if (ONE_CHUNK) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) gv[e] = g1[e];
          } else {
            Chunk<T, VEC>::load_if(go + c, active, gv);
          }
          Chunk<T, VEC>::load_if(vb + o + c, flags & 1, v00);
          Chunk<T, VEC>::load_if(vb + o + c + MD, flags & 2, v01);
          Chunk<T, VEC>::load_if(vb + o + c + row, flags & 4, v10);
          Chunk<T, VEC>::load_if(vb + o + c + row + MD, flags & 8, v11);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            p00 = fmaf(gv[e], v00[e], p00);
            p01 = fmaf(gv[e], v01[e], p01);
            p10 = fmaf(gv[e], v10[e], p10);
            p11 = fmaf(gv[e], v11[e], p11);
          }
        }
        float sa = wy0 * wx0 * p00 + wy0 * wx1 * p01 + wy1 * wx0 * p10 + wy1 * wx1 * p11;
        float sx = wy0 * (p01 - p00) + wy1 * (p11 - p10);
        float sy = wx0 * (p10 - p00) + wx1 * (p11 - p01);
        for (int off = G >> 1; off > 0; off >>= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, off);
          sx += __shfl_xor_sync(0xffffffffu, sx, off);
          sy += __shfl_xor_sync(0xffffffffu, sy, off);
        }
        if (active && j == 0) {
          const long si = ((long)b * Lq + q0) * S + s;
          const float a = rec.z;
          // d loc_x: the twin's chain x = loc * W - 0.5 (clamped form: x =
          // loc * W - 0.5, clamp, loc' = (x + 0.5) / W, x' = loc' * W - 0.5)
          float gx = __fmul_rn(a * sx, Wf);
          float gy = __fmul_rn(a * sy, Hf);
          if (radius >= 0) {
            gx = __fmul_rn(__fdiv_rn(gx, Wf), Wf) * (0.5f * (float)((flags >> 4) & 3));
            gy = __fmul_rn(__fdiv_rn(gy, Hf), Hf) * (0.5f * (float)((flags >> 6) & 3));
          }
          __stcs((float2*)grad_loc + si, make_float2(gx, gy));
          if (attn_is_bf16)
            ((__nv_bfloat16*)grad_attn)[si] = __float2bfloat16_rn(sa);
          else
            __stcs((float*)grad_attn + si, sa);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. grad_value: samples sorted by corner cell, then summed a cell at a time
// ---------------------------------------------------------------------------

// The cells of a value level: a sample's corner (y0, x0) has y0 in [-1, H)
// and x0 in [-1, W), so its cell key is (y0 + 1) * (W + 1) + (x0 + 1),
// row-major. The levels' cells follow each other in one array, each level's
// with one slot more (its end).
__host__ __device__ __forceinline__ int cell_base(const LevelTable& lv, int l) {
  int base = 0;
#pragma unroll
  for (int k = 0; k < MSDEFORM_MAX_LEVELS; ++k)
    if (k < l) base += (lv.H[k] + 1) * (lv.W[k] + 1) + 1;
  return base;
}

// Block (b * M + m) * L + l sorts the samples of (b, m) at value level l by
// cell: a thread takes a query's P samples (their locations and weights read
// together), counts each in its cell (shared-memory integer atomics, which
// are native), an exclusive scan over the level's cells gives each its first
// place, and a second pass puts every sample there as one 16-byte record:
// its attention weight, its fractions wx1 and wy1, and its query. A sample
// that reaches no corner, or whose weight is 0, is left out. Writes the
// level's cell_start [(H + 1) (W + 1) + 1] and up to Lq * P records; the
// samples of one cell keep no fixed order. Shared memory: as many ints as
// cell_start.
__global__ void __launch_bounds__(MSDEFORM_BWD_SORT_THREADS, 1)
msdeform_bwd_sort_kernel(const float* __restrict__ loc, const void* __restrict__ attn,
                         int attn_is_bf16, int Lq, int M, int L, int P, LevelTable lv, int cells,
                         int radius, int* __restrict__ cell_start, float4* __restrict__ rec) {
  extern __shared__ int hist[];  // [(H + 1) * (W + 1) + 1]
  __shared__ int warp_sums[MSDEFORM_BWD_SORT_THREADS / 32];
  const int l = blockIdx.x % L;
  const int bm = blockIdx.x / L;
  const int m = bm % M;
  const int b = bm / M;
  const int W = lv.W[l];
  const int nc = (lv.H[l] + 1) * (W + 1) + 1;
  const int LP = L * P;
  const int tid = threadIdx.x;
  int* starts = cell_start + (long)bm * cells + cell_base(lv, l);
  float4* out = rec + ((long)bm * L + l) * Lq * P;
  for (int i = tid; i < nc; i += MSDEFORM_BWD_SORT_THREADS) hist[i] = 0;
  __syncthreads();

  for (int pass = 0; pass < 2; ++pass) {
    for (int q = tid; q < Lq; q += MSDEFORM_BWD_SORT_THREADS) {
      const long s0 = (((long)b * Lq + q) * M + m) * LP + l * P;
      for (int p0 = 0; p0 < P; p0 += MSDEFORM_BWD_BATCH) {
        float2 xy[MSDEFORM_BWD_BATCH];
        float a[MSDEFORM_BWD_BATCH];
#pragma unroll
        for (int k = 0; k < MSDEFORM_BWD_BATCH; ++k) {
          const bool on = p0 + k < P;
          xy[k] = on ? __ldg((const float2*)loc + s0 + p0 + k) : make_float2(0.f, 0.f);
          a[k] = !on ? 0.f
                     : attn_is_bf16 ? __bfloat162float(((const __nv_bfloat16*)attn)[s0 + p0 + k])
                                    : __ldg((const float*)attn + s0 + p0 + k);
        }
#pragma unroll
        for (int k = 0; k < MSDEFORM_BWD_BATCH; ++k) {
          if (a[k] == 0.f) continue;  // also the batch's tail past P
          const Footprint f = footprint(xy[k], lv, L, l, q, radius);
          if (!f.inside) continue;
          const int key = (f.y0 + 1) * (W + 1) + f.x0 + 1;
          if (pass == 0)
            atomicAdd(hist + key, 1);
          else
            out[atomicAdd(hist + key, 1)] = make_float4(a[k], f.wx1, f.wy1, __int_as_float(q));
        }
      }
    }
    __syncthreads();
    if (pass == 1) break;
    // exclusive scan of the counts: a thread sums a run of cells, the
    // threads' sums are scanned across the block, then each run is rescanned
    const int per = (nc + MSDEFORM_BWD_SORT_THREADS - 1) / MSDEFORM_BWD_SORT_THREADS;
    const int c0 = min(tid * per, nc), c1 = min(c0 + per, nc);
    int sum = 0;
    for (int c = c0; c < c1; ++c) sum += hist[c];
    const int lane = tid & 31;
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[tid >> 5] = incl;
    __syncthreads();
    if (tid < 32) {
      int w = tid < MSDEFORM_BWD_SORT_THREADS / 32 ? warp_sums[tid] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (tid >= o) w += y;
      }
      if (tid < MSDEFORM_BWD_SORT_THREADS / 32) warp_sums[tid] = w;  // inclusive
    }
    __syncthreads();
    int run = incl - sum + ((tid >> 5) ? warp_sums[(tid >> 5) - 1] : 0);  // exclusive
    for (int c = c0; c < c1; ++c) {
      const int k = hist[c];
      hist[c] = run;
      starts[c] = run;
      run += k;
    }
    __syncthreads();
  }
}

// at[0 .. N) += s, 16 bytes at a time where N allows (at is then aligned).
template <int N>
__device__ __forceinline__ void add_to(float* at, const float* s) {
  if (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      float4 v = *(float4*)(at + e);
      v.x += s[e];
      v.y += s[e + 1];
      v.z += s[e + 2];
      v.w += s[e + 3];
      *(float4*)(at + e) = v;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) at[e] += s[e];
  }
}

// Block blockIdx.x = (b * M + m) * bands + band of value level l: rows
// [band * rows, band * rows + rows) of the level, all D channels of head m,
// held as fp32 in shared memory. G lanes take a cell whose corners touch
// the band, each VEC channels at a time (D / VEC / G chunks): they sum a *
// w_c * g over the cell's samples for its four corners c in registers, then
// add the four sums to the window with plain read-modify-writes. The cells
// go in four passes by the parity of their row and column: two cells of one
// pass share no pixel, so no two lanes ever write the same element at once.
// Last the block stores its band, rounded once to the value's type.
template <typename T, int VEC>
__global__ void __launch_bounds__(MSDEFORM_BWD_VALUE_THREADS, 1)
msdeform_bwd_value_kernel(const int* __restrict__ cell_start, const float4* __restrict__ rec,
                          const T* __restrict__ grad_out,
                          T* __restrict__ grad_value, int Len, int Lq, int M, int D, int L, int P,
                          LevelTable lv, int cells, int l, int rows, int bands, int G) {
  extern __shared__ float4 smem[];
  const int band = blockIdx.x % bands;
  const int bm = blockIdx.x / bands;
  const int m = bm % M;
  const int b = bm / M;
  const int W = lv.W[l];
  const int H = lv.H[l];
  const int r0 = band * rows;
  const int nrows = min(rows, H - r0);
  float* win = (float*)smem;  // [rows * W * D]
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * W * D; i += MSDEFORM_BWD_VALUE_THREADS) win[i] = 0.f;
  __syncthreads();

  const int MD = M * D;
  const int j = tid % G;  // this lane's place in its cell's group
  const int grp = tid / G;
  const int ngrp = MSDEFORM_BWD_VALUE_THREADS / G;
  const int nch = D / VEC / G;
  const int* starts = cell_start + (long)bm * cells + cell_base(lv, l);
  const float4* recs = rec + ((long)bm * L + l) * Lq * P;
  const T* gb = grad_out + (long)b * Lq * MD + m * D;
  const int WD = W * D;
  // the cells whose corners touch rows [r0, r0 + nrows): y0 in [r0 - 1, r0 +
  // nrows - 1], i.e. key rows ky = y0 + 1 in [r0, r0 + nrows]
  for (int color = 0; color < 4; ++color) {
    const int ky0 = r0 + ((color >> 1) - r0 & 1);  // the first key row of this parity
    const int kx0 = color & 1;
    const int ny = ky0 > r0 + nrows ? 0 : (r0 + nrows - ky0) / 2 + 1;
    const int nx = (W - kx0 + 2) / 2;
    for (int i = grp; i < ny * nx; i += ngrp) {
      const int iy = i / nx;
      const int ky = ky0 + 2 * iy;
      const int kx = kx0 + 2 * (i - iy * nx);
      const int key = ky * (W + 1) + kx;
      const int j0 = starts[key], j1 = starts[key + 1];
      if (j1 == j0) continue;
      // corner 00 of the cell is pixel (ky - 1, kx - 1): window row y
      const int y = ky - 1 - r0, x = kx - 1;
      const bool top = y >= 0, bottom = y + 1 < nrows, left = x >= 0, right = x + 1 < W;
      // the corners in the level (the others weigh 0, as in the twin)
      const bool in_t = ky >= 1, in_b = ky < H, in_l = kx >= 1, in_r = kx < W;
      for (int k = 0; k < nch; ++k) {
        const int c = (j + G * k) * VEC;
        float s00[VEC], s01[VEC], s10[VEC], s11[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) s00[e] = s01[e] = s10[e] = s11[e] = 0.f;
        for (int j2 = j0; j2 < j1; j2 += MSDEFORM_BWD_BATCH) {
          float4 w[MSDEFORM_BWD_BATCH];
          int q[MSDEFORM_BWD_BATCH];
#pragma unroll
          for (int r = 0; r < MSDEFORM_BWD_BATCH; ++r) {
            const int jr = j2 + r;
            const float4 e = jr < j1 ? recs[jr] : make_float4(0.f, 0.f, 0.f, 0.f);
            const float wx0 = 1.f - e.y, wy0 = 1.f - e.z;
            // a * w_c in the twin's order: (wy * wx) * a
            w[r] = make_float4((in_t && in_l) ? wy0 * wx0 * e.x : 0.f,
                               (in_t && in_r) ? wy0 * e.y * e.x : 0.f,
                               (in_b && in_l) ? e.z * wx0 * e.x : 0.f,
                               (in_b && in_r) ? e.z * e.y * e.x : 0.f);
            q[r] = jr < j1 ? __float_as_int(e.w) : -1;
          }
#pragma unroll
          for (int r = 0; r < MSDEFORM_BWD_BATCH; ++r) {
            float g[VEC];
            Chunk<T, VEC>::load_if(gb + (long)max(q[r], 0) * MD + c, q[r] >= 0, g);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              s00[e] = fmaf(w[r].x, g[e], s00[e]);
              s01[e] = fmaf(w[r].y, g[e], s01[e]);
              s10[e] = fmaf(w[r].z, g[e], s10[e]);
              s11[e] = fmaf(w[r].w, g[e], s11[e]);
            }
          }
        }
        float* at = win + y * WD + x * D + c;
        if (top && left) add_to<VEC>(at, s00);
        if (top && right) add_to<VEC>(at + D, s01);
        if (bottom && left) add_to<VEC>(at + WD, s10);
        if (bottom && right) add_to<VEC>(at + WD + D, s11);
      }
    }
    __syncthreads();
  }

  // the band, rounded once, to its place in grad_value
  T* out = grad_value + ((long)b * Len + lv.start[l] + (long)r0 * W) * MD + m * D;
  for (int i = tid; i < nrows * WD; i += MSDEFORM_BWD_VALUE_THREADS) {
    const int px = i / D;
    store_as(out + (long)px * MD + (i - px * D), win[i]);
  }
}

template <typename T, int VEC>
static cudaError_t launch_sample(const void* value, const float* loc, const void* attn,
                                 int attn_is_bf16, const void* grad_out, float* grad_loc,
                                 void* grad_attn, int B, int Len, int Lq, int M, int D, int L,
                                 int P, const LevelTable& lv, int TQ, int G, int radius,
                                 cudaStream_t st) {
  const dim3 grid((unsigned)((Lq + TQ - 1) / TQ), (unsigned)B);
  const size_t smem = (size_t)TQ * M * L * P * MSDEFORM_BWD_SAMPLE_BYTES;
  if (D / VEC == G)
    msdeform_bwd_sample_kernel<T, VEC, true><<<grid, MSDEFORM_BWD_THREADS, smem, st>>>(
        (const T*)value, loc, attn, attn_is_bf16, (const T*)grad_out, grad_loc, grad_attn, Len,
        Lq, M, D, L, P, lv, TQ, G, radius);
  else
    msdeform_bwd_sample_kernel<T, VEC, false><<<grid, MSDEFORM_BWD_THREADS, smem, st>>>(
        (const T*)value, loc, attn, attn_is_bf16, (const T*)grad_out, grad_loc, grad_attn, Len,
        Lq, M, D, L, P, lv, TQ, G, radius);
  return cudaGetLastError();
}

template <typename T, int VEC>
static cudaError_t launch_value(const float* loc, const void* attn, int attn_is_bf16,
                                const void* grad_out, void* grad_value, int* cell_start,
                                float4* rec, int B, int Len, int Lq, int M, int D,
                                int L, int P, const LevelTable& lv, const int* rows, int G,
                                int radius, cudaStream_t st) {
  const int cells = cell_base(lv, L);
  int nc = 0;  // the most cells of a level
  for (int l = 0; l < L; ++l) nc = max(nc, (lv.H[l] + 1) * (lv.W[l] + 1) + 1);
  const size_t sort_smem = (size_t)nc * sizeof(int);
  cudaError_t rc = cudaFuncSetAttribute(msdeform_bwd_sort_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)sort_smem);
  if (rc != cudaSuccess) return rc;
  msdeform_bwd_sort_kernel<<<(unsigned)(B * M * L), MSDEFORM_BWD_SORT_THREADS, sort_smem, st>>>(
      loc, attn, attn_is_bf16, Lq, M, L, P, lv, cells, radius, cell_start, rec);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  for (int l = 0; l < L; ++l) {
    const int bands = (lv.H[l] + rows[l] - 1) / rows[l];
    const size_t smem = (size_t)rows[l] * lv.W[l] * D * sizeof(float);
    rc = cudaFuncSetAttribute(msdeform_bwd_value_kernel<T, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
    msdeform_bwd_value_kernel<T, VEC>
        <<<(unsigned)(B * M * bands), MSDEFORM_BWD_VALUE_THREADS, smem, st>>>(
            cell_start, rec, (const T*)grad_out, (T*)grad_value, Len, Lq, M, D, L, P, lv,
            cells, l, rows[l], bands, G);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

extern "C" {

// Launches on `stream` and returns the CUDA error code; the caller raises on
// a non-zero code. grad_value: (B, Len, M, D) in value's type, written whole
// (no zero fill needed). shapes: host int32 array of L (H, W) pairs, the
// value levels. queries, vector, group: the sample-gradient kernel's run of
// queries a block, its 16-byte instantiation, its lanes a (query, head).
// rows: host int32 array of L, each level's band of rows for the
// value-gradient kernel (ops/msdeform.py::backward_plan chooses all of
// them). Scratch, written before it is read: cell_start, int32 of B * M *
// sum_l ((H_l + 1) (W_l + 1) + 1); rec, float4 of L * B * M * Lq * P.
int msdeform_bwd(const void* value, int value_is_bf16, const void* loc, const void* attn,
                 int attn_is_bf16, const void* grad_out, void* grad_value, void* grad_loc,
                 void* grad_attn, int B, int Len, int Lq, int M, int D, int L, int P,
                 const int* shapes, int radius, int queries, int vector, int group,
                 const int* rows, void* cell_start, void* rec, void* stream) {
  if (M < 1 || D < 1 || P < 1 || B < 1 || B > 65535 || Lq < 1 || queries < 1 ||
      (radius >= 0 && Lq != Len) ||
      (long)queries * M * L * P * MSDEFORM_BWD_SAMPLE_BYTES > MSDEFORM_BWD_SAMPLE_SMEM ||
      (long)L * B * M * Lq * P > 2147483647L || (uintptr_t)rec % 16 != 0)
    return (int)cudaErrorInvalidValue;
  LevelTable lv;
  const cudaError_t bad = msdeform_level_table(shapes, L, Len, M, D, &lv);
  if (bad != cudaSuccess) return (int)bad;
  const int itemsize = value_is_bf16 ? 2 : 4;
  const int VEC = vector ? 16 / itemsize : 1;
  if (vector && ((D * itemsize) % 16 != 0 || (uintptr_t)value % 16 != 0 ||
                 (uintptr_t)grad_out % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const int CPG = D / VEC;
  if (group < 1 || group > 32 || (group & (group - 1)) || CPG % group) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (rows[l] < 1 || rows[l] > lv.H[l] ||
        (long)rows[l] * lv.W[l] * D * sizeof(float) > MSDEFORM_BWD_MAX_SMEM)
      return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (((long)lv.H[l] + 1) * (lv.W[l] + 1) * sizeof(int) + sizeof(int) > MSDEFORM_BWD_MAX_SMEM)
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* locf = (const float*)loc;
  int* cs = (int*)cell_start;
  float4* rw = (float4*)rec;
  cudaError_t rc;
  if (value_is_bf16) {
    rc = vector ? launch_sample<__nv_bfloat16, 8>(value, locf, attn, attn_is_bf16, grad_out,
                                                  (float*)grad_loc, grad_attn, B, Len, Lq, M, D, L,
                                                  P, lv, queries, group, radius, st)
                : launch_sample<__nv_bfloat16, 1>(value, locf, attn, attn_is_bf16, grad_out,
                                                  (float*)grad_loc, grad_attn, B, Len, Lq, M, D, L,
                                                  P, lv, queries, group, radius, st);
    if (rc == cudaSuccess)
      rc = vector ? launch_value<__nv_bfloat16, 8>(locf, attn, attn_is_bf16, grad_out, grad_value,
                                                   cs, rw, B, Len, Lq, M, D, L, P, lv, rows,
                                                   group, radius, st)
                  : launch_value<__nv_bfloat16, 1>(locf, attn, attn_is_bf16, grad_out, grad_value,
                                                   cs, rw, B, Len, Lq, M, D, L, P, lv, rows,
                                                   group, radius, st);
  } else {
    rc = vector ? launch_sample<float, 4>(value, locf, attn, attn_is_bf16, grad_out,
                                          (float*)grad_loc, grad_attn, B, Len, Lq, M, D, L, P, lv,
                                          queries, group, radius, st)
                : launch_sample<float, 1>(value, locf, attn, attn_is_bf16, grad_out,
                                          (float*)grad_loc, grad_attn, B, Len, Lq, M, D, L, P, lv,
                                          queries, group, radius, st);
    if (rc == cudaSuccess)
      rc = vector ? launch_value<float, 4>(locf, attn, attn_is_bf16, grad_out, grad_value, cs, rw,
                                           B, Len, Lq, M, D, L, P, lv, rows, group, radius, st)
                  : launch_value<float, 1>(locf, attn, attn_is_bf16, grad_out, grad_value, cs, rw,
                                           B, Len, Lq, M, D, L, P, lv, rows, group, radius, st);
  }
  return (int)rc;
}

}  // extern "C"
