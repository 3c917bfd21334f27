// What the port's tensor-core kernels share (NVIDIA Hopper, sm_90a):
//
// - warp-level pieces: bf16 packing, 16-byte cp.async, ldmatrix and
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate);
// - mbarrier: init, arrive with an expected byte count, arrive, wait on a
//   phase parity;
// - the once-per-device set-up of a kernel that asks for more than 48 KB of
//   dynamic shared memory;
// - TMA: the host-side tensor-map encoder (cuTensorMapEncodeTiled, fetched
//   from libcuda through the runtime so that the library links against
//   the runtime alone) and the 3-D tile load that reports to an mbarrier;
// - wgmma: fence / commit / wait, the shared-memory matrix descriptor for
//   128-byte-swizzled tiles, and the two instruction shapes the attention
//   kernel uses (m64n128k16 with A and B in shared memory, m64n64k16 with
//   A in registers and an MN-major B).
//
// Layout conventions of the wgmma pieces. A tile is rows of 64 bf16 = 128
// bytes, written by TMA with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte
// aligned buffer: the 16-byte chunk c of row r lands at chunk c ^ (r % 8).
// Eight rows (1024 bytes) are one swizzle atom; the descriptor's stride
// offset is the distance between atoms (1024) and its layout type is 1
// (128-byte swizzle).
// - K-major operand (the 64 bf16 of a row are the product's inner
//   dimension: Q as A, K as B of Q K^T): one instruction takes 16 inner
//   elements = 32 bytes of every row, so the next k-step is the same
//   descriptor with the start address 32 bytes on.
// - MN-major operand (a row is one inner index, its 64 bf16 are the output
//   columns: V as B of P V, with the instruction's transpose-B bit set):
//   one instruction takes 16 rows = 2 atoms, so the next k-step is the
//   start address 2048 bytes on.
// Accumulator fragments (m64nN, per warp w of the warpgroup and lane):
// d[4 j + e] is row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) +
// e % 2: the mma.sync m16n8 C fragments side by side. The A fragment of the
// register form is mma.sync's m16k16 A fragment.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<const uint32_t*>(&x);
}

// 2^x, one instruction; 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; !valid zero-fills (src-size 0, nothing is read)
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_src) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem_src))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_src) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem_src))
               : "memory");
}

// D (16x8 fp32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(  // not volatile: a pure function of its operands, free to be scheduled
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16x8 fp32) = A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16_init(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

// after the inits, by the initialising thread, before the block-wide sync:
// makes them visible to the other threads and to the TMA unit
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as completed). A barrier that never
// completes is a bug in the kernel: trap rather than hang the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// one box of a 3-D tensor map -> shared memory; completion (the box's full
// byte count, out-of-range elements zero-filled and counted) goes to `bar`
__device__ __forceinline__ void tma_load_3d(void* smem_dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(smem_dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous instructions around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a 128-byte-swizzled tile (see the header note) at a shared
// address; the next k-step is desc + (bytes >> 4)
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t smem_addr) {
  uint64_t desc = (uint64_t)((smem_addr & 0x3FFFF) >> 4);
  desc |= (uint64_t)1 << 16;            // leading offset: unused by these layouts
  desc |= (uint64_t)(1024 >> 4) << 32;  // stride offset: one 8-row atom
  desc |= (uint64_t)1 << 62;            // 128-byte swizzle
  return desc;
}

#define HOPPER_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_D16(i) HOPPER_D4(i), HOPPER_D4(i + 4), HOPPER_D4(i + 8), HOPPER_D4(i + 12)

// d (64 x 128 fp32) = A (64 x 16, shared, K-major) B (128 x 16, shared,
// K-major) [+ d if accumulate]
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D16(0), HOPPER_D16(16), HOPPER_D16(32), HOPPER_D16(48)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 fp32) = A (64 x 16, registers) B (16 x 64, shared, MN-major:
// the transpose-B bit is set) [+ d if accumulate]
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D16(0), HOPPER_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#undef HOPPER_D16
#undef HOPPER_D4

// ---------------------------------------------------------------------------
// host: once per device
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Once per device and process: lets `kernel` ask for `bytes` of dynamic
// shared memory (more than the 48 KB a kernel may have unasked) and reads the
// device's SM count, which `state` keeps (0 = not done yet; one array per
// kernel, zero-initialised). Later calls cost one cudaGetDevice.
template <typename Kernel>
static inline cudaError_t allow_smem_once(Kernel kernel, int bytes, int (&state)[kMaxDevices],
                                          int* sm_count = nullptr) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!state[dev]) {
    int sms = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    state[dev] = sms;
  }
  if (sm_count) *sm_count = state[dev];
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// entry points return this plus the CUresult when an encode fails
// (CUDA runtime error codes stay below it)
constexpr int kTensorMapError = 100000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the loaded libcuda, looked up once
static inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return (EncodeTiledFn)p;
  }();
  return fn;
}

// A map over a bf16 tensor of dims (d0, d1, d2), d0 contiguous, with byte
// strides s1, s2 (multiples of 16) and a 16-byte aligned base; boxes of
// (64, box1, 1) elements land 128-byte swizzled. Elements of a box outside
// the dims read as zero. Returns 0 or kTensorMapError + CUresult.
static inline int encode_bf16_3d_sw128(CUtensorMap* map, const void* base, uint64_t d0,
                                       uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2,
                                       uint32_t box1) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return kTensorMapError;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + (int)res;
}

}  // namespace hopper
