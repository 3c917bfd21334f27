#!/usr/bin/env python3
"""Where B1's first backward kernel spends its time: an ablation on an H100.

Takes the simple backward kernel of kernel B1 (the one-warp-a-query design,
``csrc/msdeform_bwd.cu`` before its redesign; give its path with
``--source``, e.g. a ``git archive`` of that commit unpacked under
``build/``), writes three patched copies of it under
``build/b1_ablation/`` (never into the package) and times all four at the
training encoder's shape (40, 7560, 8, 32) fp32, exact form, uniform
offsets, as ``chip_smoke.py``'s ``b1_backward`` phase makes them:

- ``as_is``: the kernel unchanged;
- ``no_value_atomics``: the value gradient's atomicAdds replaced by a sum
  kept in a register (stored once, under a condition the compiler cannot
  decide), so every other instruction stays;
- ``no_shuffles``: the three broadcasts replaced by direct reads of the
  sample's location and weight, and the three warp reductions by the lane's
  own partial sums;
- ``neither``: both removed.

A patched copy computes wrong gradients: only its time is read. Then it
times a probe of shared-memory fp32 atomics (``atomicAdd`` on a 32-byte
pixel row, a warp adding one sample's four corners x 8 channels, the
pattern of the redesigned kernel) against plain read-modify-writes of the
same addresses, and prints the SASS opcodes that the shared atomic compiles
to (``cuobjdump``).

Run on a machine with an H100 and the CUDA toolkit, from the repository
root:

    python3 tools/b1_backward_ablation.py --source build/parent/dvis_plus_tpu_torch/csrc/msdeform_bwd.cu

Prints one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "b1_ablation")

# (name, [(old, new), ...]): text replacements on the PR 12 kernel
ATOMICS = [(
    """          if (ch && ga != 0.f) {
            if (on00) atomicAdd(gvb + o00 + c, w00 * ga);
            if (on01) atomicAdd(gvb + o01 + c, w01 * ga);
            if (on10) atomicAdd(gvb + o10 + c, w10 * ga);
            if (on11) atomicAdd(gvb + o11 + c, w11 * ga);
          }""",
    """          if (ch && ga != 0.f) {
            sink += (on00 ? w00 * ga : 0.f) + (on01 ? w01 * ga : 0.f) +
                    (on10 ? w10 * ga : 0.f) + (on11 ? w11 * ga : 0.f);
          }"""), (
    "  for (int base = 0; base < LP; base += 32) {",
    "  float sink = 0.f;\n  for (int base = 0; base < LP; base += 32) {"), (
    """        ((float*)grad_attn)[s] = sa;
      }
    }
  }
}""",
    """        ((float*)grad_attn)[s] = sa;
      }
    }
  }
  if (sink == 1234.5f) gvb[lane] = sink;
}""")]
SHUFFLES = [(
    """      const float xn = __shfl_sync(0xffffffffu, my_x, j);
      const float yn = __shfl_sync(0xffffffffu, my_y, j);
      const float a = __shfl_sync(0xffffffffu, my_a, j);""",
    """      const float2 xy_j = ((const float2*)loc)[s0 + r];
      const float xn = xy_j.x, yn = xy_j.y;
      const float a = attn_is_bf16 ? __bfloat162float(((const __nv_bfloat16*)attn)[s0 + r])
                                   : ((const float*)attn)[s0 + r];"""), (
    "  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);\n",
    "")]
VARIANTS = {"as_is": [], "no_value_atomics": ATOMICS, "no_shuffles": SHUFFLES,
            "neither": ATOMICS + SHUFFLES}

PROBE = r"""
#include <cuda_runtime.h>
// One warp adds one sample's four corners x 8 channels a step: lane = corner
// (lane / 8) x channel (lane % 8) of a window of 32-byte pixel rows, whose
// row stride (98 pixels) is 2 modulo 4, so the four corners fall in four
// different groups of 8 banks. mode 0: atomicAdd; mode 1: plain
// read-modify-write (racy: only its time is read).
__global__ void probe_kernel(float* out, int iters, int px, int mode) {
  extern __shared__ float win[];
  for (int i = threadIdx.x; i < px * 8; i += blockDim.x) win[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = lane >> 3, c = lane & 7;
  const int Wp = 98;
  unsigned h = (blockIdx.x * 64u + warp) * 2654435761u + 12345u;
  for (int it = 0; it < iters; ++it) {
    h = h * 1664525u + 1013904223u;
    const int p = (int)((h >> 8) % (unsigned)(px - Wp - 1));
    const int corner = p + (k & 1) + (k >> 1) * Wp;
    const float v = (float)(it & 7) * 0.125f;
    if (mode == 0)
      atomicAdd(&win[corner * 8 + c], v);
    else
      win[corner * 8 + c] += v;
  }
  __syncthreads();
  float s = 0.f;
  for (int i = threadIdx.x; i < px * 8; i += blockDim.x) s += win[i];
  atomicAdd(out, s);
}
extern "C" int probe(float* out, int blocks, int threads, int iters, int px, int mode, void* stream) {
  const size_t smem = (size_t)px * 8 * sizeof(float);
  cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  probe_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(out, iters, px, mode);
  return (int)cudaGetLastError();
}
"""


def emit(obj):
    print(json.dumps(obj), flush=True)


def patched(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"the source does not hold exactly one {old[:60]!r}: not the PR 12 kernel")
        text = text.replace(old, new)
    return text


def build_all(source):
    """nvcc every variant and the probe in parallel: {name: .so path}."""
    sys.path.insert(0, REPO)
    from dvis_plus_tpu_torch.ops import _build

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    text = open(source).read()
    inc = os.path.dirname(os.path.abspath(source))
    jobs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(patched(text, edits))
        jobs[name] = src
    with open(os.path.join(OUT, "probe.cu"), "w") as f:
        f.write(PROBE)
    jobs["probe"] = os.path.join(OUT, "probe.cu")
    nvcc = _build._nvcc()
    procs = {}
    for name, src in jobs.items():
        so = os.path.join(OUT, f"lib{name}.so")
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.CFLAGS, "-I", inc, "-shared", src, "-o", so]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        emit({"phase": "build", "variant": name, "ptxas": _build.parse_ptxas(log)})
        out[name] = so
    return out


def sass_opcodes(so):
    """The opcodes of the probe kernel's SASS that touch shared memory
    atomically (ATOMS, and the loads and branches of a CAS loop)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", text)
    return sorted({op for op in ops if op.startswith(("ATOMS", "RED", "ATOM", "LDS", "STS", "BSSY",
                                                      "BRA"))})


def time_variants(libs):
    import chip_smoke as cs
    import torch

    dev = torch.device("cuda", 0)
    value, loc, attn = cs.msdeform_inputs(dev, cs.TRAIN_LEVELS, BT=40)
    B, Len, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    g = torch.randn(B, Lq, M * D, generator=torch.Generator().manual_seed(cs.SEED + 3)).to(dev)
    gv = torch.zeros(value.shape, device=dev)
    gl, ga = torch.empty_like(loc), torch.empty_like(attn)
    shapes = (ctypes.c_int * (2 * L))(*[s for hw in cs.TRAIN_LEVELS for s in hw])
    stream = torch.cuda.current_stream().cuda_stream
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    rows = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(libs[name])
        lib.msdeform_bwd.restype = i32
        lib.msdeform_bwd.argtypes = [vp, i32, vp, vp, i32, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                     i32, i32, vp, i32, vp]

        def call(lib=lib):
            rc = lib.msdeform_bwd(value.data_ptr(), 0, loc.data_ptr(), attn.data_ptr(), 0,
                                  g.data_ptr(), gv.data_ptr(), gl.data_ptr(), ga.data_ptr(),
                                  B, Len, Lq, M, D, L, P, ctypes.cast(shapes, vp), -1, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        rows[name] = call
    # in turns, so that a drift of the clock falls on every variant alike
    times = {name: [] for name in rows}
    for _ in range(3):
        for name, call in rows.items():
            times[name].append(cs.cuda_ms(call, 5, cs.KERNEL_REPS))
    for name, ts in times.items():
        emit({"phase": "b1_backward_ablation", "variant": name,
              "shape": "train_encoder_480x768", "form": "exact", "offsets": "uniform",
              "ms": sorted(ts)[1], "ms_runs": ts})


def time_probe(so):
    import chip_smoke as cs
    import torch

    lib = ctypes.CDLL(so)
    lib.probe.restype = ctypes.c_int
    lib.probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    blocks, threads, iters, px = 132 * 4, 1024, 2048, 5880  # 184 KB of window a block
    for mode, name in ((0, "atomicAdd"), (1, "plain_rmw")):
        def call():
            rc = lib.probe(out.data_ptr(), blocks, threads, iters, px, mode, stream)
            if rc:
                raise RuntimeError(f"probe: CUDA error {rc}")

        ms = cs.cuda_ms(call, 5)
        adds = blocks * threads * iters
        emit({"phase": "smem_probe", "op": name, "ms": ms, "adds": adds,
              "adds_per_s": adds / (ms * 1e-3), "window_bytes": px * 32, "threads": threads})
    emit({"phase": "smem_probe", "sass": sass_opcodes(so)})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=os.path.join(REPO, "dvis_plus_tpu_torch", "csrc",
                                                     "msdeform_bwd.cu"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b1_backward_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__})
    libs = build_all(args.source)
    time_variants(libs)
    time_probe(libs["probe"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
