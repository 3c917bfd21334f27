"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library lands in
``build/dvis_plus_tpu_torch_kernels/`` under the repository root, named by a
hash of the flags and of every file under ``csrc`` (sources and headers), so
a changed file builds anew and an unchanged tree is reused. Sources compile
in parallel (one ``nvcc`` each), and the library is written under a
temporary name and renamed into place, so a concurrent build never sees a
half-written file. The compilers' output (what ``ptxas -v`` says of every
kernel) is kept beside the library; :func:`resource_usage` reads it.

Nothing here runs at import time: the wrappers call :func:`library` the first
time they launch a kernel on a CUDA tensor, so CPU-only machines (no
``nvcc``) never build or load anything.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "dvis_plus_tpu_torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: the assembler reports every kernel's registers and spills
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def refuse_grad(kernel: str, lifted_by: str, *tensors) -> None:
    """Kernels B2 and B3 are forward only: a launch returns a tensor with no
    ``grad_fn``. Raise ``NotImplementedError`` when gradients are enabled and
    any tensor input requires one, naming what lifts the limit, so that no
    gradient is cut silently."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} is forward only and an input requires grad; run it under "
            f"torch.no_grad() ({lifted_by})")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _library_path() -> str:
    """Named by the flags and every file under ``csrc`` (sources and the
    headers they include), so a change to any of them builds anew."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for root, dirs, files in os.walk(CSRC):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                h.update(os.path.relpath(path, CSRC).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libdvis_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library unless it exists.
    Returns its path."""
    so = _library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", src, "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        outs = [proc.communicate()[0] for _, _, proc in procs]  # wait for every nvcc
        for (cmd, _, proc), out in zip(procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    + out.decode(errors="replace")
                )
        tmp_so = os.path.join(tmp, os.path.basename(so))
        subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_so, *[o for _, o, _ in procs]],
            check=True, capture_output=True,
        )
        with open(tmp_so + ".log", "w") as f:
            f.write("".join(out.decode(errors="replace") for out in outs))
        os.replace(tmp_so + ".log", _log_path(so))
        os.replace(tmp_so, so)
    return so


def _log_path(so: str) -> str:
    return so[: -len(".so")] + ".ptxas.txt"


def parse_ptxas(text: str) -> list:
    """``ptxas -v`` output -> one record per kernel: its (mangled) name, the
    registers a thread has at launch, and its stack frame, spill stores and
    spill loads in bytes."""
    kernels, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and "stack_bytes" not in cur:
            cur["stack_bytes"], cur["spill_store_bytes"], cur["spill_load_bytes"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            kernels.append(cur)
            cur = None
    return kernels


def resource_usage() -> list:
    """Registers and spills of every kernel of the built library."""
    with open(_log_path(build())) as f:
        return parse_ptxas(f.read())


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's C signature set."""
    lib = ctypes.CDLL(build())
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.msdeform_fwd.restype = i32
    lib.msdeform_fwd.argtypes = [
        vp, i32, vp, vp, i32, vp,  # value, value_is_bf16, loc, attn, attn_is_bf16, out
        i32, i32, i32, i32, i32, i32, i32,  # B, Len, Lq, M, D, L, P
        vp, i32, i32,  # shapes (host int32[2L]), queries a block, vector
        i32, vp,  # radius, stream
    ]
    lib.msdeform_bwd.restype = i32
    lib.msdeform_bwd.argtypes = [
        vp, i32, vp, vp, i32,  # value, value_is_bf16, loc, attn, attn_is_bf16
        vp, vp, vp, vp,  # grad_out, grad_value (fp32), grad_loc, grad_attn
        i32, i32, i32, i32, i32, i32, i32,  # B, Len, Lq, M, D, L, P
        vp, i32,  # shapes (host int32[2L]), radius
        i32, i32, i32,  # queries a block, vector, lanes a (query, head)
        vp, vp, vp, vp,  # rows (host int32[L]); scratch: cell_start, records; stream
    ]
    lib.msdeform_error_string.restype = ctypes.c_char_p
    lib.msdeform_error_string.argtypes = [i32]
    lib.swin_window_attn_fwd.restype = i32
    lib.swin_window_attn_fwd.argtypes = [
        vp, vp, vp,  # q, k, v
        i64, i64, i64, i64, i64, i64,  # window and row strides of q, k, v
        vp, vp, i32, vp,  # bias, mask (or null), nW, out
        i32, i32, i32, i32, vp,  # is_bf16, B_, N, H, stream
    ]
    lib.swin_window_attn_error_string.restype = ctypes.c_char_p
    lib.swin_window_attn_error_string.argtypes = [i32]
    lib.flash_attn_fwd.restype = i32
    lib.flash_attn_fwd.argtypes = [
        vp, vp, vp,  # q, k, v
        i64, i64, i64, i64, i64, i64,  # batch and row strides of q, k, v
        vp, i32, i32, i32, i32, i32,  # out, is_bf16, B, L, H, Dh
        ctypes.c_float, vp,  # scale, stream
    ]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    lib.flash_attn_error_string.argtypes = [i32]
    return lib
