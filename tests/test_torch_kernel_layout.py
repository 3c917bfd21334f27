"""What the port's kernel wrappers check and choose before a launch, and how
the kernel library is named, on the CPU (no card, no ``nvcc``).

The bf16 attention kernels read q, k, v through 16-byte asynchronous copies
(kernel B3 through TMA tensor maps over the tensors' views, kernel B2 through
``cp.async``), so the wrappers hold the views to 16-byte aligned bases and
strides before anything is launched. The checks are plain Python on strides
and pointers and run here on CPU tensors: they must accept the column views
of a fused qkv output that ``swin.py`` and ``vit_adapter.py`` really pass,
and reject with a ``ValueError`` what a tensor map or a 16-byte copy cannot
address. Kernel B1 (deformable attention) has a 16-byte and a scalar
instantiation and gives a block a run of consecutive queries:
``kernel_plan`` chooses from shapes and the value pointer, and what the
callers really pass must reach the vector kernel. ``_build`` names the library by a hash of everything under
``csrc/``, headers included, so that a changed header never reuses a stale
build, and reads each kernel's registers and spills from what the assembler
printed.
"""
import os
import shutil

import pytest
import torch

from dvis_plus_tpu_torch.models.backbones import swin, vit_adapter
from dvis_plus_tpu_torch.models.segmenter import pixel_decoder
from dvis_plus_tpu_torch.ops import _build, flash_attn, msdeform, swin_window_attn

torch.set_num_threads(2)
DTYPES = [torch.float32, torch.bfloat16]


def _fused_flash(B, L, H, dtype, pad=0):
    """q, k, v as ``vit_adapter.Attention`` makes them: column views of one
    (B, L, 3 * H * 64 [+ pad]) tensor."""
    C = H * 64
    qkv = torch.zeros(B, L, 3 * C + pad, dtype=dtype)
    return [t.unflatten(-1, (H, 64)) for t in qkv[..., :3 * C].split(C, dim=-1)]


def _fused_swin(B_, N, H, dtype, pad=0):
    """q, k, v as ``swin.WindowAttention`` makes them."""
    C = H * 32
    qkv = torch.zeros(B_, N, 3 * C + pad, dtype=dtype)
    return list(qkv[..., :3 * C].split(C, dim=-1))


# ----------------------------------------------------------------------------
# B3: flash_attn._check_kernel_layout
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,L,H", [(5, 3681, 16), (2, 2049, 16), (1, 1, 1), (3, 63, 2)])
def test_flash_layout_accepts_fused_qkv_views(dtype, B, L, H):
    q, k, v = _fused_flash(B, L, H, dtype)
    assert q.is_contiguous() == (B * L == 1)  # one row is contiguous whatever its strides
    flash_attn._check(q, k, v)
    flash_attn._check_kernel_layout(q, k, v)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_layout_accepts_contiguous_and_row_slices(dtype):
    q, k, v = (torch.zeros(2, 200, 4, 64, dtype=dtype) for _ in range(3))
    flash_attn._check_kernel_layout(q, k, v)
    flash_attn._check_kernel_layout(*(t[:, :77] for t in (q, k, v)))  # fewer rows, same strides
    flash_attn._check_kernel_layout(*(t[1:] for t in (q, k, v)))  # later batch element


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_layout_accepts_what_the_vit_trunk_passes(dtype, monkeypatch):
    """The trunk's attention module hands ``flash_self_attention`` its views;
    record them and hold them to the kernel's layout."""
    seen = []

    def spy(q, k, v, sm_scale=None):
        flash_attn._check(q, k, v)
        flash_attn._check_kernel_layout(q, k, v)
        seen.append((q.shape, q.is_contiguous()))
        return flash_attn.attention_torch(q, k, v, sm_scale)

    monkeypatch.setattr(vit_adapter, "flash_self_attention", spy)
    attn = vit_adapter.Attention(128, 2, attn_impl="flash").to(dtype)
    out = attn(torch.randn(2, 37, 128).to(dtype))
    assert out.shape == (2, 37, 128)
    assert seen == [(torch.Size([2, 37, 2, 64]), False)]  # strided views, not copies


def _flash_bad_views(dtype):
    elems = 16 // torch.zeros(1, dtype=dtype).element_size()  # elements in 16 bytes
    q, k, v = _fused_flash(2, 40, 2, dtype)
    yield "transposed", [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    yield "head dim 32", [torch.zeros(2, 40, 4, 32, dtype=dtype)] * 3
    # a row stride that is not a multiple of 16 bytes
    yield "row stride", _fused_flash(2, 40, 2, dtype, pad=elems // 2)
    # a base that is not 16-byte aligned: the view starts half a chunk in
    flat = torch.zeros(2 * 40 * 128 + elems, dtype=dtype)
    off = flat[elems // 2: elems // 2 + 2 * 40 * 128].view(2, 40, 2, 64)
    yield "base", [off, off, off]
    # rows that overlap (a broadcast row)
    row = torch.zeros(2, 1, 2, 64, dtype=dtype).expand(2, 40, 2, 64)
    yield "overlap", [row, row, row]
    # one batch element repeated: a tensor map takes no stride of 0
    one = torch.zeros(1, 40, 2, 64, dtype=dtype).expand(3, 40, 2, 64)
    yield "batch stride 0", [one, one, one]
    yield "B * H", [torch.zeros(1, 1, 2, 64, dtype=dtype).expand(40000, 1, 2, 64)] * 3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["transposed", "head dim 32", "row stride", "base", "overlap", "batch stride 0", "B * H"])
def test_flash_layout_rejects(dtype, case):
    q, k, v = dict(_flash_bad_views(dtype))[case]
    flash_attn._check(q, k, v)  # shapes and dtypes are fine: only the layout is not
    with pytest.raises(ValueError):
        flash_attn._check_kernel_layout(q, k, v)


# ----------------------------------------------------------------------------
# B2: swin_window_attn._check and _check_kernel_layout
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B_,N,H", [(700, 144, 6), (60, 144, 24), (20, 144, 48), (12, 49, 3), (3, 189, 1)])
def test_swin_layout_accepts_fused_qkv_views(dtype, B_, N, H):
    q, k, v = _fused_swin(B_, N, H, dtype)
    assert not q.is_contiguous()
    bias = torch.zeros(H, N, N)
    mask = torch.zeros(B_, N, N) if B_ <= 12 else None
    swin_window_attn._check(q, k, v, bias, mask, H)
    swin_window_attn._check_kernel_layout(q, k, v, bias, mask)
    swin_window_attn._check_kernel_layout(*(t.contiguous() for t in (q, k, v)), bias, mask)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_layout_accepts_what_the_swin_block_passes(dtype, shifted, monkeypatch):
    seen = []

    def spy(q, k, v, bias, mask, num_heads):
        swin_window_attn._check(q, k, v, bias, mask, num_heads)
        swin_window_attn._check_kernel_layout(q, k, v, bias, mask)
        seen.append((q.shape, q.is_contiguous(), mask is not None))
        return swin_window_attn.window_attention_torch(q, k, v, bias, mask, num_heads)

    monkeypatch.setattr(swin, "window_attention", spy)
    attn = swin.WindowAttention(96, 3, 7).to(dtype)
    mask = swin.shift_mask(14, 14, 7, 3, torch.device("cpu")) if shifted else None
    out = attn(torch.randn(8, 49, 96).to(dtype), mask)
    assert out.shape == (8, 49, 96)
    assert seen == [(torch.Size([8, 49, 96]), False, shifted)]


def _swin_bad_views(dtype):
    elems = 16 // torch.zeros(1, dtype=dtype).element_size()
    yield "row stride", _fused_swin(4, 49, 3, dtype, pad=elems // 2)
    wide = torch.zeros(4, 49, 3 * 96 + elems, dtype=dtype)  # a view that starts half a chunk in
    yield "base", list(wide[..., elems // 2: elems // 2 + 3 * 96].split(96, dim=-1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["row stride", "base"])
def test_swin_layout_rejects_misaligned_views(dtype, case):
    q, k, v = dict(_swin_bad_views(dtype))[case]
    bias = torch.zeros(3, 49, 49)
    swin_window_attn._check(q, k, v, bias, None, 3)
    with pytest.raises(ValueError):
        swin_window_attn._check_kernel_layout(q, k, v, bias, None)


def _offset_view(like, offset):
    """A contiguous float32 view shaped as ``like`` that starts ``offset``
    elements into a 64-byte aligned buffer."""
    flat = torch.zeros(like.numel() + offset + 16)
    flat = flat[(-flat.data_ptr() // 4) % 16:]
    assert flat.data_ptr() % 64 == 0
    return flat[offset: offset + like.numel()].view_as(like)


@pytest.mark.parametrize("N,bias_off,mask_off,ok", [
    (144, 0, 0, True),
    (144, 4, 2, True),    # 16 and 8 bytes in: still aligned for the vector reads
    (144, 1, 0, False),   # bias 4 bytes into a 16-byte chunk
    (144, 2, 0, False),   # bias 8 bytes in
    (144, 0, 1, False),   # mask 4 bytes into an 8-byte pair
    (49, 1, 1, True),     # odd N: the kernel reads both word by word
    (50, 1, 0, True),     # N even, not a multiple of 4: bias word by word
    (50, 0, 1, False),    # ... but the mask by pairs
])
def test_swin_layout_holds_bias_and_mask_to_the_vector_reads(N, bias_off, mask_off, ok):
    """The bf16 kernel copies the bias 16 bytes at a time where N % 4 == 0
    and reads the mask 8 bytes at a time where N is even: a contiguous view
    at an odd offset must be refused before the launch."""
    q, k, v = _fused_swin(4, N, 3, torch.bfloat16)
    bias = _offset_view(torch.zeros(3, N, N), bias_off)
    mask = _offset_view(torch.zeros(2, N, N), mask_off)
    swin_window_attn._check(q, k, v, bias, mask, 3)  # contiguous float32 of the right shape
    if ok:
        swin_window_attn._check_kernel_layout(q, k, v, bias, mask)
        swin_window_attn._check_kernel_layout(q, k, v, bias, None)
    else:
        with pytest.raises(ValueError):
            swin_window_attn._check_kernel_layout(q, k, v, bias, mask)


def test_swin_check_holds_the_kernels_limits():
    q, k, v = _fused_swin(2, 49, 3, torch.bfloat16)
    bias = torch.zeros(3, 49, 49)
    swin_window_attn._check(q, k, v, bias, torch.zeros(2, 49, 49), 3)
    with pytest.raises(ValueError):  # head dim 48
        swin_window_attn._check(q, k, v, torch.zeros(2, 49, 49), None, 2)
    with pytest.raises(ValueError):  # the last dim is not contiguous
        swin_window_attn._check(*(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)), bias, None, 3)
    with pytest.raises(ValueError):  # B_ is not a multiple of nW
        swin_window_attn._check(q, k, v, bias, torch.zeros(3, 49, 49), 3)
    with pytest.raises(ValueError):  # bias in the wrong dtype
        swin_window_attn._check(q, k, v, bias.bfloat16(), None, 3)
    n = swin_window_attn.MAX_TOKENS + 1
    with pytest.raises(ValueError):  # more tokens than a block's shared memory holds
        swin_window_attn._check(*_fused_swin(1, n, 1, torch.bfloat16), torch.zeros(1, n, n), None, 1)
    swin_window_attn._check(*_fused_swin(1, n - 1, 1, torch.bfloat16), torch.zeros(1, n - 1, n - 1), None, 1)


# ----------------------------------------------------------------------------
# B1: msdeform.kernel_plan and _check
# ----------------------------------------------------------------------------

ENC = [(60, 80), (30, 40), (15, 20)]


def _msdeform_args(shapes, B, M, D, P, dtype, Lq=None, value_offset=0):
    """Zero inputs of the given shapes; ``value_offset`` elements past a
    64-byte aligned buffer's start."""
    Len = sum(h * w for h, w in shapes)
    n = B * Len * M * D
    flat = torch.zeros(n + value_offset + 64, dtype=dtype)
    flat = flat[(-flat.data_ptr() // flat.element_size()) % (64 // flat.element_size()):]
    assert flat.data_ptr() % 64 == 0
    value = flat[value_offset: value_offset + n].view(B, Len, M, D)
    Lq = Len if Lq is None else Lq
    return value, torch.zeros(B, Lq, M, len(shapes), P, 2), torch.zeros(B, Lq, M, len(shapes), P)


@pytest.mark.parametrize("dtype", DTYPES)
def test_msdeform_plan_at_the_main_shapes(dtype):
    """The encoder and the extractor take the vector kernel, a run of 2
    queries a block, within the shared memory that lets eight blocks share
    an SM."""
    value, loc, attn = _msdeform_args(ENC, 1, 8, 32, 4, dtype)
    msdeform._check(value, ENC, loc, attn, None)
    plan = msdeform.kernel_plan(value, loc)
    assert plan == (True, msdeform.MAX_RUN) == (True, 2)
    assert plan.queries * 8 * 3 * 4 * msdeform.SAMPLE_BYTES <= msdeform.RUN_SMEM
    value, loc, attn = _msdeform_args([(4, 6)], 1, 16, 64, 4, dtype, Lq=96 + 24 + 6)
    msdeform._check(value, [(4, 6)], loc, attn, None)
    assert msdeform.kernel_plan(value, loc) == (True, 2)


@pytest.mark.parametrize("dtype,D,offset,vector", [
    (torch.float32, 32, 0, True),
    (torch.float32, 4, 0, True),      # a row of 16 bytes
    (torch.float32, 4, 4, True),      # 16 bytes in
    (torch.float32, 32, 1, False),    # 4 bytes past a 16-byte boundary
    (torch.float32, 32, 2, False),    # 8 bytes past
    (torch.float32, 6, 0, False),     # rows of 24 bytes
    (torch.float32, 1, 0, False),
    (torch.bfloat16, 64, 0, True),
    (torch.bfloat16, 8, 0, True),     # a row of 16 bytes
    (torch.bfloat16, 4, 0, False),    # rows of 8 bytes
    (torch.bfloat16, 64, 1, False),   # 2 bytes past a 16-byte boundary
    (torch.bfloat16, 64, 4, False),   # 8 bytes past
    (torch.bfloat16, 64, 8, True),    # 16 bytes in
    (torch.bfloat16, 12, 0, False),   # rows of 24 bytes
])
def test_msdeform_plan_takes_the_scalar_kernel_where_16_bytes_do_not_fit(dtype, D, offset, vector):
    """No shape or alignment is refused: what the 16-byte loads cannot
    address goes to the scalar instantiation."""
    shapes = [(5, 7), (3, 3)]
    value, loc, attn = _msdeform_args(shapes, 2, 2, D, 2, dtype, value_offset=offset)
    assert value.is_contiguous()
    msdeform._check(value, shapes, loc, attn, None)
    plan = msdeform.kernel_plan(value, loc)
    assert plan.vector == vector and plan.queries == msdeform.MAX_RUN


@pytest.mark.parametrize("M,L,P,tq", [(8, 3, 4, 2), (16, 1, 4, 2), (8, 4, 4, 2), (32, 4, 8, 1),
                                      (1, 1, 1, 2), (16, 4, 8, 2), (16, 4, 10, 1)])
def test_msdeform_plan_holds_a_tile_to_its_shared_memory(M, L, P, tq):
    shapes = [(6, 6), (3, 3), (2, 2), (1, 1)][:L]
    value, loc, attn = _msdeform_args(shapes, 1, M, 8, P, torch.float32)
    msdeform._check(value, shapes, loc, attn, None)
    plan = msdeform.kernel_plan(value, loc)
    one_query = M * L * P * msdeform.SAMPLE_BYTES
    assert plan.queries == tq
    assert tq * one_query <= max(msdeform.RUN_SMEM, one_query) <= msdeform.MAX_SMEM
    assert tq == msdeform.MAX_RUN or 2 * tq * one_query > msdeform.RUN_SMEM  # no shorter than need be


def test_msdeform_check_holds_the_kernels_limits():
    value, loc, attn = _msdeform_args(ENC[1:], 1, 2, 8, 2, torch.float32)
    msdeform._check(value, ENC[1:], loc, attn, 7)
    msdeform._check(value, ENC[1:], loc, attn.bfloat16(), None)
    with pytest.raises(ValueError):  # clamped: the queries are the level grids
        msdeform._check(value, ENC[1:], loc[:, :-1], attn[:, :-1], 7)
    wide = torch.zeros(1, 1, 64, 1)  # 64 * 4 * 8 samples a query: 48 KB and 24 bytes
    with pytest.raises(ValueError):  # one query's samples exceed a block's shared memory
        msdeform._check(wide.expand(1, 4, 64, 1), [(1, 1)] * 4, torch.zeros(1, 1, 64, 4, 8, 2),
                        torch.zeros(1, 1, 64, 4, 8), None)
    with pytest.raises(TypeError):
        msdeform._check(value, ENC[1:], loc.double(), attn, None)
    with pytest.raises(TypeError):
        msdeform._check(value, ENC[1:], loc, attn.half(), None)
    with pytest.raises(ValueError):  # B beyond the grid's second dimension
        msdeform._check(value.expand(70000, -1, -1, -1), ENC[1:], loc.expand(70000, -1, -1, -1, -1, -1),
                        attn.expand(70000, -1, -1, -1, -1), None)
    big = torch.zeros(1, 1, 1).expand(1, 2**20, 2**11).unflatten(-1, (2, 2**10))
    with pytest.raises(ValueError):  # Len * M * D overflows the kernel's 32-bit offsets
        msdeform._check(big, [(2**10, 2**10)], torch.zeros(1, 1, 2, 1, 1, 2), torch.zeros(1, 1, 2, 1, 1), None)
    with pytest.raises(ValueError):  # Len * M * D fits, a corner one row further down does not
        msdeform._check(big[:, :-512], [(2**10 - 1, 2**10), (512, 1)], torch.zeros(1, 1, 2, 2, 1, 2),
                        torch.zeros(1, 1, 2, 2, 1), None)
    with pytest.raises(ValueError):  # an empty query set
        msdeform._check(value, ENC[1:], loc[:, :0], attn[:, :0], None)


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_msdeform_plan_for_what_the_pixel_decoder_passes(value_dtype, monkeypatch):
    """The encoder layer hands the wrapper contiguous tensors that take the
    vector kernel, and gets ``value_dtype`` back with no cast of its own."""
    seen = []

    def spy(value, shapes, loc, attn, radius=None):
        msdeform._check(value, shapes, loc, attn, radius)
        seen.append((msdeform.kernel_plan(value, loc), value.dtype, loc.dtype, attn.dtype, radius))
        return msdeform.ms_deform_attn_torch(value, shapes, loc, attn, radius)

    monkeypatch.setattr(pixel_decoder, "ms_deform_attn", spy)
    shapes = [(4, 6), (2, 3)]
    layer = pixel_decoder.MSDeformAttnLayer(32, 64, n_levels=2, n_heads=4, value_dtype=value_dtype,
                                            impl="pallas_local")
    src = torch.randn(2, 30, 32)
    out = layer(src, torch.zeros(30, 32), pixel_decoder.reference_points(shapes), shapes)
    assert out.shape == src.shape and out.dtype == torch.float32
    (plan, vdt, ldt, adt, radius), = seen
    assert plan.vector  # D = 8: rows of 32 bytes in fp32, of 16 in bf16
    assert radius == pixel_decoder.LOCAL_RADIUS
    assert (vdt, ldt, adt) == (pixel_decoder.dtype_of(value_dtype), torch.float32, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("coarse", [False, True])
def test_msdeform_plan_for_what_the_extractor_passes(dtype, coarse, monkeypatch):
    """The adapter's extractor (the coarse one with its pooled grid) passes
    the weights in the query's dtype with no cast and takes the result as it
    comes."""
    seen = []

    def spy(value, shapes, loc, attn, radius=None):
        msdeform._check(value, shapes, loc, attn, radius)
        seen.append((msdeform.kernel_plan(value, loc), value.dtype, loc.dtype, attn.dtype, loc.shape[1]))
        return msdeform.ms_deform_attn_torch(value, shapes, loc, attn, radius)

    monkeypatch.setattr(vit_adapter, "ms_deform_attn", spy)
    shapes = ((8, 12), (4, 6), (2, 3))
    Lq = sum(h * w for h, w in shapes)
    ext = vit_adapter.Extractor(64, 2, coarse_s8=coarse)  # the layers cast their weights per call
    refs = pixel_decoder.reference_points(shapes)[:, 1:2]
    out = ext(torch.randn(2, Lq, 64).to(dtype), refs, torch.randn(2, 24, 64).to(dtype), (4, 6), shapes)
    assert out.shape == (2, Lq, 64) and out.dtype == dtype
    (plan, vdt, ldt, adt, lq), = seen
    grids = ((4, 6), (4, 6), (2, 3)) if coarse else shapes
    assert plan.vector and lq == sum(h * w for h, w in grids)
    assert (vdt, ldt, adt) == (dtype, torch.float32, dtype)


# ----------------------------------------------------------------------------
# _build: the library's name follows every file under csrc/
# ----------------------------------------------------------------------------


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", str(dst))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return dst


def test_library_name_is_stable_for_an_unchanged_tree(csrc_copy):
    assert _build._library_path() == _build._library_path()
    assert os.path.dirname(_build._library_path()) == _build.BUILD_DIR


@pytest.mark.parametrize("name", ["hopper.cuh", "flash_attn_fwd.cu", "swin_window_attn_fwd.cu", "msdeform_fwd.cu"])
def test_library_name_changes_with_any_file_under_csrc(csrc_copy, name):
    assert (csrc_copy / name).exists()
    before = _build._library_path()
    with open(csrc_copy / name, "a") as f:
        f.write("\n// changed\n")
    assert _build._library_path() != before


def test_library_name_changes_with_a_new_header_and_with_the_flags(csrc_copy, monkeypatch):
    before = _build._library_path()
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    with_header = _build._library_path()
    assert with_header != before
    monkeypatch.setattr(_build, "CFLAGS", _build.CFLAGS + ["-lineinfo"])
    assert _build._library_path() != with_header


def test_every_source_includes_only_headers_that_are_hashed():
    """A header outside ``csrc/`` would escape the hash: the sources include
    CUDA's own headers and files of ``csrc/`` and nothing else."""
    local = set(os.listdir(_build.CSRC))
    for name in sorted(local):
        with open(os.path.join(_build.CSRC, name)) as f:
            for line in f:
                if line.startswith('#include "'):
                    assert line.split('"')[1] in local, (name, line)


PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z27swin_window_attn_mma_kernelILi9ELi3ELb1EEv7SwmArgs' for 'sm_90a'
ptxas info    : Function properties for _Z27swin_window_attn_mma_kernelILi9ELi3ELb1EEv7SwmArgs
    40 bytes stack frame, 72 bytes spill stores, 64 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 40 bytes cumulative stack size, 624 bytes cmem[0]
ptxas info    : Compile time = 812.345 ms
ptxas info    : Compiling entry function '_Z22flash_attn_simt_kernelPKfS0_S0_xxxxxxPfiif' for 'sm_90a'
ptxas info    : Function properties for _Z22flash_attn_simt_kernelPKfS0_S0_xxxxxxPfiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 596 bytes cmem[0]
"""


def test_ptxas_report_is_read_per_kernel():
    assert _build.parse_ptxas(PTXAS_SAMPLE) == [
        {"kernel": "_Z27swin_window_attn_mma_kernelILi9ELi3ELb1EEv7SwmArgs", "stack_bytes": 40,
         "spill_store_bytes": 72, "spill_load_bytes": 64, "registers": 168},
        {"kernel": "_Z22flash_attn_simt_kernelPKfS0_S0_xxxxxxPfiif", "stack_bytes": 0,
         "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 128},
    ]
    assert _build.parse_ptxas("nvcc warning : nothing of the kind") == []
