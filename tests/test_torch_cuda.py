"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Needs an NVIDIA GPU and ``nvcc``: every test here is marked ``cuda`` and
skips without a card. The module imports no jax, so it also runs on a
machine without JAX; there, run it without the repository conftest (which
imports jax):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from dvis_plus_tpu_torch.ops import flash_attn, msdeform, swin_window_attn

SHAPES = [(16, 20), (8, 10), (4, 5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, seed=0, B=2, M=8, D=32, P=4, spread=10.0):
    rng = np.random.RandomState(seed)
    Len = sum(h * w for h, w in SHAPES)
    refs = []
    for H, W in SHAPES:
        qi = (np.arange(H * W) // W + 0.5) / H
        qj = (np.arange(H * W) % W + 0.5) / W
        refs.append(np.stack([qj, qi], -1))
    ref = np.concatenate(refs, 0)
    loc = np.zeros((B, Len, M, len(SHAPES), P, 2), np.float32)
    for lv, (H, W) in enumerate(SHAPES):
        off = rng.uniform(-spread, spread, (B, Len, M, P, 2)).astype(np.float32)
        loc[:, :, :, lv] = ref[None, :, None, None] + off / np.array([W, H])
    attn = rng.rand(B, Len, M, len(SHAPES), P).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    value = rng.randn(B, Len, M, D).astype(np.float32)
    return (
        torch.from_numpy(value).to(dev, dtype),
        torch.from_numpy(loc).to(dev),
        torch.from_numpy(attn).to(dev),
    )


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# B1's bars: fp32 1e-5 of the twin's maximum (both sum in fp32, in another
# order); bf16 1e-2: kernel and twin round their fp32 sums once to bf16, so
# they differ by at most one bf16 ulp of the output (2^-8 of the value)
MSDEFORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("attn_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [None, 7])
def test_msdeform_kernel_matches_twin(cuda_device, dtype, radius, attn_dtype):
    value, loc, attn = _inputs(cuda_device, dtype)
    attn = attn.to(attn_dtype)
    msdeform.reset_launches()
    got = msdeform.ms_deform_attn(value, SHAPES, loc, attn, radius=radius)
    torch.cuda.synchronize()
    assert msdeform.launches == 1
    assert got.dtype == dtype and got.shape == (2, loc.shape[1], 8 * 32) and got.is_contiguous()
    want = msdeform.ms_deform_attn_torch(value, SHAPES, loc, attn, radius=radius)
    assert want.dtype == dtype
    assert _rel(got, want) <= MSDEFORM_TOL[dtype]


def _msdeform_case(dev, dtype, shapes, B, M, D, P, seed=0, spread=6.0, qgrids=None):
    """Queries are ``qgrids`` (default: the level grids) with reference points
    at their cell centres, offsets up to ``spread`` value pixels; the first
    queries get the special locations: exactly on the border, half a pixel
    outside, far outside."""
    rng = np.random.RandomState(seed)
    Len = sum(h * w for h, w in shapes)
    refs = []
    for H, W in qgrids or shapes:
        qi = (np.arange(H * W) // W + 0.5) / H
        qj = (np.arange(H * W) % W + 0.5) / W
        refs.append(np.stack([qj, qi], -1))
    ref = np.concatenate(refs, 0)
    Lq = ref.shape[0]
    loc = np.zeros((B, Lq, M, len(shapes), P, 2), np.float32)
    for lv, (H, W) in enumerate(shapes):
        off = rng.uniform(-spread, spread, (B, Lq, M, P, 2)).astype(np.float32)
        loc[:, :, :, lv] = ref[None, :, None, None] + off / np.array([W, H])
    H0, W0 = shapes[0]
    loc[0, 0, 0, 0, 0] = (0.0, 1.0)  # exactly on the border
    loc[0, 0, 0, 0, 1 % P] = (1.0, 0.0)
    loc[0, 1 % Lq, 0, 0, 0] = (1.0 + 0.5 / W0, 0.5)  # half a pixel outside
    loc[0, 1 % Lq, 0, 0, 1 % P] = (0.5, -0.5 / H0)
    loc[0, 2 % Lq, 0, 0, 0] = (37.0, -1e6)  # far outside
    loc[0, 2 % Lq, 0, 0, 1 % P] = (-1e30, 1e30)
    attn = rng.rand(B, Lq, M, len(shapes), P).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    value = rng.randn(B, Len, M, D).astype(np.float32)
    return (torch.from_numpy(value).to(dev, dtype), torch.from_numpy(loc).to(dev),
            torch.from_numpy(attn).to(dev))


# (shapes, B, M, D, P): edges of the tiling and of the two instantiations.
# Level grids of odd sizes, so that Lq is no multiple of a block's run of
# queries and runs span two levels; levels one pixel wide and one pixel in all; D of 4,
# 8, 32 and 64 (fp32 rows of 16 bytes and more: the vector kernel; D = 4 in
# bf16 is 8 bytes: the scalar one); M * D = 1024 both ways; D = 6 and 10,
# whose rows are no multiple of 16 bytes; one level; four levels; P = 1 and 3
MSDEFORM_EDGE_CASES = [
    ([(7, 9), (3, 5), (2, 2)], 3, 8, 32, 4),
    ([(5, 1), (1, 7), (1, 1)], 2, 4, 8, 4),
    ([(6, 5), (3, 3)], 1, 2, 4, 2),
    ([(9, 11), (5, 6), (3, 3)], 2, 16, 64, 4),
    ([(9, 11), (5, 6), (3, 3)], 1, 32, 32, 2),
    ([(7, 6), (4, 3)], 2, 3, 6, 3),
    ([(7, 6)], 2, 5, 10, 1),
    ([(6, 7), (3, 4), (2, 2), (1, 1)], 2, 8, 32, 4),
    ([(13, 17)], 1, 1, 128, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [None, 2])
@pytest.mark.parametrize("shapes,B,M,D,P", MSDEFORM_EDGE_CASES)
def test_msdeform_kernel_at_the_tiling_edges(cuda_device, dtype, radius, shapes, B, M, D, P):
    value, loc, attn = _msdeform_case(cuda_device, dtype, shapes, B, M, D, P)
    plan = msdeform.kernel_plan(value, loc)
    assert plan.vector == ((D * value.element_size()) % 16 == 0)
    msdeform.reset_launches()
    got = msdeform.ms_deform_attn(value, shapes, loc, attn, radius=radius)
    torch.cuda.synchronize()
    assert msdeform.launches == 1 and got.dtype == dtype and torch.isfinite(got).all()
    want = msdeform.ms_deform_attn_torch(value, shapes, loc, attn, radius=radius)
    assert _rel(got, want) <= MSDEFORM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [None, 3])
def test_msdeform_tiling_and_instantiation_change_no_bit(cuda_device, dtype, radius):
    """Runs of any length (one query a block, runs that end inside a level or
    span all of them) and both instantiations do the same arithmetic per
    output: equal bits. The
    scalar instantiation is reached through a contiguous view of ``value``
    that starts 4 (fp32) or 2 (bf16) bytes past a 16-byte boundary."""
    shapes = [(9, 11), (5, 6), (3, 3)]
    value, loc, attn = _msdeform_case(cuda_device, dtype, shapes, 2, 8, 32, 4, seed=1)
    ref = msdeform.ms_deform_attn(value, shapes, loc, attn, radius=radius)
    assert msdeform.kernel_plan(value, loc) == (True, 2)
    for queries in (1, 3, 5, 8, 16, 21):  # 21 runs' samples: all of 48 KB
        got = msdeform._launch(value, shapes, loc, attn, radius, msdeform.KernelPlan(True, queries))
        assert torch.equal(got, ref), queries
    flat = torch.zeros(value.numel() + 1, device=cuda_device, dtype=dtype)
    shifted = flat[1:].view_as(value).copy_(value)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    assert not msdeform.kernel_plan(shifted, loc).vector
    msdeform.reset_launches()
    got = msdeform.ms_deform_attn(shifted, shapes, loc, attn, radius=radius)
    assert msdeform.launches == 1 and torch.equal(got, ref)
    want = msdeform.ms_deform_attn_torch(value, shapes, loc, attn, radius=radius)
    assert _rel(ref, want) <= MSDEFORM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [None, 3])
def test_msdeform_kernel_with_nan_and_far_locations(cuda_device, radius):
    """Exact form: a sample whose location is NaN, or farther than a pixel
    outside the level, contributes nothing: the result equals the one with
    that sample's weight set to 0. Clamped form: the clamp brings a far
    location back to the window's edge, and a NaN coordinate goes the same way
    as a far negative one (``fmaxf`` returns its other operand). Finite either
    way."""
    shapes = [(9, 11), (5, 6), (3, 3)]
    value, loc, attn = _msdeform_case(cuda_device, torch.float32, shapes, 2, 8, 32, 4, seed=2)
    rng = np.random.RandomState(5)
    drop = torch.from_numpy(rng.rand(*attn.shape) < 0.1).to(cuda_device)
    kinds = torch.from_numpy(rng.randint(0, 3, tuple(attn.shape))).to(cuda_device)
    bad = loc.clone()
    bad[..., 0][drop & (kinds == 0)] = float("nan")
    bad[..., 1][drop & (kinds == 1)] = float("nan")
    bad[..., 0][drop & (kinds == 2)] = -7.5
    got = msdeform.ms_deform_attn(value, shapes, bad, attn, radius=radius)
    if radius is None:
        want = msdeform.ms_deform_attn(value, shapes, loc, attn * ~drop)
    else:
        want = msdeform.ms_deform_attn(value, shapes, torch.nan_to_num(bad, nan=-1e30), attn, radius=radius)
    assert torch.isfinite(got).all() and drop.sum() > 100
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_msdeform_kernel_on_pixel_centres(cuda_device):
    """Locations on pixel centres give three corners a weight of 0 (the
    kernel reads no corner of weight exactly 0): the result is the centre
    pixel's value times the attention weight."""
    shapes = [(6, 8)]
    value, loc, attn = _msdeform_case(cuda_device, torch.float32, shapes, 1, 2, 8, 1, seed=3,
                                      spread=0.0)
    loc = loc.clone()
    loc[0, :3, 0, 0, 0] = loc[0, 3:6, 0, 0, 0]  # undo the special locations
    got = msdeform.ms_deform_attn(value, shapes, loc, attn)
    want = (value[:, :, :, :] * attn[:, :, :, 0, :]).reshape(1, 48, 16)
    assert _rel(got[:, 3:], want[:, 3:]) <= 1e-6


@pytest.mark.cuda
def test_msdeform_wrapper_raises_instead_of_falling_back(cuda_device):
    value, loc, attn = _inputs(cuda_device, torch.float32)
    msdeform.reset_launches()
    with pytest.raises(TypeError):
        msdeform.ms_deform_attn(value.half(), SHAPES, loc, attn)
    with pytest.raises(TypeError):
        msdeform.ms_deform_attn(value, SHAPES, loc, attn.half())
    with pytest.raises(ValueError):
        msdeform.ms_deform_attn(value, SHAPES, loc.cpu(), attn)
    with pytest.raises(ValueError):  # the clamped form's queries are the level grids
        msdeform.ms_deform_attn(value, SHAPES, loc[:, :-1].contiguous(), attn[:, :-1].contiguous(), radius=7)
    with pytest.raises(RuntimeError):  # a run whose samples exceed a block's shared memory
        msdeform._launch(value, SHAPES, loc, attn, None, msdeform.KernelPlan(True, 64))
    with pytest.raises(RuntimeError):  # 16-byte loads from a value 4 bytes past a boundary
        flat = torch.zeros(value.numel() + 1, device=cuda_device)
        msdeform._launch(flat[1:].view_as(value), SHAPES, loc, attn, None, msdeform.KernelPlan(True, 8))
    assert msdeform.launches == 0


def _swin_inputs(dev, dtype, B_, N, H, nW, seed=0, fused=True):
    g = torch.Generator().manual_seed(seed)
    C = H * 32
    qkv = torch.randn(B_, N, 3 * C, generator=g).to(dev, dtype)  # one qkv output
    bias = (torch.randn(H, N, N, generator=g) * 2.0).to(dev)
    mask = None
    if nW:
        ids = torch.randint(0, 3, (nW, N), generator=g)
        mask = torch.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0).to(dev)
    q, k, v = qkv.split(C, dim=-1)  # column views, as the Swin block hands them over
    if not fused:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v, bias, mask


# Swin-L's four stages at window 12 (6, 12, 24, 48 heads) and Swin-T's window
# 7 (N = 49, 3 and 6 heads), with and without the shift mask; window counts
# that do not divide among the bf16 kernel's persistent blocks (7, 13, 175)
# and fewer (window, head) items than the card has SMs (5 x 2); N = 169 takes
# the kernel's widest instantiation
SWIN_CASES = [(40, 144, 6, 20), (40, 144, 6, 0), (8, 144, 48, 4), (12, 49, 3, 6),
              (7, 144, 24, 0), (175, 144, 12, 35), (60, 144, 24, 12), (13, 49, 6, 0),
              (9, 49, 3, 3), (5, 169, 2, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("B_,N,H,nW", SWIN_CASES)
def test_swin_window_attn_kernel_matches_twin(cuda_device, dtype, tol, fused, B_, N, H, nW):
    """Tolerance: fp32 rel 1e-5 (both accumulate in fp32); bf16 rel 1e-2,
    one bf16 ulp of the output (p and the output round to bf16 on both
    sides, after sums taken in different orders)."""
    q, k, v, bias, mask = _swin_inputs(cuda_device, dtype, B_, N, H, nW, fused=fused)
    swin_window_attn.reset_launches()
    got = swin_window_attn.window_attention(q, k, v, bias, mask, H)
    torch.cuda.synchronize()
    assert swin_window_attn.launches == 1
    want = swin_window_attn.window_attention_torch(q, k, v, bias, mask, H)
    assert got.dtype == dtype and got.shape == want.shape
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err <= tol, err


@pytest.mark.cuda
def test_swin_window_attn_wrapper_raises_instead_of_falling_back(cuda_device):
    q, k, v, bias, mask = _swin_inputs(cuda_device, torch.float32, 4, 144, 2, 2)
    with pytest.raises(TypeError):
        swin_window_attn.window_attention(q.half(), k.half(), v.half(), bias, mask, 2)
    with pytest.raises(ValueError):
        swin_window_attn.window_attention(q, k, v, bias.cpu(), mask, 2)
    with pytest.raises(ValueError):  # head dim 64
        swin_window_attn.window_attention(q, k, v, bias[:1], mask, 1)
    # a view that starts 8 bytes into a 16-byte chunk: no 16-byte copies
    wide = torch.zeros(4, 144, 3 * 64 + 8, device=cuda_device, dtype=torch.bfloat16)
    qb, kb, vb = wide[..., 4:4 + 3 * 64].split(64, dim=-1)
    swin_window_attn.reset_launches()
    with pytest.raises(ValueError):
        swin_window_attn.window_attention(qb, kb, vb, bias, mask, 2)
    # a bias that starts 4 bytes into a 16-byte chunk, a mask 4 bytes into an
    # 8-byte pair: contiguous, but not for the bf16 kernel's vector reads
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    flat = torch.zeros(bias.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError):
        swin_window_attn.window_attention(qb, kb, vb, flat[1:].view_as(bias), mask, 2)
    with pytest.raises(ValueError):
        swin_window_attn.window_attention(qb, kb, vb, bias, flat[1:1 + mask.numel()].view_as(mask), 2)
    assert swin_window_attn.launches == 0
    # the fp32 kernel reads element by element and takes both
    got = swin_window_attn.window_attention(q, k, v, flat[1:].view_as(bias), flat[1:1 + mask.numel()].view_as(mask), 2)
    want = swin_window_attn.window_attention_torch(q, k, v, torch.zeros_like(bias), torch.zeros_like(mask), 2)
    assert swin_window_attn.launches == 1
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(6, 10), (5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msdeform_kernel_at_the_extractor_shape(cuda_device, dtype, grid):
    """The ViT-Adapter extractor's call: the queries are not the value's
    grid (three query grids attend into one value level), M * D is 1024
    channels, and the weights come in the value's dtype."""
    rng = np.random.RandomState(3)
    B, M, D, P, (H, W) = 2, 16, 64, 4, grid
    qgrids = [(2 * H, 2 * W), (H, W), (H // 2, W // 2)]
    Lq = sum(h * w for h, w in qgrids)
    value = torch.from_numpy(rng.randn(B, H * W, M, D).astype(np.float32)).to(cuda_device, dtype)
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (B, Lq, M, 1, P, 2)).astype(np.float32)).to(cuda_device)
    attn = torch.from_numpy(rng.rand(B, Lq, M, 1, P).astype(np.float32)).to(cuda_device, dtype)
    msdeform.reset_launches()
    got = msdeform.ms_deform_attn(value, [(H, W)], loc, attn)
    torch.cuda.synchronize()
    assert msdeform.launches == 1 and got.shape == (B, Lq, M * D) and got.dtype == dtype
    want = msdeform.ms_deform_attn_torch(value, [(H, W)], loc, attn)
    assert _rel(got, want) <= MSDEFORM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("aux", [False, True])
def test_topk_select_tie_order_on_the_card(cuda_device, aux):
    """Equal scores across the K-th place: the card returns the lower flat
    index first, as the CPU does (and ``jax.lax.top_k``), twice in a row."""
    from dvis_plus_tpu_torch.models.meta.minvis import topk_select

    def tied(seed):
        rng = np.random.RandomState(seed)
        logits = rng.randn(200, 41).astype(np.float32)
        for q in rng.choice(200, 60, replace=False):  # 60 scores of exactly 1.0, K keeps 20
            logits[q] = -60.0
            logits[q, rng.randint(40)] = 60.0
        return torch.from_numpy(logits)

    logits, aux_logits = tied(7), tied(8) if aux else None
    want = topk_select(logits, 20, aux_logits)
    assert (want[0] == 1.0).all() and (want[2][1:] >= want[2][:-1]).all()  # ties, in index order
    for _ in range(2):
        got = topk_select(logits.to(cuda_device), 20,
                          None if aux_logits is None else aux_logits.to(cuda_device))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def _flash_inputs(dev, dtype, B, L, H, fused, seed=0):
    g = torch.Generator().manual_seed(seed)
    if fused:  # column views of one qkv output, as the ViT trunk hands them over
        qkv = torch.randn(B, L, 3 * H * 64, generator=g).to(dev, dtype)
        return [t.unflatten(-1, (H, 64)) for t in qkv.split(H * 64, dim=-1)]
    return [torch.randn(B, L, H, 64, generator=g).to(dev, dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,L,H", [(2, 2049, 16), (1, 3681, 4), (1, 2048, 1), (5, 3681, 16)])
def test_flash_attn_kernel_matches_twin(cuda_device, dtype, tol, fused, B, L, H):
    """Tolerance: fp32 rel 1e-5 (both accumulate in fp32); bf16 rel 1e-2, one
    bf16 ulp of the output (p and the output round to bf16 on both sides,
    after sums taken in different orders). L = 2049 and 3681 leave a ragged
    last tile of keys and of query rows; B * H runs from 1 to 80."""
    q, k, v = _flash_inputs(cuda_device, dtype, B, L, H, fused)
    flash_attn.reset_launches()
    got = flash_attn.flash_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attn.launches == 1
    want = flash_attn.attention_torch(q, k, v)
    assert got.dtype == dtype and got.shape == want.shape == (B, L, H, 64) and got.is_contiguous()
    assert torch.isfinite(got).all()
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 127, 128, 129, 1201])
def test_flash_attn_lengths_around_a_tile(cuda_device, dtype, tol, fused, L):
    """Lengths below, at and just past the bf16 kernel's 128-row tiles (and
    the fp32 kernel's 64): the tensor map's dims are the tensor's, the box is
    larger, rows past L read as zero and their keys are masked."""
    q, k, v = _flash_inputs(cuda_device, dtype, 2, L, 3, fused)
    flash_attn.reset_launches()
    got = flash_attn.flash_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attn.launches == 1
    want = flash_attn.attention_torch(q, k, v)
    assert got.shape == want.shape == (2, L, 3, 64) and torch.isfinite(got).all()
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err <= tol, err


@pytest.mark.cuda
def test_flash_attn_scale_and_short_sequences(cuda_device):
    q, k, v = _flash_inputs(cuda_device, torch.float32, 1, 2100, 2, True)
    got = flash_attn.flash_self_attention(q, k, v, sm_scale=0.05)
    want = flash_attn.attention_torch(q, k, v, 0.05)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = flash_attn.flash_self_attention(qb, kb, vb, sm_scale=0.05)
    want = flash_attn.attention_torch(qb, kb, vb, 0.05)
    assert ((got.float() - want.float()).abs().max() / want.float().abs().max()).item() <= 1e-2
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for L in (1, 63, 100, 1201):  # short sequences launch the kernel too
            qs, ks, vs = (t[:, :L].to(dtype) for t in (q, k, v))
            flash_attn.reset_launches()
            got = flash_attn.flash_self_attention(qs, ks, vs)
            assert flash_attn.launches == 1
            want = flash_attn.attention_torch(qs, ks, vs)
            err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
            assert err <= tol, (dtype, L, err)


@pytest.mark.cuda
def test_flash_attn_wrapper_raises_instead_of_falling_back(cuda_device):
    q, k, v = _flash_inputs(cuda_device, torch.float32, 1, 2048, 2, False)
    with pytest.raises(TypeError):
        flash_attn.flash_self_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attn.flash_self_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):  # head dim 32
        flash_attn.flash_self_attention(*(t.reshape(1, 2048, 4, 32) for t in (q, k, v)))
    with pytest.raises(ValueError):  # heads not on contiguous columns
        flash_attn.flash_self_attention(*(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)))
    # a row stride of 8 bytes more than a multiple of 16: no tensor map
    wide = torch.zeros(1, 256, 3 * 128 + 4, device=cuda_device, dtype=torch.bfloat16)
    views = [t.unflatten(-1, (2, 64)) for t in wide[..., :3 * 128].split(128, dim=-1)]
    flash_attn.reset_launches()
    with pytest.raises(ValueError):
        flash_attn.flash_self_attention(*views)
    # one batch element repeated (batch stride 0): no tensor map
    with pytest.raises(ValueError):
        flash_attn.flash_self_attention(*(t[:, :256].bfloat16().expand(3, -1, -1, -1) for t in (q, k, v)))
    # the bf16 kernel takes the row max before it scales: no negative scale
    with pytest.raises(ValueError):
        flash_attn.flash_self_attention(*(t[:, :256].bfloat16() for t in (q, k, v)), sm_scale=-0.05)
    assert flash_attn.launches == 0
    # the fp32 kernel scales first and takes any scale
    qs, ks, vs = (t[:, :256] for t in (q, k, v))
    got = flash_attn.flash_self_attention(qs, ks, vs, sm_scale=-0.05)
    want = flash_attn.attention_torch(qs, ks, vs, -0.05)
    assert flash_attn.launches == 1
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


# ---------------------------------------------------------------------------
# MinVIS, CTVIS, Video Mask2Former and the runs download on the card
# ---------------------------------------------------------------------------


def _tiny_arch(arch, compute_dtype="float32"):
    """A tiny preset of ``arch`` (the port's presets with small widths)."""
    from dvis_plus_tpu_torch import config

    cfg = getattr(config, f"{arch}_r50_ytvis19")()
    m = cfg.model
    m.compute_dtype = compute_dtype
    m.pixel_decoder.conv_dim = m.pixel_decoder.mask_dim = 32
    m.pixel_decoder.transformer_enc_layers = 2
    m.pixel_decoder.transformer_dim_feedforward = 64
    td = m.transformer_decoder
    td.hidden_dim = td.mask_dim = 32
    td.num_queries, td.nheads, td.dim_feedforward, td.dec_layers = 8, 4, 64, 2
    td.reid_hidden_dim = 32
    m.tracker.num_layers, m.tracker.feedforward_dim, m.tracker.matcher_solver = 1, 64, "jv"
    cfg.test.window_size = 3
    return cfg


def _arch_models(cfg, dev):
    from dvis_plus_tpu_torch.cli import build_model

    torch.manual_seed(0)
    cpu = build_model(cfg.model).eval()
    card = build_model(cfg.model).eval()
    card.load_state_dict(cpu.state_dict())
    return cpu, card.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minvis", "ctvis", "video_maskformer"])
def test_minvis_and_clip_paths_on_the_card_match_the_cpu(cuda_device, arch):
    """7 frames at 64x96 in windows of 3 (one clip-joint forward for the
    clip model): logits and (aligned) masks on the card (B1, cuDNN) against
    the CPU (B1's plain version), fp32, rel <= 1e-3; B1 ran on the card only."""
    from dvis_plus_tpu_torch.engine.inference import _clipformer_video, _minvis_video

    cfg = _tiny_arch(arch)
    fn = _clipformer_video if arch == "video_maskformer" else _minvis_video
    x = np.random.RandomState(1).randn(7, 64, 96, 3).astype(np.float32)
    cpu, card = _arch_models(cfg, cuda_device)
    with torch.inference_mode():
        msdeform.reset_launches()
        want = fn(cfg, cpu, x, 3)
        assert msdeform.launches == 0
        got = fn(cfg, card, x, 3)
        torch.cuda.synchronize()
    assert msdeform.launches == 2 * (1 if arch == "video_maskformer" else 3)
    for g, w in zip(got[:2], want[:2]):
        assert g.is_cuda and g.shape == w.shape
        assert _rel(g.cpu(), w) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("k_col", [8, 1])
def test_runs_download_equals_packed_on_the_card(cuda_device, k_col):
    from dvis_plus_tpu_torch.engine.inference import paged_inference_video

    rng = np.random.RandomState(2)
    coarse = torch.from_numpy(rng.randn(40, 9, 6, 8).astype(np.float32))
    masks = torch.nn.functional.interpolate(coarse, size=(120, 160), mode="bilinear").to(cuda_device)
    logits = torch.from_numpy(rng.randn(40, 41).astype(np.float32)).to(cuda_device)
    kw = dict(img_size=(480, 620), output_size=(720, 930), padded_size=(480, 640), topk=20, chunk=4)
    _, _, pk = paged_inference_video(logits, masks, download="packed", **kw)
    _, _, cr = paged_inference_video(logits, masks, download="runs", k_col=k_col, **kw)
    frames = [(i, t) for i in range(20) for t in range(9)]
    assert [cr.frame_any(*f) for f in frames] == [pk.frame_any(*f) for f in frames]
    assert all(cr.encode_frame(*f) == pk.encode_frame(*f) for f in frames if pk.frame_any(*f))
    assert (len(cr.fallback) < len(frames) // 2) if k_col == 8 else cr.fallback


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minvis", "video_maskformer"])
def test_pipeline_and_runs_write_the_plain_loops_bytes_on_the_card(cuda_device, arch, tmp_path):
    """The threaded pipeline (its worker enters the card's device itself)
    and the runs download write the bytes of the plain loop's packed
    download."""
    from dvis_plus_tpu_torch.engine.inference import run_vis_inference
    from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator

    outs = []
    for download, pipeline in (("packed", False), ("runs", True)):
        cfg = _tiny_arch(arch)
        cfg.test.mask_download, cfg.test.eval_pipeline = download, pipeline
        _, card = _arch_models(cfg, cuda_device)
        rng = np.random.RandomState(3)
        videos = [{"images": rng.randn(T, 64, 96, 3).astype(np.float32), "image_size": [56, 96],
                   "height": 90, "width": 144, "video_id": v} for v, T in ((1, 5), (2, 3))]
        ev = YTVISEvaluator("synthetic", str(tmp_path / download))
        run_vis_inference(cfg, card, iter(videos), ev)
        with open(ev.write_results(), "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and len(outs[0]) > 100


@pytest.mark.cuda
def test_b1_launches_on_the_minvis_slice_shape(cuda_device):
    """Full-width R50 MinVIS, bf16, one 5-frame window at 480x640 (the
    timed slice's shape): B1 runs once per encoder layer, 6 times."""
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.config import minvis_r50_ytvis19
    from dvis_plus_tpu_torch.engine.inference import _minvis_video

    cfg = minvis_r50_ytvis19()
    torch.manual_seed(0)
    model = build_model(cfg.model).to(cuda_device).eval()
    x = np.random.RandomState(4).randn(5, 480, 640, 3).astype(np.float32)
    with torch.inference_mode():
        msdeform.reset_launches()
        logits, masks, _ = _minvis_video(cfg, model, x, 5)
        torch.cuda.synchronize()
    assert msdeform.launches == cfg.model.pixel_decoder.transformer_enc_layers == 6
    assert logits.shape == (100, 41) and masks.shape == (100, 5, 120, 160)
    assert torch.isfinite(logits.float()).all() and torch.isfinite(masks.float()).all()


# ---------------------------------------------------------------------------
# VPS and VSS on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_panoptic_bookkeeping_on_the_card_equals_the_plain_version(cuda_device, seed):
    """The card's head outputs, three time chunks: the device bookkeeping
    gives the id map and segments of the plain host version run on the same
    outputs (fp16 masks on the host), exactly."""
    from dvis_plus_tpu_torch.models.meta import dvis_online as heads

    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((3.0 * rng.randn(20, 7)).astype(np.float32)).to(cuda_device)
    masks = torch.from_numpy((4.0 * rng.randn(20, 5, 30, 40)).astype(np.float32)).to(cuda_device)
    geometry = ((112, 150), (170, 230), (120, 160))
    outs = [heads.panoptic_probs(logits, masks[:, s : s + 2], *geometry, 0.0) for s in (0, 2, 4)]
    scores, labels, keep = outs[0][:3]
    seg, infos, kept = heads.panoptic_segments_device(scores, labels, keep, [o[3:] for o in outs], 4, 0.3)
    assert seg.is_cuda and seg.dtype == torch.int32 and seg.shape == (5, 170, 230)
    want = heads.panoptic_segments_host(
        scores.cpu().numpy(), labels.cpu().numpy(), keep.cpu().numpy(),
        torch.cat([o[3] for o in outs], 1).half().cpu().numpy(),
        torch.cat([o[4] for o in outs]).cpu().numpy(), 4, 0.3)
    np.testing.assert_array_equal(seg.cpu().numpy(), want[0])
    assert infos == want[1] and list(kept) == list(want[2]) and len(infos) > 1


def _tiny_task(preset):
    """A tiny VIPSeg / VSPW preset (``dvis_online_r50_{vipseg,vspw}``) with
    the widths of ``_tiny_arch`` and 5 classes."""
    from dvis_plus_tpu_torch import config

    cfg = getattr(config, preset)()
    m = cfg.model
    m.compute_dtype, m.num_classes = "float32", 5
    m.pixel_decoder.conv_dim = m.pixel_decoder.mask_dim = 32
    m.pixel_decoder.transformer_enc_layers = 2
    m.pixel_decoder.transformer_dim_feedforward = 64
    td = m.transformer_decoder
    td.hidden_dim = td.mask_dim = 32
    td.num_queries, td.nheads, td.dim_feedforward, td.dec_layers = 8, 4, 64, 2
    td.reid_hidden_dim = 32
    m.tracker.num_layers, m.tracker.feedforward_dim, m.tracker.matcher_solver = 1, 64, "jv"
    cfg.test.window_size = 3
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["dvis_online_r50_vipseg", "dvis_online_r50_vspw"])
def test_vps_and_vss_on_the_card_match_the_cpu(cuda_device, preset):
    """7 frames at 64x96 (valid 56x96, output 90x144), windows of 3: the id
    maps (VPS) or class maps (VSS) of the card and of the CPU agree on at
    least 99.9 % of the pixels, and VPS gives the same segments; B1 ran on
    the card only."""
    from dvis_plus_tpu_torch.engine.inference import run_vps_inference, run_vss_inference

    cfg = _tiny_task(preset)
    cpu, card = _arch_models(cfg, cuda_device)
    x = np.random.RandomState(5).randn(7, 64, 96, 3).astype(np.float32)
    video = {"images": x, "image_size": [56, 96], "height": 90, "width": 144, "video_id": "v",
             "file_names": [f"{t}.jpg" for t in range(7)]}
    outs = {}
    for name, model in (("cpu", cpu), ("card", card)):
        seen = []

        class Recorder:
            def process(self, video_id, frame_names, *maps):
                seen.append(maps)

        msdeform.reset_launches()
        if cfg.test.task == "vps":
            run_vps_inference(cfg, model, iter([video]), Recorder(), 2)
        else:
            run_vss_inference(cfg, model, iter([video]), Recorder())
        outs[name] = (seen[0], msdeform.launches)
    assert outs["cpu"][1] == 0 and outs["card"][1] == 2 * 3
    got, want = outs["card"][0], outs["cpu"][0]
    assert got[0].shape == want[0].shape == (7, 90, 144)
    assert (got[0] == want[0]).mean() >= 0.999
    if cfg.test.task == "vps":
        assert got[1] == want[1]


def _tiny_daq(arch="daq_online"):
    """The tiny DAQ preset: a table of 6 slots, 2 background slots, 8
    new-instance queries (the segmenter's count), kick-out after 2 missed
    frames."""
    cfg = _tiny_arch(arch)
    d = cfg.model.daq
    d.num_new_ins, d.max_num_instances, d.num_slots, d.kick_out_frame_num = 8, 6, 2, 2
    return cfg


def _daq_stream(cfg, model, x):
    """stream_video with every frame's slot state and the distance of every
    value the stream compared with a threshold from it."""
    from dvis_plus_tpu_torch.engine.daq_inference import stream_video

    d, cutter, states, margins = cfg.model.daq, model.tracker, [], []
    step, pred, cls, seg = cutter.inference_step, cutter._prediction, cutter._class_logits, model.segment_only

    def score(logits):
        return logits.float().softmax(-1)[:, :-1].max(-1).values.cpu()

    def recording_step(*args, **kwargs):
        out, state = step(*args, **kwargs)
        states.append([t.cpu() for t in (state.alive, state.seq_id, state.invalid_frames)])
        return out, state

    def recording_pred(h, mf):
        logits, masks = pred(h, mf)
        if states:  # the first frame's validity comes from the segmenter
            margins.append(float((score(logits) - d.inference_select_thr).abs().min()))
        return logits, masks

    def recording_cls(h):
        out = cls(h)
        margins.append(float((score(out) - d.keep_threshold).abs().min()))
        return out

    def recording_seg(images):
        out = seg(images)
        if not states:
            margins.append(float((score(out["pred_logits"][0]) - d.aux_inference_select_thr).abs().min()))
        return out

    cutter.inference_step, cutter._prediction, cutter._class_logits = recording_step, recording_pred, recording_cls
    model.segment_only = recording_seg
    try:
        with torch.inference_mode():
            records, *_ = stream_video(cfg, model, x)
    finally:
        del cutter.inference_step, cutter._prediction, cutter._class_logits, model.segment_only
    return records, states, margins


@pytest.mark.cuda
def test_daq_cutter_stream_on_the_card_matches_the_cpu(cuda_device):
    """7 frames at 64x96 in windows of 3 through ``stream_video``: the slot
    state of every frame (alive, seq ids, missed-frame counts) equal on the
    card and on the CPU, the sequences' frames equal, their logits and
    embeds rel <= 1e-3; B1 ran on the card only. Every score the CPU
    compared with a threshold lies more than 1e-4 from it, and the stream
    starts sequences after frame 0, kicks tracks out and keeps tracks
    through missed frames."""
    cfg = _tiny_daq()
    cpu, card = _arch_models(cfg, cuda_device)
    with torch.no_grad():
        for m in (cpu, card):
            m.tracker.class_embed.weight.mul_(1.5)
    x = np.random.RandomState(6).randn(7, 64, 96, 3).astype(np.float32)
    msdeform.reset_launches()
    want, want_states, margins = _daq_stream(cfg, cpu, x)
    assert msdeform.launches == 0
    got, got_states, _ = _daq_stream(cfg, card, x)
    assert msdeform.launches == 2 * 3
    assert min(margins) > 1e-4
    assert len(got_states) == len(want_states) == 7
    for t, (g, w) in enumerate(zip(got_states, want_states)):
        for a, b in zip(g, w):
            assert torch.equal(a, b), t
    assert any(int(s[2].max()) > 0 for s in want_states)
    assert sorted(got) == sorted(want) and any(r.start > 0 for r in want.values())
    assert any(r.frames[-1] < 6 for r in want.values())
    for sid, r in want.items():
        assert got[sid].frames == r.frames
        for key in ("logits", "embeds"):
            assert _rel(torch.from_numpy(np.stack(getattr(got[sid], key))),
                        torch.from_numpy(np.stack(getattr(r, key)))) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("alive", [50, 20, 0])
def test_auction_on_daq_slot_costs_on_the_card(cuda_device, alive):
    """The cutter's 55 x 100 slot costs (dead rows all 2.0): the card's
    auction, checked first after 16 rounds, equals the CPU's checked every
    round."""
    from dvis_plus_tpu_torch.ops.assignment import auction_lap

    rng = np.random.RandomState(alive)
    a = rng.randn(55, 32).astype(np.float32)
    b = rng.randn(100, 32).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True) + 1e-6
    b /= np.linalg.norm(b, axis=1, keepdims=True) + 1e-6
    live = np.zeros(55, bool)
    live[:alive] = live[50:] = True
    cost = torch.from_numpy(np.where(live[:, None], 1.0 - a @ b.T, 2.0).astype(np.float32))
    want = auction_lap(cost)
    got = auction_lap(cost.to(cuda_device), first_check=16)
    assert got.is_cuda and torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# Open vocabulary on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["online", "offline"])
def test_ov_stream_on_the_card_matches_the_cpu(cuda_device, arch):
    """OV-DVIS++ with a tiny ConvNeXt (depths (1, 1, 2, 1)), 6 frames at
    64x96 in windows of 3, a random 5-class classifier: the fused log-probs
    and masks on the card (B1, cuDNN) against the CPU (B1's plain version),
    fp32, rel <= 1e-3, the same top-10 labels; B1 ran on the card only.
    Every mask value the CPU thresholded (at stride 4, and resized onto the
    stride-32 CLIP map) lies more than 1e-4 from 0."""
    _ov_stream_case(cuda_device, arch)


@pytest.mark.cuda
def test_ov_rn50_stream_on_the_card_matches_the_cpu(cuda_device):
    """The same for OV-DVIS++ online on the CLIP RN50 trunk (a
    ModifiedResNet of width 8, its masked attention pooling the
    out-of-vocabulary head), as ``configs/ov/ov_online_r50_zeroshot_*.yaml``
    build it."""
    _ov_stream_case(cuda_device, "online", resnet=True)


def _ov_stream_case(cuda_device, arch, resnet=False):
    from dvis_plus_tpu_torch import config
    from dvis_plus_tpu_torch.cli_ov import build_ov_model
    from dvis_plus_tpu_torch.engine.ov_inference import ov_video_logits_masks_fn
    from dvis_plus_tpu_torch.models.meta.minvis import topk_select
    from dvis_plus_tpu_torch.models.ov.heads import resize_masks

    cfg = getattr(config, f"ov_{arch}_convnextl_zeroshot_ytvis19")()
    m = cfg.model
    m.compute_dtype = "float32"
    m.backbone.clip_depths, m.backbone.clip_dims = (1, 1, 2, 1), (16, 24, 32, 40)
    m.ov.clip_embed_dim = 24
    if resnet:
        b = m.backbone
        b.name, b.clip_model_type = "clip_rn50", "resnet"
        b.clip_depths, b.clip_resnet_width, b.clip_attnpool_spacial = (1, 1, 2, 1), 8, 3
    m.pixel_decoder.conv_dim = m.pixel_decoder.mask_dim = 32
    m.pixel_decoder.transformer_enc_layers = 2
    m.pixel_decoder.transformer_dim_feedforward = 64
    td = m.transformer_decoder
    td.hidden_dim = td.mask_dim = 32
    td.num_queries, td.nheads, td.dim_feedforward, td.dec_layers = 8, 4, 64, 2
    m.tracker.num_layers = m.refiner.num_layers = 1
    m.tracker.feedforward_dim = m.refiner.feedforward_dim = 64
    cfg.test.window_size = 3
    torch.manual_seed(0)
    cpu = build_ov_model(cfg).eval()
    with torch.no_grad():  # mask logits of a trained model's order
        for name, p in cpu.named_parameters():
            if "mask_embed" in name and name.endswith("weight"):
                p.mul_(10.0)
            # at width 8 the random RN50 leaves its ReLU maps nearly constant
            # over the stride-32 positions, where the pixel decoder's
            # one-channel GroupNorm groups amplify rounding (x3, as
            # tests/test_torch_common.py::jax_ov_model_and_params)
            elif resnet and name.startswith("backbone.clip_model.visual.") and p.dim() == 4:
                p.mul_(3.0)
    card = build_ov_model(cfg).eval()
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda_device)
    rng = np.random.RandomState(2)
    tc, nt = rng.randn(15, 24).astype(np.float32), (3,) * 5 + (1,)
    overlap = np.array([1, 0, 1, 0, 0], np.float32)
    x = rng.randn(6, 64, 96, 3).astype(np.float32)
    with torch.inference_mode():
        msdeform.reset_launches()
        want = ov_video_logits_masks_fn(cfg, cpu, tc, nt, overlap)(x)
        assert msdeform.launches == 0
        got = ov_video_logits_masks_fn(cfg, card, tc, nt, overlap)(x)
        torch.cuda.synchronize()
    assert msdeform.launches == 2 * 2
    w_masks = want[1].float()
    assert w_masks.abs().min().item() > 1e-4
    assert resize_masks(w_masks, (2, 3)).abs().min().item() > 1e-4
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        assert _rel(g.cpu(), w) <= 1e-3
    assert topk_select(got[0].cpu(), 10)[1].tolist() == topk_select(want[0], 10)[1].tolist()


# ---------------------------------------------------------------------------
# B1's backward kernel against autograd of the twin. fp32: 1e-5 of the
# largest gradient (the kernel adds grad_value with atomics, in another order
# from run to run); bf16 values: 2e-2 (the value and weight gradients are
# rounded once to bf16 on both sides). B2 and B3 are forward only: with
# gradients on, an input that requires one raises instead of returning a
# tensor with no grad_fn.
# ---------------------------------------------------------------------------

MSDEFORM_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _msdeform_grads(fn, value, shapes, loc, attn, grad_out, radius):
    v, l, a = (t.detach().clone().requires_grad_() for t in (value, loc, attn))
    fn(v, shapes, l, a, radius=radius).backward(grad_out)
    return v.grad, l.grad, a.grad


def _check_msdeform_grads(value, shapes, loc, attn, radius):
    B, Lq = loc.shape[:2]
    g = torch.randn(B, Lq, value.shape[2] * value.shape[3], generator=torch.Generator().manual_seed(3))
    g = g.to(value.device, value.dtype)
    msdeform.reset_launches()
    got = _msdeform_grads(msdeform.ms_deform_attn, value, shapes, loc, attn, g, radius)
    torch.cuda.synchronize()
    assert msdeform.launches == 1 and msdeform.backward_launches == 1
    want = _msdeform_grads(msdeform.ms_deform_attn_torch, value, shapes, loc, attn, g, radius)
    for name, x, y in zip(("value", "locations", "weights"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        tol = MSDEFORM_GRAD_TOL[value.dtype if name != "locations" else torch.float32]
        if name == "weights" and attn.dtype == torch.bfloat16:
            tol = MSDEFORM_GRAD_TOL[torch.bfloat16]
        assert _rel(x, y) <= tol, (name, _rel(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("attn_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [None, 7, 2])
def test_msdeform_backward_matches_twin_autograd(cuda_device, dtype, radius, attn_dtype):
    value, loc, attn = _inputs(cuda_device, dtype)
    _check_msdeform_grads(value, SHAPES, loc, attn.to(attn_dtype), radius)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(MSDEFORM_EDGE_CASES)))
def test_msdeform_backward_edge_cases(cuda_device, case, dtype):
    """The forward's edge cases (and the special locations on and outside
    the border), both forms; the extractor form (Lq != Len) once a case."""
    shapes, B, M, D, P = MSDEFORM_EDGE_CASES[case]
    value, loc, attn = _msdeform_case(cuda_device, dtype, shapes, B, M, D, P, seed=case)
    for radius in (None, 2):
        _check_msdeform_grads(value, shapes, loc, attn, radius)
    qgrids = [(2 * h, 2 * w) for h, w in shapes[:1]] + list(shapes)
    value, loc, attn = _msdeform_case(cuda_device, dtype, shapes, B, M, D, P, seed=case, qgrids=qgrids)
    _check_msdeform_grads(value, shapes, loc, attn, None)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2], ids=["value", "locations", "weights"])
def test_msdeform_wrapper_gradients_match_the_twin(cuda_device, which):
    """One input requiring a gradient: the wrapper launches the forward and,
    in the backward, the backward kernel, whose gradient for that input
    equals autograd of the twin's; under no_grad it launches the forward
    alone (the frozen segmenter's way)."""
    inputs = list(_inputs(cuda_device, torch.float32))
    inputs[which].requires_grad_()
    value, loc, attn = inputs
    msdeform.reset_launches()
    out = msdeform.ms_deform_attn(value, SHAPES, loc, attn)
    assert out.requires_grad and msdeform.launches == 1 and msdeform.backward_launches == 0
    (got,) = torch.autograd.grad(out.square().sum(), inputs[which])
    assert msdeform.backward_launches == 1
    (want,) = torch.autograd.grad(msdeform.ms_deform_attn_torch(value, SHAPES, loc, attn).square().sum(),
                                  inputs[which])
    assert _rel(got, want) <= 1e-5
    with torch.no_grad():
        msdeform.ms_deform_attn(value, SHAPES, loc, attn)
    assert msdeform.launches == 2 and msdeform.backward_launches == 1


def _check_backward_launch(value, shapes, loc, attn, radius, plan=None):
    """``_launch_backward`` (with ``plan``, else the default one) against
    autograd of the twin, at the bars above."""
    B, Lq = loc.shape[:2]
    g = torch.randn(B, Lq, value.shape[2] * value.shape[3], generator=torch.Generator().manual_seed(4))
    g = g.to(value.device, value.dtype)
    got = msdeform._launch_backward(value, shapes, loc, attn, radius, g, plan)
    torch.cuda.synchronize()
    want = _msdeform_grads(msdeform.ms_deform_attn_torch, value, shapes, loc, attn, g, radius)
    for name, x, y, t in zip(("value", "locations", "weights"), got, want, (value, loc, attn)):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.isfinite(x).all(), name
        assert _rel(x, y) <= MSDEFORM_GRAD_TOL[t.dtype], (name, _rel(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(MSDEFORM_EDGE_CASES)))
def test_msdeform_backward_far_offsets_at_the_edge_cases(cuda_device, case, dtype):
    """Exact form, offsets uniform over +-64 value pixels: most samples leave
    their level or land far from their query, on the edge cases' shapes."""
    shapes, B, M, D, P = MSDEFORM_EDGE_CASES[case]
    value, loc, attn = _msdeform_case(cuda_device, dtype, shapes, B, M, D, P, seed=case, spread=64.0)
    _check_msdeform_grads(value, shapes, loc, attn, None)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [None, 2])
@pytest.mark.parametrize("rows", [1, 4, 5])
def test_msdeform_backward_bands_with_a_ragged_edge(cuda_device, rows, radius):
    """The value-gradient kernel with the levels cut into bands of ``rows``
    rows that do not divide them (13 = 4 + 4 + 4 + 1, 7 = 5 + 2, ...): the
    corners on a band's edge row and the cells above it reach the right
    block."""
    shapes = [(13, 17), (7, 9), (3, 5)]
    value, loc, attn = _msdeform_case(cuda_device, torch.float32, shapes, 2, 4, 32, 4, seed=7)
    plan = msdeform.backward_plan(value, loc, shapes)
    plan = plan._replace(rows=tuple(min(rows, h) for h, _ in shapes))
    _check_backward_launch(value, shapes, loc, attn, radius, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msdeform_backward_coarse_queries_on_a_finer_level(cuda_device, dtype):
    """Query grids coarser than the value levels (Lq != Len, the exact
    form): each query's samples spread over several pixels of the finer
    level, and many queries' samples share its cells."""
    shapes = [(24, 32), (12, 16)]
    value, loc, attn = _msdeform_case(cuda_device, dtype, shapes, 2, 8, 32, 4, seed=9,
                                      qgrids=[(3, 4), (6, 8)])
    assert loc.shape[1] == 60
    _check_msdeform_grads(value, shapes, loc, attn, None)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
def test_msdeform_backward_bf16_heads_of_64(cuda_device, misaligned):
    """The extractor's heads (D = 64, bf16 values and weights): aligned, the
    16-byte instantiation; a value view 2 bytes past a 16-byte boundary,
    the scalar one (32 lanes a head, two channels each)."""
    shapes = [(10, 12)]
    value, loc, attn = _msdeform_case(cuda_device, torch.bfloat16, shapes, 2, 4, 64, 4, seed=11,
                                      qgrids=[(20, 24), (10, 12), (5, 6)])
    attn = attn.to(torch.bfloat16)
    if misaligned:
        flat = torch.zeros(value.numel() + 1, device=cuda_device, dtype=torch.bfloat16)
        value = flat[1:].view_as(value).copy_(value)
    plan = msdeform.backward_plan(value, loc, shapes)
    assert (plan.vector, plan.group) == ((False, 32) if misaligned else (True, 8))
    _check_msdeform_grads(value, shapes, loc, attn, None)


@pytest.mark.cuda
def test_swin_window_attn_wrapper_refuses_inputs_that_require_grad(cuda_device):
    q, k, v, bias, mask = _swin_inputs(cuda_device, torch.bfloat16, 8, 144, 2, 2)
    bias.requires_grad_()
    swin_window_attn.reset_launches()
    with pytest.raises(NotImplementedError, match="swin_fused_attn"):
        swin_window_attn.window_attention(q, k, v, bias, mask, 2)
    with torch.no_grad():
        swin_window_attn.window_attention(q, k, v, bias, mask, 2)
    assert swin_window_attn.launches == 1


@pytest.mark.cuda
def test_flash_attn_wrapper_refuses_inputs_that_require_grad(cuda_device):
    q, k, v = _flash_inputs(cuda_device, torch.bfloat16, 1, 256, 2, False)
    q.requires_grad_()
    flash_attn.reset_launches()
    with pytest.raises(NotImplementedError, match="vit_flash_attention"):
        flash_attn.flash_self_attention(q, k, v)
    with torch.no_grad():
        flash_attn.flash_self_attention(q, k, v)
    assert flash_attn.launches == 1


def _tiny_batch(B=2, T=3, N=4, H=64, W=96, seed=0):
    from dvis_plus_tpu_torch.engine.trainer import Batch
    from dvis_plus_tpu_torch.losses.targets import VideoTargets

    g = torch.Generator().manual_seed(seed)
    masks = torch.zeros(B, N, T, H, W, dtype=torch.bool)
    for b in range(B):
        for n in range(N - 1):
            y, x = int(torch.randint(0, H - 24, (1,), generator=g)), int(torch.randint(0, W - 30, (1,), generator=g))
            for t in range(T):
                if not (n == 1 and t == 0):
                    masks[b, n, t, y:y + 20, x + 2 * t:x + 2 * t + 24] = True
    fv = masks.flatten(3).any(-1)
    labels = torch.randint(0, 5, (B, N), generator=g)
    return Batch(torch.randn(B, T, 3, H, W, generator=g), VideoTargets(labels, masks, fv.any(-1), fv))


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One DVIS++ online step from the same weights, batch and draws (a CPU
    generator, its values moved to the tensors' device): the losses rel
    <= 1e-4, the tracker's gradients within 1e-3 as a norm; the frozen
    segmenter's deformable attention launched kernel B1 under no_grad."""
    import copy

    from dvis_plus_tpu_torch.config import tiny
    from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
    from dvis_plus_tpu_torch.losses.targets import VideoTargets
    from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline
    from dvis_plus_tpu_torch.utils.draws import Draws

    cfg = tiny("dvis_online", "model.num_classes=5", "model.tracker.matcher_solver=jv")
    torch.manual_seed(0)
    cpu_model = DVISOnline(cfg.model)
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    batch = _tiny_batch()
    gpu_batch = Batch(batch.images.to(cuda_device), VideoTargets(*(t.to(cuda_device) for t in batch.targets)))
    out = []
    msdeform.reset_launches()
    for model, b in ((cpu_model, batch), (gpu_model, gpu_batch)):
        step, init = build_train_step(cfg, model)
        _, metrics = step(init(), b, Draws(torch.Generator().manual_seed(7)))
        grads = torch.cat([p.grad.flatten().cpu() for n, p in model.named_parameters() if p.requires_grad])
        out.append(({k: float(v) for k, v in metrics.items()}, grads))
    assert msdeform.launches == cfg.model.pixel_decoder.transformer_enc_layers
    (want, gw), (got, gg) = out
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    assert ((gg - gw).norm() / gw.norm()).item() <= 1e-3


@pytest.mark.cuda
def test_minvis_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One MinVIS step (the whole segmenter trained: B1's forward and
    backward kernels in each encoder layer) from the same weights, batch and
    draws, the card replaying the CPU's masked-attention decisions, the
    sampling offsets off the pixel grid (``chip_smoke.off_grid``): the
    losses rel <= 1e-4, the decoders' gradients within 1e-3 as a
    norm, the backbone's within 1e-2 (a ReLU input within rounding of 0
    passes its gradient on one device and not on the other: on the CPU, the
    JAX package and the port differ so by 1.6e-3, tests/test_torch_minvis_train.py)."""
    import copy

    from dvis_plus_tpu_torch.config import tiny
    from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
    from dvis_plus_tpu_torch.losses.targets import VideoTargets
    from dvis_plus_tpu_torch.models.segmenter.segmenter import Segmenter
    from dvis_plus_tpu_torch.utils.draws import Draws

    cfg = tiny("minvis", "model.num_classes=5")
    from chip_smoke import off_grid, replay_attention

    torch.manual_seed(0)
    cpu_model = Segmenter(cfg.model)
    off_grid(cpu_model)  # the initialisation samples exactly on pixel corners
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    batch = _tiny_batch()
    gpu_batch = Batch(batch.images.to(cuda_device), VideoTargets(*(t.to(cuda_device) for t in batch.targets)))

    out, decisions = [], []
    msdeform.reset_launches()
    for model, b in ((cpu_model, batch), (gpu_model, gpu_batch)):
        # the card replays the CPU's masked-attention decisions, which the
        # random model's mask logits put near the threshold
        replay_attention(model.sem_seg_head.predictor, decisions, replay=model is gpu_model)
        step, init = build_train_step(cfg, model)
        _, metrics = step(init(), b, Draws(torch.Generator().manual_seed(7)))
        grads = {part: torch.cat([p.grad.flatten().cpu() for n, p in model.named_parameters()
                                  if n.startswith(part)]) for part in ("sem_seg_head.", "backbone.")}
        out.append(({k: float(v) for k, v in metrics.items()}, grads))
    layers = cfg.model.pixel_decoder.transformer_enc_layers
    assert msdeform.launches == layers and msdeform.backward_launches == layers
    (want, gw), (got, gg) = out
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    for part, tol in (("sem_seg_head.", 1e-3), ("backbone.", 1e-2)):
        assert ((gg[part] - gw[part]).norm() / gw[part].norm()).item() <= tol, part


@pytest.mark.cuda
def test_msdeform_backward_at_the_extractor_training_shape(cuda_device):
    """B1's backward at the ViT-L extractor's training shape (480x768
    frames): 1,440 value tokens on one 30x48 level, 16 heads of 64 in bf16,
    7,560 queries (the 60x96, 30x48 and 15x24 grids), four points, exact;
    two frames. Against autograd of the twin at the bf16 bar."""
    shapes = [(30, 48)]
    value, loc, attn = _msdeform_case(cuda_device, torch.bfloat16, shapes, 2, 16, 64, 4, seed=13,
                                      qgrids=[(60, 96), (30, 48), (15, 24)])
    assert value.shape == (2, 1440, 16, 64) and loc.shape[1] == 7560
    _check_msdeform_grads(value, shapes, loc, attn.to(torch.bfloat16), None)


@pytest.mark.cuda
def test_vitl_minvis_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One MinVIS step with a tiny ViT-Adapter (a 4-block trunk, frozen):
    B1's forward and backward in the encoder layer and in each of the six
    extractors on the card; the losses rel <= 1e-4, the decoders' gradients
    within 1e-3 as a norm, the adapter's within 1e-2; the trunk has none."""
    import copy

    from chip_smoke import VIT_TINY, off_grid, replay_attention
    from dvis_plus_tpu_torch.config import tiny
    from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
    from dvis_plus_tpu_torch.losses.targets import VideoTargets
    from dvis_plus_tpu_torch.models.segmenter.segmenter import Segmenter
    from dvis_plus_tpu_torch.utils.draws import Draws

    cfg = tiny("minvis", "model.num_classes=5", *VIT_TINY)
    torch.manual_seed(0)
    cpu_model = Segmenter(cfg.model)
    off_grid(cpu_model)
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    batch = _tiny_batch()
    gpu_batch = Batch(batch.images.to(cuda_device), VideoTargets(*(t.to(cuda_device) for t in batch.targets)))
    out, decisions = [], []
    msdeform.reset_launches()
    for model, b in ((cpu_model, batch), (gpu_model, gpu_batch)):
        replay_attention(model.sem_seg_head.predictor, decisions, replay=model is gpu_model)
        step, init = build_train_step(cfg, model)
        _, metrics = step(init(), b, Draws(torch.Generator().manual_seed(7)))
        assert all(p.grad is None for p in model.backbone.vit_module.parameters())
        grads = {part: torch.cat([p.grad.flatten().cpu() for n, p in model.named_parameters()
                                  if n.startswith(part) and p.grad is not None])
                 for part in ("sem_seg_head.", "backbone.")}
        out.append(({k: float(v) for k, v in metrics.items()}, grads))
    b1 = cfg.model.pixel_decoder.transformer_enc_layers + 4 + 2  # the encoder, 4 + 2 extractors
    assert msdeform.launches == b1 and msdeform.backward_launches == b1
    (want, gw), (got, gg) = out
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    for part, tol in (("sem_seg_head.", 1e-3), ("backbone.", 1e-2)):
        assert ((gg[part] - gw[part]).norm() / gw[part].norm()).item() <= tol, part


@pytest.mark.cuda
def test_swin_trains_through_the_plain_op_and_serves_through_b2(cuda_device):
    """A Swin (head width 32) on the card: in training mode its window
    attention is the plain op (no B2 launch) and every parameter gets a
    gradient; in eval mode, without gradients, each block launches B2."""
    from dvis_plus_tpu_torch.models.backbones.swin import SwinTransformer
    from dvis_plus_tpu_torch.utils.draws import Draws

    torch.manual_seed(0)
    net = SwinTransformer(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window_size=7,
                          drop_path_rate=0.3).to(cuda_device)
    x = torch.randn(2, 3, 96, 128, device=cuda_device)
    swin_window_attn.reset_launches()
    net.train()
    out = net(x, Draws(torch.Generator(device=cuda_device).manual_seed(1)))
    sum(v.float().square().mean() for v in out.values()).backward()
    assert swin_window_attn.launches == 0
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in net.parameters())
    net.eval()
    with torch.no_grad():
        net(x)
    assert swin_window_attn.launches == 8


@pytest.mark.cuda
def test_nccl_world_size_one_step_matches_the_one_process_step(cuda_device, tmp_path, monkeypatch):
    """One DVIS++ online step on the card under a process group of one NCCL
    rank (``parallel.mesh.init_distributed``: the gradients all-reduced,
    the losses summed over the group) against the same step without a
    group: losses rel <= 1e-4, the tracker's gradients within 1e-3 as a
    norm."""
    import copy

    from dvis_plus_tpu_torch.config import tiny
    from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
    from dvis_plus_tpu_torch.losses.targets import VideoTargets
    from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline
    from dvis_plus_tpu_torch.parallel.mesh import init_distributed
    from dvis_plus_tpu_torch.utils.draws import Draws

    cfg = tiny("dvis_online", "model.num_classes=5", "model.tracker.matcher_solver=jv")
    torch.manual_seed(0)
    models = [DVISOnline(cfg.model).to(cuda_device)]
    models.append(copy.deepcopy(models[0]))
    batch = _tiny_batch()
    batch = Batch(batch.images.to(cuda_device), VideoTargets(*(t.to(cuda_device) for t in batch.targets)))
    out = []
    for grouped, model in zip((False, True), models):
        if grouped:
            monkeypatch.setenv("WORLD_SIZE", "1")
            monkeypatch.setenv("RANK", "0")
            monkeypatch.setenv("LOCAL_RANK", "0")
            assert init_distributed("cuda", init_method=f"file://{tmp_path}/rendezvous") == torch.device("cuda", 0)
            assert torch.distributed.get_backend() == "nccl"
        try:
            step, init = build_train_step(cfg, model)
            _, metrics = step(init(), batch, Draws(torch.Generator().manual_seed(7)))
            grads = torch.cat([p.grad.flatten().cpu() for n, p in model.named_parameters() if p.requires_grad])
            out.append(({k: float(v) for k, v in metrics.items()}, grads))
        finally:
            if grouped:
                torch.distributed.destroy_process_group()
    (want, gw), (got, gg) = out
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6), (k, got[k], want[k])
    assert ((gg - gw).norm() / gw.norm()).item() <= 1e-3


@pytest.mark.cuda
def test_sharded_refiner_on_the_card_names_the_device_twice(cuda_device):
    """The object-sharded refiner pass over ``[cuda:0, cuda:0]`` (Q = 9 in
    two shards: one padded row) against the plain pass, fp32: rel <= 1e-5."""
    from dvis_plus_tpu_torch.models.refiner.temporal_refiner import TemporalRefiner
    from dvis_plus_tpu_torch.parallel.sp import refiner_embed_pass_sharded

    torch.manual_seed(0)
    refiner = TemporalRefiner(5, 64, 128, 4, 2, 32).to(cuda_device).eval()
    ie = torch.randn(1, 12, 9, 64, device=cuda_device)
    fe = torch.randn(1, 12, 10, 64, device=cuda_device)
    with torch.no_grad():
        want = refiner.embed_pass(ie, fe)
        got = refiner_embed_pass_sharded(refiner, ie, fe, [torch.device("cuda", 0)] * 2)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].device == ie.device
        assert _rel(got[k], want[k]) <= 1e-5, k


@pytest.mark.cuda
@pytest.mark.parametrize("B_,N,H,nW", [(40, 144, 6, 20), (60, 144, 24, 12), (12, 49, 3, 6), (13, 49, 6, 0)])
def test_swin_fast_softmax_serves_through_b2(cuda_device, B_, N, H, nW):
    """``backbone.swin_fast_softmax`` on the card: the wrapper launches B2
    (the fused kernel's precedence), within 1e-2 of the bf16-score plain
    path on the same tensors (q, k, v at half scale: scores of order 1, as
    a model's, where bf16 scores round to steps well under 1 % of their
    exp)."""
    q, k, v, bias, mask = _swin_inputs(cuda_device, torch.bfloat16, B_, N, H, nW)
    q, k, v = q * 0.5, k * 0.5, v * 0.5
    swin_window_attn.reset_launches()
    got = swin_window_attn.window_attention(q, k, v, bias * 0.25, mask, H, fast_softmax=True)
    torch.cuda.synchronize()
    assert swin_window_attn.launches == 1
    want = swin_window_attn.window_attention_fast_softmax_torch(q, k, v, bias * 0.25, mask, H)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _rel(got, want) <= 1e-2


@pytest.mark.cuda
def test_fpn_segmenter_on_the_card_matches_the_cpu(cuda_device):
    """MinVIS with ``pixel_decoder.name=fpn`` at small widths, fp32: the
    card (cuDNN convolutions, no B1 launch) against the CPU, rel <= 1e-4."""
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.config import tiny

    cfg = tiny("minvis", "model.pixel_decoder.name=fpn")
    torch.manual_seed(0)
    model = build_model(cfg.model).eval()
    x = torch.randn(3, 3, 96, 128)
    msdeform.reset_launches()
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda_device)(x.to(cuda_device))
    torch.cuda.synchronize()
    assert msdeform.launches == 0
    for key in ("pred_logits", "pred_masks", "pred_embds"):
        assert _rel(got[key].cpu(), want[key]) <= 1e-4, key


@pytest.mark.cuda
def test_demo_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The demo's long-video mode (DVIS++ online, ``--chunk-size 3``) at
    small widths, fp32, every top-K instance drawn: the card's overlays
    equal to the CPU's on at least 99.9 % of pixels."""
    import cv2

    from dvis_plus_tpu_torch import demo
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.config import TINY_TRAIN, load_config

    yaml = "configs/dvis/dvis_online_r50_ytvis19.yaml"
    opts = [*TINY_TRAIN, "model.tracker.matcher_solver=jv", "input.min_size_test=64",
            "input.max_size_test=96", "test.window_size=2", "test.max_num=4"]
    torch.manual_seed(0)
    torch.save(build_model(load_config(yaml, opts).model).state_dict(), tmp_path / "w.pth")
    frames = tmp_path / "frames"
    frames.mkdir()
    y, x = np.mgrid[0:64, 0:96]
    for t in range(5):
        img = np.stack([x * 2, y * 3, np.full_like(x, 40 * t)], -1).astype(np.uint8)
        cv2.imwrite(str(frames / f"{t:05d}.jpg"), img)
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = tmp_path / device
        demo.main(["--config-file", yaml, "--input", str(frames), "--output", str(outs[device]),
                   "--device", device, "--chunk-size", "3", "--confidence-threshold", "0", *opts,
                   f"weights={tmp_path / 'w.pth'}"])
    equal = total = 0
    for t in range(5):
        a, b = (cv2.imread(str(outs[d] / f"{t:05d}.jpg")) for d in ("cuda", "cpu"))
        equal += int((a == b).all(-1).sum())
        total += a.shape[0] * a.shape[1]
    assert equal >= 0.999 * total, equal / total
