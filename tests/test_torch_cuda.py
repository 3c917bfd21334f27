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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [None, 7])
def test_msdeform_kernel_matches_twin(cuda_device, dtype, radius):
    value, loc, attn = _inputs(cuda_device, dtype)
    msdeform.reset_launches()
    got = msdeform.ms_deform_attn(value, SHAPES, loc, attn, radius=radius)
    torch.cuda.synchronize()
    assert msdeform.launches == 1
    want = msdeform.ms_deform_attn_torch(value, SHAPES, loc, attn, radius=radius)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err


@pytest.mark.cuda
def test_msdeform_wrapper_raises_instead_of_falling_back(cuda_device):
    value, loc, attn = _inputs(cuda_device, torch.float32)
    with pytest.raises(TypeError):
        msdeform.ms_deform_attn(value.half(), SHAPES, loc, attn)
    with pytest.raises(ValueError):
        msdeform.ms_deform_attn(value, SHAPES, loc.cpu(), attn)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msdeform_kernel_at_the_extractor_shape(cuda_device, dtype):
    """The ViT-Adapter extractor's call: the queries are not the value's
    grid (three query grids attend into one value level) and M * D is the
    kernel's limit of 1024 channels."""
    rng = np.random.RandomState(3)
    B, M, D, P, (H, W) = 2, 16, 64, 4, (6, 10)
    Lq = 4 * H * W + H * W + (H // 2) * (W // 2)
    value = torch.from_numpy(rng.randn(B, H * W, M, D).astype(np.float32)).to(cuda_device, dtype)
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (B, Lq, M, 1, P, 2)).astype(np.float32)).to(cuda_device)
    attn = torch.from_numpy(rng.rand(B, Lq, M, 1, P).astype(np.float32)).to(cuda_device)
    msdeform.reset_launches()
    got = msdeform.ms_deform_attn(value, [(H, W)], loc, attn)
    torch.cuda.synchronize()
    assert msdeform.launches == 1 and got.shape == (B, Lq, M * D)
    want = msdeform.ms_deform_attn_torch(value, [(H, W)], loc, attn)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


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
