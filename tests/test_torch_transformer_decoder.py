"""Port masked-attention decoder and sine position encoding against the JAX
ones, fp32, rel <= 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.models.segmenter.position_encoding import position_embedding_sine_2d as jax_pe
from dvis_plus_tpu.models.segmenter.transformer_decoder import MaskedTransformerDecoder
from dvis_plus_tpu_torch.models.segmenter.position_encoding import position_embedding_sine_2d
from tests.test_torch_common import H_IN, W_IN, jax_model_and_params, port_model, rel_err

torch.set_num_threads(2)


@pytest.mark.parametrize("hw", [(2, 3), (15, 20), (60, 80)])
def test_position_encoding_matches_jax(hw):
    got = position_embedding_sine_2d(*hw, 64).numpy()
    assert rel_err(got, jax_pe(*hw, 64)) <= 1e-5


def test_decoder_matches_jax():
    cfg, _, params = jax_model_and_params()
    td = cfg.model.transformer_decoder
    rng = np.random.RandomState(0)
    BT, C = 2, td.hidden_dim
    ms = [rng.randn(BT, H_IN // s, W_IN // s, C).astype(np.float32) for s in (32, 16, 8)]
    mf = rng.randn(BT, H_IN // 4, W_IN // 4, td.mask_dim).astype(np.float32)
    jmod = MaskedTransformerDecoder(
        num_classes=cfg.model.num_classes, hidden_dim=C, num_queries=td.num_queries,
        num_heads=td.nheads, dim_feedforward=td.dim_feedforward, num_layers=td.dec_layers,
        mask_dim=td.mask_dim, reid_branch=td.reid_branch, reid_hidden_dim=td.reid_hidden_dim,
    )
    jp = {"params": params["params"]["segmenter"]["transformer_decoder"]}
    want = jax.jit(jmod.apply)(jp, [jnp.asarray(m) for m in ms], jnp.asarray(mf))
    with torch.no_grad():
        got = port_model(cfg, params).sem_seg_head.predictor(
            [torch.from_numpy(np.moveaxis(m, -1, 1).copy()) for m in ms],
            torch.from_numpy(np.moveaxis(mf, -1, 1).copy()),
        )
    for k in ("pred_logits", "pred_masks", "pred_embds", "pred_embds_without_norm",
              "pred_reid_embed"):
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k
    # the attention masks fed back between layers actually block keys
    blocked = np.asarray(jax.nn.sigmoid(want["aux_pred_masks"][-1]) < 0.5)
    assert 0 < blocked.mean() < 1
