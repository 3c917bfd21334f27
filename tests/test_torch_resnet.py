"""Port ResNet-50 (NCHW) against the JAX ResNet-50 (NHWC), fp32, rel <= 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dvis_plus_tpu.models.backbones.resnet import resnet50
from tests.test_torch_common import images, jax_model_and_params, nchw, port_model, rel_err

torch.set_num_threads(2)


def test_resnet50_matches_jax():
    cfg, _, params = jax_model_and_params()
    x = images(2)
    jp = {"params": params["params"]["segmenter"]["backbone"]}
    want = jax.jit(lambda p, x: resnet50().apply(p, x))(jp, jnp.asarray(x))
    with torch.no_grad():
        got = port_model(cfg, params).backbone(nchw(x))
    assert sorted(got) == ["res2", "res3", "res4", "res5"]
    for k in got:
        w = np.moveaxis(np.asarray(want[k]), -1, 1)
        assert got[k].shape == w.shape, k
        assert rel_err(got[k].numpy(), w) <= 1e-5, k
