"""The whole slice: the port's ``run_vis_inference`` against the JAX one on
the same weights and videos (fp32, exact deformable op, JV matcher).

Two synthetic videos of 7 and 4 frames with window 3, so the tracker carry
crosses windows and the last window is ragged. Per video: top-K scores
(rel 1e-4), labels and query order equal, and packed masks identical except
at pixels whose JAX pre-threshold value is within 1e-4 of the threshold.
RLE strings are not compared here: both sides encode the same bits."""
import jax
import numpy as np
import torch

import dvis_plus_tpu.engine.inference as jax_inference
import dvis_plus_tpu_torch.engine.inference as port_inference
from tests.test_torch_common import images, jax_model_and_params, port_model, rel_err
from tests.test_torch_postproc import _jax_prethreshold

torch.set_num_threads(2)


class Recorder:
    def __init__(self):
        self.rows = {}

    def process(self, video_id, output):
        self.rows[video_id] = output


def _loader():
    for vid, (T, img, out) in enumerate([(7, (64, 96), (48, 72)), (4, (56, 96), (96, 144))], 1):
        x = images(T, seed=10 + vid)
        x[:, img[0]:] = 0.0  # padding below the valid region
        yield {"images": x, "image_size": np.asarray(img), "height": out[0],
               "width": out[1], "video_id": vid}


def _record_paged(monkeypatch, module):
    """Record each video's (mean logits, masks, sizes, aux logits) on their
    way into ``module.paged_inference_video``."""
    seen = {}
    paged = module.paged_inference_video

    def recording(mask_cls, mask_pred, img_size, output_size, padded_size, **kw):
        aux = kw.get("aux_pred_cls")
        seen[len(seen) + 1] = (np.asarray(mask_cls), np.asarray(mask_pred), img_size,
                               output_size, padded_size, None if aux is None else np.asarray(aux))
        return paged(mask_cls, mask_pred, img_size, output_size, padded_size, **kw)

    monkeypatch.setattr(module, "paged_inference_video", recording)
    return seen


def test_run_vis_inference_matches_jax(monkeypatch):
    cfg, model, params = jax_model_and_params()
    seen = _record_paged(monkeypatch, jax_inference)
    seen_port = _record_paged(monkeypatch, port_inference)
    want = Recorder()
    jax_inference.run_vis_inference(cfg, model, params, _loader(), want)
    got = Recorder()
    port_inference.run_vis_inference(cfg, port_model(cfg, params), _loader(), got)

    assert sorted(got.rows) == sorted(want.rows) == [1, 2]
    for vid in (1, 2):
        g, w = got.rows[vid], want.rows[vid]
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=1e-4)
        assert g["pred_labels"] == w["pred_labels"]
        assert g["pred_masks"].shape == w["pred_masks"].shape
        # the video-level logits and stride-4 masks themselves
        mask_cls, mask_pred, img, out, pad, _ = seen[vid]
        assert rel_err(seen_port[vid][0], mask_cls) <= 2e-4
        assert rel_err(seen_port[vid][1], mask_pred) <= 2e-4
        # JAX pre-threshold masks of its top-K queries
        flat = jax.nn.softmax(mask_cls, -1)[:, :-1].reshape(-1)
        queries = np.asarray(jax.lax.top_k(flat, len(w["pred_scores"]))[1]) // (mask_cls.shape[1] - 1)
        pre = _jax_prethreshold(mask_pred[queries], img, out, pad)
        for bits in (g["pred_masks"].unpack(), w["pred_masks"].unpack()):
            differ = bits != (pre > 0)
            assert np.all(np.abs(pre[differ]) < 1e-4)
