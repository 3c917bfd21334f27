"""Adapters, one a model family: what a driver captures of the program's model,
its layer spans, the plain reference's outputs of a unit of work and the
operations of that work. A configuration file names its adapter
(``"reference": "<name>"``) and the registry loads ``adapters/<name>.py``, so a
later configuration of another family brings an adapter file of its own.

An ``eval_stream`` adapter module gives:

- ``capture(model, cap) -> undo``: hooks on the program's model that hand its
  outputs to ``cap.append(name, tensor)`` (a tensor a window, concatenated
  along the first dimension) or ``cap.put(name, tensor)`` (one a video);
- ``spans(model, spans)``: the spans of its layers in a traced run;
- ``reference_outputs(ns, seed, gains, videos, sample_idx, device,
  precision="fp32", candidates=None)``: per video, the plain reference's
  outputs under the names ``capture`` gives (``reference/check_vss.py``
  compares every one of them), ``mask_samples`` and ``aux_logits`` where the
  model makes them, the ``class_map`` and the map numbers of ``candidates``;
- ``video_flops(mcfg, T, padded, image_size, output_size, window, cache_path)``:
  the operations of one video of ``T`` frames.
"""
