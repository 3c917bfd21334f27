"""PyTorch + CUDA port of the DVIS++ video-segmentation stack for NVIDIA Hopper.

The JAX package ``dvis_plus_tpu`` is the reference: every module here names
its counterpart, and the tests hold the two against each other on the CPU.
This package imports ``torch`` and never ``jax`` or ``flax``.

Ported so far: DVIS++ online VIS inference with a ResNet-50 segmenter (the
``configs/dvis/dvis_online_r50_ytvis19.yaml`` path). Multi-scale deformable
attention runs through a hand-written CUDA kernel
(``csrc/msdeform_fwd.cu``) on CUDA tensors and through its plain PyTorch twin
on CPU tensors.
"""

__version__ = "0.1.0"
