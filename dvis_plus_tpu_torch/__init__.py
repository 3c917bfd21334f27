"""PyTorch + CUDA port of the DVIS++ video-segmentation stack for NVIDIA Hopper.

The JAX package ``dvis_plus_tpu`` is the reference: every module here names
its counterpart, and the tests hold the two against each other on the CPU.
This package imports ``torch`` and never ``jax`` or ``flax``.

Ported so far: VIS inference of every architecture under ``configs/dvis/``
on the YouTube-VIS and OVIS sets: DVIS++ online and offline (ResNet, Swin,
DINOv2 ViT-Adapter), MinVIS, CTVIS and Video Mask2Former, with the JAX
package's eval loop (``runs`` mask download, threaded post-processing) and
its own C++ RLE codec (``native/rle.cpp``). Multi-scale deformable
attention, Swin window attention and the ViT trunk's attention run through
hand-written CUDA kernels (``csrc/``) on CUDA tensors and through their
plain PyTorch twins on CPU tensors.
"""

__version__ = "0.1.0"
