"""PyTorch/CUDA port of ``mm_training_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one, which stays the reference. It
imports ``torch``, numpy and the standard library only: never ``jax``, flax
or ``mm_training_tpu``. Slice 1 is the LiDAR / LiDAR+radar serving path
(voxelize -> pillar encoder -> CenterPoint head -> decode + circle NMS),
slice 2 its train and eval steps (targets, train-mode BatchNorm, focal + L1
loss, clipped AdamW), slice 3 the camera branch and fusion on the serving
path (ResNet-50, DepthNet with the deformable conv, the LiDAR depth oracle,
the factorized lift-splat, the BEV warp), slice 4 the camera train and eval
steps (the depth loss, random flips and dropout, the backward kernels of the
splat, the deformable conv and the warp), and the raw-rig form of the camera
path (a rig with roll, pitch or skew: the general lift-splat and its
backward), with their hand-written kernels under ``csrc/``.

Entry points run on the card (``device='cuda'``) unless the caller passes
``device='cpu'``; without a card they raise rather than fall back.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, default CUDA; raises when CUDA is asked
    for and there is no card."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" to '
                           'run the plain PyTorch versions on the CPU')
    return dev


__all__ = ['resolve_device']
