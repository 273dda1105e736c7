"""Device ops of the port: each kernel's wrapper beside its plain version.

A wrapper given a CPU tensor runs the plain PyTorch version; given a CUDA
tensor it launches its kernel (``csrc/``) or raises, and adds one to its
``launches`` count. Modules: ``affine_act`` (kernel A and its backward A'),
``voxelize`` (K1), ``gaussian`` (K2), ``circle_nms`` (K3), ``voxel_pooling``
(K4, the factorized lift-splat), ``deform_conv`` (K5, the deformable conv's
sampling), ``depth_labels`` (K6), ``warp`` (K7, the BEV warp), ``build``
(nvcc + ctypes).
"""
