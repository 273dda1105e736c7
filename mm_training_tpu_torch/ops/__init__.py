"""Device ops of the port: each kernel's wrapper beside its plain version.

A wrapper given a CPU tensor runs the plain PyTorch version; given a CUDA
tensor it launches its kernel (``csrc/``) or raises, and adds one to its
``launches`` count. Modules: ``affine_act`` (kernel A and its backward A'),
``voxelize`` (K1), ``gaussian`` (K2), ``circle_nms`` (K3), ``voxel_pooling``
(K4, the factorized lift-splat, and its backward K4'; K8, the raw-rig
lift-splat, and its backward K8'), ``deform_conv`` (K5,
the deformable conv, and its transposed sampling K5'), ``depth_labels``
(K6), ``warp`` (K7, the BEV warp, and its backward K7'), ``build`` (nvcc +
ctypes).
"""
