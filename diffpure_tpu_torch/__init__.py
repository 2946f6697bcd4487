"""PyTorch / CUDA port of diffpure_tpu for NVIDIA Hopper (H100).

The layout mirrors ``diffpure_tpu``: each module here is the counterpart of
the module at the same path there, which stays the numerical reference.
Public functions keep that package's NHWC layout; module parameter names are
the original PyTorch ones (``all_modules.{i}.Conv_0.weight``, ...), so real
checkpoints load with ``load_state_dict(strict=True)``.

The hand-written CUDA kernels live in ``csrc/`` and are built at first use
(``ops/_cuda.py``): the fused NCSN++ blocks and their backward (the CIFAR-10
path), and the tiled GroupNorm, halo conv and flash attention of the
ImageNet-256 ADM path.
"""
__version__ = "0.1.0"
