"""TWILIGHT's progressive multiple sequence alignment with the TALCO-XDrop
DP on an NVIDIA GPU: the PyTorch and CUDA port of `twilight_tpu`.

The port imports the jax-free host half of `twilight_tpu` unchanged
(configuration, sequence I/O, trees, the progressive pipeline and the host
kernels) and owns every module on the path that imported jax: the CUDA
kernel and its wrapper (`ops.talco_cuda`), the batcher
(`ops.device_kernel`) and the command line (`cli`). It never imports jax.
"""
__version__ = "0.1.0"
