"""PyTorch/CUDA port of `faceposegenerator_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference; every module here names the
JAX function it ports, and `tests/test_torch_*.py` hold each against it.
Plain tensor code is PyTorch; the Pallas kernels of the JAX package become
CUDA C++ kernels under `csrc/`, built with `nvcc` at first use.

This file imports nothing: import the submodules you need, e.g.
`from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline`.
"""
