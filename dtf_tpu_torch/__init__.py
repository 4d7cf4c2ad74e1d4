"""dtf_tpu_torch -- the PyTorch/CUDA port of dtf_tpu for NVIDIA Hopper.

The package mirrors dtf_tpu's module layout, so each module's
counterpart is found by its path.  It imports torch, numpy and the
standard library, never jax or dtf_tpu.  The serving path (paged
TransformerLM decode behind ServeEngine) is ported; its two attention
kernels are hand-written CUDA under csrc/, built with nvcc at first use.
"""
