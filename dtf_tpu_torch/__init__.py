"""dtf_tpu_torch -- the PyTorch/CUDA port of dtf_tpu for NVIDIA Hopper.

The package mirrors dtf_tpu's module layout, so each module's
counterpart is found by its path.  It imports torch, numpy and the
standard library, never jax or dtf_tpu.  Ported: the serving path
(paged TransformerLM decode behind ServeEngine), LM training
(``cli/lm_main``) and ResNet training (``cli/cifar_main``,
``cli/imagenet_main``), on one device or under synchronous data
parallelism over ``torch.distributed`` (``runtime/mesh.py``,
``cli/launch.py``), with checkpoints, crash-exact resume under the
launcher's supervision, fault injection and tracing
(``train/checkpoint.py``, ``chaos/``, ``obs/``).  The attention kernels are hand-written CUDA
under csrc/, built with nvcc at first use; the ResNets run cuDNN
convolutions through plain torch ops.
"""
