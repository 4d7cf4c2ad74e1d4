"""Attention ops: the blockwise math, the flash forward and the paged
KV cache, each kernel beside its plain PyTorch version."""
