"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``verify_fused``: the two-part verify/AR/draft attention.  ``prefill_flash``:
the causal prefill attention.  Kernels build on first use (``_build``); on CPU
tensors the wrappers run the plain versions.
"""
