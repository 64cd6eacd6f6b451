"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``verify_fused``: the two-part verify/AR/draft attention.  ``prefill_flash``:
the causal prefill attention.  ``matmul_q``: the int8 weight-only matmul.
``filter_stats``: the one-pass statistics of exact top-k / top-p sampling.
``attention``: the frontier-bounded verify attention of
``qwen3.forward(attn_impl="pallas")``.  Kernels build on first use
(``_build``); on CPU tensors the wrappers run the plain versions.
"""
