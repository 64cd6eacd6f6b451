"""Benchmark and serving-client helpers of the port.  The JAX package's
``bench`` exports its metric summaries only, which are not ported yet
(ROADMAP.md Queue 1, item "Serving, the rest"); import the submodules."""
