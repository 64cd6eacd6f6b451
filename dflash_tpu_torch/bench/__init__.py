"""Benchmark and serving-client helpers of the port.  The JAX package's
``bench`` exports its metric summaries only, which are not ported yet
(ROADMAP.md Queue 1, item 1, "Headline bench and the bench CLI"); import
the submodules."""
