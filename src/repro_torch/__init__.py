"""PyTorch port of the AIE4ML toolflow, with hand-written Hopper kernels.

``repro`` (JAX) is the reference; this package imports torch and numpy,
never jax and never ``repro``. Its entry points (``compile_graph``,
``EmittedModel``, ``build_paper_model``) run on the CUDA card unless the
caller passes another device, and raise when no card is present.
"""
