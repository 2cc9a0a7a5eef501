"""Kernels of the port: hand-written CUDA for the Pallas kernels of
``bluefog_tpu.parallel`` (this slice: the decode-attention kernel)."""
