"""Data plane and kernels of the port: rank-major collectives
(``collectives``, the stacked backend) and hand-written CUDA for the
Pallas kernels of ``bluefog_tpu.parallel`` (so far the decode-attention
kernel K4 and the 1x1-conv backward K1)."""
