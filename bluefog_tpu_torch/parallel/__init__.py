"""Data plane and kernels of the port: rank-major collectives
(``collectives``: the stacked and process backends, the sequence axis
``SeqAxis``), sequence-parallel attention (``ring_attention``,
``ulysses``), the pipeline schedules (``pipeline``: GPipe and the
circular schedule over a ``MeshAxis``), the single-device attention references
(``ring_attention``: ``full_attention``, ``blockwise_attention``) and
hand-written CUDA for the Pallas kernels
of ``bluefog_tpu.parallel``: the decode-attention kernel K4
(``decode_attention``), the 1x1-conv backward K1 (``conv1x1``), the
flash attention forward and backward K2, K3a, K3b
(``flash_attention``), and splash attention's fused one-pass backward
K5 (``splash``)."""
