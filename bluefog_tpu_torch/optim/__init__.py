"""Decentralized optimizers of the port (``bluefog_tpu.optim``'s
counterpart).  This slice ports the functional train step over the
stacked backend; the eager ``torch.optim`` wrappers wait for a later
slice (ROADMAP.md, Queue 1, item 4)."""

from bluefog_tpu_torch.optim import functional  # noqa: F401
from bluefog_tpu_torch.optim.functional import (ELEMENTWISE_OPTIMIZERS,
                                                build_train_step,
                                                comm_weight_inputs,
                                                consensus_distance,
                                                rank_major)

__all__ = ["functional", "build_train_step", "rank_major",
           "consensus_distance", "comm_weight_inputs",
           "ELEMENTWISE_OPTIMIZERS"]
