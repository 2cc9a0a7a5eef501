"""The step check on the card: the tiny sweep (every train-step matrix
point, the collective contracts with the exchanges on the card, the
serving residents) is clean, and the planted faults are flagged there as
on the CPU.  Marked ``cuda``: without an NVIDIA card the tests skip.  The
file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_step_check_cuda.py
"""

import pytest
import torch

from bluefog_tpu_torch.analysis import step_check as S
from bluefog_tpu_torch.parallel.collectives import StackedBackend

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def test_tiny_sweep_clean_on_the_card():
    _card()
    findings = S.run_sweep(device="cuda")
    assert findings == [], "\n".join(f.render() for f in findings)


def test_planted_faults_flagged_on_the_card():
    _card()
    backend = StackedBackend(S.N_RANKS, device="cuda")
    case = dict(comm_mode="cta", overlap="bucketed", guard=False,
                health=False, compress=None, topology=S._weighted_ring())
    step, args = S._build(case, backend)
    fs = S.check_step(S.baked_table_step(step), args, name="mutant")
    assert {f.rule for f in fs} == {"dead-weight-operand",
                                    "baked-weight-const"}, fs
    assert S.check_collective_contracts(device="cuda",
                                        tamper=S.drop_one_permute)
    fs = S.check_serving_residents(device="cuda",
                                   wrap=S.copied_weights_engine)
    assert {f.rule for f in fs} == {"baked-weight-const"}
