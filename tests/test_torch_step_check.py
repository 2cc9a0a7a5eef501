"""The port's step check (``bluefog_tpu_torch.analysis.step_check``, the
counterpart of ``bluefog_tpu.analysis.jaxpr_check``): the full sweep is
clean on the CPU, its matrix is JAX's case for case, and the checker has
teeth.  The mutation tests are JAX's (``tests/test_analysis.py``): a
step that combines with its build-time table whatever table it is given
is flagged ``dead-weight-operand`` and ``baked-weight-const``, a step
whose table feeds no combine is flagged dead, a step without its
``default_comm_weights`` (or with other shapes) ``missing-weight-operand``,
the healthy guarded build is not flagged, a prediction with a permute
removed is flagged ``collective-contract``, and a serving engine whose
decode program reads a copy of the weights taken at build is flagged
``baked-weight-const``."""

import pytest
import torch

from bluefog_tpu.analysis import jaxpr_check as J
from bluefog_tpu_torch.analysis import step_check as S
from bluefog_tpu_torch.parallel.collectives import StackedBackend


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def backend():
    return StackedBackend(S.N_RANKS, device="cpu")


def _case(**kw):
    base = dict(comm_mode="cta", overlap="none", guard=True, health=True,
                compress=None, topology=S._weighted_ring())
    base.update(kw)
    return base


def test_full_sweep_clean():
    """Every train-step matrix point: zero findings.  The sweep's other
    two parts, the collective contracts and the serving residents, are
    held clean once each, beside their mutants below."""
    findings = S.run_sweep(device="cpu", include_collectives=False,
                           include_serving=False)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_sweep_matrix_is_jaxs():
    assert [S.case_id(c) for c in S.sweep_cases()] == \
        [J.case_id(c) for c in J.sweep_cases()]
    assert len(S.sweep_cases()) == 38


def test_readings_of_a_sound_step(backend):
    readings = {}
    step, args = S._build(_case(comm_mode="atc"), backend)
    before = {k: v.clone() for k, v in args[0].items()}
    assert S.check_step(step, args, name="atc", readings=readings) == []
    assert readings["dead_gap"] > 0.0
    assert readings["restore_gap"] == 0.0
    assert 0.0 < readings["baked_ratio"] <= 1.0
    # the state is put back as it was
    for k, v in args[0].items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("comm_mode", ["cta", "atc"])
def test_mutant_baked_table_flagged(backend, guard, comm_mode):
    step, args = S._build(_case(comm_mode=comm_mode, guard=guard,
                                health=guard), backend)
    readings = {}
    fs = S.check_step(S.baked_table_step(step), args, name="mutant",
                      readings=readings)
    assert {f.rule for f in fs} == {"dead-weight-operand",
                                    "baked-weight-const"}, fs
    assert readings["dead_gap"] == 0.0 and readings["baked_ratio"] > 1e3


def test_healthy_step_not_flagged(backend):
    """Control for the mutation pair: the real guarded build on the same
    ring is clean."""
    assert S._build_and_check(_case(), backend) == []


def test_mutant_dead_operand_flagged(backend):
    """A step whose table feeds no combine (a "none" step wearing a
    neighbor step's table) is flagged dead, and its params miss the
    third table's prediction."""
    step, args = S._build(_case(guard=False, health=False), backend)
    opt = args[1]
    params = args[0]
    _, loss_fn = S._problem("cpu")
    from bluefog_tpu_torch.optim import functional as F

    bare = F.build_train_step(loss_fn, opt, backend, comm_mode="none")
    for k in ("comm_mode", "comm_specs", "default_comm_weights"):
        setattr(bare, k, getattr(step, k))
    fs = S.check_step(bare, (params, opt, args[2], 0), name="dead")
    assert {f.rule for f in fs} == {"dead-weight-operand",
                                    "baked-weight-const"}, fs


def test_mutant_missing_operand_flagged(backend):
    step, args = S._build(_case(guard=False, health=False), backend)

    def no_table(*a):
        return step(*a)

    no_table.__dict__.update(step.__dict__)
    del no_table.default_comm_weights
    fs = S.check_step(no_table, args, name="missing")
    assert [f.rule for f in fs] == ["missing-weight-operand"]
    no_table.default_comm_weights = tuple(
        (cw[:, :-1], sw) for cw, sw in step.default_comm_weights)
    fs = S.check_step(no_table, args, name="missing")
    assert [f.rule for f in fs] == ["missing-weight-operand"]


def test_equal_ranks_refused(backend):
    """A combine of equal rows reads no weight: the check refuses such
    state rather than calling every step dead."""
    step, args = S._build(_case(), backend)
    with torch.no_grad():
        for v in args[0].values():
            v.copy_(v[:1].expand_as(v))
    with pytest.raises(ValueError, match="equal across ranks"):
        S.check_step(step, args, name="equal")


def test_mutant_dropped_permute_prediction_flagged():
    assert S.check_collective_contracts(device="cpu") == []
    fs = S.check_collective_contracts(device="cpu",
                                      tamper=S.drop_one_permute)
    assert fs and {f.rule for f in fs} == {"collective-contract"}
    where = {(f.path, f.symbol) for f in fs}
    assert ("schedule[pod_1x8]", "period") in where
    assert ("schedule[pod_1x8]", "round_0") in where
    assert ("a2a[pod_4x2]", "period") in where
    assert ("hier[pod_4x2]", "round_0") in where


def test_serving_residents_and_copied_weights_mutant():
    assert S.check_serving_residents(device="cpu") == []
    fs = S.check_serving_residents(device="cpu",
                                   wrap=S.copied_weights_engine)
    assert {(f.rule, f.path) for f in fs} == {
        ("baked-weight-const", "serving[decode_step]"),
        ("baked-weight-const", "spec_serving[spec_step]")}
