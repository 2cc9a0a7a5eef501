"""Two repairs of the port's surface against the JAX package: the
``bluefog_tpu_torch.optim`` exports (``MoEConfig`` among them) and
``config.observe()``, with the topology control plane's re-plan knobs
read from the same environment as JAX's ``config``."""

import pytest

from bluefog_tpu import config as JCFG
from bluefog_tpu import optim as JO

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import config as CFG
from bluefog_tpu_torch import optim as TO

# JAX's optim names the port still refuses: none since the model axes
# (ROADMAP.md Queue 1, item 10) brought rank_spec_tree
REFUSED = set()


def test_optim_exports_the_jax_packages_names():
    jax_names = {n for n in dir(JO) if not n.startswith("_")}
    assert jax_names - set(TO.__all__) == REFUSED
    for name in TO.__all__:
        assert hasattr(TO, name), name
    assert TO.MoEConfig is bt.MoEConfig is TO.functional.MoEConfig


@pytest.mark.parametrize("value", [None, "0", "1", "false", "False", "yes"])
def test_config_observe_equals_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("BLUEFOG_OBSERVE", raising=False)
    else:
        monkeypatch.setenv("BLUEFOG_OBSERVE", value)
    assert CFG.observe() is JCFG.observe()
    assert CFG.observe() is CFG.observe_raw()
    assert CFG.observe() is (value not in ("0", "false", "False"))


_KNOBS = ("window", "patience", "degrade_ratio", "margin", "cooldown",
          "probation")
_ENV = {"window": "WINDOW", "patience": "PATIENCE",
        "degrade_ratio": "DEGRADE", "margin": "MARGIN",
        "cooldown": "COOLDOWN", "probation": "PROBATION"}


@pytest.mark.parametrize("value", [None, "0", "-2", "3", "2.5", "junk"])
def test_topology_replan_knobs_equal_jax(monkeypatch, value):
    for knob in _KNOBS:
        name = f"BLUEFOG_TOPOLOGY_REPLAN_{_ENV[knob]}"
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for knob in _KNOBS:
        fn = f"topology_replan_{knob}"
        assert fn in CFG.__all__
        try:
            want = getattr(JCFG, fn)()
        except ValueError:
            with pytest.raises(ValueError):
                getattr(CFG, fn)()
            continue
        got = getattr(CFG, fn)()
        assert got == want and type(got) is type(want), (knob, value)
