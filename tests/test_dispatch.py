"""The batched-physics routing rule in physics/dispatch.py."""

import copy
import inspect

import numpy as np
import pytest

from mjrl_tpu import envs
from mjrl_tpu.physics import dispatch, soa


@pytest.mark.parametrize(
    "name, expected", [("ant", True), ("hopper", True), ("humanoid", False)]
)
def test_soa_eligible(name, expected):
    model = envs.make(name).model
    assert dispatch.soa_eligible(model) is expected
    if name == "humanoid":
        # the per-env engine is kept for contact-heavy models
        assert soa.num_contact_candidates(model) > dispatch._MAX_SOA_CANDIDATES
        assert soa.soa_supported(model)


def test_tendons_stay_on_engine():
    model = copy.copy(envs.make("hopper").model)
    model.tendon_Jq = np.zeros((1, model.nq), np.float32)
    assert soa.soa_supported(model)
    assert not dispatch.soa_eligible(model)


def test_stepper_kind_follows_rule():
    ant = envs.make("ant")
    humanoid = envs.make("humanoid")
    # custom_vmap wrapper for the SoA route, the plain per-env loop otherwise
    assert hasattr(ant._frame_step, "def_vmap")
    assert not hasattr(humanoid._frame_step, "def_vmap")
    off = dispatch.make_frame_stepper(ant.model, ant.frame_skip, use_soa=False)
    assert not hasattr(off, "def_vmap")


def test_rule_names_no_backend():
    src = inspect.getsource(dispatch)
    assert "default_backend" not in src and "platform" not in src
