"""The vendored locomotion MJCF files compile like Gymnasium's own copies."""

import os

import numpy as np
import pytest

from mjrl_tpu.envs.locomotion import _asset_path
from mjrl_tpu.physics.mjcf import load_mjcf

ASSETS = [
    "hopper.xml", "walker2d.xml", "half_cheetah.xml",
    "swimmer.xml", "ant.xml", "humanoid.xml",
]


@pytest.mark.parametrize("asset", ASSETS)
def test_vendored_asset_matches_gymnasium(asset):
    ours = load_mjcf(_asset_path(asset))
    assert ours.nq > 0 and np.all(np.asarray(ours.link_mass) >= 0)
    gymnasium = pytest.importorskip("gymnasium")
    upstream = os.path.join(
        os.path.dirname(gymnasium.__file__), "envs", "mujoco", "assets", asset
    )
    if not os.path.exists(upstream):
        pytest.skip(f"installed Gymnasium has no {asset}")
    ref = load_mjcf(upstream)
    np.testing.assert_array_equal(ours.link_mass, ref.link_mass)
    np.testing.assert_array_equal(ours.default_qpos, ref.default_qpos)


def test_licence_is_vendored():
    text = open(os.path.join(os.path.dirname(_asset_path("ant.xml")), "LICENSE")).read()
    assert "MIT License" in text and "Farama Foundation" in text
