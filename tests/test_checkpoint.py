"""CheckpointManager: numpy round trip, retention, ``best``, atomic layout."""

import os

import numpy as np
import pytest

from mjrl_tpu.utils.checkpoint import CheckpointManager


def _state(v: float):
    return {
        "params": [{"w": np.full((3, 2), v, np.float32), "b": np.zeros(2, np.float32)}],
        "iteration": np.asarray(int(v), np.int32),
        "score": np.float32(v),
    }


def _template():
    return _state(0.0)


def test_save_restore_round_trip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_step() is None
    assert ckpt.restore_latest(_template()) is None
    ckpt.save(3, _state(3.0))
    ckpt.save(7, _state(7.0))
    assert ckpt.latest_step() == 7
    got = ckpt.restore_latest(_template())
    np.testing.assert_array_equal(got["params"][0]["w"], np.full((3, 2), 7.0))
    assert got["iteration"].dtype == np.int32 and int(got["iteration"]) == 7
    assert float(ckpt.restore(3, _template())["score"]) == 3.0
    # a second manager on the same directory sees the same checkpoints
    assert CheckpointManager(str(tmp_path)).latest_step() == 7


def test_max_to_keep_and_layout(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        ckpt.save(step, _state(float(step)))
    assert sorted(os.listdir(tmp_path / "iterations")) == ["3", "4"]
    # saving an existing step replaces it
    ckpt.save(4, _state(9.0))
    assert float(ckpt.restore(4, _template())["score"]) == 9.0
    assert sorted(os.listdir(tmp_path / "iterations")) == ["3", "4"]


def test_best_is_separate(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=1)
    ckpt.save_best(_state(5.0))
    ckpt.save(1, _state(1.0))
    ckpt.save(2, _state(2.0))
    ckpt.save_best(_state(6.0))
    assert float(ckpt.restore_best(_template())["score"]) == 6.0
    assert ckpt.latest_step() == 2
    assert (tmp_path / "best").is_dir()


def test_restore_rejects_other_structure(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, _state(1.0))
    bad = _template()
    bad["params"][0]["w"] = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(1, bad)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(1, {"only": np.zeros(1)})
