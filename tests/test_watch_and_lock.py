"""Unit tests for the live-viewer helpers (`cli/watch.py`)."""

import os
import tempfile

import numpy as np

from dart_tpu.cli import watch as watch_mod
from dart_tpu.io.streaming import EPISODE_STREAM_DTYPE


def test_read_new_tails_incrementally():
    dtype = EPISODE_STREAM_DTYPE
    recs = np.zeros(5, dtype)
    recs["k"] = np.arange(5)
    recs["err"] = np.linspace(0.1, 0.02, 5)
    with tempfile.NamedTemporaryFile(suffix=".ring", delete=False) as f:
        path = f.name
        recs[:3].tofile(f)
    try:
        first = watch_mod.read_new(path, dtype, 0)
        assert first.size == 3 and first["k"].tolist() == [0, 1, 2]
        # nothing new yet
        assert watch_mod.read_new(path, dtype, 3).size == 0
        with open(path, "ab") as f:
            recs[3:].tofile(f)
        more = watch_mod.read_new(path, dtype, 3)
        assert more.size == 2 and more["k"].tolist() == [3, 4]
    finally:
        os.unlink(path)


def test_sparkline_and_tray_map_render():
    s = watch_mod.sparkline([0.0, 0.5, 1.0])
    assert len(s) == 3 and s[-1] == watch_mod.SPARK[-1]
    assert watch_mod.sparkline([]) == ""
    m = watch_mod.tray_map(0.0, 0.0, 0.1, 0.05)
    lines = m.splitlines()
    assert lines[0].startswith("+") and lines[-1].startswith("+")
    assert any("o" in ln for ln in lines)       # object marker
    assert any("x" in ln for ln in lines)       # target marker
    # off-tray coordinates must not crash (clipped out of the grid)
    watch_mod.tray_map(5.0, -5.0)
