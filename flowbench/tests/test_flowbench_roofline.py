"""The kernels' least times at level 0 of 1024x436, as PERF.md's kernel
table gives them: K2 one iteration at B=128, K7 a resident solve of 16
sweeps at B=1 (bytes bound) and of 300 (operations bound)."""

import pytest

from flowbench import roofline
from flowbench.roofline import k2, k7

PX = 436 * 1024


def test_level0_bounds():
    peaks = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert 1e3 * k2.bound_s([(PX, 128)], peaks) == pytest.approx(1.0918, abs=5e-5)
    assert 1e3 * k7.bound_s([(PX, 16)], peaks) == pytest.approx(0.00693, abs=5e-6)
    assert 1e3 * k7.bound_s([(PX, 300)], peaks) == pytest.approx(0.0800, abs=5e-5)


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        roofline.peaks("cpu")
