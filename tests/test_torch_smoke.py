"""Helpers of ``chip_smoke.py`` that decide a gate, on fixed inputs:
phase 12(a)'s paired median of the traced / untraced wall ratios, and
the former statistic (min of the first three in turns) it replaced."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_paired_median_reads_the_middle_pair():
    walls_u = [0.100, 0.100, 0.110, 0.100, 0.200, 0.100, 0.100, 0.105, 0.100]
    walls_t = [0.105, 0.104, 0.115, 0.160, 0.210, 0.101, 0.103, 0.110, 0.180]
    med, ratios = chip_smoke.paired_median(walls_u, walls_t)
    assert ratios == pytest.approx([1.05, 1.04, 0.115 / 0.110, 1.6, 1.05, 1.01, 1.03,
                                    0.110 / 0.105, 1.8])
    assert med == pytest.approx(0.110 / 0.105)  # the fifth of nine, sorted
    # two slow traced solves move two pairs, not the median under the gate
    assert med <= chip_smoke.TRACE_GATE < max(ratios)


def test_paired_median_of_an_even_count_and_bad_inputs():
    med, ratios = chip_smoke.paired_median([1.0, 1.0, 2.0, 2.0], [1.1, 1.3, 2.0, 2.4])
    assert med == pytest.approx((1.1 + 1.2) / 2) and len(ratios) == 4
    with pytest.raises(ValueError):
        chip_smoke.paired_median([1.0], [1.0, 2.0])
    with pytest.raises(ValueError):
        chip_smoke.paired_median([], [])


def test_turns_min_ratio_is_the_former_statistic():
    # one slow untraced solve among the first three leaves the min alone,
    # one fast traced solve sets it: the former gate read 0.9 here
    walls_u = [0.100, 0.150, 0.100, 9.0]
    walls_t = [0.120, 0.090, 0.130, 0.0]
    assert chip_smoke.turns_min_ratio(walls_u, walls_t) == pytest.approx(0.9)
    assert chip_smoke.TRACE_PAIRS >= 9 and chip_smoke.TRACE_GATE == 1.15
