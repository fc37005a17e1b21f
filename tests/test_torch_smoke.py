"""Helpers of ``chip_smoke.py`` that decide a gate, on fixed inputs:
phase 12(a)'s paired median of the traced / untraced wall ratios, and
the former statistic (min of the first three in turns) it replaced;
phase 8c's comparison of the kernel route's loss and gradients with the
plain route's, on the CPU routes."""

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


@pytest.mark.parametrize("fault", [False, True])
def test_route_gaps_reads_an_lse_in_base_2(monkeypatch, fault):
    """route_gaps on a reduced phi3-mini through FlashAttention's CPU
    route: within f32 of the plain route, and with the saved lse in
    base 2 (the sm90 kernel's running max) far past check (c)'s bound."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm

    failed = []
    monkeypatch.setattr(chip_smoke, "fail", failed.append)
    if fault:
        plain = ops.attention_lse_ref
        monkeypatch.setattr(ops, "attention_lse_ref", lambda q, k, v, *, causal: (
            plain(q, k, v, causal=causal)[0],
            plain(q, k, v, causal=causal)[1] / math.log(2)))
    cfg = dataclasses.replace(get_arch("phi3-mini-3.8b").make_config(reduced=True),
                              attn_impl="pallas", n_layers=2)
    params = lm.init_tree(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.as_tensor(v) for k, v in lm_batch(0, 2, 128, cfg.vocab, seed=0).items()}
    rel, gaps = chip_smoke.route_gaps(params, batch, cfg, "(c)")
    # the CPU route launches no kernel, which route_gaps reports
    assert failed and all("launched" in m for m in failed)
    assert rel <= 1e-6  # lse is read by the backward alone
    if fault:
        assert max(gaps.values()) > 10 * chip_smoke.TRAIN_BF16_GRAD_TOL
    else:
        assert max(gaps.values()) <= 1e-5


def test_paired_walls_alternate_the_order(monkeypatch):
    """Phase 12(a)'s pairs run the untraced solve first in even pairs and
    second in odd ones, and each wall lands on its own side."""
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    order = []

    class Solver:
        def __init__(self, name):
            self.name = name

        def solve(self, problem):
            order.append(self.name)

    walls_u, walls_t = chip_smoke.paired_walls(Solver("u"), Solver("t"), None, pairs=5)
    assert order == ["u", "t", "t", "u", "u", "t", "t", "u", "u", "t"]
    assert len(walls_u) == len(walls_t) == 5
    assert chip_smoke.TRACE_PAIRS == 21 and chip_smoke.TRACE_PAIRS % 2 == 1

