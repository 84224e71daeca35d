"""The bound, K1's roofline share and the GCUPS arithmetic against values
worked out by hand."""

import pytest

from swbench import kernels
from swbench.trace import Launch, Trace


def test_bound_of_an_h100():
    # 132 SMs x 128 instructions a clock x 1,980 MHz = 33.454 T instructions/s;
    # 1e12 cells x 1.5 instructions = 44.8375 ms.
    ms, kind = kernels.bound_ms(10**12, 0, 132, 1980.0)
    assert kind == "operations"
    assert ms == pytest.approx(1.5e12 / (132 * 128 * 1980e6) * 1e3)
    assert ms == pytest.approx(44.8375, rel=1e-4)
    # 3.35e9 bytes take 1 ms at 3.35 TB/s, more than 1e6 cells' 0.045 us.
    assert kernels.bound_ms(10**6, 3_350_000_000, 132, 1980.0) == (pytest.approx(1.0), "bytes")


def test_k1_bytes_count_rows_outputs_and_references():
    # packed 4 x 256 int32 = 4,096 B; output 3 x 4 x 256 int32 = 12,288 B; refs 3 x 100 B.
    args = (0, 4, 256, 0, 0, 0, 3, 5, -3, -4, 0, 0, 0, 0, 0, 0)
    assert kernels.k1_bytes(args, 100.0) == 4096 + 12288 + 300


class _Event:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def _trace(flushes):
    tr = Trace()
    tr.sms, tr.clock_mhz, tr.cards = 132, 1980.0, 1
    tr.window = (0.0, 100.0)
    t = 0.0
    for cells, lanes in flushes:
        t0 = t
        for m in lanes:
            t += 1.0
            args = (0, 4, m, 0, 0, 0, 1, 5, -3, -4, 0, 0, 0, 0, 0, 0)
            tr.launches.append(Launch("swt_lane_best_varlen_s16x2", 0, t, args, "flush", _Event(0.0), _Event(10.0),
                                      ms=10.0))
        tr.spans.append(("flush", t0, t + 0.5, {"cells": cells, "ref_bp": 100, "refs": 1}))
        t += 1.0
    return tr


def test_k1_roofline_takes_one_form_and_skips_mixed_flushes():
    # Two one-pass flushes of 1e12 cells in 4 launches of 10 ms: 44.8375 ms of
    # bound over 40 ms each, so 2 x 44.8375 / 80 = 112.09%; a wide flush and
    # a mixed one count elsewhere or nowhere.
    tr = _trace([(10**12, [256, 256]), (10**12, [256, 256]), (10**11, [4096]), (10**11, [256, 4096])])
    ops_ms = kernels.bound_ms(2 * 10**12, 0, 132, 1980.0)[0]
    assert kernels.k1_roofline(tr, wide=False) == pytest.approx(100 * ops_ms / 40.0, rel=1e-6)
    wide_ms = kernels.bound_ms(10**11, 0, 132, 1980.0)[0]
    assert kernels.k1_roofline(tr, wide=True) == pytest.approx(100 * wide_ms / 10.0, rel=1e-6)
    assert any("1 flushes mixed" in note for note in tr.notes)
    assert kernels.k1_roofline(_trace([(10**11, [4096])]), wide=False) is None


def test_real_gcups_is_the_window_cells_over_its_seconds(tiny):
    from swbench import run

    result = run.run_cell("tiny.x", 2**31 + 21, 8.0, False, "cpu", root=tiny, log=lambda m: None)
    window = result["window"]
    assert window["files"] >= 1
    # 6 reads of 30-40 bp (the uniform quantiles: 30, 32, 34, 36, 38, 40 = 210 bp)
    # against every reference base of the tiny corpus, for each file.
    from swbench import gen, spec
    cfg = spec.config(spec.load(tiny), spec.cell(spec.load(tiny), "tiny.x"), tiny)
    ref_bp = int(gen.lognormal_lengths(cfg["median_bp"], cfg["mean_bp"], cfg["min_bp"], cfg["max_bp"],
                                       cfg["total_bp"]).sum())
    assert window["real_cells"] == window["files"] * 210 * ref_bp
    assert result["metrics"]["real_gcups"]["value"] == pytest.approx(window["real_cells"] / window["seconds"] / 1e9)
