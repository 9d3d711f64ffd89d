"""The metric arithmetic: percentiles, rates over the whole window,
failures counted as failures."""

import math

import numpy as np
import pytest

from benchmark import readings, stats
from seldon_core_tpu_torch import loadtester


@pytest.mark.parametrize("n", [1, 2, 7, 20, 101, 333])
def test_percentile_is_the_load_testers(n):
    rs = np.random.default_rng(n)
    lat = list(rs.exponential(0.1, n))
    agg = loadtester.aggregate([(lat, 0)], 1.0, "x")
    for p in loadtester.PERCENTILES:
        assert round(stats.percentile([x * 1e3 for x in lat], p), 2) == agg[f"p{p}_ms"]


def test_percentile_of_nothing():
    assert stats.percentile([], 95) is None


def rec(i, due, spans=(), error=None, done=None):
    r = {"i": i, "due": due, "sent": due, "spans": [list(s) for s in spans]}
    if error:
        r["error"] = error
    if done is not None:
        r["done"] = done
    return r


def test_a_failed_request_is_never_a_fast_sample():
    ok = [rec(i, 0.0, [(0.1, 1), (0.2, 1)], done=0.2) for i in range(19)]
    bad = rec(19, 0.0, error="HTTP 503")
    t = stats.ttfts_ms(ok + [bad])
    assert math.isinf(max(t)) and len(t) == 20
    # 1 of 20 failed: the p95 (index 19 of 20) is the failure
    assert math.isinf(stats.percentile(t, 95))
    assert readings.finite(stats.percentile(t, 95)) is None
    assert stats.percentile(stats.ttfts_ms(ok), 95) == pytest.approx(100.0)


def test_ttft_counts_from_when_the_request_was_due():
    r = rec(0, 10.0, [(10.5, 3), (11.0, 2)])
    r["sent"] = 10.3  # the generator ran late: the wait is the user's
    assert stats.ttfts_ms([r]) == [pytest.approx(500.0)]


def test_tpot_is_last_minus_first_over_tokens_after_the_first():
    r = rec(0, 0.0, [(1.0, 1), (1.5, 4), (2.0, 5)], done=2.0)
    assert stats.tpots_ms([r]) == [pytest.approx(1000.0 / 9)]
    one = rec(1, 0.0, [(1.0, 1)], done=1.0)
    assert stats.tpots_ms([one]) == []


def test_tokens_and_rows_are_counted_over_the_window():
    recs = [rec(0, 0.0, [(0.5, 4), (1.5, 4), (3.5, 4)]), rec(1, 1.0, [(2.0, 1)])]
    assert stats.tokens_in(recs, 1.0, 3.0) == 5
    preds = [rec(0, 0.0, done=0.5), rec(1, 0.0, done=2.5), rec(2, 0.0, error="x"),
             rec(3, 0.0, done=3.5)]
    assert [r["i"] for r in stats.answered_in(preds, 0.0, 3.0)] == [0, 1]
    lat = stats.latencies_ms(preds)
    assert lat[0] == pytest.approx(500.0) and math.isinf(lat[2])


class _Plan:
    kind = "generate"

    def __init__(self, lens):
        self.prompt_len = np.asarray(lens)


class _Run:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_lanes_per_step_leaves_out_first_tokens():
    before = {"stats": {"steps": 100, "tokens": 1000, "admitted": 10}}
    close = {"stats": {"steps": 164, "tokens": 1000 + 2048 + 5, "admitted": 15}}
    run = _Run(before=before, until=close)
    assert readings.lanes_per_step(run) == pytest.approx(2048 / 64)


def test_generate_flops_by_context():
    from benchmark import counts

    model = {"vocab_size": 100, "d_model": 8, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1,
             "d_ff": 16}
    # prompt of 5, a 2-token hit; tokens 0 (prefill), then 1 and 2 decoded
    r = rec(0, 0.0, [(1.0, 1), (2.0, 2)])
    r["hit"] = 2
    run = _Run(records=[r], plan=_Plan([5]), model=model)
    want = (sum(counts.decoder_flops_per_token(model, p + 1) for p in range(2, 5))
            + counts.decoder_flops_per_token(model, 6) + counts.decoder_flops_per_token(model, 7))
    assert readings._gen_flops_in(run, 0.0, 3.0) == pytest.approx(want)
    # only the later span inside the sub-window
    assert readings._gen_flops_in(run, 1.5, 3.0) == pytest.approx(
        counts.decoder_flops_per_token(model, 6) + counts.decoder_flops_per_token(model, 7))


def test_flash_roofline_from_the_ledgers_prefills():
    from benchmark import counts

    model = {"n_heads": 32, "n_kv_heads": 8, "d_model": 4096, "n_layers": 2}
    before = {"ledger": {("prefill", "p1024", ""): (1.0, 5.0, 0, 0),
                         ("decode_burst", "b128", ""): (9.0, 9.0, 0, 0)}}
    after = {"ledger": {("prefill", "p1024", ""): (1.5, 6.0, 0, 0),
                        ("prefill", "m4p512", ""): (0.2, 1.0, 0, 0),
                        ("prefill", "px128", ""): (0.1, 3.0, 0, 0),
                        ("decode_burst", "b128", ""): (9.5, 19.0, 0, 0)}}
    # one p1024 and one m4p512 dispatch: two layers each, four launches
    kernels = [("void flash_fwd_wgmma_kernel<128, 2>(...)", 1e-4)] * 4
    run = _Run(sub={"kernels": kernels}, sub_before=before, sub_after=after, model=model)
    mean = (counts.flash_bound_s(1, 32, 8, 1024, 128) + counts.flash_bound_s(4, 32, 8, 512, 128)) / 2
    assert readings.flash_roofline(run) == pytest.approx(100.0 * mean * 4 / 4e-4)
    # a launch more at the trace's edge is priced at the mean
    run.sub = {"kernels": kernels + kernels[:1]}
    assert readings.flash_roofline(run) == pytest.approx(100.0 * mean * 5 / 5e-4)
    assert readings.flash_roofline(_Run(sub={"kernels": []}, model=model)) is None


def test_device_readers_find_nothing_without_a_device_trace():
    run = _Run(sub={"busy_s": None, "window_s": 2.0, "kernels": []}, plan=_Plan([1]))
    assert readings.device_idle_pct(run) is None
    assert readings.step_mfu(run) is None
    assert readings.device_idle_pct(_Run(sub={"busy_s": 1.5, "window_s": 2.0})) == 25.0
