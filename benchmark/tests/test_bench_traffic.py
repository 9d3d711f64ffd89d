"""The traffic generator: determinism by seed and its parameters."""

import json
import os

import numpy as np
import pytest

from benchmark.generators import requests as gen

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def traffic(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


SEED = 2**31 + 977  # past 32 signed bits, as the driver's seeds are


@pytest.mark.parametrize("name", ["chat", "shared-prefix", "long-prompt", "docs-grpc"])
def test_same_seed_same_plan(name):
    p = traffic(name)
    a, b = gen.plan(p, SEED, 12.0, 32768), gen.plan(p, SEED, 12.0, 32768)
    assert len(a) == len(b) == round(p["rate_per_s"] * 12.0)
    assert np.array_equal(a.t, b.t)
    for i in (0, len(a) // 2, len(a) - 1):
        if a.kind == "generate":
            assert a.prompt(i) == b.prompt(i)
            assert a.max_new[i] == b.max_new[i]
        else:
            assert np.array_equal(a.rows(i), b.rows(i))


@pytest.mark.parametrize("name", ["chat", "shared-prefix", "long-prompt", "docs-grpc"])
def test_other_seed_same_work_other_order(name):
    """Two seeds offer the same multiset of sizes and gaps, in another
    order, with other token ids."""
    p = traffic(name)
    a, b = gen.plan(p, SEED, 12.0, 32768), gen.plan(p, SEED + 1, 12.0, 32768)
    # the gaps between sends are one multiset in two orders (the last gap
    # of each order lies past the window's last send)
    ga, gb = (np.round(np.diff(np.sort(x.t)), 9) for x in (a, b))
    assert len(ga) - np.isin(ga, gb).sum() <= 1
    if a.kind == "generate":
        assert sorted(a.prompt_len) == sorted(b.prompt_len)
        assert sorted(a.max_new) == sorted(b.max_new)
        assert list(a.prompt_len) != list(b.prompt_len) or list(a.max_new) != list(b.max_new)
        assert a.prompt(0) != b.prompt(0)
    else:
        assert sorted(a.row_lens.ravel()) == sorted(b.row_lens.ravel())
        assert not np.array_equal(a.rows(0), b.rows(0))


def test_arrivals_fill_the_window_in_order():
    p = traffic("chat")
    pl = gen.plan(p, SEED, 30.0, 32768)
    assert pl.t.min() == 0.0 and pl.t.max() < 30.0
    gaps = np.diff(np.sort(pl.t))
    # exponential quantiles: mean gap 1/rate, a long tail
    assert abs(gaps.mean() - 1.0 / p["rate_per_s"]) < 0.05 / p["rate_per_s"]
    assert gaps.max() > 3.0 / p["rate_per_s"]


def test_rate_override_changes_the_count():
    pl = gen.plan(traffic("chat"), SEED, 10.0, 32768, rate=3.0)
    assert len(pl) == 30


def test_lengths_follow_the_distribution():
    p = traffic("chat")
    pl = gen.plan(p, SEED, 60.0, 32768)
    lo, hi = p["prompt"]["min"], p["prompt"]["max"]
    assert pl.prompt_len.min() >= lo and pl.prompt_len.max() <= hi
    assert abs(np.median(pl.prompt_len) - p["prompt"]["median"]) <= 0.05 * p["prompt"]["median"]
    assert pl.max_new.min() >= p["output"]["min"] and pl.max_new.max() <= p["output"]["max"]
    for i in range(5):
        toks = pl.prompt(i)
        assert len(toks) == pl.prompt_len[i]
        assert all(p.get("id_low", 1) <= t < 32768 for t in toks)


def test_shared_documents_by_zipf():
    p = traffic("shared-prefix")
    pl = gen.plan(p, SEED, 30.0, 32768)
    k = p["shared"]["documents"]
    counts = np.bincount(pl.doc, minlength=k)
    w = 1.0 / np.arange(1, k + 1) ** p["shared"]["zipf_s"]
    assert np.abs(counts / len(pl) - w / w.sum()).max() < 2.0 / len(pl) + 1e-9
    assert list(counts) == sorted(counts, reverse=True)
    for i in range(4):
        toks = pl.prompt(i)
        assert toks[:p["shared"]["doc_len"]] == [int(x) for x in pl.documents[pl.doc[i]]]
        suffix = len(toks) - p["shared"]["doc_len"]
        assert p["shared"]["suffix"]["min"] <= suffix <= p["shared"]["suffix"]["max"]


def test_predict_rows_are_padded_documents():
    p = traffic("docs-grpc")
    pl = gen.plan(p, SEED, 4.0, 30522)
    rows = pl.rows(3)
    assert rows.shape == (p["rows"], p["pad_to"]) and rows.dtype == np.int32
    for r, n in zip(rows, pl.row_lens[3]):
        assert (r[:n] > 0).all() and (r[n:] == 0).all()
        assert p["row_len"]["min"] <= n <= p["row_len"]["max"]


def test_quantiles_uniform_and_fixed():
    u = gen.quantiles({"dist": "uniform", "min": 32, "max": 128}, 97)
    assert u.min() == 32 and u.max() == 128
    assert (gen.quantiles({"dist": "fixed", "value": 7}, 5) == 7).all()
    with pytest.raises(ValueError):
        gen.quantiles({"dist": "pareto"}, 3)


def test_largest_shapes():
    assert gen.plan(traffic("long-prompt"), SEED, 5.0, 32768).largest() == {
        "prompt_min": 2048, "prompt_max": 3840, "output_max": 128}
    assert gen.plan(traffic("shared-prefix"), SEED, 5.0, 32768).largest() == {
        "prompt_min": 2048 + 32, "prompt_max": 2048 + 256, "output_max": 128}
