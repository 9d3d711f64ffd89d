"""The benchmark's frozen copies of the program's counts agree with the
program's functions today, and the flash kernel's count with a brute
force over the causal mask."""

import json
import os

import pytest
import torch

from benchmark import counts
from seldon_core_tpu_torch.models.bert import BertClassifier
from seldon_core_tpu_torch.models.llm import DecoderLM

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model_keys(config):
    with open(os.path.join(HERE, "configs", f"{config}.json")) as f:
        return json.load(f)["model"]


MISTRAL = model_keys("mistral-7b-v0.3")
BERT = model_keys("bert-base-uncased")


@pytest.mark.parametrize("ctx", [0, 1, 512, 4095.5])
def test_decoder_flops_per_token(ctx):
    assert counts.decoder_flops_per_token(MISTRAL, ctx) == DecoderLM(**MISTRAL).flops_per_token(ctx)


def test_decoder_params_and_decode_bytes():
    m = DecoderLM(**MISTRAL)
    assert counts.decoder_n_params(MISTRAL) == m.n_params() == 7_248_023_552
    for ctx, batch in ((1, 1), (700, 32), (4096, 7)):
        assert counts.decoder_decode_bytes_per_token(MISTRAL, ctx, batch) == \
            m.decode_bytes_per_token(ctx, batch)


def test_prefill_flops_sum_per_token_counts():
    got = counts.decoder_prefill_flops(MISTRAL, 16, 100)
    want = sum(counts.decoder_flops_per_token(MISTRAL, p + 1) for p in range(16, 116))
    assert got == pytest.approx(want, rel=1e-12)
    assert counts.decoder_prefill_flops(MISTRAL, 5, 0) == 0.0


@pytest.mark.parametrize("t", [128, 512])
def test_bert_flops_per_row(t):
    assert counts.bert_flops_per_row(BERT, t) == BertClassifier(**BERT).flops_per_row(t)


@pytest.mark.parametrize("t", [1, 7, 64])
def test_flash_flops_and_bytes_brute_force(t):
    b, h, kv, dh = 2, 4, 2, 8
    visible = int(torch.ones(t, t).tril().sum())
    assert counts.flash_flops(b, h, t, dh) == 4.0 * b * h * dh * visible
    # q and o of h heads, k and v of kv heads, [b, heads, t, dh] bf16
    assert counts.flash_bytes(b, h, kv, t, dh) == 2 * b * t * dh * (h + h + kv + kv)


def test_flash_bound_picks_the_larger():
    fl = counts.flash_flops(1, 32, 4096, 128) / counts.PEAK_FLOPS["bfloat16"]
    by = counts.flash_bytes(1, 32, 8, 4096, 128) / counts.PEAK_BYTES_S
    assert counts.flash_bound_s(1, 32, 8, 4096, 128) == max(fl, by) == fl
