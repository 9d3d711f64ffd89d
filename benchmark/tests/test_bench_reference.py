"""The plain references at a tiny size against the program's CPU path
(this test imports both; the references import nothing of the program)."""

import copy

import pytest
import torch

from benchmark.reference import bert_encoder, decoder
from seldon_core_tpu_torch.models.bert import BertClassifier
from seldon_core_tpu_torch.models.llm import DecoderLM

LLM = {"vocab_size": 96, "d_model": 32, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
       "d_ff": 48, "max_seq": 64, "rope_theta": 1000000.0, "norm_eps": 1e-5,
       "dtype": "float32"}
BERT = {"vocab_size": 80, "d_model": 32, "n_layers": 2, "n_heads": 2, "d_ff": 64,
        "max_seq": 32, "type_vocab": 2, "num_classes": 2, "layer_norm_eps": 1e-12,
        "dtype": "float32"}
SEED = 2**31 + 5


def test_decoder_weights_are_the_programs_initialisation():
    prog = DecoderLM(**LLM).init_params(SEED, device="cpu")
    ref = decoder.make_weights(LLM, SEED, torch.device("cpu"))
    for k in decoder.MATRICES:
        assert torch.equal(ref["blocks"][k], prog["blocks"][k]), k
    assert torch.equal(ref["embed"], prog["embed"])
    assert torch.equal(ref["unembed"], prog["unembed"])


def test_decoder_weights_round_to_the_served_type():
    cfg = dict(LLM, dtype="bfloat16")
    prog = DecoderLM(**cfg).init_params(SEED, device="cpu")
    ref = decoder.make_weights(cfg, SEED, torch.device("cpu"))
    assert ref["blocks"]["w2"].dtype == torch.bfloat16
    assert torch.equal(ref["blocks"]["w2"], prog["blocks"]["w2"].to(torch.bfloat16))


def test_decoder_logits_match_the_programs_forward():
    m = DecoderLM(**LLM)
    params = m.init_params(SEED, device="cpu")
    w = decoder.make_weights(LLM, SEED, torch.device("cpu"))
    toks = torch.randint(0, LLM["vocab_size"], (1, 23), generator=torch.Generator().manual_seed(3))
    want = m.apply(params, toks)[0]
    got = decoder.logits(LLM, w, [toks[0].tolist()], [0])[0]
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)


def test_decoder_compare_reads_the_served_gap():
    m = DecoderLM(**LLM)
    params = m.init_params(SEED, device="cpu")
    w = decoder.make_weights(LLM, SEED, torch.device("cpu"))
    prompt = list(range(1, 12))
    out = m.generate(params, torch.tensor([prompt]), 8)[0].tolist()
    sample = [{"prompt": prompt, "served": out[len(prompt):]}]
    got = decoder.compare(LLM, w, sample)
    assert got["positions"] == 8 and got["logit_gap"] < 1e-4
    wrong = copy.deepcopy(sample)
    wrong[0]["served"][3] = (wrong[0]["served"][3] + 1) % LLM["vocab_size"]
    assert decoder.compare(LLM, w, wrong)["logit_gap"] > 1e-3
    ctl = decoder.compare(LLM, w, sample, control="fp8")
    assert ctl["control_gap"] >= 0.0


def test_bert_weights_are_the_programs_initialisation():
    prog = BertClassifier(**BERT).init_params(SEED, device="cpu")
    ref = bert_encoder.make_weights(BERT, SEED, torch.device("cpu"))
    for k in ("tok_embed", "pos_embed", "type_embed"):
        assert torch.equal(ref[k], prog[k]), k
    for k in bert_encoder.MATRICES:
        assert torch.equal(ref["blocks"][k], prog["blocks"][k]), k
    assert torch.equal(ref["pooler"], prog["pooler"]["w"])
    assert torch.equal(ref["classifier"], prog["classifier"]["w"])
    # the biases the reference leaves out are zero in the program
    assert all(float(prog["blocks"][k].abs().max()) == 0.0
               for k in ("wq_b", "wk_b", "wv_b", "wo_b", "w1_b", "w2_b"))


def test_bert_logits_match_the_programs_forward():
    m = BertClassifier(**BERT)
    params = m.init_params(SEED, device="cpu")
    w = bert_encoder.make_weights(BERT, SEED, torch.device("cpu"))
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(1, BERT["vocab_size"], (5, 32), generator=g)
    ids[1, 20:] = 0  # padding, as a tokenizer pads to max_length
    ids[3, 9:] = 0
    want = m.apply(params, ids)
    got = bert_encoder.forward(BERT, w, ids)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    out = bert_encoder.compare(BERT, w, ids, want, control="fp8")
    assert out["logit_err"] < 1e-4 and out["rows"] == 5
    bad = want.clone()
    bad[2, 0] += 0.5
    assert bert_encoder.compare(BERT, w, ids, bad)["logit_err"] > 1e-2


def test_fp8_control_rounds_per_column():
    w = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    q = decoder.fp8_columns(w)
    assert q.shape == w.shape and not torch.equal(q, w)
    rel = ((q - w).abs() / w.abs().amax(dim=0, keepdim=True)).max()
    assert rel < 2.0 ** -4 and rel > 2.0 ** -12


@pytest.mark.parametrize("mod", [decoder, bert_encoder])
def test_references_set_tf32_back(mod):
    before = torch.backends.cuda.matmul.allow_tf32
    if mod is decoder:
        w = decoder.make_weights(LLM, SEED, torch.device("cpu"))
        mod.compare(LLM, w, [{"prompt": [1, 2, 3], "served": [4, 5]}])
    else:
        w = bert_encoder.make_weights(BERT, SEED, torch.device("cpu"))
        ids = torch.ones(2, 8, dtype=torch.long)
        mod.compare(BERT, w, ids, torch.zeros(2, 2))
    assert torch.backends.cuda.matmul.allow_tf32 == before
