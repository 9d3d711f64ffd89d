"""The port's checkpoint export (``seldon_core_tpu_torch.convert``) on tiny
random-init ``transformers`` models, built as tests/test_convert.py
builds them (no download): the exported tree equals the JAX converter's
leaf for leaf, and what the port serves from the exported directory on
the CPU equals the ``transformers`` forward (the tolerances of
tests/test_convert.py: float32 logits within atol 2e-4, rtol 2e-3;
greedy tokens equal)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")

from seldon_core_tpu import convert as jax_convert  # noqa: E402
from seldon_core_tpu_torch import convert  # noqa: E402
from seldon_core_tpu_torch.servers.generateserver import GenerateServer  # noqa: E402
from seldon_core_tpu_torch.servers.torchserver import TorchServer  # noqa: E402

from test_convert import tiny_hf_bert, tiny_hf_llama, tiny_hf_vit  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAKERS = {"bert": tiny_hf_bert, "llama": tiny_hf_llama, "vit": tiny_hf_vit}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    return {path: tree}


@pytest.mark.parametrize("family", sorted(MAKERS))
def test_tree_equals_the_jax_converter(family):
    hf = MAKERS[family]()
    config, params = convert.HF_FAMILIES[family](hf)
    j_config, j_params = jax_convert.HF_FAMILIES[family](hf)
    assert config == j_config
    mine, theirs = _leaves(params), _leaves(j_params)
    assert sorted(mine) == sorted(theirs)
    for path, leaf in theirs.items():
        assert mine[path].dtype == leaf.dtype and np.array_equal(mine[path], leaf), path
    assert convert.ZOO_FAMILY == jax_convert.ZOO_FAMILY


def _export(tmp_path, family):
    hf = MAKERS[family]()
    config, params = convert.HF_FAMILIES[family](hf)
    config["dtype"] = "float32"
    out = convert.export_model(convert.ZOO_FAMILY[family], config, params,
                               str(tmp_path / family))
    meta = json.load(open(os.path.join(out, "jax_config.json")))
    assert meta == {"family": convert.ZOO_FAMILY[family], "config": config,
                    "checkpoint": "params.npz"}
    return hf, out


def _served(out_dir, x):
    server = TorchServer(out_dir, device="cpu")
    server.load()
    return np.asarray(server.predict(x, []), np.float32)


def test_bert_export_serves_transformers_logits(tmp_path):
    hf, out = _export(tmp_path, "bert")
    tokens = np.random.RandomState(0).randint(1, 120, (2, 10)).astype(np.int32)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(tokens.astype(np.int64)),
                 attention_mask=torch.ones(tokens.shape, dtype=torch.long)).logits.numpy()
    np.testing.assert_allclose(_served(out, tokens), ref, atol=2e-4, rtol=2e-3)


def test_vit_export_serves_transformers_logits(tmp_path):
    hf, out = _export(tmp_path, "vit")
    # transformers' ViT takes [B, C, H, W], the zoo's [B, H, W, C]
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        ref = hf(pixel_values=torch.tensor(x.transpose(0, 3, 1, 2))).logits.numpy()
    np.testing.assert_allclose(_served(out, x), ref, atol=2e-4, rtol=2e-3)


def test_llama_export_serves_transformers_logits_and_tokens(tmp_path):
    hf, out = _export(tmp_path, "llama")
    tokens = np.random.RandomState(0).randint(0, 120, (2, 12)).astype(np.int32)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(tokens.astype(np.int64))).logits.numpy()
    np.testing.assert_allclose(_served(out, tokens), ref, atol=2e-4, rtol=2e-3)
    server = GenerateServer(model_uri=out, device="cpu", slots=2)
    server.load()
    try:
        prompt = [5, 17, 42]
        got = server.predict({"prompt_tokens": [prompt], "max_new_tokens": 5}, [])["tokens"][0]
    finally:
        server.close()
    with torch.no_grad():
        want = hf.generate(torch.tensor([prompt]), max_new_tokens=5, do_sample=False)[0].tolist()
    assert got == want


def test_cli_exports_a_local_checkpoint_that_serves(tmp_path, capsys):
    """``main`` (the ``seldon-tpu-torch-export`` command) on a local
    ``save_pretrained`` directory writes a model directory GenerateServer
    serves, in the config's default bfloat16."""
    hf = tiny_hf_llama()
    src = str(tmp_path / "hf")
    hf.save_pretrained(src)
    out = str(tmp_path / "out")
    convert.main(["--hf", src, "--family", "llama", "--out", out])
    assert "exported" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["jax_config.json", "params.npz"]
    server = GenerateServer(model_uri=out, device="cpu", slots=2)
    server.load()
    try:
        got = server.predict({"prompt_tokens": [[5, 17, 42]], "max_new_tokens": 4}, [])
    finally:
        server.close()
    toks = got["tokens"][0]
    assert len(toks) == 7 and toks[:3] == [5, 17, 42] and all(0 <= t < 120 for t in toks)
    with pytest.raises(ValueError, match="unknown family"):
        convert.convert_hf(src, "gpt2", out)


def test_module_imports_without_transformers():
    """The card's machine has no ``transformers``: importing the module and
    exporting a tree must not need it."""
    child = (
        "import sys, tempfile, numpy as np\n"
        "sys.modules['transformers'] = None\n"
        "from seldon_core_tpu_torch import convert\n"
        "d = convert.export_model('llm', {'d_model': 2}, {'w': np.ones(2, np.float32)},\n"
        "                         tempfile.mkdtemp())\n"
        "print(sorted(convert.load_npz(d + '/params.npz', device='cpu')))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                          timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "['w']"
