"""seldon_core_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points default to CUDA without dropping quietly
to the CPU."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "seldon_core_tpu_torch")

# a fresh interpreter: tests/conftest.py imports JAX into this one
_CHILD = r'''
import asyncio, importlib, json, os, pkgutil, sys, tempfile
import seldon_core_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from seldon_core_tpu_torch import microservice, wrapper
from seldon_core_tpu_torch.http_server import Request
d = tempfile.mkdtemp()
cfg = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
           d_ff=32, max_seq=32, dtype="float32")
json.dump({"family": "llm", "config": cfg}, open(os.path.join(d, "jax_config.json"), "w"))
params = [{"name": "model_uri", "value": d, "type": "STRING"},
          {"name": "device", "value": "cpu", "type": "STRING"},
          {"name": "slots", "value": 2, "type": "INT"}]
user = microservice.build_user_object(
    "seldon_core_tpu_torch.servers.generateserver.GenerateServer", json.dumps(params))
user.load()
app = wrapper.get_rest_microservice(user)
body = json.dumps({"jsonData": {"prompt_tokens": [1, 2, 3], "max_new_tokens": 4}}).encode()
resp = asyncio.run(app._dispatch(
    Request("POST", "/predict", "", {"content-type": "application/json"}, body)))
user.close()
tokens = json.loads(resp.body)["jsonData"]["tokens"]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "seldon_core_tpu"
             or m.startswith("seldon_core_tpu."))
print(json.dumps({"status": resp.status, "tokens": tokens, "bad": bad}))
'''


def test_package_imports_no_jax_and_serves():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["status"] == 200
    assert len(out["tokens"][0]) == 7 and out["tokens"][0][:3] == [1, 2, 3]
    assert out["bad"] == []


# the engine's modules with no protobuf and no grpc runtime: a stub of
# None in sys.modules makes every import of them fail
_NO_PROTO_CHILD = r'''
import asyncio, json, sys
sys.modules["google.protobuf"] = None
sys.modules["grpc"] = None
import seldon_core_tpu_torch.engine_main
import seldon_core_tpu_torch.graph.client
import seldon_core_tpu_torch.graph.executor
import seldon_core_tpu_torch.graph.service as service
import seldon_core_tpu_torch.resilience
import seldon_core_tpu_torch.tracing
from seldon_core_tpu_torch.graph.spec import PredictorSpec, default_predictor
from seldon_core_tpu_torch.http_server import Request
try:
    import google.protobuf
    blocked = False
except ImportError:
    blocked = True
spec = default_predictor(PredictorSpec.from_dict(
    {"name": "p", "graph": {"name": "m", "implementation": "SIMPLE_MODEL"}}))
rest = service.EngineApp(spec).rest_app()
body = json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode()
resp = asyncio.run(rest._dispatch(Request(
    "POST", "/api/v0.1/predictions", "", {"content-type": "application/json"}, body)))
print(json.dumps({"blocked": blocked, "status": resp.status,
                  "data": json.loads(resp.body)["data"]["ndarray"]}))
'''


def test_engine_imports_and_serves_without_protobuf_or_grpc():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_PROTO_CHILD], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"blocked": True, "status": 200, "data": [[0.9, 0.05, 0.05]]}


_IMPORT_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_IMPORT_REF = re.compile(r"^\s*(import|from)\s+seldon_core_tpu(\.|\s|$)", re.M)
_RELATIVE_OUT = re.compile(r"^\s*from\s+\.\.\.", re.M)  # would leave the package


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_source_scan():
    offenders = []
    for path in _sources():
        text = open(path).read()
        for rx in (_IMPORT_JAX, _IMPORT_REF, _RELATIVE_OUT):
            if rx.search(text):
                offenders.append((os.path.relpath(path, REPO), rx.pattern))
    assert offenders == []


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable here")
    from seldon_core_tpu_torch.device import resolve_device
    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerateServer(model_uri=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchServer(model_uri=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecoderLM(vocab_size=8, d_model=8, n_layers=1, n_heads=2, n_kv_heads=1,
                  d_ff=8).init_params(0)
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and alone in a directory without the package."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO), (str(alone), str(tmp_path))):
        env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
        proc = subprocess.run([sys.executable, script], capture_output=True, text=True,
                              timeout=120, env=env, cwd=cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


# the control plane, rollouts and the serving planner, driven through the
# port's sdctl in a fresh interpreter
_CONTROL_PLANE_CHILD = r'''
import json, os, sys, tempfile
from seldon_core_tpu_torch.controlplane import cli
from seldon_core_tpu_torch.controlplane.reconciler import DeploymentController
from seldon_core_tpu_torch.planning import CostModel, ServingPlanner, TrafficSim
from seldon_core_tpu_torch.rollout import RolloutController, ShadowMirror, diff_responses
d = tempfile.mkdtemp()
dep = os.path.join(d, "dep.json")
json.dump({"name": "iso", "predictors": [{"name": "p0", "graph": {
    "name": "m", "implementation": "SIMPLE_MODEL"}}]}, open(dep, "w"))
cli.main(["--store-dir", os.path.join(d, "store"), "apply", "-f", dep])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "seldon_core_tpu"
             or m.startswith("seldon_core_tpu."))
print(json.dumps({"bad": bad, "diff": diff_responses({"jsonData": {"tokens": [[1]]}},
                                                     {"jsonData": {"tokens": [[1]]}})}))
'''


def test_control_plane_subpackages_stand_alone():
    for sub in ("controlplane", "rollout", "planning"):
        files = [f for f in os.listdir(os.path.join(PKG, sub)) if f.endswith(".py")]
        assert "__init__.py" in files
        for f in files:
            text = open(os.path.join(PKG, sub, f)).read()
            assert not _IMPORT_JAX.search(text) and not _IMPORT_REF.search(text), (sub, f)
            assert not _RELATIVE_OUT.search(text), (sub, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _CONTROL_PLANE_CHILD], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "seldondeployment.machinelearning.seldon.io/iso added" in proc.stdout
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [] and out["diff"]["diverged"] is False
