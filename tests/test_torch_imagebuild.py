"""The port's image build (seldon_core_tpu_torch/build.py, ``sdctl
build``) held against the JAX package's on the CPU.

Counterpart of tests/test_build.py: for the same user directory both
packages write the same build context — the same files, and the same
Dockerfile but for the lines listed in ``DOCKERFILE_DIFFERENCES`` (the
PyTorch-with-CUDA base image and the port's microservice command); the
same refusals; ``docker build`` injectable; ``sdctl build``; and the
Dockerfile's own command, run here, starts the port's microservice and
answers a predict."""

import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest

from _net import free_port
from _torch_tools import JAX, PKGS, PORT, m

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (JAX line, port line) of the python Dockerfile; every other line equal
DOCKERFILE_DIFFERENCES = [
    ("# without the s2i toolchain).",
     "# without the s2i toolchain), on PyTorch built for CUDA."),
    ("FROM python:3.12-slim", "FROM pytorch/pytorch:2.4.0-cuda12.4-cudnn9-runtime"),
    ('CMD seldon-tpu-microservice $MODEL_NAME $API_TYPE '
     '$( [ "$PERSISTENCE" = "1" ] && echo --persistence )',
     'CMD seldon-tpu-torch-microservice $MODEL_NAME $API_TYPE '
     '$( [ "$PERSISTENCE" = "1" ] && echo --persistence )'),
]


def build(pkg):
    return m(pkg, "build")


@pytest.fixture
def pysrc(tmp_path):
    src = tmp_path / "user"
    src.mkdir()
    # a component that runs on the card unless told otherwise
    (src / "MyModel.py").write_text(
        "import numpy as np\n"
        "import torch\n"
        "class MyModel:\n"
        "    def __init__(self, device='cuda'):\n"
        "        self.device = torch.device(device)\n"
        "    def predict(self, X, names, meta=None):\n"
        "        x = torch.as_tensor(np.asarray(X, dtype=np.float32), device=self.device)\n"
        "        return (x * 1).cpu().numpy()\n")
    (src / "requirements.txt").write_text("numpy\n")
    (src / "data").mkdir()
    (src / "data" / "w.txt").write_text("1\n")
    return src


def _contexts(tmp_path, src, **kw):
    out = {}
    for pkg in PKGS:
        ctx = tmp_path / f"ctx-{pkg}-{len(kw)}"
        files = build(pkg).write_build_context(str(src), str(ctx), **kw)
        out[pkg] = (files, {f: (ctx / f).read_text() for f in files})
    return out


def _line_diff(a, b):
    """The (a's, b's) pairs of lines where ``a`` and ``b`` differ."""
    al, bl = a.splitlines(), b.splitlines()
    assert len(al) == len(bl)
    return [(x, y) for x, y in zip(al, bl) if x != y]


@pytest.mark.parametrize("kw", [
    dict(model_name="MyModel", api_type="BOTH", service_type="MODEL", persistence=True),
    dict(model_name="MyModel.MyModel", api_type="rest", service_type="router"),
    dict(model_name="MyModel", api_type="FBS", service_type="COMBINER"),
])
def test_python_context_equals_jax_but_the_listed_lines(pysrc, tmp_path, kw):
    got = _contexts(tmp_path, pysrc, **kw)
    assert got[PORT][0] == got[JAX][0] == sorted(
        ["Dockerfile", "src/MyModel.py", "src/data/w.txt", "src/requirements.txt"])
    for f in got[PORT][0]:
        if f != "Dockerfile":
            assert got[PORT][1][f] == got[JAX][1][f]
    assert _line_diff(got[JAX][1]["Dockerfile"], got[PORT][1]["Dockerfile"]) == \
        DOCKERFILE_DIFFERENCES
    df = got[PORT][1]["Dockerfile"]
    assert f"API_TYPE={kw['api_type'].upper()}" in df and "MODEL_NAME=" in df


def test_cpp_context_equals_jax(tmp_path):
    src = tmp_path / "cpp"
    src.mkdir()
    (src / "component.cpp").write_text("int main(){return 0;}\n")
    got = _contexts(tmp_path, src, model_name="cpp-clf", language="cpp")
    assert got[PORT] == got[JAX]
    assert 'ENTRYPOINT ["/component"]' in got[PORT][1]["Dockerfile"]


def test_base_image_is_an_argument(pysrc, tmp_path):
    build(PORT).write_build_context(str(pysrc), str(tmp_path / "c"), "MyModel",
                                    base_image="nvcr.io/nvidia/pytorch:24.05-py3")
    assert "FROM nvcr.io/nvidia/pytorch:24.05-py3\n" in (tmp_path / "c" / "Dockerfile").read_text()


def _refusal(pkg, *args, **kw):
    with pytest.raises((ValueError, FileNotFoundError)) as e:
        build(pkg).write_build_context(*args, **kw)
    return type(e.value).__name__, str(e.value)


def test_refusals_equal_jax(pysrc, tmp_path):
    (tmp_path / "empty").mkdir()
    cases = [
        ((str(tmp_path / "empty"), str(tmp_path / "c0"), "Nope"), {}),
        ((str(pysrc), str(pysrc / "ctx"), "MyModel"), {}),
        ((str(pysrc), str(tmp_path / "c1"), "MyModel"), {"api_type": "SOAP"}),
        ((str(pysrc), str(tmp_path / "c2"), "MyModel"), {"service_type": "ORACLE"}),
        ((str(pysrc), str(tmp_path / "c3"), "MyModel"), {"language": "java"}),
        ((str(pysrc), str(tmp_path / "c4"), "x"), {"language": "cpp"}),
        ((str(tmp_path / "c5" / "src"), str(tmp_path / "c5"), "MyModel"), {}),
    ]
    (tmp_path / "c5" / "src").mkdir(parents=True)
    (tmp_path / "c5" / "src" / "MyModel.py").write_text("")
    for args, kw in cases:
        assert _refusal(PORT, *args, **kw) == _refusal(JAX, *args, **kw), (args, kw)


def test_docker_build_invocation_injectable(tmp_path):
    for pkg in PKGS:
        calls = []
        assert build(pkg).docker_build(str(tmp_path), "repo/img:1",
                                       runner=lambda cmd, check: calls.append((cmd, check)))
        assert calls == [(["docker", "build", "-t", "repo/img:1", str(tmp_path)], True)]


def test_sdctl_build(pysrc, tmp_path, capsys):
    out = tmp_path / "ctx"
    m(PORT, "controlplane.cli").main(
        ["--store-dir", str(tmp_path / "store"), "build", "--src", str(pysrc),
         "--model-name", "MyModel", "--api-type", "GRPC", "--persistence", "--out", str(out),
         "--base-image", "my/base:1"])
    assert "wrote build context (4 files)" in capsys.readouterr().out
    df = (out / "Dockerfile").read_text()
    assert "FROM my/base:1\n" in df and "API_TYPE=GRPC" in df and "PERSISTENCE=1" in df


def test_generated_command_actually_serves(pysrc, tmp_path):
    """The Dockerfile's CMD with its ENV block, run here (no docker): the
    port's microservice comes up with the component's ``device`` parameter
    set to ``cpu`` and answers a predict."""
    out = tmp_path / "ctx"
    build(PORT).write_build_context(str(pysrc), str(out), "MyModel")
    df = (out / "Dockerfile").read_text()
    cmd_line = re.search(r"^CMD (.+)$", df, re.M).group(1).strip()
    assert cmd_line.startswith("seldon-tpu-torch-microservice ")
    port = free_port()
    # the console script as the image has it on PATH; this host runs the module
    shell_cmd = cmd_line.replace(
        "seldon-tpu-torch-microservice", f"{sys.executable} -m seldon_core_tpu_torch.microservice",
    ) + f" --service-port {port}"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "MODEL_NAME": "MyModel", "API_TYPE": "REST", "SERVICE_TYPE": "MODEL",
           "PERSISTENCE": "0", "OMP_NUM_THREADS": "1",
           "PREDICTIVE_UNIT_PARAMETERS": json.dumps(
               [{"name": "device", "value": "cpu", "type": "STRING"}])}
    proc = subprocess.Popen(["bash", "-c", shell_cmd], cwd=str(out / "src"), env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode(),
            headers={"Content-Type": "application/json"})
        deadline, last = time.time() + 60, None
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"the microservice exited: {proc.stderr.read()[-2000:]}")
            try:
                with urllib.request.urlopen(req, timeout=2) as resp:
                    assert json.loads(resp.read())["data"]["ndarray"] == [[1.0, 2.0]]
                    return
            except OSError as e:
                last = e
                time.sleep(0.3)
        raise AssertionError(f"microservice never answered: {last}")
    finally:
        proc.terminate()
        proc.wait(timeout=10)
