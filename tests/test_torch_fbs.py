"""The port's FlatBuffers transport (``seldon_core_tpu_torch/fbs.py``):
the JAX package's own cases (``tests/test_fbs.py``) run against the
port, the port's frames are byte-identical to the JAX encoder's, each
package's decoder reads the other's frames, the port needs no
``flatbuffers`` runtime, and an FBSServer over a CPU GenerateServer
answers a strData prompt with the JAX server's tokens."""

import json
import os
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from seldon_core_tpu import fbs as jax_fbs
from seldon_core_tpu_torch import fbs
from seldon_core_tpu_torch.user_model import SeldonComponent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the JAX package's cases (tests/test_fbs.py) -----------------------------


def test_tensor_round_trip():
    arr = np.arange(12, dtype=np.float64).reshape(3, 4)
    blob = fbs.encode_message(arr, names=["a", "b", "c", "d"], puid="p-1")
    out = fbs.decode_message(blob)
    assert out["method"] == fbs.METHOD_PREDICT
    np.testing.assert_array_equal(out["data"], arr)
    assert out["names"] == ["a", "b", "c", "d"]
    assert out["puid"] == "p-1"


def test_str_and_bin_round_trip():
    out = fbs.decode_message(fbs.encode_message(str_data="hello"))
    assert out["strData"] == "hello" and out["data"] is None
    out = fbs.decode_message(fbs.encode_message(bin_data=b"\x00\x01\xff"))
    assert out["binData"] == b"\x00\x01\xff"


def test_status_round_trip():
    blob = fbs.encode_message(
        status=(500, "boom", fbs.STATUS_FAILURE), method=fbs.METHOD_RESPONSE
    )
    out = fbs.decode_message(blob)
    assert out["method"] == fbs.METHOD_RESPONSE
    assert out["status"] == {"code": 500, "info": "boom", "status": "FAILURE"}


def test_unknown_protocol_version_rejected():
    blob = fbs.encode_message(np.zeros((1,)))
    payload = bytearray(blob[4:])
    idx = bytes(payload).find(struct.pack("<i", fbs.SELDON_PROTOCOL_V1))
    assert idx >= 0
    payload[idx:idx + 4] = struct.pack("<i", 99)
    with pytest.raises(ValueError, match="protocol"):
        fbs.decode_message(bytes(struct.pack("<I", len(payload))) + bytes(payload))


class Tripler(SeldonComponent):
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 3


def test_fbs_server_predict_round_trip():
    srv = fbs.FBSServer(Tripler(), host="127.0.0.1", port=0).start()
    try:
        out = fbs.fbs_predict("127.0.0.1", srv.port, [[1.0, 2.0]], ["x", "y"])
        assert out["method"] == fbs.METHOD_RESPONSE
        assert out["status"]["code"] == 200
        np.testing.assert_array_equal(out["data"], [[3.0, 6.0]])
        out2 = fbs.fbs_predict("127.0.0.1", srv.port, [[5.0]])
        np.testing.assert_array_equal(out2["data"], [[15.0]])
    finally:
        srv.close()


def test_fbs_server_wires_errors_back():
    class Boom(SeldonComponent):
        def predict(self, X, names, meta=None):
            raise RuntimeError("nope")

    srv = fbs.FBSServer(Boom(), host="127.0.0.1", port=0).start()
    try:
        out = fbs.fbs_predict("127.0.0.1", srv.port, [[1.0]])
        assert out["status"]["status"] == "FAILURE"
        assert "nope" in out["status"]["info"]
    finally:
        srv.close()


def test_oversized_frame_rejected():
    srv = fbs.FBSServer(Tripler(), host="127.0.0.1", port=0).start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port), 5) as conn:
            conn.sendall(struct.pack("<I", fbs.FBSServer.MAX_FRAME + 1))
            head = conn.recv(4)
            (ln,) = struct.unpack("<I", head)
            payload = b""
            while len(payload) < ln:
                c = conn.recv(65536)
                if not c:
                    break
                payload += c
        out = fbs.decode_message(head + payload)
        assert out["status"]["code"] == 413
    finally:
        srv.close()


def test_fbs_server_bindata_and_jsondata_responses():
    class BytesModel(SeldonComponent):
        def predict(self, X, names, meta=None):
            return b"\x01\x02\x03"

    srv = fbs.FBSServer(BytesModel(), host="127.0.0.1", port=0).start()
    try:
        out = fbs.fbs_predict("127.0.0.1", srv.port, [[1.0]])
        assert out["binData"] == b"\x01\x02\x03"
    finally:
        srv.close()

    class DictModel(SeldonComponent):
        def predict(self, X, names, meta=None):
            return {"answer": 42}

    srv = fbs.FBSServer(DictModel(), host="127.0.0.1", port=0).start()
    try:
        out = fbs.fbs_predict("127.0.0.1", srv.port, [[1.0]])
        assert json.loads(out["strData"]) == {"answer": 42}
    finally:
        srv.close()


def test_fbs_close_unblocks_idle_connection():
    srv = fbs.FBSServer(Tripler(), host="127.0.0.1", port=0).start()
    conn = socket.create_connection(("127.0.0.1", srv.port), 5)
    try:
        time.sleep(0.1)  # let the accept loop register the connection
        srv.close()  # must shut the idle keep-alive conn down, not leak it
        conn.settimeout(5)
        try:
            assert conn.recv(1) == b""
        except ConnectionResetError:
            pass
    finally:
        conn.close()


def test_fbs_reuse_port_two_servers():
    srv1 = fbs.FBSServer(Tripler(), host="127.0.0.1", port=0, reuse_port=True).start()
    srv2 = fbs.FBSServer(Tripler(), host="127.0.0.1", port=srv1.port,
                         reuse_port=True).start()
    try:
        out = fbs.fbs_predict("127.0.0.1", srv1.port, [[2.0]])
        np.testing.assert_array_equal(out["data"], [[6.0]])
    finally:
        srv1.close()
        srv2.close()


def test_framing_is_explicit_not_guessed():
    blob = fbs.encode_message(str_data="x")
    bare = blob[4:]
    out = fbs.decode_message(bare, prefixed=False)
    assert out["strData"] == "x"
    with pytest.raises(ValueError, match="length prefix"):
        fbs.decode_message(struct.pack("<I", 999) + bare)
    with pytest.raises(ValueError, match="shorter"):
        fbs.decode_message(b"\x01")


# -- the port against the JAX package ----------------------------------------

_RS = np.random.RandomState(0)

MESSAGES = {
    "empty": {},
    "response_empty": {"method": fbs.METHOD_RESPONSE},
    "status_ok": {"status": (200, "", fbs.STATUS_SUCCESS), "method": fbs.METHOD_RESPONSE},
    "status_failure": {"status": (500, "ValueError: nope", fbs.STATUS_FAILURE),
                       "method": fbs.METHOD_RESPONSE},
    "str": {"str_data": "hello"},
    "str_empty": {"str_data": ""},
    "str_unicode": {"str_data": "žluťoučký ☃ 頁"},
    "str_long_puid": {"str_data": "x" * 1001, "puid": "p-42"},
    "bin": {"bin_data": b"\x00\x01\xff"},
    "bin_empty": {"bin_data": b""},
    "bin_odd": {"bin_data": bytes(range(7)), "status": (200, "", 0)},
    "tensor_scalar_row": {"arr": np.zeros((1,))},
    "tensor_empty": {"arr": np.zeros((0,))},
    "tensor_2d_names": {"arr": _RS.randn(3, 4), "names": ["a", "b", "c", "d"],
                        "puid": "p-1"},
    "tensor_3d": {"arr": _RS.randn(2, 3, 5)},
    "tensor_4d_int": {"arr": _RS.randint(-9, 9, (2, 1, 3, 2))},
    "tensor_many_names": {"arr": _RS.randn(1, 40), "names": [f"f{i}" for i in range(40)]},
    "tensor_large": {"arr": _RS.randn(64, 129)},
    "tensor_response": {"arr": _RS.randn(2, 2), "names": ["p", "q"],
                        "status": (200, "", fbs.STATUS_SUCCESS),
                        "method": fbs.METHOD_RESPONSE, "puid": "abc"},
    "tensor_nonfinite": {"arr": np.array([[np.inf, -np.inf, 0.0, -0.0]])},
}


def _assert_decoded_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].shape == b[k].shape
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_frames_byte_identical_to_jax(name):
    msg = MESSAGES[name]
    assert fbs.encode_message(**msg) == jax_fbs.encode_message(**msg)


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_each_decoder_reads_the_other_packages_frames(name):
    msg = MESSAGES[name]
    port_frame, jax_frame = fbs.encode_message(**msg), jax_fbs.encode_message(**msg)
    _assert_decoded_equal(fbs.decode_message(jax_frame), jax_fbs.decode_message(jax_frame))
    _assert_decoded_equal(jax_fbs.decode_message(port_frame), fbs.decode_message(port_frame))
    _assert_decoded_equal(fbs.decode_message(port_frame[4:], prefixed=False),
                          jax_fbs.decode_message(jax_frame[4:], prefixed=False))


_shapes = st.lists(st.integers(0, 5), min_size=1, max_size=4)
_text = st.text(max_size=40)


@settings(max_examples=60, deadline=None)
@given(shape=_shapes, seed=st.integers(0, 2 ** 16), names=st.lists(_text, max_size=6),
       puid=_text, status=st.one_of(st.none(), st.tuples(st.integers(0, 599), _text,
                                                        st.integers(0, 1))),
       method=st.integers(0, 1))
def test_tensor_frames_byte_identical_hypothesis(shape, seed, names, puid, status, method):
    arr = np.random.RandomState(seed).randn(*shape)
    kw = dict(names=names, puid=puid, status=status, method=method)
    frame = fbs.encode_message(arr, **kw)
    assert frame == jax_fbs.encode_message(arr, **kw)
    _assert_decoded_equal(fbs.decode_message(frame), jax_fbs.decode_message(frame))


@settings(max_examples=60, deadline=None)
@given(text=st.one_of(st.none(), st.text(max_size=300)),
       blob=st.one_of(st.none(), st.binary(max_size=300)), puid=_text)
def test_str_and_bin_frames_byte_identical_hypothesis(text, blob, puid):
    kw = dict(str_data=text, bin_data=blob, puid=puid)
    frame = fbs.encode_message(**kw)
    assert frame == jax_fbs.encode_message(**kw)
    _assert_decoded_equal(fbs.decode_message(frame), jax_fbs.decode_message(frame))


def test_needs_no_flatbuffers_runtime():
    """The card's machine has no ``flatbuffers`` package: the port encodes,
    decodes and serves without it."""
    child = r'''
import json, sys
sys.modules["flatbuffers"] = None
import numpy as np
from seldon_core_tpu_torch import fbs
class Twice:
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2
srv = fbs.FBSServer(Twice(), host="127.0.0.1", port=0).start()
out = fbs.fbs_predict("127.0.0.1", srv.port, [[1.5, 2.0]], ["a", "b"])
srv.close()
print(json.dumps({"data": out["data"].tolist(), "mods": "flatbuffers" in sys.modules
                  and sys.modules["flatbuffers"] is not None}))
'''
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "data": [[3.0, 4.0]], "mods": False}


# -- a generate server behind the FBS front ----------------------------------

CFG = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq=64, dtype="float32")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from _torch_engine import make_model_dir

    from seldon_core_tpu.servers.generateserver import GenerateServer as JaxGenerateServer
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    model_dir = make_model_dir(tmp_path_factory.mktemp("llm"))
    port = GenerateServer(model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2)
    port.load()
    jax_server = JaxGenerateServer(model_uri=model_dir, slots=2, steps_per_poll=2)
    jax_server.load()
    yield port, jax_server
    port.close()
    jax_server.close()


def _frame_call(conn, frame):
    conn.sendall(frame)
    head = fbs._recv_exact(conn, 4)
    return fbs.decode_message(head + fbs._recv_exact(conn, struct.unpack("<I", head)[0]))


@pytest.mark.parametrize("text", ["hi there", "seldon on the card", "z" * 20])
def test_fbs_generate_str_prompt_equals_jax(servers, text):
    """A strData prompt is a byte-level prompt; the jsonData answer crosses
    as a JSON string in StrData, with the JAX server's tokens."""
    port, jax_server = servers
    srv = fbs.FBSServer(port, host="127.0.0.1", port=0).start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port), 60) as conn:
            out = _frame_call(conn, fbs.encode_message(str_data=text))
    finally:
        srv.close()
    assert out["status"] == {"code": 200, "info": "", "status": "SUCCESS"}
    assert json.loads(out["strData"]) == jax_server.predict(text, [])


def test_fbs_generate_ndarray_fails_and_connection_stays_usable(servers):
    port, jax_server = servers
    srv = fbs.FBSServer(port, host="127.0.0.1", port=0).start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port), 60) as conn:
            bad = _frame_call(conn, fbs.encode_message(np.array([[1.0, 2.0]])))
            good = _frame_call(conn, fbs.encode_message(str_data="again"))
    finally:
        srv.close()
    assert bad["status"]["status"] == "FAILURE" and bad["status"]["code"] == 500
    assert bad["status"]["info"].startswith("ValueError: generate expects")
    assert json.loads(good["strData"]) == jax_server.predict("again", [])
