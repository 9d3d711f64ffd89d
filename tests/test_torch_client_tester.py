"""The port's SeldonClient and contract testers (seldon_core_tpu_torch/
client.py, tester.py) held against the JAX package's on the CPU.

Counterpart of tests/test_client_tester.py: the contract machinery gives
the same batches, checks and contracts from the same inputs and seeds;
both packages' clients, pointed at the same port microservice (REST and
gRPC), engine and gateway (with and without oauth), give the same
responses; the tester's summary and CLI agree."""

import asyncio
import copy
import json

import numpy as np
import pytest

from _net import free_port
from _torch_tools import JAX, PKGS, PORT, Proba, m, serve_microservice

CONTRACT = {
    "features": [
        {"name": "sepal_length", "ftype": "continuous", "dtype": "FLOAT", "range": [4, 8]},
        {"name": "petal", "ftype": "continuous", "dtype": "FLOAT", "repeat": 2, "range": [0, 3]},
    ],
    "targets": [
        {"name": "proba", "ftype": "continuous", "dtype": "FLOAT", "range": [0, 1], "shape": [3]}
    ],
}

CONTRACTS = {
    "iris": CONTRACT,
    "mixed": {"features": [
        {"name": "color", "ftype": "categorical", "dtype": "STRING", "values": ["r", "g", "b"]},
        {"name": "x", "ftype": "continuous", "dtype": "FLOAT", "range": [0, 1]},
    ], "targets": []},
    "int_shape_inf": {"features": [
        {"name": "n", "ftype": "continuous", "dtype": "INT", "range": [0, 100]},
        {"name": "img", "ftype": "continuous", "dtype": "FLOAT", "shape": [2, 3],
         "range": ["-inf", "inf"]},
        {"name": "k", "ftype": "continuous", "dtype": "FLOAT", "repeat": 3},
    ], "targets": [{"name": "y", "ftype": "categorical", "values": ["a", "b"]}]},
}


def _tester(pkg):
    return m(pkg, "tester")


def client_cls(pkg):
    return m(pkg, "client").SeldonClient


def scrub(resp):
    """A client response as compared across packages: the engine's random
    puid dropped."""
    body = copy.deepcopy(resp.response)
    if isinstance(body, dict):
        (body.get("meta") or {}).pop("puid", None)
    return resp.success, body


@pytest.fixture(scope="module")
def micro():
    rest, grpc_ep, stop = serve_microservice(Proba())
    yield rest, grpc_ep
    stop()


# -- contract machinery -----------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_unfold_and_feature_names_equal_jax(name):
    got = {pkg: _tester(pkg).unfold_contract(CONTRACTS[name]) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    assert _tester(PORT).feature_names(got[PORT]) == _tester(JAX).feature_names(got[JAX])


@pytest.mark.parametrize("name", sorted(CONTRACTS))
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_generate_batch_equals_jax_from_the_same_seed(name, seed):
    for field in ("features", "targets"):
        c = _tester(JAX).unfold_contract(CONTRACTS[name])
        if not c[field]:
            continue
        want = _tester(JAX).generate_batch(c, 6, field=field, seed=seed)
        got = _tester(PORT).generate_batch(c, 6, field=field, seed=seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tolist() == want.tolist()


def test_contract_error_equals_jax():
    bad = {"features": [{"name": "bad", "ftype": "nope"}]}
    msgs = []
    for pkg in PKGS:
        with pytest.raises(_tester(pkg).ContractError) as e:
            _tester(pkg).generate_batch(bad, 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("response", [
    {"data": {"ndarray": [[0.2, 0.3, 0.5]]}},
    {"data": {"ndarray": [[0.2, 0.3]]}},
    {"data": {"ndarray": [[0.2, 0.3, 1.5]]}},
    {"data": {"tensor": {"shape": [2, 3], "values": [0.1, 0.2, 0.7, 0.3, 0.3, 0.4]}}},
    {"data": {"raw": {"dtype": "float32", "shape": [1, 2], "data": "AAA="}}},
    {"strData": "x"},
    {},
])
def test_validate_response_equals_jax(response):
    c = _tester(JAX).unfold_contract(CONTRACT)
    got = [_tester(pkg).validate_response(c, copy.deepcopy(response)) for pkg in PKGS]
    assert got[1] == got[0]


@pytest.mark.parametrize("X,names", [
    (np.array([[1.5, 0.5], [3.0, 0.7]]), ["a", "b"]),
    (np.array([[1], [3]]), ["n"]),
    (np.array([["r", 1.0], ["g", 2.0]], dtype=object), None),
    (np.array([0.5, 1.5, 2.5]), None),
])
def test_generate_contract_from_data_equals_jax(X, names):
    got = [_tester(pkg).generate_contract_from_data(X, names=names) for pkg in PKGS]
    assert got[1] == got[0]


# -- clients against the same port microservice ------------------------------


def test_clients_microservice_rest_and_grpc_equal(micro):
    rest, grpc_ep = micro
    x = np.array([[5.0, 1.0, 1.0]])
    for ep, transport in ((rest, "rest"), (grpc_ep, "grpc")):
        got = []
        for pkg in PKGS:
            c = client_cls(pkg)(microservice_endpoint=ep, transport=transport)
            got.append(c.microservice(x, names=["a", "b", "c"]))
        assert got[0].success and got[1].success, (got[0].msg, got[1].msg)
        assert got[1].response == got[0].response
        np.testing.assert_allclose(got[1].data, [[0.2, 0.3, 0.5]])


@pytest.mark.parametrize("method", ["transform-input", "route", "aggregate", "send-feedback"])
@pytest.mark.parametrize("transport", ["rest", "grpc"])
def test_clients_component_methods_equal(micro, method, transport):
    rest, grpc_ep = micro
    ep = rest if transport == "rest" else grpc_ep
    got = []
    for pkg in PKGS:
        c = client_cls(pkg)(microservice_endpoint=ep, transport=transport)
        if method == "aggregate":
            r = c.microservice([np.array([[1.0, 2.0]]), np.array([[3.0, 4.0]])],
                               method="aggregate")
        elif method == "send-feedback":
            r = c.microservice_feedback({"data": {"ndarray": [[1.0]]}},
                                        {"data": {"ndarray": [[0.2, 0.3, 0.5]]}}, reward=1.0)
        else:
            r = c.microservice(np.array([[1.0, 2.0]]), method=method)
        got.append(r)
    assert got[0].success and got[1].success, (got[0].msg, got[1].msg)
    assert got[1].response == got[0].response
    if method == "aggregate":
        np.testing.assert_allclose(got[1].data, [[2.0, 3.0]])


@pytest.mark.parametrize("ptype", ["ndarray", "tensor", "raw"])
def test_clients_payload_types_equal(micro, ptype):
    rest, _ = micro
    got = []
    for pkg in PKGS:
        c = client_cls(pkg)(microservice_endpoint=rest, payload_type=ptype)
        got.append(c.microservice(np.array([[5.0, 1.0, 1.0]])))
    assert got[0].success and got[1].success
    assert got[1].request == got[0].request and got[1].response == got[0].response
    assert got[1].data.shape == (1, 3)


def test_clients_bin_str_json_messages_equal():
    c = [client_cls(pkg)(microservice_endpoint="127.0.0.1:1") for pkg in PKGS]
    for kw in ({"bin_data": b"\x00\x01"}, {"str_data": "hi"}, {"json_data": {"a": [1]}}):
        assert c[1]._message(**kw) == c[0]._message(**kw)


def test_clients_connection_refused_is_graceful():
    for pkg in PKGS:
        r = client_cls(pkg)(microservice_endpoint="127.0.0.1:1", timeout_s=0.5).microservice(
            np.array([[1.0]]))
        assert not r.success and r.msg and r.data is None


def test_client_unknown_method_and_missing_target_raise_as_jax():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="unknown microservice method"):
            client_cls(pkg)(microservice_endpoint="x:1").microservice(method="nope")
        with pytest.raises(ValueError, match="need gateway_endpoint"):
            client_cls(pkg)().predict(np.array([[1.0]]))
        with pytest.raises(ValueError, match="gateway does not serve gRPC"):
            client_cls(pkg)(deployment_name="d", gateway_endpoint="x:1",
                            transport="grpc").predict(np.array([[1.0]]))


# -- the contract tester ----------------------------------------------------


@pytest.mark.parametrize("endpoint", ["predict", "transform-input", "route", "send-feedback"])
def test_contract_test_summary_equals_jax(micro, endpoint):
    rest, _ = micro
    got = []
    for pkg in PKGS:
        c = client_cls(pkg)(microservice_endpoint=rest)
        got.append(_tester(pkg).run_contract_test(
            c, CONTRACT, n_requests=3, batch_size=4, endpoint=endpoint, seed=0))
    assert got[1] == got[0]
    if endpoint == "transform-input":
        # X + 1 is three wide, as the targets, but falls outside [0, 1]
        assert got[1]["failed"] == 3 and "outside" in got[1]["violations"][0]
    else:
        assert got[1]["ok"] == 3 and got[1]["failed"] == 0


def test_tester_cli_equals_jax(micro, tmp_path, capsys):
    rest, grpc_ep = micro
    cpath = tmp_path / "contract.json"
    cpath.write_text(json.dumps(CONTRACT))
    outs = []
    for pkg in PKGS:
        for ep in (rest, grpc_ep):
            host, port = ep.split(":")
            argv = [str(cpath), host, port, "-n", "2", "-b", "2", "--seed", "0"]
            if ep == grpc_ep:
                argv.append("--grpc")
            _tester(pkg).main(argv)
            outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert outs[2:] == outs[:2]
    assert outs[2]["ok"] == 2 and outs[3]["ok"] == 2


# -- clients against the port's engine and gateway ---------------------------


def _gateway(oauth=None):
    cp = m(PORT, "controlplane")
    rt = m(PORT, "controlplane.runtime")
    store = cp.ResourceStore()
    gw = cp.Gateway(seed=3, oauth=oauth)
    ctl = cp.DeploymentController(store, runtime=rt.InProcessRuntime(), gateway=gw)
    dep = cp.SeldonDeployment.from_dict({"name": "cl", "predictors": [
        {"name": "main", "graph": {"name": "clf", "implementation": "SIMPLE_MODEL"}}]})
    store.apply(dep)
    return ctl, gw, dep


@pytest.mark.parametrize("oauth", [None, {"mykey": "mysecret"}])
def test_clients_external_engine_and_gateway_equal(oauth):
    async def go():
        ctl, gw, dep = _gateway(oauth)
        await ctl.reconcile(dep.clone())
        gw_port = free_port()
        gw_task = asyncio.create_task(gw.app().serve_forever("127.0.0.1", gw_port))
        await asyncio.sleep(0.1)
        engine_port = next(iter(ctl.components.values()))[0].spec.http_port
        creds = {"oauth_key": "mykey", "oauth_secret": "mysecret"} if oauth else {}

        def drive(pkg):
            cls = client_cls(pkg)
            ec = cls(engine_endpoint=f"127.0.0.1:{engine_port}")
            r1 = ec.predict(np.array([[1.0, 2.0]]))
            gc = cls(deployment_name="cl", gateway_endpoint=f"127.0.0.1:{gw_port}", **creds)
            r2 = gc.predict(np.array([[1.0, 2.0]]), names=["a", "b"])
            r3 = gc.feedback(r2.request, r2.response, reward=1.0)
            r4 = gc.predict(json_data={"x": 1})
            return r1, r2, r3, r4

        loop = asyncio.get_running_loop()
        try:
            got = {pkg: await loop.run_in_executor(None, drive, pkg) for pkg in PKGS}
        finally:
            gw_task.cancel()
            await ctl.shutdown()
        for a, b in zip(got[JAX], got[PORT]):
            assert scrub(b) == scrub(a)
        r1, r2, r3, _r4 = got[PORT]
        assert r1.success and r1.data.shape == (1, 3)
        assert r2.success and r2.meta.get("puid")
        assert r3.success

    asyncio.run(go())


def test_client_grpc_external_engine_equals_jax():
    from _torch_tools import serve_engine

    _app, _port, gport, stop = serve_engine(
        {"name": "m", "implementation": "SIMPLE_MODEL"}, grpc=True)
    try:
        got = []
        for pkg in PKGS:
            c = client_cls(pkg)(engine_endpoint=f"127.0.0.1:{gport}", transport="grpc")
            p = c.predict(np.array([[1.0, 2.0]]))
            f = c.feedback({"data": {"ndarray": [[1.0]]}}, p.response, reward=1.0)
            got.append((scrub(p), scrub(f)))
        assert got[1] == got[0]
        assert got[1][0][0] and got[1][0][1]["data"]["ndarray"] == [[0.9, 0.05, 0.05]]
    finally:
        stop()


def test_client_oauth_bad_credentials_fail_gracefully():
    async def go():
        ctl, gw, dep = _gateway({"mykey": "mysecret"})
        await ctl.reconcile(dep.clone())
        gw_port = free_port()
        gw_task = asyncio.create_task(gw.app().serve_forever("127.0.0.1", gw_port))
        await asyncio.sleep(0.1)

        def drive(pkg):
            return client_cls(pkg)(deployment_name="cl", gateway_endpoint=f"127.0.0.1:{gw_port}",
                                   oauth_key="mykey", oauth_secret="wrong").predict(
                np.array([[1.0]]))

        loop = asyncio.get_running_loop()
        try:
            got = [await loop.run_in_executor(None, drive, pkg) for pkg in PKGS]
        finally:
            gw_task.cancel()
            await ctl.shutdown()
        for r in got:
            assert not r.success and r.msg.startswith("oauth token:")
        assert got[1].msg == got[0].msg

    asyncio.run(go())

