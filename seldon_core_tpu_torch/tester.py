"""Contract-driven testers + serving-test generator.

Counterpart of ``seldon_core_tpu/tester.py``, with the reference's three
test tools:
  * ``seldon-core-microservice-tester`` — fuzz one wrapped component from a
    contract JSON (reference: python/seldon_core/microservice_tester.py:83-264)
  * ``seldon-core-api-tester`` — same contracts against the external API
    (reference: python/seldon_core/api_tester.py:104)
  * ``seldon-core-tester`` test-file generator from a dataset
    (reference: python/seldon_core/serving_test_gen.py:61)

Contract format (unchanged from the reference so existing contracts work):
``{"features": [{name, ftype: continuous|categorical, dtype, range|values,
shape?, repeat?}], "targets": [...]}``. A numpy generator from the same
seed gives the same batch as the JAX package's tester::

    python -m seldon_core_tpu_torch.tester contract.json HOST PORT -n 10 -b 4
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Any, Dict, List, Optional

import numpy as np

from .client import SeldonClient, SeldonClientResponse

logger = logging.getLogger(__name__)


class ContractError(ValueError):
    pass


def unfold_contract(contract: Dict[str, Any]) -> Dict[str, Any]:
    """Expand `repeat` shorthand into concrete feature/target entries
    (reference: microservice_tester.py:112-140)."""
    out: Dict[str, Any] = {"features": [], "targets": []}
    for section in ("features", "targets"):
        for feature in contract.get(section, []):
            repeat = feature.get("repeat")
            if repeat is None:
                out[section].append(dict(feature))
            else:
                for i in range(int(repeat)):
                    f = dict(feature)
                    del f["repeat"]
                    f["name"] = f"{feature['name']}{i + 1}"
                    out[section].append(f)
    return out


def _gen_continuous(rng: np.random.Generator, f_range, shape) -> np.ndarray:
    lo = -1e3 if f_range[0] in ("inf", "-inf") else float(f_range[0])
    hi = 1e3 if f_range[1] == "inf" else float(f_range[1])
    return rng.uniform(lo, hi, size=shape)


def generate_batch(contract: Dict[str, Any], n: int, field: str = "features",
                   seed: Optional[int] = None) -> np.ndarray:
    """Random batch matching the contract's feature defs
    (reference: microservice_tester.py:83-110)."""
    rng = np.random.default_rng(seed)
    cols: List[np.ndarray] = []
    dtypes = set()
    for fdef in contract[field]:
        ftype = fdef.get("ftype")
        if ftype == "continuous":
            shape = [n] + list(fdef.get("shape", [1]))
            batch = np.around(_gen_continuous(rng, fdef.get("range", ["inf", "inf"]), shape), 3)
            if fdef.get("dtype") == "INT":
                batch = batch.astype(int)
            dtypes.add("num")
        elif ftype == "categorical":
            batch = rng.choice(np.asarray(fdef["values"], dtype=object), size=(n, 1))
            dtypes.add("cat")
        else:
            raise ContractError(f"unknown feature type {ftype!r} for {fdef.get('name')}")
        cols.append(batch.reshape(n, -1))
    out = np.concatenate(cols, axis=1)
    return out if len(dtypes) == 1 else out.astype(object)


def feature_names(contract: Dict[str, Any], field: str = "features") -> List[str]:
    return [f["name"] for f in contract[field]]


def validate_response(contract: Dict[str, Any], response: Dict[str, Any]) -> List[str]:
    """Check a response's data block against the contract's targets;
    returns a list of violations (empty = pass)."""
    problems: List[str] = []
    data = response.get("data")
    if data is None:
        if "strData" in response or "jsonData" in response or "binData" in response:
            return problems
        return ["response has no data block"]
    from .payload import json_data_to_array

    try:
        arr = np.asarray(json_data_to_array(data))
    except Exception as e:  # noqa: BLE001
        return [f"undecodable response data: {e}"]
    targets = contract.get("targets", [])
    if targets and arr.dtype != object:
        widths = [int(np.prod(t.get("shape", [1]))) for t in targets]
        width = sum(widths)
        if arr.ndim == 2 and arr.shape[1] != width:
            problems.append(f"response width {arr.shape[1]} != contract targets width {width}")
        elif arr.ndim == 2:
            col = 0
            for t, w in zip(targets, widths):
                block = arr[:, col:col + w]
                col += w
                if t.get("ftype") == "continuous" and "range" in t:
                    lo, hi = t["range"]
                    lo = -np.inf if lo in ("inf", "-inf") else float(lo)
                    hi = np.inf if hi == "inf" else float(hi)
                    if block.size and (block.min() < lo or block.max() > hi):
                        problems.append(f"target {t['name']}: values outside [{lo}, {hi}]")
    return problems


def run_contract_test(
    client: SeldonClient,
    contract: Dict[str, Any],
    n_requests: int = 1,
    batch_size: int = 1,
    endpoint: str = "predict",
    external: bool = False,
    seed: Optional[int] = None,
    validate: bool = True,
) -> Dict[str, Any]:
    """Fire contract-generated traffic; returns a summary dict."""
    contract = unfold_contract(contract)
    names = feature_names(contract)
    ok = fail = 0
    violations: List[str] = []
    for i in range(n_requests):
        batch = generate_batch(contract, batch_size, seed=None if seed is None else seed + i)
        if endpoint == "send-feedback":
            request = {"data": {"names": names, "ndarray": batch.tolist()}}
            truth = generate_batch(contract, batch_size, field="targets",
                                   seed=None if seed is None else seed + i)
            response = {"data": {"ndarray": truth.tolist()}}
            if external:
                resp = client.feedback(request, response, reward=1.0)
            else:
                resp = client.microservice_feedback(request, response, reward=1.0)
        elif external:
            resp = client.predict(batch, names=names)
        else:
            resp = client.microservice(batch, method=endpoint, names=names)
        if resp.success:
            probs = validate_response(contract, resp.response or {}) if (
                validate and endpoint in ("predict", "transform-input", "transform-output")
            ) else []
            if probs:
                violations.extend(probs)
                fail += 1
            else:
                ok += 1
        else:
            fail += 1
            violations.append(resp.msg)
    return {"requests": n_requests, "ok": ok, "failed": fail, "violations": violations[:20]}


# -- serving-test generator -------------------------------------------------


def generate_contract_from_data(
    X: np.ndarray,
    names: Optional[List[str]] = None,
    targets: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Infer a contract from a sample batch (reference:
    serving_test_gen.py:61 create_seldon_api_testing_file, column ranges
    from the dataframe)."""
    X = np.asarray(X)
    if X.ndim == 1:
        X = X.reshape(-1, 1)
    features = []
    for j in range(X.shape[1]):
        name = names[j] if names and j < len(names) else f"f{j}"
        col = X[:, j]
        if col.dtype.kind in "OUS":
            features.append(
                {"name": name, "ftype": "categorical",
                 "dtype": "STRING", "values": sorted({str(v) for v in col})}
            )
        else:
            col = col.astype(float)
            features.append(
                {"name": name, "ftype": "continuous",
                 "dtype": "INT" if np.allclose(col, col.astype(int)) else "FLOAT",
                 "range": [float(col.min()), float(col.max())]}
            )
    return {"features": features, "targets": targets or []}


# -- CLI --------------------------------------------------------------------


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("seldon-tpu-torch-tester")
    parser.add_argument("contract", help="path to contract JSON")
    parser.add_argument("host")
    parser.add_argument("port", type=int)
    parser.add_argument("--endpoint", default="predict",
                        choices=["predict", "transform-input", "transform-output",
                                 "route", "send-feedback"])
    parser.add_argument("-n", "--n-requests", type=int, default=1)
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument("--grpc", action="store_true")
    parser.add_argument("--api", action="store_true",
                        help="drive the external engine/gateway API instead of a microservice")
    parser.add_argument("--deployment", help="deployment name (gateway mode)")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("-p", "--prnt", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level="INFO")
    with open(args.contract) as f:
        contract = json.load(f)
    endpoint_addr = f"{args.host}:{args.port}"
    if args.api and args.deployment:
        if args.grpc:
            parser.error(
                "the gateway serves REST only; point --api at an engine "
                "host:port (drop --deployment) for gRPC"
            )
        client = SeldonClient(
            deployment_name=args.deployment, namespace=args.namespace,
            gateway_endpoint=endpoint_addr,
            transport="grpc" if args.grpc else "rest",
        )
    elif args.api:
        client = SeldonClient(engine_endpoint=endpoint_addr,
                              transport="grpc" if args.grpc else "rest")
    else:
        client = SeldonClient(microservice_endpoint=endpoint_addr,
                              transport="grpc" if args.grpc else "rest")
    summary = run_contract_test(
        client, contract,
        n_requests=args.n_requests, batch_size=args.batch_size,
        endpoint=args.endpoint, external=args.api, seed=args.seed,
    )
    print(json.dumps(summary))
    if summary["failed"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
