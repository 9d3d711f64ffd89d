"""Control-plane CLI: apply/get/delete deployments + run the controller.

Counterpart of ``seldon_core_tpu/controlplane/cli.py``: the port's
``sdctl`` (console script ``seldon-tpu-torch-ctl``), a kubectl-equivalent
for the file-backed resource store (the reference's users drive the
operator with `kubectl apply -f deployment.json` — reference:
testing/scripts/test_prepackaged_servers.py:7-35):

    python -m seldon_core_tpu_torch.controlplane apply -f dep.json
    python -m seldon_core_tpu_torch.controlplane get [name]
    python -m seldon_core_tpu_torch.controlplane scale <name> <replicas> [--predictor P]
    python -m seldon_core_tpu_torch.controlplane status <name>
    python -m seldon_core_tpu_torch.controlplane delete <name>
    python -m seldon_core_tpu_torch.controlplane controller --subprocess-runtime --gateway-port 8003

``render``, ``crd``, ``controller --kube`` (Kubernetes objects and the
live-cluster operator, ``k8s.py``/``kube.py``) and ``build`` (the image
build, ``build.py``) are not ported yet and exit naming the module they
wait for.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys
import tempfile

from .ingress import Gateway
from .reconciler import DeploymentController
from .resource import SeldonDeployment
from .runtime import InProcessRuntime, SubprocessRuntime
from .store import ResourceStore
from .placement import DevicePlacement

DEFAULT_STORE = os.environ.get(
    "SELDON_TPU_STORE", os.path.join(tempfile.gettempdir(), "seldon-tpu-torch-store")
)


def _not_ported(what: str, module: str) -> None:
    raise SystemExit(
        f"{what} is not ported to seldon_core_tpu_torch yet (waits for {module})"
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("seldon-tpu-torch-ctl")
    parser.add_argument("--store-dir", default=DEFAULT_STORE)
    parser.add_argument("--namespace", "-n", default="default")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_apply = sub.add_parser("apply")
    p_apply.add_argument("-f", "--filename", required=True)

    p_get = sub.add_parser("get")
    p_get.add_argument("name", nargs="?")

    p_delete = sub.add_parser("delete")
    p_delete.add_argument("name")

    p_scale = sub.add_parser(
        "scale", help="set a predictor's replica count (kubectl scale parity)"
    )
    p_scale.add_argument("name")
    p_scale.add_argument("replicas", type=int)
    p_scale.add_argument(
        "--predictor", default=None,
        help="predictor to scale (default: the only one; required when several)",
    )

    p_status = sub.add_parser(
        "status", help="per-predictor replica/traffic rollup for one deployment"
    )
    p_status.add_argument("name")

    p_render = sub.add_parser(
        "render",
        help="emit Kubernetes YAML for a SeldonDeployment (not ported yet)",
    )
    p_render.add_argument("-f", "--filename", required=True)
    p_render.add_argument("-o", "--output", default="-",
                          help="output file (default stdout)")

    sub.add_parser(
        "crd",
        help="print the SeldonDeployment CustomResourceDefinition YAML "
        "(not ported yet)",
    )

    p_ctl = sub.add_parser("controller")
    p_ctl.add_argument("--gateway-port", type=int, default=int(os.environ.get("GATEWAY_PORT", 8003)))
    p_ctl.add_argument("--subprocess-runtime", action="store_true",
                       help="one OS process per component instead of in-process asyncio")
    p_ctl.add_argument("--placement", action="store_true",
                       help="count engines against the host's CUDA devices "
                       "(a generation that does not fit is refused)")
    p_ctl.add_argument("--poll-s", type=float, default=1.0,
                       help="store re-scan period (picks up sdctl writes from other processes)")
    p_ctl.add_argument("--kube", action="store_true",
                       help="operator mode on a live cluster (not ported yet)")
    p_ctl.add_argument("--kube-server", default=None,
                       help="kube-apiserver URL (default: in-cluster; use "
                       "`kubectl proxy` + http://127.0.0.1:8001 from a laptop)")
    p_ctl.add_argument("--kube-token", default=None,
                       help="bearer token (default: in-cluster service account)")
    p_ctl.add_argument("--resync-s", type=float, default=30.0,
                       help="kube mode: level-triggered reconcile period")
    p_ctl.add_argument("--once", action="store_true",
                       help="kube mode: one reconcile pass then exit "
                       "(GitOps/CI: converge and report, no daemon)")
    p_ctl.add_argument("--leader-elect", action="store_true",
                       help="kube mode: coordination.k8s.io Lease leader "
                       "election — run replicas for HA; only the leader "
                       "reconciles")
    p_ctl.add_argument("--lease-duration-s", type=float, default=15.0,
                       help="kube mode: leader lease duration (takeover "
                       "happens within ~one duration of a leader dying)")

    p_build = sub.add_parser(
        "build",
        help="user code -> servable image build context (not ported yet)",
    )
    p_build.add_argument("--src", required=True,
                         help="directory with the user component")
    p_build.add_argument("--model-name", required=True,
                         help="module.Class (python) or a label (cpp)")
    p_build.add_argument("--api-type", default="REST",
                         choices=["REST", "GRPC", "BOTH", "FBS"])
    p_build.add_argument("--service-type", default="MODEL",
                         choices=["MODEL", "ROUTER", "TRANSFORMER",
                                  "OUTPUT_TRANSFORMER", "COMBINER"])
    p_build.add_argument("--persistence", action="store_true")
    p_build.add_argument("--language", default="python",
                         choices=["python", "cpp"])
    p_build.add_argument("--out", required=True,
                         help="build-context output directory")
    p_build.add_argument("--image", default=None,
                         help="also run `docker build -t IMAGE` when a "
                         "docker CLI is present")

    args = parser.parse_args(argv)
    logging.basicConfig(level="INFO", format="%(asctime)s %(name)s %(levelname)s %(message)s")

    if args.cmd == "build":
        _not_ported("sdctl build", "build.py")
    store = ResourceStore(persist_dir=args.store_dir)

    if args.cmd == "apply":
        with open(args.filename) as f:
            dep = SeldonDeployment.from_dict(json.load(f))
        if dep.namespace == "default" and args.namespace != "default":
            dep.namespace = args.namespace
        dep, event = store.apply(dep)
        print(f"seldondeployment.machinelearning.seldon.io/{dep.name} {event.lower()}")
        return

    if args.cmd == "render":
        _not_ported("sdctl render", "k8s.py")

    if args.cmd == "crd":
        _not_ported("sdctl crd", "k8s.py and kube.py")

    if args.cmd == "get":
        deps = store.list(args.namespace)
        if args.name:
            deps = [d for d in deps if d.name == args.name]
            if not deps:
                print(f"not found: {args.name}", file=sys.stderr)
                raise SystemExit(1)
            print(json.dumps(deps[0].to_dict(), indent=2))
            return
        for d in deps:
            s = d.status
            print(f"{d.namespace}/{d.name}\tgen={d.generation}\t{s.state}\t{s.description}")
        return

    if args.cmd == "delete":
        ok = store.delete(args.name, args.namespace)
        print(
            f"seldondeployment.machinelearning.seldon.io/{args.name} "
            + ("deleted" if ok else "not found")
        )
        return

    if args.cmd == "scale":
        dep = store.get(args.name, args.namespace)
        if dep is None:
            print(f"not found: {args.name}", file=sys.stderr)
            raise SystemExit(1)
        dep = dep.clone()
        candidates = [
            p for p in dep.predictors
            if args.predictor is None or p.name == args.predictor
        ]
        if args.predictor is None and len(candidates) > 1:
            names = [p.name for p in dep.predictors]
            print(f"deployment has predictors {names}; pass --predictor", file=sys.stderr)
            raise SystemExit(1)
        if not candidates:
            print(f"no predictor {args.predictor!r} in {args.name}", file=sys.stderr)
            raise SystemExit(1)
        if args.replicas < 1:
            print("replicas must be >= 1", file=sys.stderr)
            raise SystemExit(1)
        candidates[0].replicas = args.replicas
        store.apply(dep)  # generation bump -> controller reconciles
        print(
            f"seldondeployment.machinelearning.seldon.io/{args.name} "
            f"predictor {candidates[0].name} scaled to {args.replicas}"
        )
        return

    if args.cmd == "status":
        dep = store.get(args.name, args.namespace)
        if dep is None:
            print(f"not found: {args.name}", file=sys.stderr)
            raise SystemExit(1)
        s = dep.status
        print(f"{dep.namespace}/{dep.name}  gen={dep.generation}  {s.state}  {s.description}")
        by_name = {ps.name: ps for ps in s.predictor_status}
        for p in dep.predictors:
            ps = by_name.get(p.name)
            avail = f"{ps.replicas_available}/{ps.replicas}" if ps else "?/?"
            extras = []
            if p.hpa_spec:
                extras.append(
                    f"hpa {p.hpa_spec.get('minReplicas', 1)}-{p.hpa_spec.get('maxReplicas')}"
                )
            if p.tpu_mesh:
                extras.append(f"mesh {p.tpu_mesh}")
            print(
                f"  {p.name}\treplicas {avail}\ttraffic {p.traffic}%"
                + ("\t" + ", ".join(extras) if extras else "")
            )
        return

    if args.cmd == "controller" and args.kube:
        _not_ported("sdctl controller --kube", "kube.py")

    if args.cmd == "controller":
        runtime = SubprocessRuntime() if args.subprocess_runtime else InProcessRuntime()
        placement = DevicePlacement() if args.placement else None
        gateway = Gateway()
        controller = DeploymentController(
            store, runtime=runtime, placement=placement, gateway=gateway
        )

        async def run():
            # SIGTERM/SIGINT stop the loop and every component this
            # controller started: a child outliving its controller would
            # keep its device memory with no one to stop it
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                loop.add_signal_handler(sig, stop.set)
            tasks = [
                asyncio.create_task(controller.run(stop)),
                asyncio.create_task(
                    gateway.app().serve_forever("0.0.0.0", args.gateway_port)
                ),
                asyncio.create_task(_rescan_loop(store, args.store_dir, args.poll_s)),
            ]
            try:
                await stop.wait()
            finally:
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                await controller.shutdown()

        try:
            asyncio.run(run())
        except KeyboardInterrupt:
            pass
        return


async def _rescan_loop(store: ResourceStore, persist_dir: str, period_s: float) -> None:
    """Pick up applies/deletes written by other sdctl processes: re-read the
    persist dir and diff against the in-memory view."""
    loop = asyncio.get_running_loop()
    while True:
        await asyncio.sleep(period_s)
        try:
            # file parsing off the loop so big stores don't stall the gateway
            fresh = await loop.run_in_executor(
                None, lambda: ResourceStore(persist_dir=persist_dir)
            )
        except Exception:
            continue
        fresh_keys = {d.key for d in fresh.list()}
        for dep in fresh.list():
            mine = store.get(dep.name, dep.namespace)
            if (
                mine is None
                or mine.spec_hash() != dep.spec_hash()
                or mine.annotations != dep.annotations
            ):
                store.apply(dep)
        for dep in list(store.list()):
            if dep.key not in fresh_keys:
                store.delete(dep.name, dep.namespace)


if __name__ == "__main__":
    main()
