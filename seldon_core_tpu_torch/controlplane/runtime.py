"""Component runtimes: how the reconciler materializes desired state.

Counterpart of ``seldon_core_tpu/controlplane/runtime.py``. The
reference operator emits K8s Deployments and lets kubelet run pods
(reference: operator/controllers/seldondeployment_controller.go:855-900);
here a runtime starts the same logical components on the CUDA host:

  * ``InProcessRuntime`` — engines and microservices as asyncio servers
    inside the controller process, on real localhost ports. This is both
    the test tier (SURVEY §4: in-process fake placement) and the
    single-host production mode: co-located graph units stay INPROCESS so
    a request never leaves the process between nodes.
  * ``SubprocessRuntime`` — one OS process per component, env-injected
    exactly like the engine sidecar (``ENGINE_PREDICTOR`` b64 —
    reference: operator/controllers/seldondeployment_engine.go:101-214)
    and the wrapper (``PREDICTIVE_UNIT_PARAMETERS`` env). The children
    are ``seldon_core_tpu_torch.engine_main`` and
    ``seldon_core_tpu_torch.microservice``, on the card by their own
    default: nothing here passes a device.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


DRAIN_ANNOTATION = "seldon.io/drain-seconds"
DEFAULT_DRAIN_S = 10.0


def _drain_seconds(spec: "ComponentSpec") -> float:
    """Rolling-update drain budget from the predictor's annotations
    (``seldon.io/drain-seconds``, default 10 — the reference's preStop
    sleep made configurable)."""
    ann = (spec.engine_spec or {}).get("annotations") or {}
    try:
        return float(ann.get(DRAIN_ANNOTATION, DEFAULT_DRAIN_S))
    except (TypeError, ValueError):
        return DEFAULT_DRAIN_S


@dataclass
class ComponentSpec:
    """One schedulable unit: an engine, a microservice, or an explainer."""

    name: str  # unique within the runtime, e.g. "default/dep/predictor-0/engine"
    kind: str  # "engine" | "microservice" | "explainer"
    deployment: str
    predictor: str
    replica: int = 0
    # engine kinds carry the full predictor spec dict; microservices carry
    # the interface name + parameters
    engine_spec: Optional[Dict[str, Any]] = None
    interface_name: Optional[str] = None
    parameters: Optional[List[Dict[str, Any]]] = None
    env: Dict[str, str] = field(default_factory=dict)
    http_port: int = 0
    grpc_port: int = 0
    # routable components receive external traffic from the gateway:
    # engines, and direct-exposed models in no-engine mode
    routable: bool = False
    # a device mesh over the engine's placement-allocated block (sharded
    # serving: not ported yet, so always None here)
    mesh: Any = None


class ComponentHandle:
    """A running component; reconciler tracks these by spec name."""

    def __init__(self, spec: ComponentSpec):
        self.spec = spec
        # absolute start stamp, display/status only — never interval math
        # seldon-lint: disable=wall-clock
        self.started_at = time.time()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.spec.http_port}"

    async def ready(self) -> bool:  # pragma: no cover - overridden
        raise NotImplementedError

    async def stop(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    async def load(self) -> Optional[float]:
        """In-flight request concurrency (autoscaler signal); None when
        this component kind has no load probe."""
        return None

    async def fleet(self) -> Optional[dict]:
        """This member's /fleet telemetry payload (metric snapshot +
        profiler/burn summaries); None when the component kind has no
        fleet scrape."""
        return None

    async def retune(
        self, knobs: dict, origin: str = "planner"
    ) -> Optional[dict]:
        """Actuate a live scheduler retune on this member through the
        safe path (the engine's POST /retune — staged, validated against
        the boot compile census, applied at a poll boundary). Returns
        the per-unit ``{"changed": ...}`` payload, or None when the
        component kind has no retune surface. Out-of-census refusals
        raise (typed RetuneError in-process, HTTP 409 over the wire) —
        the planner prunes those configs instead of retrying."""
        return None


class _InProcessHandle(ComponentHandle):
    def __init__(
        self,
        spec: ComponentSpec,
        tasks: List[asyncio.Task],
        probe,
        grpc_server=None,
        app=None,
        rest_app=None,
    ):
        super().__init__(spec)
        self._tasks = tasks
        self._probe = probe
        self._grpc_server = grpc_server
        self.app = app
        self.rest_app = rest_app

    async def ready(self) -> bool:
        try:
            out = self._probe()
            if asyncio.iscoroutine(out):
                out = await out
            return bool(out)
        except Exception:
            return False

    async def load(self) -> Optional[float]:
        if self.app is None:
            return None
        return float(getattr(self.app, "inflight", 0))

    async def fleet(self) -> Optional[dict]:
        fn = getattr(self.app, "fleet_summary", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 - telemetry must not fail ops
            return None

    async def retune(
        self, knobs: dict, origin: str = "planner"
    ) -> Optional[dict]:
        walk = getattr(self.app, "units_with", None)
        if walk is None:
            return None
        targets = list(walk("retune"))
        if not targets:
            return None
        loop = asyncio.get_running_loop()
        units: dict = {}
        for name, target in targets:
            # blocking until the scheduler's poll boundary: off the
            # event loop (same discipline as the /retune route).
            # RetuneError propagates — an out-of-census config is the
            # planner's signal to prune, not a fault to swallow.
            units[name] = await loop.run_in_executor(
                None, lambda f=target.retune: f(knobs, origin)
            )
        return {"units": units}

    async def stop(self) -> None:
        # graceful drain before teardown (reference preStop idiom:
        # `curl /pause; sleep 10` — seldondeployment_engine.go:173-177;
        # here pause ALWAYS rejects new work first, then the wait is
        # exact on the in-flight gauge, bounded by seldon.io/drain-seconds)
        if self.app is not None:
            self.app.paused = True
            drain_s = _drain_seconds(self.spec)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + drain_s
            while getattr(self.app, "inflight", 0) > 0 and loop.time() < deadline:
                await asyncio.sleep(0.02)
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=0.1)
        tasks = list(self._tasks)
        # engine handles: the readiness poll loop and the executor's unit
        # clients outlive the server tasks unless shut down here — leaking
        # them keeps dead graphs polling forever across rolling updates
        if self.app is not None:
            ready_task = getattr(self.app, "_ready_task", None)
            if ready_task is not None:
                tasks.append(ready_task)
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        if self.app is not None:
            try:
                await self.app.executor.close()
            except Exception:  # noqa: BLE001
                pass
            # the CloudEvents sink owns a worker thread + queue; without
            # this, every rolling update leaks one per replaced engine
            sink = getattr(getattr(self.app, "request_logger", None), "sink", None)
            if sink is not None and hasattr(sink, "close"):
                try:
                    sink.close()
                except Exception:  # noqa: BLE001
                    pass
        pool = getattr(self.rest_app, "_hook_pool", None)
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


class InProcessRuntime:
    """Run components as asyncio servers in the controller's loop."""

    def __init__(self, open_ports: bool = True, grpc: bool = False):
        # open_ports=False → don't bind sockets (pure logical placement,
        # the reconciler-unit-test mode); engine apps are still constructed
        # and reachable via handle.app
        self.open_ports = open_ports
        self.grpc = grpc

    async def start(self, spec: ComponentSpec) -> ComponentHandle:
        from ..graph.service import EngineApp
        from ..graph.spec import PredictorSpec, default_predictor, validate_predictor

        if spec.kind == "engine":
            from ..graph.service import RequestLogger

            pspec = PredictorSpec.from_dict(spec.engine_spec)
            pspec = default_predictor(pspec)
            validate_predictor(pspec)
            app = EngineApp(
                pspec, mesh=spec.mesh, request_logger=RequestLogger.from_env()
            )
            app.start_readiness_loop()
            tasks = []
            if self.open_ports:
                spec.http_port = spec.http_port or free_port()
                rest = app.rest_app()
                # bind BEFORE returning the handle: readiness is probed
                # in-process (no socket), so a lazily-bound listener could
                # report Available while the port still refuses connections
                await rest.start("127.0.0.1", spec.http_port)
                tasks.append(asyncio.create_task(rest.serve()))
            grpc_server = None
            if self.open_ports and self.grpc:
                spec.grpc_port = spec.grpc_port or free_port()
                grpc_server = app.grpc_server()
                grpc_server.add_insecure_port(f"127.0.0.1:{spec.grpc_port}")
                await grpc_server.start()
            # probe the graph directly rather than app.graph_ready — the
            # cached flag initializes True before the first poll, which would
            # make the reconciler's rolling-update readiness gate vacuous
            handle = _InProcessHandle(
                spec, tasks, lambda: app.executor.ready(), grpc_server, app=app
            )
            return handle

        if spec.kind in ("microservice", "explainer"):
            from ..microservice import build_user_object
            from ..wrapper import ServerState, get_rest_microservice
            import json as _json

            user_object = build_user_object(
                spec.interface_name, _json.dumps(spec.parameters or [])
            )
            if hasattr(user_object, "load"):
                await asyncio.get_running_loop().run_in_executor(None, user_object.load)
            state = ServerState()
            rest = get_rest_microservice(user_object, state)
            tasks = []
            if self.open_ports:
                spec.http_port = spec.http_port or free_port()
                await rest.start("127.0.0.1", spec.http_port)
                tasks.append(asyncio.create_task(rest.serve()))
            handle = _InProcessHandle(
                spec,
                tasks,
                lambda: state.ready and (not tasks or rest.is_serving()),
                rest_app=rest,
            )
            handle.user_object = user_object
            return handle

        raise ValueError(f"unknown component kind {spec.kind!r}")


class _SubprocessHandle(ComponentHandle):
    def __init__(self, spec: ComponentSpec, proc: subprocess.Popen):
        super().__init__(spec)
        self.proc = proc

    async def ready(self) -> bool:
        if self.proc.poll() is not None:
            return False

        def probe() -> bool:
            try:
                with urllib.request.urlopen(f"{self.url}/ready", timeout=1.0) as r:
                    return r.status == 200
            except Exception:
                return False

        return await asyncio.get_running_loop().run_in_executor(None, probe)

    def _probe_inflight(self) -> Optional[float]:
        """GET /inflight. Returns the gauge, 0.0 when the process is GONE
        (connection refused / dead proc — nothing left to drain), or None
        when the state is UNKNOWN (timeout, slow event loop): callers must
        keep waiting on None, not treat it as drained — probes time out
        exactly when the engine is busiest."""
        if self.proc.poll() is not None:
            return 0.0
        try:
            with urllib.request.urlopen(f"{self.url}/inflight", timeout=0.5) as r:
                return float(json.loads(r.read()).get("inflight", 0))
        except urllib.error.URLError as e:
            if isinstance(getattr(e, "reason", None), ConnectionRefusedError):
                return 0.0
            return None
        except Exception:
            return None

    async def load(self) -> Optional[float]:
        out = await asyncio.get_running_loop().run_in_executor(
            None, self._probe_inflight
        )
        return None if out is None else out

    async def fleet(self) -> Optional[dict]:
        if self.proc.poll() is not None:
            return None

        def probe() -> Optional[dict]:
            try:
                with urllib.request.urlopen(
                    f"{self.url}/fleet", timeout=2.0
                ) as r:
                    return json.loads(r.read())
            except Exception:
                return None

        return await asyncio.get_running_loop().run_in_executor(None, probe)

    async def retune(
        self, knobs: dict, origin: str = "planner"
    ) -> Optional[dict]:
        if self.proc.poll() is not None:
            return None

        def post() -> Optional[dict]:
            body = json.dumps(
                {"knobs": knobs, "origin": origin}
            ).encode()
            req = urllib.request.Request(
                f"{self.url}/retune", data=body,
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=15.0) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code == 409:
                    # out-of-census refusal: surface it typed so the
                    # planner prunes the config (parity with the
                    # in-process RetuneError path)
                    from ..serving.continuous import RetuneError

                    raise RetuneError(e.read().decode()) from None
                if e.code == 501:
                    return None  # member has no retune surface
                raise
            except Exception:  # noqa: BLE001 - member mid-restart
                return None

        return await asyncio.get_running_loop().run_in_executor(None, post)

    async def drain_to(self, peer: str, timeout_s: float) -> Optional[dict]:
        """POST /drain {"to": peer}: the member checkpoints its in-flight
        generations and hands them to the peer engine at ``host:port``;
        its pending requests answer with the peer's tokens. Returns the
        per-unit summaries, or None when the member has no generate unit
        (501) or is gone."""
        if self.proc.poll() is not None:
            return None

        def post() -> Optional[dict]:
            body = json.dumps({"to": peer, "timeout_s": timeout_s}).encode()
            req = urllib.request.Request(
                f"{self.url}/drain", data=body,
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=timeout_s + 10.0) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code == 501:
                    return None
                raise

        return await asyncio.get_running_loop().run_in_executor(None, post)

    async def stop(self) -> None:
        # graceful drain first (reference preStop: curl /pause; sleep —
        # operator/controllers/seldondeployment_engine.go:173-177): pause
        # rejects new work, then poll /inflight until live requests hit
        # zero (exact, not a fixed sleep), bounded by seldon.io/drain-seconds
        loop = asyncio.get_running_loop()

        def pause():
            try:
                urllib.request.urlopen(f"{self.url}/pause", timeout=0.5).read()
            except Exception:
                pass

        await loop.run_in_executor(None, pause)
        deadline = loop.time() + _drain_seconds(self.spec)
        while loop.time() < deadline:
            n = await loop.run_in_executor(None, self._probe_inflight)
            if n is not None and n <= 0:
                break
            await asyncio.sleep(0.1)
        self.proc.terminate()
        try:
            await asyncio.get_running_loop().run_in_executor(None, self.proc.wait, 5)
        except Exception:
            self.proc.kill()


class SubprocessRuntime:
    """One OS process per component (the multi-process production mode)."""

    def __init__(self, python: str = sys.executable):
        self.python = python

    async def start(self, spec: ComponentSpec) -> ComponentHandle:
        import base64
        import json as _json

        spec.http_port = spec.http_port or free_port()
        env = {**os.environ, **spec.env}
        # scope persisted component state per deployment/predictor
        # (persistence.state_key reads these — reference: persistence.py:21)
        env.setdefault("SELDON_DEPLOYMENT_ID", spec.deployment.replace("/", "-"))
        env.setdefault("PREDICTOR_ID", spec.predictor)
        if spec.kind == "engine":
            env["ENGINE_PREDICTOR"] = base64.b64encode(
                _json.dumps(spec.engine_spec).encode()
            ).decode()
            cmd = [
                self.python, "-m", "seldon_core_tpu_torch.engine_main",
                "--host", "127.0.0.1",
                "--http-port", str(spec.http_port),
                "--no-grpc",
            ]
        else:
            env["PREDICTIVE_UNIT_PARAMETERS"] = _json.dumps(spec.parameters or [])
            env["PREDICTIVE_UNIT_SERVICE_PORT"] = str(spec.http_port)
            cmd = [
                self.python, "-m", "seldon_core_tpu_torch.microservice",
                spec.interface_name, "REST",
                "--host", "127.0.0.1",
                "--service-port", str(spec.http_port),
            ]
        proc = subprocess.Popen(cmd, env=env)
        return _SubprocessHandle(spec, proc)
