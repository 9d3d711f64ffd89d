"""Deployment reconciler: SeldonDeployment resources → running components.

Counterpart of ``seldon_core_tpu/controlplane/reconciler.py``. Parity
with the operator's reconcile loop (reference: operator/controllers/
seldondeployment_controller.go:253-391,1067-1122): per predictor it runs
the admission defaulting/validation, the model-initializer (modelUri
download — reference: operator/controllers/
model_initializer_injector.go:65-242), prepackaged server wiring
(reference: seldondeployment_prepackaged_servers.go:30-176), device
placement over the host's CUDA devices (replaces node-pool scheduling),
engine injection with the b64 graph env (reference:
seldondeployment_engine.go:101-214), explainer components (reference:
seldondeployment_explainers.go:32-187), then diffs desired vs running
components, performs create-before-delete rolling updates, and rolls the
status up to Creating/Available/Failed. Sharded serving
(``seldon.io/mesh``, a predictor ``tpuMesh``) is not ported yet: such a
deployment fails its reconcile.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..graph.spec import (
    ANNOTATION_KV_TIER_BYTES,
    ANNOTATION_MESH,
    ANNOTATION_TENANTS,
    GraphSpecError,
    PREPACKAGED_SERVERS,
    PredictorSpec,
    default_predictor,
    inject_kv_tier_param,
    inject_tenants_param,
    parse_disagg_annotations,
    parse_kv_tier_annotation,
    parse_mesh_annotation,
    parse_tenants_annotation,
    validate_deployment,
)
from ..storage import Storage
from .resource import (
    STATE_AVAILABLE,
    STATE_CREATING,
    STATE_FAILED,
    DeploymentStatus,
    PredictorStatus,
    SeldonDeployment,
)
from .runtime import ComponentHandle, ComponentSpec, InProcessRuntime
from .store import EVENT_DELETED, ResourceStore
from .placement import DevicePlacement, PlacementError

logger = logging.getLogger(__name__)

# annotation keys (reference: seldondeployment_types.go:35-45 k8s
# annotations-as-feature-flags, delivered via podinfo downward API)
ANNOTATION_SEPARATE_ENGINE = "seldon.io/engine-separate-pod"
ANNOTATION_NO_ENGINE = "seldon.io/no-engine"


class DeploymentController:
    def __init__(
        self,
        store: ResourceStore,
        runtime: Optional[InProcessRuntime] = None,
        placement: Optional[DevicePlacement] = None,
        gateway=None,
        model_cache_dir: Optional[str] = None,
        ready_timeout_s: float = 30.0,
    ):
        self.store = store
        self.runtime = runtime or InProcessRuntime()
        self.placement = placement
        self.gateway = gateway
        self.model_cache_dir = model_cache_dir
        self.ready_timeout_s = ready_timeout_s
        # component-name -> (handle, spec_hash of owning deployment)
        self.components: Dict[str, Tuple[ComponentHandle, str]] = {}
        self._reconciling: Dict[str, asyncio.Lock] = {}
        # autoscaler state: (dep.key, predictor) -> consecutive ticks that
        # wanted a scale-DOWN (stabilization window, like the k8s HPA's)
        self.autoscale_period_s = 5.0
        self.scale_down_ticks = 3
        self._scale_down_streak: Dict[Tuple[str, str], int] = {}
        # progressive delivery: the rollout state machines tick alongside
        # the autoscaler (rollout/controller.py); weight updates land as
        # store.apply generation bumps this controller then reconciles
        from ..rollout import RolloutController

        self.rollout = RolloutController(store)
        self.rollout_period_s = 1.0
        # disaggregated serving: (dep.key, predictor, prefill index) ->
        # KV transport port. Allocated once and reused across reconciles
        # so a decode-pool scale event keeps pointing at live prefill
        # listeners instead of re-rolling every peer address.
        self._kv_ports: Dict[Tuple[str, str, int], int] = {}
        # fleet telemetry plane: a deployment-scope metrics registry every
        # member's /fleet snapshot merges into (per-member deltas, so a
        # member restart resets cleanly), the previous snapshot per member
        # the delta is diffed against, and the latest SLO burn verdicts
        # per (dep.key, predictor) — the autoscaler's page-veto signal
        from ..graph.engine_metrics import MetricsRegistry

        self.fleet_metrics = MetricsRegistry()
        self.fleet_period_s = 5.0
        self._fleet_prev: Dict[str, Dict] = {}
        self._fleet_units: Dict[str, Dict] = {}
        self._burn_verdicts: Dict[Tuple[str, str], List[Dict]] = {}
        # autonomic planning (planning/planner.py): one decision table
        # per (dep.key, predictor) that opted in via seldon.io/planner,
        # ticked next to the fleet scrape. Decisions actuate ONLY
        # through safe paths — handle.retune() lands at a poll
        # boundary, scale decisions rewrite replicas through the same
        # clamped spec path the HPA uses — and precedence with the
        # autoscaler is deterministic: a burn-verdict page VETOES any
        # same-tick scale-down (counted below), and any planner scale
        # change resets the autoscaler's stabilization streak so the
        # two controllers share ONE hysteresis window (docs/operate.md
        # §"Autonomic planning").
        self.planner_period_s = 5.0
        self._planners: Dict[Tuple[str, str], Any] = {}
        self._planner_profiles: Dict[str, Any] = {}  # path -> CostModel|None
        self._planner_events: deque = deque(maxlen=256)
        self.planner_stats = {
            "ticks": 0, "retunes": 0, "retunes_refused": 0,
            "scale_ups": 0, "scale_downs": 0, "vetoes": 0, "holds": 0,
        }

    # -- desired state ------------------------------------------------------

    async def _initialize_models(self, pspec: PredictorSpec) -> None:
        """Model-initializer: pull every unit's modelUri to local disk and
        point the unit at the local copy (reference: init-container download
        into emptyDir /mnt/models, model_initializer_injector.go:65-242).
        Downloads run on the default executor so a multi-GB pull doesn't
        stall the controller loop (or the co-hosted gateway)."""
        loop = asyncio.get_running_loop()
        for unit in pspec.graph.walk():
            if not unit.model_uri:
                continue
            scheme = unit.model_uri.split("://", 1)[0] if "://" in unit.model_uri else ""
            if scheme in ("", "file"):
                continue  # already local
            out_dir = (
                None if self.model_cache_dir is None else f"{self.model_cache_dir}/{unit.name}"
            )
            unit.model_uri = await loop.run_in_executor(
                None, Storage.download, unit.model_uri, out_dir
            )

    @staticmethod
    def _component_hash(dep: SeldonDeployment) -> str:
        """Spec hash extended with annotations: annotation flips (e.g.
        separate-engine) must produce new component names so running
        engines are replaced, not half-updated.

        Replica COUNTS are excluded: a scale event (autoscaler or manual
        `replicas` bump) must add/remove replica components without
        renaming — and so recreating — the survivors (the reference's HPA
        scales the Deployment without a pod-template change)."""
        import hashlib
        import json as _json

        blob = dep.spec_hash(include_replicas=False) + _json.dumps(
            dep.annotations, sort_keys=True
        )
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    async def desired_components(self, dep: SeldonDeployment) -> List[ComponentSpec]:
        specs: List[ComponentSpec] = []
        h = self._component_hash(dep)
        no_engine = dep.annotations.get(ANNOTATION_NO_ENGINE, "false") == "true"
        for pspec in dep.predictors:
            if pspec.tpu_mesh:
                raise GraphSpecError(
                    f"{pspec.name}: a predictor tpuMesh (sharded serving) is "
                    "not ported to seldon_core_tpu_torch yet"
                )
            separate = dep.annotations.get(ANNOTATION_SEPARATE_ENGINE, "false") == "true"
            pspec = default_predictor(pspec, separate_pods=False)
            await self._initialize_models(pspec)
            # separate-pod units become standalone microservices; their ports
            # are allocated here and written back into the engine graph so
            # the engine's REST client dials the real socket (reference:
            # createStandaloneModelServers prepackaged_servers.go:248)
            if separate:
                for unit in pspec.graph.walk():
                    if unit.endpoint.transport in ("REST", "GRPC") and unit.implementation in PREPACKAGED_SERVERS:
                        from .runtime import free_port

                        port = free_port()
                        unit.endpoint.transport = "REST"
                        unit.endpoint.service_host = "127.0.0.1"
                        unit.endpoint.service_port = port
                        specs.append(
                            ComponentSpec(
                                name=f"{dep.key}/{pspec.name}/{unit.name}/svc-{h[:8]}",
                                kind="microservice",
                                deployment=dep.key,
                                predictor=pspec.name,
                                interface_name=PREPACKAGED_SERVERS[unit.implementation],
                                http_port=port,
                                parameters=[
                                    {"name": "model_uri", "value": unit.model_uri, "type": "STRING"},
                                    *[p.to_dict() for p in unit.parameters],
                                ],
                            )
                        )
            def explainer_spec() -> Optional[ComponentSpec]:
                explainer = pspec.annotations.get("seldon.io/explainer-type")
                if not explainer:
                    return None
                return ComponentSpec(
                    name=f"{dep.key}/{pspec.name}/explainer-{h[:8]}",
                    kind="explainer",
                    deployment=dep.key,
                    predictor=pspec.name,
                    interface_name="seldon_core_tpu_torch.components.explainer.Explainer",
                    parameters=[
                        {"name": "explainer_type", "value": explainer, "type": "STRING"},
                        {
                            "name": "model_uri",
                            "value": pspec.annotations.get("seldon.io/explainer-model-uri", ""),
                            "type": "STRING",
                        },
                    ],
                )

            if no_engine:
                # no-engine mode: expose the single graph node directly, no
                # orchestrator hop (reference: seldon.io/no-engine annotation,
                # seldondeployment_types.go:43-45). Only single-node graphs
                # qualify — deeper graphs need the engine walk.
                if parse_disagg_annotations(pspec) is not None:
                    raise GraphSpecError(
                        f"{pspec.name}: seldon.io/disagg needs the engine "
                        f"(pool roles are engine parameters); drop "
                        f"{ANNOTATION_NO_ENGINE}"
                    )
                root = pspec.graph
                if root.children:
                    raise GraphSpecError(
                        f"{pspec.name}: {ANNOTATION_NO_ENGINE} requires a single-node graph"
                    )
                if root.implementation not in PREPACKAGED_SERVERS:
                    raise GraphSpecError(
                        f"{pspec.name}: {ANNOTATION_NO_ENGINE} needs a prepackaged "
                        f"implementation, got {root.implementation!r}"
                    )
                for replica in range(max(1, pspec.replicas)):
                    specs.append(
                        ComponentSpec(
                            name=f"{dep.key}/{pspec.name}/{replica}/model-{h[:8]}",
                            kind="microservice",
                            deployment=dep.key,
                            predictor=pspec.name,
                            replica=replica,
                            routable=True,
                            interface_name=PREPACKAGED_SERVERS[root.implementation],
                            parameters=[
                                {"name": "model_uri", "value": root.model_uri, "type": "STRING"},
                                *[p.to_dict() for p in root.parameters],
                            ],
                        )
                    )
                espec = explainer_spec()
                if espec is not None:
                    specs.append(espec)
                continue
            disagg = parse_disagg_annotations(pspec)
            if disagg is not None:
                specs.extend(self._disagg_components(dep, pspec, h, disagg))
                espec = explainer_spec()
                if espec is not None:
                    specs.append(espec)
                continue
            # kv-tier annotation: the byte budget lands on the
            # GENERATE_SERVER unit as the host_kv_tier_bytes parameter
            # (one source of truth — the annotation; see graph/spec.py)
            tier_bytes = parse_kv_tier_annotation(pspec)
            # mesh annotation: the shape lands on the member spec as the
            # tpuMesh field (one source of truth — the annotation; see
            # graph/spec.py) so placement and the engine's in-process
            # mesh build both read the same already-validated shape
            mesh_shape = parse_mesh_annotation(pspec)
            # tenants annotation: the validated roster lands on the
            # GENERATE_SERVER unit as the `tenants` parameter, verbatim
            # CSV (one source of truth — the annotation; the server
            # re-parses with the same strict grammar at construction)
            tenants_raw = (
                (pspec.annotations or {}).get(ANNOTATION_TENANTS)
                if parse_tenants_annotation(pspec) is not None else None
            )
            for replica in range(max(1, pspec.replicas)):
                name = f"{dep.key}/{pspec.name}/{replica}/engine-{h[:8]}"
                espec_dict = pspec.to_dict()
                if tenants_raw is not None:
                    espec_dict = inject_tenants_param(
                        espec_dict, tenants_raw
                    )
                    espec_dict["annotations"] = {
                        k: v
                        for k, v in (
                            espec_dict.get("annotations") or {}
                        ).items()
                        if k != ANNOTATION_TENANTS
                    }
                if tier_bytes is not None:
                    espec_dict = inject_kv_tier_param(espec_dict, tier_bytes)
                    # injected as a parameter now: strip the annotation
                    # so any re-validation of the member spec doesn't
                    # see both sources of truth at once
                    espec_dict["annotations"] = {
                        k: v
                        for k, v in (espec_dict.get("annotations") or {}).items()
                        if k != ANNOTATION_KV_TIER_BYTES
                    }
                if mesh_shape is not None:
                    espec_dict["tpuMesh"] = dict(mesh_shape)
                    # same inject-then-strip: tpuMesh carries the shape
                    # now, so re-validation never sees both sources
                    espec_dict["annotations"] = {
                        k: v
                        for k, v in (espec_dict.get("annotations") or {}).items()
                        if k != ANNOTATION_MESH
                    }
                specs.append(
                    ComponentSpec(
                        name=name,
                        kind="engine",
                        deployment=dep.key,
                        predictor=pspec.name,
                        replica=replica,
                        routable=True,
                        engine_spec=espec_dict,
                    )
                )
            espec = explainer_spec()
            if espec is not None:
                specs.append(espec)
        return specs

    def _disagg_components(
        self, dep: SeldonDeployment, pspec: PredictorSpec, h: str, disagg
    ) -> List[ComponentSpec]:
        """Split a ``seldon.io/disagg`` GENERATE_SERVER predictor into
        two independently scaled pools: ``prefill`` engines (role=prefill,
        each listening on a stable KV port, NOT routable — they serve the
        slab transport only) and ``decode`` engines (role=decode, peer
        pointed round-robin at the prefill listeners, routable — the
        gateway sends generate traffic here). Scaling either pool only
        adds/removes members of that pool: the per-pool replica
        annotations are excluded from the component-naming hash exactly
        like ``replicas`` is."""
        n_prefill, n_decode = disagg
        tier_bytes = parse_kv_tier_annotation(pspec)

        def pool_spec(role: str, extra) -> Dict:
            d = pspec.to_dict()
            if tier_bytes is not None:
                # both pools carry the tier: the prefill pool's tier is
                # what the KV-port listener answers peer prefix-lookups
                # from; the decode pool's tier is the pressure spill
                d = inject_kv_tier_param(d, tier_bytes)
            # the pool member is already specialized: strip the disagg
            # annotations (and the kv-tier annotation, now injected as
            # a parameter) so the runtime's re-validation doesn't see a
            # role/tier parameter on a spec that still asks to own it
            d["annotations"] = {
                k: v
                for k, v in (d.get("annotations") or {}).items()
                if not k.startswith("seldon.io/disagg")
                and k != ANNOTATION_KV_TIER_BYTES
            }
            graph = d["graph"]
            params = list(graph.get("parameters") or [])
            params.append({"name": "role", "value": role, "type": "STRING"})
            for k, v in extra:
                params.append({"name": k, "value": str(v), "type": "STRING"})
            graph["parameters"] = params
            return d

        from .runtime import free_port

        def port_bindable(port: int) -> bool:
            import socket as _socket

            s = _socket.socket()
            try:
                s.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
                s.bind(("0.0.0.0", port))
                return True
            except OSError:
                return False
            finally:
                s.close()

        ports = []
        for i in range(n_prefill):
            key = (dep.key, pspec.name, i)
            comp_name = f"{dep.key}/{pspec.name}/pf{i}/engine-{h[:8]}"
            if (
                key in self._kv_ports
                and comp_name not in self.components
                and not port_bindable(self._kv_ports[key])
            ):
                # the listener is NOT ours right now (component down) and
                # a foreign process holds the cached port: retrying the
                # same dead port every reconcile would wedge the
                # deployment in CREATING forever — allocate fresh (the
                # dependent decode members re-point via their peer-port
                # names)
                del self._kv_ports[key]
            if key not in self._kv_ports:
                self._kv_ports[key] = free_port()
            ports.append(self._kv_ports[key])
        out: List[ComponentSpec] = []
        for i in range(n_prefill):
            out.append(
                ComponentSpec(
                    name=f"{dep.key}/{pspec.name}/pf{i}/engine-{h[:8]}",
                    kind="engine",
                    deployment=dep.key,
                    predictor=pspec.name,
                    replica=i,
                    routable=False,
                    engine_spec=pool_spec(
                        "prefill", [("kv_port", ports[i])]
                    ),
                )
            )
        # peer-LIST assignment (not per-member round-robin): every decode
        # member gets the FULL candidate set of prefill listeners and the
        # engine's failover transport picks per transfer — so a prefill-
        # pool resize shrinks/grows the candidate set instead of
        # re-pointing (and so replacing) survivors. Decode names carry no
        # peer port: survivors keep serving through a resize, ejecting
        # torn-down listeners at runtime (a survivor only learns about
        # ADDED listeners when it is next recreated — acceptable, the
        # failover layer keeps it correct on its stale subset meanwhile).
        peer_list = ",".join(f"127.0.0.1:{p}" for p in ports)
        for r in range(n_decode):
            out.append(
                ComponentSpec(
                    name=f"{dep.key}/{pspec.name}/{r}/engine-{h[:8]}",
                    kind="engine",
                    deployment=dep.key,
                    predictor=pspec.name,
                    replica=r,
                    routable=True,
                    engine_spec=pool_spec(
                        "decode",
                        [("peer", peer_list)],
                    ),
                )
            )
        return out

    # -- reconcile ----------------------------------------------------------

    async def reconcile(self, dep: SeldonDeployment) -> DeploymentStatus:
        lock = self._reconciling.setdefault(dep.key, asyncio.Lock())
        async with lock:
            return await self._reconcile_locked(dep)

    async def _reconcile_locked(self, dep: SeldonDeployment) -> DeploymentStatus:
        status = DeploymentStatus(state=STATE_CREATING)

        def fail(desc: str) -> DeploymentStatus:
            status.state = STATE_FAILED
            status.description = desc
            status.predictor_status = []
            dep.status = status
            self.store.update_status(dep)
            if self.gateway is not None:
                # routes must track what actually survives a failed
                # reconcile (e.g. the recreate fallback tore the old
                # generation down) — never leave stale handles routable
                self.gateway.set_routes(
                    dep, self._routable_endpoints(dep), self._explainer_endpoints(dep)
                )
            return status

        try:
            validate_deployment(dep.predictors)
            desired = await self.desired_components(dep)
        except Exception as e:  # noqa: BLE001 - any bad spec must not kill run()
            return fail(str(e))

        desired_names = {s.name for s in desired}
        mine = {n for n, (h, _) in self.components.items() if h.spec.deployment == dep.key}

        # device placement: one block per (predictor, replica) engine. Prefer
        # create-before-delete; when devices don't fit both generations at
        # once, fall back to tearing the old generation down first
        # (Recreate-strategy equivalent).
        if self.placement is not None:
            try:
                self._allocate_blocks(dep, desired)
            except PlacementError:
                for name in sorted(mine - desired_names):
                    handle, _ = self.components.pop(name)
                    self.placement.release(name)
                    await handle.stop()
                mine = {n for n, (h, _) in self.components.items() if h.spec.deployment == dep.key}
                try:
                    self._allocate_blocks(dep, desired)
                except PlacementError as e:
                    self._release_blocks(desired)
                    return fail(str(e))

        # create-before-delete rolling update (reference: Deployment
        # rolling-update semantics exercised by test_rolling_updates.py)
        created: List[ComponentHandle] = []
        try:
            for spec in desired:
                if spec.name not in self.components:
                    if spec.kind == "explainer":
                        # point the explainer at a live engine of its
                        # predictor (reference: --predictor_host arg,
                        # seldondeployment_explainers.go:105-110); engines
                        # precede explainers in desired order so the port
                        # is known by now
                        self._wire_explainer_endpoint(spec, desired_names)
                    handle = await self.runtime.start(spec)
                    self.components[spec.name] = (handle, dep.spec_hash())
                    created.append(handle)
            # wait for new components to come ready before tearing down old
            ok = await self._await_ready(created)
        except Exception as e:  # noqa: BLE001 - component boot must not kill run()
            logger.exception("%s: component start failed", dep.key)
            for handle in created:
                self.components.pop(handle.spec.name, None)
                await handle.stop()
            self._release_blocks(desired, keep=mine)
            return fail(f"component start failed: {e}")

        if ok:
            # repoint the gateway at the new generation BEFORE tearing the
            # old one down — otherwise there's a window where the route
            # table still targets stopped components (502s under
            # SubprocessRuntime), defeating create-before-delete
            if self.gateway is not None:
                self.gateway.set_routes(
                    dep,
                    {
                        pred: [h for h in handles if h.spec.name in desired_names]
                        for pred, handles in self._routable_endpoints(dep).items()
                    },
                    {
                        pred: [h for h in handles if h.spec.name in desired_names]
                        for pred, handles in self._explainer_endpoints(dep).items()
                    },
                )
            for name in sorted(mine - desired_names):
                handle, _ = self.components.pop(name)
                if self.placement is not None:
                    self.placement.release(name)
                # zero-loss replacement/scale-down: checkpoint the
                # member's in-flight generations and hand them to a
                # surviving (or new-generation) peer BEFORE teardown —
                # rolling maintenance drops zero requests
                await self._drain_generate_member(handle)
                await handle.stop()
        else:
            # roll back: tear down the failed new generation, keep old
            for handle in created:
                self.components.pop(handle.spec.name, None)
                if self.placement is not None:
                    self.placement.release(handle.spec.name)
                await handle.stop()
            return fail("new components failed readiness")

        # status rollup (reference: seldondeployment_controller.go:1111-1119)
        for pspec in dep.predictors:
            replicas = max(1, pspec.replicas)
            try:
                disagg = parse_disagg_annotations(pspec)
            except GraphSpecError:
                disagg = None
            if disagg is not None:
                # routable components are the decode pool; availability
                # is judged against ITS size (prefill members gate
                # readiness through _await_ready like any component)
                replicas = disagg[1]
            avail = 0
            for name, (handle, _) in self.components.items():
                if (
                    handle.spec.deployment == dep.key
                    and handle.spec.predictor == pspec.name
                    and handle.spec.routable
                    and await handle.ready()
                ):
                    avail += 1
            status.predictor_status.append(
                PredictorStatus(name=pspec.name, replicas=replicas, replicas_available=avail)
            )
        status.state = (
            STATE_AVAILABLE
            if all(p.replicas_available >= p.replicas for p in status.predictor_status)
            else STATE_CREATING
        )
        dep.status = status
        self.store.update_status(dep)
        if self.gateway is not None:
            self.gateway.set_routes(
                dep, self._routable_endpoints(dep), self._explainer_endpoints(dep)
            )
        self._wire_shadow_mirrors(dep)
        return status

    @staticmethod
    def _generate_unit(handle, attr: str):
        """The in-process generate unit behind ``handle`` exposing
        ``attr`` (``drain_to`` / ``resume_checkpoint``), or None — only
        the default in-process engine runtime carries live unit objects.
        Delegates the graph walk to ``EngineApp.units_with`` so unit
        discovery lives in one module."""
        app = getattr(handle, "app", None)
        if app is None or not hasattr(app, "units_with"):
            return None
        return next((u for _n, u in app.units_with(attr)), None)

    async def _drain_generate_member(self, handle) -> None:
        """Before stopping a generate member (hot-swap replacement or
        decode-pool scale-down), checkpoint its live lanes + queued
        requests and migrate them to a surviving routable member of the
        same predictor (loopback — the handles share this process).
        Honors ``seldon.io/drain-seconds`` as the handoff budget.
        Best-effort: a member with nothing to migrate costs one empty
        drain; a failed handoff fails those requests typed exactly as a
        plain teardown would have, never worse."""
        from .runtime import _drain_seconds

        src = self._generate_unit(handle, "drain_to")
        if src is None or getattr(src, "batcher", None) is None:
            await self._drain_member_over_http(handle)
            return
        peer = None
        for _name, (h, _) in self.components.items():
            if (
                h is not handle
                and h.spec.deployment == handle.spec.deployment
                and h.spec.predictor == handle.spec.predictor
                and h.spec.routable
            ):
                peer = self._generate_unit(h, "resume_checkpoint")
                if peer is not None:
                    break
        if peer is None:
            return
        drain_s = _drain_seconds(handle.spec)
        loop = asyncio.get_running_loop()
        try:
            summary = await asyncio.wait_for(
                loop.run_in_executor(
                    None, lambda: src.drain_to(peer, timeout_s=drain_s)
                ),
                timeout=drain_s + 5.0,
            )
            if summary.get("drained"):
                logger.info(
                    "%s: drained %d in-flight generation(s) to a peer "
                    "before teardown", handle.spec.name,
                    summary["drained"],
                )
        except Exception:  # noqa: BLE001 - drain is best-effort
            logger.exception(
                "%s: drain before teardown failed", handle.spec.name
            )

    async def _drain_member_over_http(self, handle) -> None:
        """The out-of-process half of ``_drain_generate_member``: a
        member in its own process (``SubprocessRuntime``) hands its
        in-flight generations to a surviving routable member of the same
        predictor over the engine's ``POST /drain {"to": host:port}``, so
        a scale-down or a rolling update drops no request there either.
        Best-effort like the in-process path; a member without a
        generate unit answers 501 and is simply stopped."""
        from .runtime import _drain_seconds

        drain = getattr(handle, "drain_to", None)
        if drain is None or handle.spec.kind != "engine":
            return
        peer = next((
            h for _name, (h, _) in self.components.items()
            if h is not handle
            and h.spec.kind == "engine"
            and h.spec.deployment == handle.spec.deployment
            and h.spec.predictor == handle.spec.predictor
            and h.spec.routable
            and h.spec.http_port
        ), None)
        if peer is None:
            return
        t0 = asyncio.get_running_loop().time()
        try:
            summary = await drain(
                f"127.0.0.1:{peer.spec.http_port}", _drain_seconds(handle.spec)
            )
        except Exception:  # noqa: BLE001 - drain is best-effort
            logger.exception("%s: drain before teardown failed", handle.spec.name)
            return
        drained = sum(
            int((u or {}).get("drained", 0))
            for u in ((summary or {}).get("units") or {}).values()
        )
        if drained:
            logger.info(
                "%s: drained %d in-flight generation(s) to %s over /drain "
                "in %.1f ms before teardown", handle.spec.name, drained,
                peer.spec.name, (asyncio.get_running_loop().time() - t0) * 1e3,
            )

    def _wire_shadow_mirrors(self, dep: SeldonDeployment) -> None:
        """Shadow-mode rollouts mirror at the ENGINE: every live
        predictor's EngineApp gets a bounded, diffing ShadowMirror whose
        targets are the candidate's engines (the gateway then skips its
        legacy fire-and-forget for this deployment). Cleared — restoring
        the byte-identical no-rollout path — whenever no shadow rollout is
        active."""
        from ..rollout import ShadowMirror, plan_from_deployment

        try:
            plan = plan_from_deployment(dep)
        except GraphSpecError:
            plan = None
        if (
            plan is not None
            and plan.mode == "shadow"
            and self.rollout is not None
            and not self.rollout.shadow_active(dep, plan)
        ):
            # terminal rollout (failed on divergence, or promoted): no
            # longer active — keeping the mirror attached would double
            # every live request's device load forever just because the
            # annotations are still on the spec
            plan = None
        engines = self._routable_endpoints(dep)
        shadow_preds = {
            p.name for p in dep.predictors
            if p.annotations.get("seldon.io/shadow", "false") == "true"
        }
        mirror_targets = None
        if plan is not None and plan.mode == "shadow":
            # EVERY shadow predictor stays a target (a plain shadow must
            # not starve because a rollout candidate exists beside it —
            # the gateway's legacy mirror is suppressed for the whole
            # deployment), but only ONE handle per predictor: mirroring
            # each replica would multiply duplicate dispatch and inflate
            # the divergence denominator min_samples reads
            targets = []
            for pred in sorted(shadow_preds):
                for h in engines.get(pred, []):
                    if getattr(h, "app", None) is not None or h.spec.http_port:
                        targets.append((pred, h))
                        break
            if targets:
                mirror_targets = targets
            else:
                logger.warning(
                    "rollout %s: shadow mode but no mirrorable shadow "
                    "endpoint — the rollout will pause forever "
                    "(mirroring needs in-process or HTTP-reachable "
                    "shadow engines)", dep.key,
                )
        mirrors_wired = 0
        for pred, handles in engines.items():
            if mirror_targets is not None and pred in shadow_preds:
                continue  # shadows never re-mirror
            for h in handles:
                app = getattr(h, "app", None)
                if app is None:
                    continue
                if mirror_targets is None:
                    app.shadow_mirror = None
                    continue
                cur = getattr(app, "shadow_mirror", None)
                if (
                    cur is not None
                    and cur.deployment == dep.key
                    and cur.targets == mirror_targets
                ):
                    mirrors_wired += 1
                    continue  # unchanged: keep counts/bound/divergence ring
                app.shadow_mirror = ShadowMirror(
                    mirror_targets,
                    deployment=dep.key,
                    metrics=getattr(app, "metrics", None),
                )
                mirrors_wired += 1
        if mirror_targets is not None and mirrors_wired == 0:
            logger.warning(
                "rollout %s: shadow mode but no in-process live engine to "
                "mirror FROM — no mirrored samples will arrive and the "
                "rollout will pause forever (shadow rollouts need the "
                "default in-process engine runtime)", dep.key,
            )

    def _wire_explainer_endpoint(self, spec: ComponentSpec, desired_names) -> None:
        if any((p or {}).get("name") == "predictor_endpoint" for p in spec.parameters or []):
            return
        candidates = [
            handle.spec
            for _name, (handle, _) in self.components.items()
            if (
                handle.spec.deployment == spec.deployment
                and handle.spec.predictor == spec.predictor
                and handle.spec.routable
                and handle.spec.http_port
            )
        ]
        # during a rolling update both generations are alive here — wire
        # against the NEW generation (in desired_names); the old one is
        # torn down at the end of this same reconcile
        new_gen = [c for c in candidates if c.name in desired_names]
        target = (new_gen or candidates or [None])[0]
        if target is None:
            return
        path = "/predict" if target.kind == "microservice" else "/api/v0.1/predictions"
        spec.parameters = (spec.parameters or []) + [
            {"name": "predictor_endpoint", "value": f"127.0.0.1:{target.http_port}", "type": "STRING"},
            {"name": "predictor_path", "value": path, "type": "STRING"},
        ]

    def _allocate_blocks(self, dep: SeldonDeployment, desired: List[ComponentSpec]) -> None:
        """All-or-nothing device allocation for the desired engines: on a
        PlacementError, blocks grabbed within this call are released so a
        failed generation never leaks devices."""
        fresh: List[str] = []
        try:
            for spec in desired:
                if spec.kind != "engine":
                    continue
                pspec = dep.predictor(spec.predictor)
                mesh_spec = pspec.tpu_mesh if pspec else None
                if pspec is not None and mesh_spec is None:
                    # seldon.io/mesh predictors carry no tpuMesh on the
                    # DEPLOYMENT spec (the annotation owns it; the member
                    # spec got tpuMesh injected) — consult the annotation
                    # so placement carves the same block
                    mesh_spec = parse_mesh_annotation(pspec)
                if self.placement.assigned(spec.name) is None:
                    self.placement.allocate(spec.name, mesh_spec)
                    fresh.append(spec.name)
                if mesh_spec and spec.name not in self.components:
                    # a mesh over the placed block: sharded serving is
                    # not ported, so mesh_for raises PlacementError
                    spec.mesh = self.placement.mesh_for(spec.name, mesh_spec)
        except PlacementError:
            for name in fresh:
                self.placement.release(name)
            raise

    def _release_blocks(self, desired: List[ComponentSpec], keep=()) -> None:
        if self.placement is None:
            return
        for spec in desired:
            if spec.name not in keep and spec.name not in self.components:
                self.placement.release(spec.name)

    def _endpoints_by(self, dep: SeldonDeployment, want) -> Dict[str, List[ComponentHandle]]:
        out: Dict[str, List[ComponentHandle]] = {}
        for name, (handle, _) in self.components.items():
            if handle.spec.deployment == dep.key and want(handle.spec):
                out.setdefault(handle.spec.predictor, []).append(handle)
        return out

    def _routable_endpoints(self, dep: SeldonDeployment) -> Dict[str, List[ComponentHandle]]:
        return self._endpoints_by(dep, lambda s: s.routable)

    def _explainer_endpoints(self, dep: SeldonDeployment) -> Dict[str, List[ComponentHandle]]:
        return self._endpoints_by(dep, lambda s: s.kind == "explainer")

    async def _await_ready(self, handles: List[ComponentHandle]) -> bool:
        deadline = asyncio.get_running_loop().time() + self.ready_timeout_s
        pending = list(handles)
        while pending and asyncio.get_running_loop().time() < deadline:
            still = []
            for h in pending:
                if not await h.ready():
                    still.append(h)
            pending = still
            if pending:
                await asyncio.sleep(0.05)
        return not pending

    async def delete(self, dep: SeldonDeployment) -> None:
        mine = [n for n, (h, _) in self.components.items() if h.spec.deployment == dep.key]
        for name in mine:
            handle, _ = self.components.pop(name)
            if self.placement is not None:
                self.placement.release(name)
            await handle.stop()
        if self.gateway is not None:
            self.gateway.drop_routes(dep.key)
        # a re-created deployment must start a FRESH scale-down window
        for key in [k for k in self._scale_down_streak if k[0] == dep.key]:
            del self._scale_down_streak[key]
        # ... and fresh KV transport ports for its prefill pool
        for key in [k for k in self._kv_ports if k[0] == dep.key]:
            del self._kv_ports[key]

    # -- watch loop ---------------------------------------------------------

    # -- autoscaler ---------------------------------------------------------

    async def autoscale_once(self) -> Dict[str, int]:
        """One HPA evaluation pass (reference: createHpas
        seldondeployment_controller.go:805 + the k8s HPA control loop; the
        scaling metric is in-flight concurrency per engine replica,
        summed from the engines' /inflight gauges).

        desired = ceil(total_inflight / targetConcurrency), clamped to
        [minReplicas, maxReplicas]. Scale-up applies immediately;
        scale-down waits ``scale_down_ticks`` consecutive low passes
        (stabilization, so a burst lull doesn't thrash replicas). Returns
        {"<dep.key>/<predictor>": new_replicas} for every change applied.
        """
        changes: Dict[str, int] = {}
        for dep in self.store.list():
            try:
                changes.update(await self._autoscale_deployment(dep))
            except Exception:  # noqa: BLE001 - one malformed hpaSpec must
                # not stop autoscaling every other deployment
                logger.exception("autoscale %s failed", dep.key)
        return changes

    async def _autoscale_deployment(self, dep) -> Dict[str, int]:
        import math

        from ..graph.spec import parse_hpa_spec

        new_replicas: Dict[str, int] = {}
        for pspec in dep.predictors:
            hpa = pspec.hpa_spec
            if not hpa:
                continue
            lo, hi, target = parse_hpa_spec(hpa, who=f"{dep.key}/{pspec.name}")
            handles = [
                handle
                for handle, _ in self.components.values()
                if handle.spec.deployment == dep.key
                and handle.spec.predictor == pspec.name
                and handle.spec.routable
            ]
            # two counts: ``current`` is what the spec says (the value a
            # scale decision rewrites), ``observed`` what is actually
            # serving — after a placement-capped or lagging reconcile the
            # two diverge, and a decision made against the wrong one either
            # mis-triggers the scale-down streak or (worse) applies an
            # instant scale-down through the scale-UP branch
            current = max(1, pspec.replicas)
            observed = max(1, len(handles) or pspec.replicas)
            if self.placement is not None and pspec.tpu_mesh:
                # never scale past the devices that exist: desired beyond the
                # free device blocks would just flip the deployment FAILED
                # while the old replicas keep serving (k8s HPA's
                # unschedulable-pods analogue, caught before, not after)
                per_replica = 1
                for v in pspec.tpu_mesh.values():
                    per_replica *= int(v)
                # anchor at the LARGER of spec/observed: when placement is
                # exhausted (free=0) an observed-only anchor would clamp
                # desired to the observed count and ratchet the spec down
                # under sustained load, killing the lag guard below
                placeable = (
                    max(current, observed)
                    + self.placement.capacity()["free"] // per_replica
                )
                hi = min(hi, max(lo, placeable))
            # probes run concurrently: with SubprocessRuntime each is an
            # HTTP call with a 0.5s timeout, and the controller loop must
            # not stall on M x N sequential probes
            loads = await asyncio.gather(*(h.load() for h in handles))
            known = [v for v in loads if v is not None]
            if not known:
                continue
            total = sum(known)
            desired = min(hi, max(lo, math.ceil(total / target)))
            streak_key = (dep.key, pspec.name)
            if self._worst_burn(dep.key, pspec.name) == "page":
                # a paging SLO burn verdict (fast AND slow windows above
                # the page rate) overrides the load signal: tenants are
                # burning error budget even if per-replica load looks
                # fine, so veto any scale-down streak and apply one
                # replica of upward pressure (clamped to hi/placement)
                self._scale_down_streak.pop(streak_key, None)
                desired = min(hi, max(desired, current + 1))
            if desired > current:
                self._scale_down_streak.pop(streak_key, None)
                new_replicas[pspec.name] = desired
            elif desired < current:
                if desired > observed:
                    # load demands MORE capacity than is actually serving;
                    # the spec merely hasn't materialized yet. Not a
                    # low-load signal — don't let reconcile lag accumulate
                    # into a streak that shrinks the spec.
                    self._scale_down_streak.pop(streak_key, None)
                else:
                    streak = self._scale_down_streak.get(streak_key, 0) + 1
                    self._scale_down_streak[streak_key] = streak
                    if streak >= self.scale_down_ticks:
                        self._scale_down_streak.pop(streak_key, None)
                        new_replicas[pspec.name] = desired
            else:
                self._scale_down_streak.pop(streak_key, None)
        if not new_replicas:
            return {}
        updated = dep.clone()
        for pspec in updated.predictors:
            if pspec.name in new_replicas:
                pspec.replicas = new_replicas[pspec.name]
        self.store.apply(updated)  # generation bump -> reconcile
        changes = {}
        for name, n in new_replicas.items():
            changes[f"{dep.key}/{name}"] = n
            logger.info("autoscale %s/%s -> %d replicas", dep.key, name, n)
        return changes

    # -- fleet telemetry scrape ---------------------------------------------

    async def fleet_scrape_once(self) -> Dict[str, Dict]:
        """Pull every member's /fleet payload, diff it against the
        member's previous snapshot, and merge the deltas into the
        deployment-scope ``fleet_metrics`` registry with
        member/predictor/deployment labels — the one pane of glass for
        disagg/sharded/multi-tenant deployments. Also refreshes the SLO
        burn verdict feed the autoscaler consumes. Returns the latest
        unit summaries per member (tools/smoke assert on them)."""
        from ..graph.engine_metrics import diff_fleet_snapshot

        live = set()
        # verdicts accumulate across a predictor's MEMBERS (an idle
        # member's empty list must not mask a hot member's page)
        burn: Dict[Tuple[str, str], List[Dict]] = {}
        for name, (handle, _) in list(self.components.items()):
            snap = await handle.fleet()
            if snap is None:
                continue
            live.add(name)
            labels = {
                "deployment": handle.spec.deployment,
                "predictor": handle.spec.predictor,
                "member": name,
            }
            metrics = snap.get("metrics") or {}
            self.fleet_metrics.ingest_fleet(
                diff_fleet_snapshot(self._fleet_prev.get(name), metrics),
                labels,
            )
            self._fleet_prev[name] = metrics
            units = snap.get("units") or {}
            self._fleet_units[name] = units
            burn.setdefault(
                (handle.spec.deployment, handle.spec.predictor), []
            ).extend(
                v
                for unit in units.values()
                for v in (unit.get("slo_burn") or {}).get("verdicts", [])
            )
        self._burn_verdicts = burn
        # members torn down since the last scrape must not leave stale
        # snapshots (a re-created member under the same name would diff
        # against its predecessor's totals)
        for name in list(self._fleet_prev):
            if name not in live:
                del self._fleet_prev[name]
                self._fleet_units.pop(name, None)
        return dict(self._fleet_units)

    def fleet_summary(self) -> Dict[str, Dict]:
        """Deployment-level rollup: the merged metric plane plus the
        latest per-member unit summaries and burn verdicts."""
        return {
            "metrics": self.fleet_metrics.fleet_snapshot(),
            "members": dict(self._fleet_units),
            "burn_verdicts": {
                f"{dep}/{pred}": v
                for (dep, pred), v in self._burn_verdicts.items()
            },
            "planner": {
                "stats": dict(self.planner_stats),
                "recent": list(self._planner_events)[-20:],
            },
        }

    def _worst_burn(self, dep_key: str, predictor: str) -> str:
        """Worst burn severity across a predictor's members (``ok`` when
        no verdicts have been scraped)."""
        from ..serving.slo_burn import SEVERITIES

        worst = 0
        for v in self._burn_verdicts.get((dep_key, predictor), []):
            try:
                worst = max(worst, SEVERITIES.index(v.get("severity")))
            except ValueError:
                continue
        return SEVERITIES[worst]

    # -- autonomic planner tick ---------------------------------------------

    def _planner_for(self, key: Tuple[str, str], cfg: Dict[str, Any]):
        """The (dep, predictor)'s decision table, created on first tick.
        The planner shares the HPA's ``scale_down_ticks`` stabilization
        window — ONE hysteresis constant for both controllers. A
        profile artifact that fails to decode disables the cost model
        (typed refusal logged once per path), never the planner: the
        burn/pressure/idle rules need no profile."""
        planner = self._planners.get(key)
        if planner is not None:
            return planner
        from ..planning import CostModel, ServingPlanner, read_profile

        cost_model = None
        path = cfg.get("profile")
        if path:
            if path not in self._planner_profiles:
                try:
                    self._planner_profiles[path] = CostModel(
                        read_profile(path)
                    )
                except Exception:  # noqa: BLE001 - corrupt/missing SPF1
                    # refuses typed; the planner runs model-less
                    logger.exception(
                        "planner: profile %s unusable, running without "
                        "a cost model", path,
                    )
                    self._planner_profiles[path] = None
            cost_model = self._planner_profiles[path]
        planner = ServingPlanner(
            cost_model=cost_model,
            scale_down_ticks=self.scale_down_ticks,
        )
        self._planners[key] = planner
        return planner

    def _planner_telemetry(self, dep, pspec):
        """(gauges, counter_totals, current_config, census) for one
        predictor, all harvested from the LAST fleet scrape — the
        planner consumes the same telemetry plane operators see, never
        a private side channel."""
        busy: List[float] = []
        config = census = None
        for name, (handle, _) in self.components.items():
            if (
                handle.spec.deployment != dep.key
                or handle.spec.predictor != pspec.name
            ):
                continue
            for unit in (self._fleet_units.get(name) or {}).values():
                prof = unit.get("profiler") or {}
                if "device_busy_frac" in prof:
                    busy.append(float(prof["device_busy_frac"]))
                plan = unit.get("planning") or {}
                if config is None and plan.get("config"):
                    config = plan["config"]
                    census = plan.get("census")
        gauges: Dict[str, float] = {}
        if busy:
            gauges["device_busy_frac"] = sum(busy) / len(busy)
        want = {"deployment": dep.key, "predictor": pspec.name}
        totals = {
            "sheds": self.fleet_metrics.counter_total(
                "seldon_engine_pressure_sheds", want
            ),
            "preemptions": self.fleet_metrics.counter_total(
                "seldon_engine_preemptions", want
            ),
        }
        return gauges, totals, config, census

    async def planner_tick_once(self) -> Dict[str, Dict[str, Any]]:
        """One planner pass over every predictor that opted in via
        ``seldon.io/planner``. Returns the decision event per
        ``<dep.key>/<predictor>`` (tools/planner_smoke asserts on
        them)."""
        from ..graph.spec import parse_planner_annotations

        results: Dict[str, Dict[str, Any]] = {}
        live = set()
        for dep in self.store.list():
            for pspec in dep.predictors:
                try:
                    cfg = parse_planner_annotations(pspec)
                except GraphSpecError as e:
                    logger.warning(
                        "planner: %s/%s annotations unusable: %s",
                        dep.key, pspec.name, e,
                    )
                    continue
                if not cfg or not cfg["enabled"]:
                    continue
                key = (dep.key, pspec.name)
                live.add(key)
                try:
                    results[f"{dep.key}/{pspec.name}"] = (
                        await self._planner_tick_one(
                            dep, pspec, self._planner_for(key, cfg)
                        )
                    )
                except Exception:  # noqa: BLE001 - one predictor's tick
                    # must not stop planning the others
                    logger.exception("planner tick %s failed", key)
        # predictors that dropped the annotation (or the deployment)
        # must not keep stale streak/cooldown state around
        for key in [k for k in self._planners if k not in live]:
            del self._planners[key]
        return results

    async def _planner_tick_one(self, dep, pspec, planner) -> Dict[str, Any]:
        self.planner_stats["ticks"] += 1
        gauges, totals, config, census = self._planner_telemetry(dep, pspec)
        verdicts = self._burn_verdicts.get((dep.key, pspec.name), [])
        decision = planner.tick(
            verdicts=verdicts, gauges=gauges, counter_totals=totals,
            current_config=config, census=census,
        )
        outcome = await self._planner_actuate(dep, pspec, decision)
        event = {
            "deployment": dep.key, "predictor": pspec.name,
            "action": decision.action, "rank": decision.rank,
            "reason": decision.reason, "knobs": dict(decision.knobs),
            **outcome,
        }
        self._planner_events.append(event)
        if decision.action != "hold" or outcome.get("vetoed"):
            logger.info(
                "planner %s/%s: %s (%s)%s", dep.key, pspec.name,
                decision.action, decision.reason,
                " [VETOED by burn page]" if outcome.get("vetoed") else "",
            )
        return event

    async def _planner_actuate(self, dep, pspec, decision) -> Dict[str, Any]:
        """Actuate one decision through the safe paths ONLY. The
        planner/autoscaler precedence rule lives here, at the last
        writer, so it holds even when verdicts changed between the
        planner's tick and this actuation: a page-severity burn verdict
        VETOES any scale-down in the same tick (counted, logged) —
        exactly the autoscaler's own page veto, so the two controllers
        resolve every same-tick conflict the same way (the table in
        docs/operate.md §"Autonomic planning")."""
        streak_key = (dep.key, pspec.name)
        if decision.action == "hold":
            self.planner_stats["holds"] += 1
            return {}
        if decision.action == "retune":
            from ..serving.continuous import RetuneError

            handles = [
                handle for handle, _ in self.components.values()
                if handle.spec.deployment == dep.key
                and handle.spec.predictor == pspec.name
            ]
            applied = refused = 0
            for handle in handles:
                try:
                    out = await handle.retune(
                        dict(decision.knobs), origin="planner"
                    )
                except RetuneError as e:
                    # out-of-census knobs refuse typed and change
                    # NOTHING — never half-applied across members
                    refused += 1
                    logger.warning(
                        "planner: retune refused by %s: %s",
                        handle.spec.name, e,
                    )
                    continue
                except Exception:  # noqa: BLE001 - a dead member must
                    # not stop the rest of the pool retuning
                    refused += 1
                    logger.exception(
                        "planner: retune failed on %s", handle.spec.name
                    )
                    continue
                if out is not None:
                    applied += 1
            self.planner_stats["retunes"] += applied
            self.planner_stats["retunes_refused"] += refused
            return {"retuned": applied, "refused": refused}
        # scale decisions rewrite replicas through the same clamped
        # spec path the HPA uses (store.apply -> reconcile)
        current = max(1, pspec.replicas)
        lo, hi = 1, current + 1
        if pspec.hpa_spec:
            from ..graph.spec import parse_hpa_spec

            lo, hi, _target = parse_hpa_spec(
                pspec.hpa_spec, who=f"{dep.key}/{pspec.name}"
            )
        if decision.action == "scale_down":
            if self._worst_burn(dep.key, pspec.name) == "page":
                self.planner_stats["vetoes"] += 1
                self._scale_down_streak.pop(streak_key, None)
                return {"vetoed": True}
            desired = max(lo, current - 1)
        else:
            desired = min(hi, current + 1)
            if self.placement is not None and pspec.tpu_mesh:
                # same never-past-the-devices clamp as the autoscaler
                per_replica = 1
                for v in pspec.tpu_mesh.values():
                    per_replica *= int(v)
                desired = min(
                    desired,
                    current + self.placement.capacity()["free"] // per_replica,
                )
        if desired == current:
            return {"replicas": current, "clamped": True}
        updated = dep.clone()
        for p in updated.predictors:
            if p.name == pspec.name:
                p.replicas = desired
        self.store.apply(updated)  # generation bump -> reconcile
        # shared hysteresis: a planner scale event restarts the HPA's
        # stabilization window (the autoscaler pops the same streak on
        # its own scale events) — neither controller can saw against
        # the other's fresh decision
        self._scale_down_streak.pop(streak_key, None)
        key = "scale_ups" if decision.action == "scale_up" else "scale_downs"
        self.planner_stats[key] += 1
        logger.info(
            "planner %s/%s -> %d replicas", dep.key, pspec.name, desired
        )
        return {"replicas": desired}

    async def run(self, stop_event: Optional[asyncio.Event] = None) -> None:
        """Consume store events forever (controller-runtime manager parity,
        reference: operator/main.go:49-93). The autoscaler evaluates every
        ``autoscale_period_s`` between events."""
        q = self.store.watch()
        # reconcile pre-existing resources (controller restart)
        for dep in self.store.list():
            await self.reconcile(dep.clone())
        loop = asyncio.get_running_loop()
        next_autoscale = loop.time() + self.autoscale_period_s
        next_rollout = loop.time() + self.rollout_period_s
        next_fleet = loop.time() + self.fleet_period_s
        next_planner = loop.time() + self.planner_period_s
        try:
            while stop_event is None or not stop_event.is_set():
                if loop.time() >= next_autoscale:
                    next_autoscale = loop.time() + self.autoscale_period_s
                    try:
                        await self.autoscale_once()
                    except Exception:  # noqa: BLE001 - probe hiccups must
                        # not kill the manager loop
                        logger.exception("autoscale pass failed")
                if loop.time() >= next_fleet:
                    next_fleet = loop.time() + self.fleet_period_s
                    try:
                        await self.fleet_scrape_once()
                    except Exception:  # noqa: BLE001 - a slow/dead member's
                        # scrape must not kill the manager loop
                        logger.exception("fleet scrape failed")
                if loop.time() >= next_planner:
                    next_planner = loop.time() + self.planner_period_s
                    try:
                        await self.planner_tick_once()
                    except Exception:  # noqa: BLE001 - a bad profile or
                        # dead member must not kill the manager loop
                        logger.exception("planner pass failed")
                if loop.time() >= next_rollout:
                    next_rollout = loop.time() + self.rollout_period_s
                    try:
                        # analysis windows are plan-interval-gated inside;
                        # this cadence only bounds verdict latency. Weight
                        # changes surface as store events consumed below.
                        verdicts = self.rollout.tick_all()
                        # shadow verdicts change no spec (no store event,
                        # so no reconcile): rewire mirrors directly, or a
                        # failed/promoted shadow would keep receiving a
                        # duplicate of every request forever
                        for vkey in verdicts:
                            vdep = next(
                                (d for d in self.store.list()
                                 if d.key == vkey), None,
                            )
                            if vdep is not None:
                                self._wire_shadow_mirrors(vdep)
                    except Exception:  # noqa: BLE001 - one bad rollout
                        # must not kill the manager loop
                        logger.exception("rollout pass failed")
                try:
                    event, dep = await asyncio.wait_for(q.get(), timeout=0.2)
                except asyncio.TimeoutError:
                    continue
                try:
                    if event == EVENT_DELETED:
                        await self.delete(dep)
                    else:
                        await self.reconcile(dep.clone())
                except Exception:  # noqa: BLE001 - one bad resource must not
                    # stop reconciling the others (controller-runtime requeues
                    # on error rather than crashing the manager)
                    logger.exception("reconcile %s failed", dep.key)
        finally:
            self.store.unwatch(q)

    async def shutdown(self) -> None:
        for name in list(self.components):
            handle, _ = self.components.pop(name)
            if self.placement is not None:
                self.placement.release(name)
            await handle.stop()
