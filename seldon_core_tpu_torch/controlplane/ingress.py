"""Ingress gateway: weighted canary routing across predictors.

Parity with the reference's Istio VirtualService traffic weights and
Ambassador mappings (reference: operator/controllers/
seldondeployment_controller.go:113-224 createIstioResources;
operator/controllers/ambassador.go:50-222 — weighted canaries, shadow
predictors, header-based routing). One asyncio HTTP front exposes

    /seldon/<namespace>/<deployment>/api/v0.1/predictions  (and /feedback)

and fans each request to one predictor's engine chosen by traffic weight,
honouring a ``seldon-predictor`` header override and mirroring traffic to
shadow predictors fire-and-forget.

Auth (reference: the legacy OAuth "apife" gateway the client SDK speaks —
python/seldon_core/seldon_client.py:931-1106): when key/secret pairs are
configured (constructor or ``SELDON_OAUTH_KEY``/``SELDON_OAUTH_SECRET``
env), ``POST /oauth/token`` with HTTP Basic credentials issues a bearer
token and every /seldon/* route requires ``Authorization: Bearer <tok>``.
Unconfigured gateways stay open (in-cluster mode).
"""

from __future__ import annotations

import asyncio
import base64
import logging
import os
import random
import secrets
import time
from typing import Dict, List, Optional, Tuple

from ..http_server import HTTPServer, Request, Response, error_body

logger = logging.getLogger(__name__)

HEADER_PREDICTOR = "seldon-predictor"
ANNOTATION_SHADOW = "seldon.io/shadow"


def _log_shadow_failure(task: "asyncio.Task") -> None:
    if not task.cancelled() and task.exception() is not None:
        logger.warning("shadow mirror failed: %s", task.exception())


class _Route:
    __slots__ = ("predictor", "weight", "handles", "shadow", "_rr")

    def __init__(self, predictor: str, weight: int, handles: List, shadow: bool):
        self.predictor = predictor
        self.weight = weight
        self.handles = handles
        self.shadow = shadow
        self._rr = 0

    def pick(self):
        """Round-robin over replica engines of one predictor."""
        if not self.handles:
            return None
        h = self.handles[self._rr % len(self.handles)]
        self._rr += 1
        return h


TOKEN_TTL_S = 3600.0


class Gateway:
    def __init__(self, seed: Optional[int] = None,
                 oauth: Optional[Dict[str, str]] = None):
        # deployment key -> list of routes
        self._routes: Dict[str, List[_Route]] = {}
        # deployment key -> predictor -> explainer handles (reference:
        # "<deployment>-explainer" service, seldondeployment_explainers.go:160)
        self._explainers: Dict[str, Dict[str, List]] = {}
        self._rng = random.Random(seed)
        # oauth key -> secret; empty = open gateway
        if oauth is None and os.environ.get("SELDON_OAUTH_KEY"):
            oauth = {
                os.environ["SELDON_OAUTH_KEY"]: os.environ.get("SELDON_OAUTH_SECRET", "")
            }
        self._oauth = dict(oauth or {})
        self._tokens: Dict[str, float] = {}  # token -> expiry monotonic

    # -- auth ---------------------------------------------------------------

    @property
    def auth_enabled(self) -> bool:
        return bool(self._oauth)

    def issue_token(self, key: str, secret: str) -> Optional[str]:
        if key not in self._oauth or not secrets.compare_digest(
            self._oauth[key], secret
        ):
            return None
        # sweep expired tokens on issuance so the table is bounded by the
        # number of live tokens, not the total ever issued
        now = time.monotonic()
        self._tokens = {t: exp for t, exp in self._tokens.items() if exp > now}
        token = secrets.token_urlsafe(24)
        self._tokens[token] = now + TOKEN_TTL_S
        return token

    def check_token(self, token: str) -> bool:
        exp = self._tokens.get(token)
        if exp is None:
            return False
        if time.monotonic() > exp:
            self._tokens.pop(token, None)
            return False
        return True

    def _authorized(self, req: Request) -> bool:
        if not self._oauth:
            return True
        header = req.headers.get("authorization", "")
        if header.lower().startswith("bearer "):
            return self.check_token(header[7:].strip())
        return False

    # -- route table maintenance (called by the reconciler) -----------------

    def set_routes(self, dep, endpoints: Dict[str, List], explainers: Optional[Dict[str, List]] = None) -> None:
        routes = []
        for pspec in dep.predictors:
            shadow = pspec.annotations.get(ANNOTATION_SHADOW, "false") == "true"
            routes.append(
                _Route(pspec.name, pspec.traffic, endpoints.get(pspec.name, []), shadow)
            )
        self._routes[dep.key] = routes
        self._explainers[dep.key] = dict(explainers or {})

    def drop_routes(self, key: str) -> None:
        self._routes.pop(key, None)
        self._explainers.pop(key, None)

    def select_explainer(self, key: str, header_predictor: Optional[str] = None):
        """Explainer handle for the (chosen) predictor of a deployment."""
        explainers = self._explainers.get(key) or {}
        if not explainers:
            return None
        if header_predictor:
            handles = explainers.get(header_predictor) or []
            return handles[0] if handles else None
        # only live (non-shadow) predictors' explainers are eligible — a
        # shadow's explainer explains a model serving 0% of real traffic
        routes = self._routes.get(key) or []
        for r in routes:
            if not r.shadow and r.predictor in explainers and explainers[r.predictor]:
                return explainers[r.predictor][0]
        return None

    def route_table(self) -> Dict[str, List[Tuple[str, int, int, bool]]]:
        return {
            k: [(r.predictor, r.weight, len(r.handles), r.shadow) for r in rs]
            for k, rs in self._routes.items()
        }

    # -- selection ----------------------------------------------------------

    def select(self, key: str, header_predictor: Optional[str] = None):
        """Choose (primary_handle, [shadow_handles]) for one request."""
        routes = self._routes.get(key)
        if not routes:
            return None, []
        live = [r for r in routes if not r.shadow]
        shadows = [r for r in routes if r.shadow]
        if header_predictor:
            for r in routes:
                if r.predictor == header_predictor:
                    return r.pick(), []
            return None, []
        total = sum(r.weight for r in live)
        if total <= 0:
            chosen = live[0] if live else None
        else:
            x = self._rng.uniform(0, total)
            acc = 0.0
            chosen = live[-1]
            for r in live:
                acc += r.weight
                if x <= acc:
                    chosen = r
                    break
        return (chosen.pick() if chosen else None), [s.pick() for s in shadows if s.handles]

    # -- HTTP front ---------------------------------------------------------

    async def _forward(self, handle, path: str, payload):
        """Dispatch to an engine; uses the in-process app when available
        (zero-copy localhost fast path, like the webhook's
        ServiceHost=localhost — reference: seldondeployment_webhook.go:211-216)."""
        import json as _json

        app = getattr(handle, "app", None)
        if app is not None:
            if path.endswith("/feedback"):
                return await app.send_feedback(payload)
            if path.endswith("/predictions") or path == "/predict":
                return await app.predict(payload)
            raise LookupError(f"no engine route {path}")
        user_object = getattr(handle, "user_object", None)
        if user_object is not None:
            # no-engine mode: the routable component is a bare model
            from .. import seldon_methods

            if path.endswith("/feedback") or path.endswith("/send-feedback"):
                fn = seldon_methods.send_feedback
            elif path.endswith("/predictions") or path == "/predict":
                fn = seldon_methods.predict
            elif path.endswith("/explain"):
                fn = seldon_methods.explain
            else:
                raise LookupError(f"no model route {path}")
            return await asyncio.get_running_loop().run_in_executor(
                None, fn, user_object, payload
            )

        def do_post():
            import urllib.request

            from ..payload import jsonable

            req = urllib.request.Request(
                f"{handle.url}{path}",
                data=_json.dumps(jsonable(payload)).encode(),
                headers={"content-type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=10.0) as r:
                return _json.loads(r.read())

        return await asyncio.get_running_loop().run_in_executor(None, do_post)

    def app(self) -> HTTPServer:
        from ..http_server import max_body_from_env

        # the gateway fronts every engine: its cap must be raisable too or
        # a raised engine-side seldon.io/rest-max-body dies at the gateway
        server = HTTPServer("gateway", max_body_bytes=max_body_from_env())
        gw = self

        async def token_endpoint(req: Request) -> Response:
            """POST /oauth/token with HTTP Basic key:secret (the reference
            client's oauth flow — seldon_client.py:931-1106)."""
            if not gw.auth_enabled:
                return Response(error_body(404, "oauth not configured"), 404)
            header = req.headers.get("authorization", "")
            key = secret = None
            if header.lower().startswith("basic "):
                try:
                    decoded = base64.b64decode(header[6:]).decode()
                    key, _, secret = decoded.partition(":")
                except Exception:  # noqa: BLE001 - malformed basic auth
                    pass
            if key is None:
                body = req.json() or {}
                key, secret = body.get("key"), body.get("secret")
            token = gw.issue_token(key or "", secret or "")
            if token is None:
                return Response(error_body(401, "bad oauth credentials"), 401)
            return Response(
                {"access_token": token, "token_type": "bearer",
                 "expires_in": int(TOKEN_TTL_S)}
            )

        async def handler(req: Request) -> Response:
            if not gw._authorized(req):
                return Response(error_body(401, "missing or invalid bearer token"), 401)
            # /seldon/<ns>/<name>/api/v0.1/predictions
            parts = [p for p in req.path.split("/") if p]
            if len(parts) < 4 or parts[0] != "seldon":
                return Response(error_body(404, f"no route for {req.path}"), 404)
            ns, name = parts[1], parts[2]
            api_path = "/" + "/".join(parts[3:])
            key = f"{ns}/{name}"
            if api_path.endswith("/explain"):
                handle = gw.select_explainer(key, req.headers.get(HEADER_PREDICTOR))
                if handle is None:
                    return Response(error_body(404, f"no explainer for {key}"), 404)
                try:
                    out = await gw._forward(handle, "/explain", req.json())
                except Exception as e:  # noqa: BLE001 - gateway must answer
                    return Response(error_body(502, str(e)), 502)
                return Response(out)
            primary, shadows = gw.select(key, req.headers.get(HEADER_PREDICTOR))
            if primary is None:
                return Response(error_body(503, f"no live predictor for {key}"), 503)
            # req.json() handles both raw JSON and the reference's
            # form-encoded `json=` body style
            payload = req.json()
            # legacy gateway-side mirroring ONLY when the engine doesn't
            # mirror for itself: a rollout wires a bounded, diffing
            # ShadowMirror onto the primary's EngineApp (rollout/mirror.py),
            # and double-mirroring would send shadows every request twice.
            # The engine mirrors PREDICTIONS only — feedback (reward
            # signals a shadow's routers need) still fans out here even
            # mid-rollout
            engine_mirrors = (
                getattr(getattr(primary, "app", None), "shadow_mirror", None)
                is not None
                and (api_path.endswith("/predictions") or api_path == "/predict")
            )
            if not engine_mirrors:
                for s in shadows:
                    t = asyncio.ensure_future(gw._forward(s, api_path, payload))
                    t.add_done_callback(_log_shadow_failure)
            try:
                out = await gw._forward(primary, api_path, payload)
            except LookupError as e:
                return Response(error_body(404, str(e)), 404)
            except Exception as e:  # noqa: BLE001 - gateway must answer
                status = getattr(e, "status", None)
                if status == 503 and (
                    api_path.endswith("/predictions") or api_path == "/predict"
                ):
                    # engine-internal retry: a 503-class refusal (dead,
                    # restarting, or DRAINING generate batcher) is
                    # member-local — retry once on another routable
                    # member. Generation is seed-deterministic, and a
                    # client resume token riding the payload re-enters
                    # exactly where the dead member stopped, so the
                    # retried response is byte-identical to an
                    # uninterrupted run.
                    alt = None
                    for _ in range(3):
                        cand, _sh = gw.select(
                            key, req.headers.get(HEADER_PREDICTOR)
                        )
                        if cand is not None and cand is not primary:
                            alt = cand
                            break
                    if alt is not None:
                        try:
                            return Response(
                                await gw._forward(alt, api_path, payload)
                            )
                        except Exception as e2:  # noqa: BLE001 - second member
                            e = e2
                            status = getattr(e2, "status", None)
                if status == 503:
                    after = getattr(e, "retry_after_s", None)
                    return Response(
                        error_body(503, str(e)), 503,
                        headers={"Retry-After": str(max(1, int(after + 0.5)))
                                 if after else "1"},
                    )
                return Response(error_body(502, str(e)), 502)
            return Response(out)

        async def routes(req: Request) -> Response:
            if not gw._authorized(req):
                return Response(error_body(401, "missing or invalid bearer token"), 401)
            return Response(gw.route_table())

        server.add_prefix_route("/seldon/", handler)
        server.add_route("/routes", routes)
        server.add_route("/oauth/token", token_endpoint)
        return server
