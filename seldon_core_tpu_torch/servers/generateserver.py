"""Generate prepackaged server: LLM token generation with continuous
batching behind the unary predict protocol, in PyTorch.

Counterpart of ``seldon_core_tpu/servers/generateserver.py``
(``GenerateServer``), core only. Model URI layout: the same
``jax_config.json`` as ``servers/torchserver`` with ``"family": "llm"``.
Server parameters (typed, e.g. from ``PREDICTIVE_UNIT_PARAMETERS``)::

    device           "cuda" (default) or "cpu"; CUDA missing -> error
    slots            decode lanes (default 8)
    max_seq          cache length override
    steps_per_poll   decode steps per burst (default 8; pow2-floored)
    pipeline_depth   bursts in flight before the host reads the oldest
                     (default 3; 1 = synchronous)
    attn_bucket      attention-read bucket granularity (default 128)
    fused_steps_per_dispatch
                     fused stop-aware decode: up to this many steps per
                     dispatch with on-device stop detection (0 = off)
    depth_groups     depth-aware decode: at most this many sub-bursts per
                     poll, lanes grouped by attention bucket (0/1 = off)
    depth_group_split_bytes
                     the modelled price of one more sub-burst (default:
                     the params' bytes; 0 = always split)
    prefill_chunk    chunked prefill: prompts whose bucket exceeds this
                     many tokens prefill one chunk per poll (0 = off)
    restart_budget / restart_backoff_s
                     scheduler supervision (defaults 3 / 0.5)
    admit_queue_limit
                     admit-queue cap; a submit past it is shed with
                     ShedError (429 at the engine); 0 = no cap
    prefix_cache_hbm_bytes
                     radix prefix KV-cache budget in device bytes (0 =
                     off): finished requests publish their prompt's K/V,
                     later prompts sharing a prefix splice it and prefill
                     only the suffix; responses then carry per-request
                     ``cache_hit_tokens``
    prefix_cache_min_tokens
                     shortest prefix worth caching or reusing (default 16)
    hbm_ledger_bytes HBM-pressure budget of the scheduler's ledger (live
                     decode footprint + staging slabs + prefix cache; 0 =
                     off). Over the high watermark the reclaim ladder
                     evicts prefixes, preempts decode lanes (checkpoint on
                     the host, recompute-resume, same tokens) and sheds
                     admissions (429 at the engine)
    pressure_high / pressure_low
                     the watermarks as fractions of the budget (defaults
                     0.90 / 0.75)
    speculate_tokens speculative decoding: a draft proposes this many
                     tokens per round, one target forward verifies them
                     (0 = off). Exact for any draft: greedy lanes emit the
                     target's argmax decode, temperature lanes use
                     speculative sampling. Needs a draft:
    draft_layers     early-exit self-draft: the first N layers of the
                     served model (embed, unembed and final norm shared,
                     the blocks sliced as views: no second copy)
    draft_uri        a separate draft model directory (same layout, same
                     vocab), loaded like the served model
    warmup_prompt_lens / warmup_max_new_tokens
                     traffic shape ``warm()`` runs before the server
                     listens (CSV string or list)
    role             ``unified`` (default: prefill and decode here) |
                     ``prefill`` (prompt prefill only, the K/V slab
                     exported over the KV transport: one lane, no
                     scheduler loop, no generate traffic) | ``decode``
                     (prefill at the ``peer`` pool, the slab spliced into
                     decode lanes here). Refused with speculation
    peer             decode role: the prefill pool's KV endpoints, a
                     comma-separated ``host:port`` list; peers are probed,
                     ejected with backoff on a failed transfer and
                     readmitted on a good probe, a failed transfer retries
                     once on the next peer, and with the whole pool
                     ejected the prompt is prefilled here
                     (``degraded_local_prefill``). ``set_peer()`` wires
                     live prefill servers instead (loopback transport,
                     same codec, in memory)
    kv_port          prefill role: TCP port of the KV export listener
                     (0 = none, loopback only)
    kv_chunk_bytes   KV transport write size (default 1 MiB)
    peer_eject_backoff_s
                     decode role: first re-probe backoff of an ejected
                     peer (exponential, capped at 30 s; default 1.0)
    host_kv_tier_bytes
                     host-RAM KV tier budget (0 = off): reclaim demotes
                     prefix slabs there instead of dropping them (a later
                     match promotes them back), preempted lanes
                     checkpoint their K/V for a copy-back resume, prefill
                     exports publish their slabs for peers, and the KV
                     port answers peer prefix lookups from it
    kv_tier_min_tokens / kv_tier_promote_min_tokens
                     the tier's demote and promote thresholds (0 =
                     prefix_cache_min_tokens / the demote threshold)
    kv_tier_peer_lookup
                     decode role: ask the prefill peers' tiers for a
                     shared prefix before a full prefill (-1 = on exactly
                     when host_kv_tier_bytes is set, 0 = off, 1 = on)
    resume_tokens    live migration: every streamed span (and the unary
                     response) carries an opaque SGC1 resume token
                     (``serving/migration.py``); after a member death the
                     token resumes the generation on any peer serving the
                     same ``weight_version``, the same tokens with no
                     span re-sent (0 = off; refused with speculation)
    swap_drain_ms    hot-swap straggler bound: after this long draining a
                     staged weight swap, the remaining in-flight lanes are
                     checkpointed (0 = wait forever)
    swap_resume_policy
                     what becomes of those lanes: ``resume`` (default)
                     finishes them on the new weights, ``fail`` refuses
                     them with a 409
    tenants          multi-tenant paging: ``name=slo_class[@model_uri]``
                     entries, comma-separated (slo_class strict |
                     standard | best_effort); the first tenant boots
                     resident on ``model_uri``, the others must share its
                     architecture. Needs:
    weight_pager_host_bytes
                     the pager's host-RAM budget for the tenants'
                     checkpoints (half of it caps one checkpoint)
    tenant_tick_ms / tenant_max_wait_polls / tenant_min_resident_ms
                     the tenant scheduler's wake period, its starvation
                     bound in batcher polls and the least time a tenant
                     stays resident while it has work (20 / 256 / 50)
    flight_recorder  the scheduler flight recorder's capacity (default 512,
                     0 = off): per-poll decision records and scheduling
                     events, served by :meth:`GenerateServer.flight_dump`
                     (the ``/flightrecorder`` route)
    profiler         the device-time ledger (``serving/profiler.py``; 0 =
                     off, the default): every dispatch timed with CUDA
                     events and attributed per (kind, variant, tenant),
                     exported as ``gen_device_*`` series
    profiler_deep_every
                     the JAX package's deep samples: refused above 0 (the
                     scheduler's ``gen.*`` ranges name every dispatch in a
                     trace taken through ``tracing.start_device_profile``)
    profiler_hbm_gb_s / profiler_dispatch_floor_us
                     the denominators of the live ``gen_mbu_pct`` and
                     ``gen_dispatch_floor_pct`` gauges (0 = omit the gauge)
    slo_objectives   SLO burn-rate objectives, ``slo:threshold_ms:target``
                     entries, comma-separated (``ttft:200:0.99``); the
                     completed requests' samples feed the burn engine
                     (``serving/slo_burn.py``) and ``gen_slo_*`` series
    slo_fast_window_s / slo_slow_window_s
                     the burn engine's windows (60 / 3600)

Sharded serving (the JAX server's mesh parameters):

    mesh             an explicit ``parallel/mesh.py`` ``ServingMesh`` (the
                     engine hands the control plane's placement here); it
                     always wins over ``mesh_shape``
    mesh_shape       build a serving mesh at load: ``"data=2,model=4"``
                     (strict, refused at construction when malformed) or
                     ``"auto"`` (every visible device factored, collapsed
                     to ``data x model``). The params and the KV cache are
                     stored split over the mesh, the compute runs on its
                     first device; greedy and seeded tokens equal the
                     unmeshed server's. ``model`` must divide n_heads and
                     d_ff (refused at load)
    shard_cache_seq  split the KV cache length over the mesh's ``seq`` axis

The fault config's ``pressure`` section
(``SELDON_FAULTS``) drives the ledger's budget mid-run, its ``kv_*``
rules perturb the decode role's transfers per peer.

Live retune: :meth:`GenerateServer.retune` (the engine's ``/retune``),
:meth:`GenerateServer.retune_census` and
:meth:`GenerateServer.serving_config`.

Migration and swap entry points: :meth:`GenerateServer.drain_to`
(checkpoint every generation and hand it to a peer server or, over TCP,
a peer engine's ``/drain``), :meth:`GenerateServer.resume_checkpoint`
and :meth:`GenerateServer.hot_swap` / ``cancel_hot_swap`` (the engine's
``/weights/swap``).

The remaining deadline budget in the message meta (``deadlineMs``,
stamped per in-process hop by the engine) bounds each request: the
batcher sheds a submit whose expected queue wait outlives it, and a
request still running at its deadline is cancelled (lane freed) and
answered with ``DeadlineExceeded`` (504 at the engine).

:meth:`GenerateServer.stream` is the streaming twin of ``predict``: one
prompt, validated and submitted before any byte goes out, its tokens
delivered span by span through a :class:`StreamHandle`.

Requests are parsed and queued on the caller's thread as host lists;
every device operation runs on the batcher's scheduler thread.

Request (jsonData)::

    {"prompt_tokens": [1, 2, ...],        # or "prompt": "text" (byte-level)
     "max_new_tokens": 32, "temperature": 0.0, "eos_id": null, "seed": 0,
     "tenant": "acme"}                    # multi-tenant servers only

or ``{"resume_token": "..."}``: continue the generation a token
describes (400 for a malformed token, 409 for another weight version).

``prompt_tokens`` may be a list of lists: each prompt is submitted
separately and rides the same in-flight decode batch.

Response (jsonData): ``{"tokens": [[...]], "text": [...],
"cache_hit_tokens": [...], "resume_tokens": [...]}`` (``text`` only for
byte-level string prompts, ``cache_hit_tokens`` only with the prefix
cache on -- for a decode role these tokens' K/V never crossed the wire
-- and ``resume_tokens`` only with ``resume_tokens`` on). The response
meta's tags carry the served ``weight_version``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from ..analysis.roles import caller_thread
from ..device import resolve_device
from ..metrics import CounterDeltas
from ..resilience import DeadlineExceeded, FaultInjector, deadline_s_from_meta
from ..user_model import SeldonComponent
from .torchserver import TorchServer

logger = logging.getLogger(__name__)

# parameters of the JAX GenerateServer whose feature the port does not
# have, with their off value (other JAX-server parameters, which only act
# through one of these, are accepted and ignored, as the JAX server
# accepts unknown ones): the ledger's deep samples, whose ranges the
# scheduler's own ``gen.*`` ranges replace
_NOT_PORTED: Dict[str, Any] = {"profiler_deep_every": 0}


def _is_off(name: str, value, off) -> bool:
    if value == off:
        return True
    if isinstance(value, str):
        v = value.strip().lower()
        if isinstance(off, str):
            return v == off
        return v in ("", "0", "none", "null", "false")
    return False


@dataclasses.dataclass
class StreamHandle:
    """A live token stream: iterate ``chunks``; call ``cancel()`` when the
    consumer goes away so the decode lane is reclaimed."""

    chunks: Iterable
    cancel: Callable[[], bool]
    # the prompt's tokens (the engine's span tags it)
    prompt_len: int = 0


class GenerateServer(SeldonComponent):
    # class-level defaults: a partly built instance behaves as the
    # unified role with no transport endpoints
    _role = "unified"
    _kv_server = None
    _kv_client = None
    _resume_tokens = False
    batcher = None
    tenant_pager = None
    tenant_scheduler = None
    profiler = None
    slo_burn = None

    def __init__(
        self,
        model_uri: str,
        device: str = "cuda",
        slots: int = 8,
        max_seq: Optional[int] = None,
        steps_per_poll: int = 8,
        pipeline_depth: int = 3,
        attn_bucket: int = 128,
        fused_steps_per_dispatch: int = 0,
        depth_groups: int = 0,
        depth_group_split_bytes: Optional[int] = None,
        prefill_chunk: int = 0,
        restart_budget: int = 3,
        restart_backoff_s: float = 0.5,
        admit_queue_limit: int = 0,
        prefix_cache_hbm_bytes: int = 0,
        prefix_cache_min_tokens: int = 16,
        hbm_ledger_bytes: int = 0,
        pressure_high: float = 0.90,
        pressure_low: float = 0.75,
        speculate_tokens: int = 0,
        draft_layers: int = 0,
        draft_uri: Optional[str] = None,
        warmup_prompt_lens: Optional[Sequence[int]] = None,
        warmup_max_new_tokens: int = 0,
        role: str = "unified",
        peer: Optional[str] = None,
        kv_port: int = 0,
        kv_chunk_bytes: int = 1 << 20,
        peer_eject_backoff_s: float = 1.0,
        host_kv_tier_bytes: int = 0,
        kv_tier_min_tokens: int = 0,
        kv_tier_promote_min_tokens: int = 0,
        kv_tier_peer_lookup: int = -1,
        resume_tokens: int = 0,
        swap_drain_ms: int = 0,
        swap_resume_policy: str = "resume",
        tenants: Optional[str] = None,
        weight_pager_host_bytes: int = 0,
        tenant_tick_ms: int = 20,
        tenant_max_wait_polls: int = 256,
        tenant_min_resident_ms: int = 50,
        flight_recorder: int = 512,
        profiler: int = 0,
        profiler_hbm_gb_s: float = 0.0,
        profiler_dispatch_floor_us: float = 0.0,
        slo_objectives: Optional[str] = None,
        slo_fast_window_s: float = 60.0,
        slo_slow_window_s: float = 3600.0,
        mesh=None,
        mesh_shape: Optional[str] = None,
        shard_cache_seq=False,
        **kwargs,
    ):
        for name, value in kwargs.items():
            if name in _NOT_PORTED and not _is_off(name, value, _NOT_PORTED[name]):
                raise NotImplementedError(
                    f"GenerateServer parameter {name}={value!r} is not ported to "
                    "seldon_core_tpu_torch yet (only its off value "
                    f"{_NOT_PORTED[name]!r} is supported)"
                )
        role = str(role or "unified").strip().lower()
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"role must be unified|prefill|decode, got {role!r}")
        if role != "unified" and int(speculate_tokens) > 0:
            raise ValueError(
                "disaggregated roles do not support speculative decoding "
                "(the draft cache cannot cross the KV transport)"
            )
        self._role = role
        self._mesh = mesh
        # the mesh knob, parsed strictly here (a malformed shape refuses
        # at construction, never mid-load); "auto" factors at load
        self._mesh_shape: Optional[Any] = None
        if isinstance(mesh_shape, str):
            mesh_shape = mesh_shape.strip()
        if mesh_shape:
            if str(mesh_shape).lower() == "auto":
                self._mesh_shape = "auto"
            else:
                from ..parallel.mesh import parse_mesh_shape

                self._mesh_shape = parse_mesh_shape(str(mesh_shape))
        self._shard_cache_seq = (
            shard_cache_seq.strip().lower() in ("1", "true", "yes")
            if isinstance(shard_cache_seq, str) else bool(shard_cache_seq)
        )
        # typed parameters deliver booleans as strings
        self._resume_tokens = (
            resume_tokens.strip().lower() == "true"
            if isinstance(resume_tokens, str) and not resume_tokens.strip().isdigit()
            else bool(int(resume_tokens))
        )
        if self._resume_tokens and int(speculate_tokens) > 0:
            raise ValueError(
                "resume_tokens is not supported with speculative decoding (the token's "
                "RNG re-derivation assumes the plain decode split chain)"
            )
        self._swap_drain_ms = int(swap_drain_ms)
        self._swap_resume_policy = str(swap_resume_policy or "resume")
        self._swap_count = 0
        # multi-tenancy: the strict spec grammar, refused at construction;
        # the pager's host budget gates the whole subsystem
        self._tenant_spec = None
        if not _is_off("tenants", tenants, None):
            from ..serving.weightpager import parse_tenant_spec

            self._tenant_spec = parse_tenant_spec(str(tenants))
        self._weight_pager_host_bytes = int(weight_pager_host_bytes)
        if self._tenant_spec and self._weight_pager_host_bytes <= 0:
            raise ValueError("tenants configured but weight_pager_host_bytes is 0 — the "
                             "pager's host-RAM staging budget must be set")
        if self._tenant_spec and role != "unified":
            raise ValueError("multi-tenant paging is not supported on disaggregated roles "
                             "(the KV transport assumes one weight lineage)")
        self._tenant_tick_ms = int(tenant_tick_ms)
        self._tenant_max_wait_polls = int(tenant_max_wait_polls)
        self._tenant_min_resident_ms = int(tenant_min_resident_ms)
        self.tenant_pager = None  # WeightPager, set at load
        self.tenant_scheduler = None  # TenantScheduler, set at load
        self._peer = None if _is_off("peer", peer, None) else peer
        self._kv_port = int(kv_port)
        self._kv_chunk_bytes = int(kv_chunk_bytes)
        self._peer_eject_backoff_s = float(peer_eject_backoff_s)
        self._host_kv_tier_bytes = int(host_kv_tier_bytes)
        self._kv_tier_min_tokens = int(kv_tier_min_tokens)
        self._kv_tier_promote_min_tokens = int(kv_tier_promote_min_tokens)
        # -1 = auto: peer prefix lookups ride exactly the tier knob
        self._kv_tier_peer_lookup = (
            self._host_kv_tier_bytes > 0
            if int(kv_tier_peer_lookup) < 0 else bool(int(kv_tier_peer_lookup))
        )
        self._kv_server = None  # PrefillTransportServer (prefill role)
        self._kv_client = None  # FailoverKVClient over the peers (decode role)
        self._faults = None
        self.model_uri = model_uri
        self.device = resolve_device(device)
        self._slots = int(slots)
        self._max_seq = int(max_seq) if max_seq else None
        self._steps_per_poll = int(steps_per_poll)
        self._pipeline_depth = int(pipeline_depth)
        self._attn_bucket = int(attn_bucket)
        self._fused_steps_per_dispatch = int(fused_steps_per_dispatch)
        self._depth_groups = int(depth_groups)
        split = depth_group_split_bytes
        if isinstance(split, str) and split.strip().lower() in ("", "none", "null"):
            split = None
        self._depth_group_split_bytes = int(split) if split is not None else None
        self._prefill_chunk = int(prefill_chunk)
        self._restart_budget = int(restart_budget)
        self._restart_backoff_s = float(restart_backoff_s)
        self._admit_queue_limit = int(admit_queue_limit)
        self._prefix_cache_hbm_bytes = int(prefix_cache_hbm_bytes)
        self._prefix_cache_min_tokens = int(prefix_cache_min_tokens)
        self._hbm_ledger_bytes = int(hbm_ledger_bytes)
        self._pressure_high = float(pressure_high)
        self._pressure_low = float(pressure_low)
        self._speculate_tokens = int(speculate_tokens)
        self._draft_layers = int(draft_layers)
        self._draft_uri = None if _is_off("draft_uri", draft_uri, None) else str(draft_uri)
        if isinstance(warmup_prompt_lens, str):
            warmup_prompt_lens = [
                int(x) for x in warmup_prompt_lens.split(",") if x.strip()
            ]
        self._warmup_prompt_lens = list(warmup_prompt_lens or [])
        self._warmup_max_new_tokens = int(warmup_max_new_tokens)
        self._deltas = CounterDeltas()
        self._flight_recorder = int(flight_recorder)
        # the device-time ledger: off by default (a shared no-op then)
        from ..serving.profiler import DeviceTimeLedger

        self.profiler = DeviceTimeLedger(
            enabled=bool(int(profiler)),
            hbm_gb_s=float(profiler_hbm_gb_s),
            dispatch_floor_us=float(profiler_dispatch_floor_us),
        )
        # SLO burn-rate engine, fed by the completed-request samples
        # metrics() drains; "slo:threshold_ms:target" entries, parsed
        # strictly here
        self.slo_burn = None
        if not _is_off("slo_objectives", slo_objectives, None):
            from ..serving.slo_burn import SloBurnEngine, SloObjective

            objs = []
            for ent in str(slo_objectives).split(","):
                ent = ent.strip()
                if not ent:
                    continue
                parts = ent.split(":")
                if len(parts) != 3:
                    raise ValueError("slo_objectives entries are slo:threshold_ms:target "
                                     f"(e.g. ttft:200:0.99), got {ent!r}")
                objs.append(SloObjective(parts[0].strip(), float(parts[1]) * 1e-3,
                                         float(parts[2])))
            self.slo_burn = SloBurnEngine(objs, fast_window_s=float(slo_fast_window_s),
                                          slow_window_s=float(slo_slow_window_s))
        self.batcher = None
        self._model = None

    @staticmethod
    def _cast_params_freeing(tree, dt):
        """Cast float32 leaves to ``dt`` in place through nested dicts,
        dropping each float32 leaf as it is replaced, so the float32 and
        the cast copy of the whole model are never resident together."""
        import torch

        for key in list(tree):
            v = tree[key]
            if isinstance(v, dict):
                GenerateServer._cast_params_freeing(v, dt)
            elif isinstance(v, torch.Tensor) and v.dtype == torch.float32:
                tree[key] = v.to(dt)
            del v
        return tree

    def load(self) -> None:
        import torch

        from ..serving.continuous import ContinuousBatcher

        if self._mesh is None and self._mesh_shape is not None:
            self._mesh = self._build_mesh()
        if self._mesh is not None:
            # the mesh's first device computes: the weights load there
            self.device = self._mesh.device
        server = TorchServer(self.model_uri, device=self.device)
        _apply, params = server.build()
        self._model = server._model
        if self._model is None or not hasattr(self._model, "decode_step_ragged_list"):
            raise RuntimeError(
                f"model family {getattr(self._model, '__class__', None)} "
                "does not support generate(); use family 'llm'"
            )
        if self._mesh is not None:
            from ..parallel.mesh import validate_model_dims

            cfg = self._model.cfg
            validate_model_dims(self._mesh.shape, int(cfg.n_heads), int(cfg.d_ff),
                                n_kv_heads=int(cfg.n_kv_heads))
        dt = self._model.dtype
        if dt != torch.float32:
            params = self._cast_params_freeing(params, dt)
        draft_model, draft_params = self._build_draft(params)
        self.batcher = ContinuousBatcher(
            self._model,
            params,
            # a prefill-role server runs no decode lanes: its slabs are
            # exported, never inserted here -- one lane keeps the cache
            # allocation minimal
            slots=1 if self._role == "prefill" else self._slots,
            max_seq=self._max_seq,
            steps_per_poll=self._steps_per_poll,
            pipeline_depth=self._pipeline_depth,
            attn_bucket=self._attn_bucket,
            fused_steps_per_dispatch=self._fused_steps_per_dispatch,
            depth_groups=self._depth_groups,
            depth_group_split_bytes=self._depth_group_split_bytes,
            prefill_chunk=self._prefill_chunk,
            restart_budget=self._restart_budget,
            restart_backoff_s=self._restart_backoff_s,
            admit_queue_limit=self._admit_queue_limit,
            prefix_cache_hbm_bytes=self._prefix_cache_hbm_bytes,
            prefix_cache_min_tokens=self._prefix_cache_min_tokens,
            hbm_ledger_bytes=self._hbm_ledger_bytes,
            pressure_high=self._pressure_high,
            pressure_low=self._pressure_low,
            draft_model=draft_model,
            draft_params=draft_params,
            speculate_tokens=self._speculate_tokens,
            host_kv_tier_bytes=self._host_kv_tier_bytes,
            kv_tier_min_tokens=self._kv_tier_min_tokens,
            kv_tier_promote_min_tokens=self._kv_tier_promote_min_tokens,
            swap_drain_ms=self._swap_drain_ms,
            swap_resume_policy=self._swap_resume_policy,
            flight_recorder_capacity=self._flight_recorder,
            profiler=self.profiler,
            mesh=self._mesh,
            shard_cache_seq=self._shard_cache_seq,
        )
        # chaos harness (off without SELDON_FAULTS): the scheduler section
        # wires induced poll death onto the batcher's fault hook, the
        # pressure section a mid-run ledger re-budget (before warm(), so
        # that it captures the resume's replay step); kv rules are
        # resolved per peer when the transports are built
        self._faults = faults = FaultInjector.from_env()
        if faults is not None:
            self.batcher.fault_hook = faults.scheduler_hook()
            self.batcher.pressure_hook = faults.pressure_hook()
        if self._tenant_spec:
            # every tenant staged and the version lineage aligned to the
            # first tenant's namespaced version before warm(): one warm
            # serves all tenants (kernels and graphs are shape-keyed)
            self._load_tenants(params)
        if self._warmup_prompt_lens:
            # warm before listen: the first admission wave must not pay
            # the kernel build, the libraries' first-call setup or the
            # capture of the decode-burst CUDA graphs
            self.batcher.warm(
                prompt_lens=self._warmup_prompt_lens,
                max_new_tokens=self._warmup_max_new_tokens,
            )
        if self._role == "prefill":
            # no scheduler loop: export_prefill runs on the transport's
            # handler threads, decode lanes never activate
            if self._kv_port:
                from ..serving.disagg import PrefillTransportServer

                self._kv_server = PrefillTransportServer(
                    self, port=self._kv_port, chunk_bytes=self._kv_chunk_bytes)
                logger.info("generateserver: prefill role exporting KV on :%d",
                            self._kv_server.port)
        else:
            self.batcher.start()
            if self.tenant_scheduler is not None:
                # the page-in thread waits on scheduler progress, so it
                # starts once the poll loop is live
                self.tenant_scheduler.start()
        if self._role == "decode" and self._peer is not None:
            self._kv_client = self._build_failover(self._peer)
        logger.info(
            "generateserver: %s ready on %s (role=%s, slots=%d, max_seq=%d)",
            self.model_uri, self.device, self._role, self._slots, self.batcher.max_seq,
        )

    def _build_mesh(self):
        """The serving mesh of the ``mesh_shape`` knob over this server's
        device type: ``auto`` factors every visible device and collapses
        the factors to ``data x model`` (generate serving runs no pipeline
        axis, and ``seq`` pays only with ``shard_cache_seq``, which takes
        an explicit shape)."""
        from ..parallel.mesh import factor_devices, make_serving_mesh, serving_device_count

        if self._mesh_shape == "auto":
            f = factor_devices(serving_device_count(self.device))
            shape = {"data": f["data"] * f["stage"] * f["seq"], "model": f["model"]}
        else:
            shape = dict(self._mesh_shape)
        mesh = make_serving_mesh(shape, device=self.device)
        logger.info("generateserver: sharded serving mesh %s over %d device(s)",
                    shape, mesh.size)
        return mesh

    def _build_draft(self, params):
        """``(draft_model, draft_params)`` for speculation, or ``(None,
        None)`` when ``speculate_tokens`` is 0. ``draft_uri`` loads a
        separate draft like the served model; ``draft_layers`` N builds
        the early-exit self-draft: the served model's first N layers,
        sharing its embed, unembed and final norm, its blocks sliced as
        views of the served (already cast) tensors."""
        import dataclasses as _dc

        from ..models.llm import DecoderLM

        if self._speculate_tokens <= 0:
            return None, None
        if self._draft_uri:
            dserver = TorchServer(self._draft_uri, device=self.device)
            _apply, dparams = dserver.build()
            dmodel = dserver._model
            return dmodel, self._cast_params_freeing(dparams, dmodel.dtype)
        if self._draft_layers > 0:
            n_layers = self._model.cfg.n_layers
            if self._draft_layers >= n_layers:
                raise ValueError(
                    f"draft_layers ({self._draft_layers}) must be < the served "
                    f"model's n_layers ({n_layers})"
                )
            cfg = _dc.asdict(self._model.cfg)
            cfg["n_layers"] = self._draft_layers
            dmodel = DecoderLM(device=self.device, **cfg)
            blocks = {name: w[: self._draft_layers] for name, w in params["blocks"].items()}
            return dmodel, {**params, "blocks": blocks}
        raise ValueError("speculate_tokens needs draft_layers or draft_uri")

    def _load_checkpoint(self, model_uri: str, what: str):
        """A checkpoint of the served architecture in the serving dtype,
        on this server's device: the params of a hot swap or a tenant.
        ``residual_scale`` is ignored (it only shapes random init)."""
        import torch

        server = TorchServer(model_uri, device=self.device)
        _apply, params = server.build()
        other = server._model
        if other is None or not hasattr(other, "cfg"):
            raise ValueError(f"{what} checkpoint at {model_uri!r} is not an llm-family model dir")
        served_cfg = dataclasses.asdict(self._model.cfg)
        other_cfg = dataclasses.asdict(other.cfg)
        served_cfg.pop("residual_scale", None)
        other_cfg.pop("residual_scale", None)
        if other_cfg != served_cfg:
            changed = sorted(k for k in set(other_cfg) | set(served_cfg)
                             if other_cfg.get(k) != served_cfg.get(k))
            raise ValueError(
                f"{what} checkpoint architecture differs from the served model "
                f"({', '.join(changed)}); same-shape checkpoints only")
        dt = self._model.dtype
        if dt != torch.float32:
            params = self._cast_params_freeing(params, dt)
        return params

    def _load_tenants(self, primary_params) -> None:
        """Stage every declared tenant's checkpoint in the weight pager
        and align the batcher's version lineage to the first tenant's
        namespaced version. The others load as hot swaps do (same
        architecture, cast to the serving dtype before staging, so a
        page-in is decode and upload)."""
        from ..serving.weightpager import TenantScheduler, WeightPager

        pager = WeightPager(self._weight_pager_host_bytes)
        primary, primary_slo, primary_uri = self._tenant_spec[0]
        if primary_uri and primary_uri != self.model_uri:
            raise ValueError(
                f"primary tenant {primary!r} declares model uri {primary_uri!r} but the "
                f"server loads {self.model_uri!r} — the first tenant boots resident on "
                "the served model")
        v0 = pager.put(primary, primary_params, primary_slo)
        pager.mark_resident(primary)
        for name, slo, uri in self._tenant_spec[1:]:
            pager.put(name, self._load_checkpoint(uri or self.model_uri, f"tenant {name!r}"),
                      slo)
        b = self.batcher
        # caches are empty: adopting the namespaced version purges nothing
        b.weight_version = v0
        if b._prefix_index is not None:
            b._prefix_index.set_version(v0)
        if b._kv_tier is not None:
            b._kv_tier.set_version(v0)
        b.tenant_pager = self.tenant_pager = pager
        self.tenant_scheduler = TenantScheduler(
            b, pager, {name: slo for name, slo, _uri in self._tenant_spec},
            tick_s=self._tenant_tick_ms / 1e3,
            max_wait_polls=self._tenant_max_wait_polls,
            min_resident_s=self._tenant_min_resident_ms / 1e3,
        )
        logger.info("generateserver: multi-tenant paging over %d tenant(s), %d host-staging "
                    "bytes, resident=%s", len(self._tenant_spec),
                    self._weight_pager_host_bytes, primary)

    def _encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def _decode(self, tokens: Iterable[int]) -> str:
        return bytes(t for t in tokens if 0 <= t < 256).decode("utf-8", "replace")

    def _parse_prompts(self, body: Dict[str, Any]):
        """Wire-schema parser: returns (token_lists, text_mode, sampling
        kwargs)."""
        if "prompt" in body and "prompt_tokens" not in body:
            prompts = body["prompt"]
            prompts = [prompts] if isinstance(prompts, str) else list(prompts)
            token_lists = [self._encode(p) for p in prompts]
            text_mode = True
        else:
            pt = body.get("prompt_tokens")
            if not pt:
                raise ValueError("need prompt_tokens or prompt")
            token_lists = (
                [list(p) for p in pt] if isinstance(pt[0], (list, tuple)) else [list(pt)]
            )
            text_mode = False
        kw = dict(
            max_new_tokens=int(body.get("max_new_tokens", 32)),
            temperature=float(body.get("temperature", 0.0)),
            eos_id=body.get("eos_id"),
            seed=int(body.get("seed", 0)),
        )
        return token_lists, text_mode, kw

    # -- disaggregated serving (prefill/decode pools) ------------------------

    def _note_peer_event(self, kind: str, addr: str, reason: str = "") -> None:
        """Counter and flight-record hook of the failover transport's
        eject/readmit decisions (``peer_ejected`` / ``peer_readmitted``
        records, ``peer_ejections`` / ``peer_readmissions`` counters)."""
        b = self.batcher
        if b is None:
            return
        key = "peer_ejections" if kind == "peer_ejected" else "peer_readmissions"
        with b._export_lock:
            b.stats[key] += 1
        rec = {"type": kind, "peer": addr}
        if reason:
            rec["reason"] = reason
        b._flight(rec)

    def _build_failover(self, peers):
        """Decode role: the peer list (a comma-separated ``host:port``
        string, a live server object, or a sequence of either) becomes
        one FailoverKVClient with this server's ejection counters and
        per-peer chaos faults wired in."""
        from ..serving.disagg import make_failover

        injector = self._faults
        return make_failover(
            peers,
            chunk_bytes=self._kv_chunk_bytes,
            fault_for=injector.kv_faults_for if injector is not None else None,
            eject_backoff_s=self._peer_eject_backoff_s,
            on_eject=lambda addr, reason: self._note_peer_event("peer_ejected", addr, reason),
            on_readmit=lambda addr: self._note_peer_event("peer_readmitted", addr),
        )

    def set_peer(self, prefill_server) -> None:
        """Wire a decode-role server to its prefill peer(s): a live
        prefill GenerateServer (loopback transport: the slab still
        round-trips the full codec in memory), a ``host:port`` string
        (TCP; comma-separated for a list), or a sequence of either."""
        if self._role != "decode":
            raise RuntimeError(f"set_peer on a {self._role}-role server")
        self._kv_client = self._build_failover(prefill_server)

    def kv_ping(self) -> bool:
        """Loopback health probe target: True while this server's batcher
        can still serve prefill exports."""
        return self.batcher is not None and self.batcher.health == "serving"

    @caller_thread
    def prefill_export(self, request: Dict[str, Any]):
        """PREFILL-side transport handler: run the prompt forward and
        return ``(meta, slab)`` for the wire codec (the loopback transport
        calls it directly, PrefillTransportServer per TCP connection). A
        ``prefix_lookup`` request is answered from the host KV tier
        instead, with no device work."""
        if self.batcher is None:
            self.load()
        if request.get("prefix_lookup"):
            return self._tier_lookup(request)
        toks = request.get("tokens")
        if not toks:
            raise ValueError("prefill request needs tokens")
        return self.batcher.export_prefill(
            [int(t) for t in toks],
            max_new_tokens=int(request.get("max_new_tokens", 32)),
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"),
            seed=int(request.get("seed", 0)),
            covered_len=int(request.get("covered_len", 0)),
        )

    @caller_thread
    def _tier_lookup(self, request: Dict[str, Any]):
        """Answer a peer's prefix lookup from the local host tier: the
        stored entry covering the prompt's longest prefix, whole (the
        puller re-inserts it and lets its own radix match serve the
        common depth), or a typed TierMiss the failover layer passes
        without ejecting. Host bytes only: never the device."""
        from ..serving.disagg import TierMiss

        b = self.batcher
        tier = b._kv_tier
        toks = [int(t) for t in request.get("tokens") or []]
        if tier is None or not toks:
            raise TierMiss("no host KV tier on this member")
        if request.get("weight_version") != b.weight_version:
            raise TierMiss(
                f"tier serves weight_version {b.weight_version!r}, peer asked for "
                f"{request.get('weight_version')!r}"
            )
        # the shared usable-hit probe: the puller's own gate and caps run
        # here, before the transfer is paid
        hit = b.tier_prefix_lookup(toks, min_tokens=int(request.get("min_tokens", 0)))
        if hit is None:
            raise TierMiss("no usable stored prefix for this prompt (miss, below the "
                           "promote gate, or not a win at this prompt's bucket)")
        depth, meta, slab = hit
        with b._export_lock:
            b.stats["kv_tier_hits"] = tier.stats["hits"]
        from ..serving.disagg import prompt_hash

        b._flight({"type": "tier_hit", "kind": "prefix", "source": "peer", "tokens": depth,
                   "phash": prompt_hash(meta.get("tokens") or [])[:8]})
        out_meta = {
            "kind": "tier_prefix",
            "tokens": meta.get("tokens"),
            "weight_version": b.weight_version,
            "tier_depth": depth,
        }
        return out_meta, slab

    @caller_thread
    def _peer_prefix_pull(self, toks, deadline_s) -> int:
        """Decode-role tier sharing: on a local radix miss, ask the
        prefill peers' host tiers for a shared prefix and promote the
        answer into the local radix index. Returns the new
        ``remote_covered_len`` (0 when nothing was pulled); misses and
        transport trouble are non-events."""
        from ..serving.disagg import DisaggError

        b = self.batcher
        try:
            meta, slab = self._kv_client.prefill({
                "prefix_lookup": True,
                "tokens": [int(t) for t in toks],
                "weight_version": b.weight_version,
                "min_tokens": b.tier_promote_gate,
            }, deadline_s=deadline_s)
        except DisaggError:
            # a miss, or peer trouble the failover layer has handled
            return 0
        if meta.get("weight_version") != b.weight_version:
            return 0
        b.promote_peer_prefix(meta, slab)
        return b.remote_covered_len(toks)

    @caller_thread
    def _remote_submit(self, toks, kw, deadline_s, covered=None, on_tokens=None):
        """Decode-role submit: bounds-check and shed BEFORE the handoff,
        find the transfer-dedup base (the local radix cache, then this
        member's own tier, then the peers' tiers), pull the slab
        (suffix-only when possible) from the prefill pool and queue it as
        a remote lane insert. With the whole prefill pool ejected, serve
        the prompt with a local prefill instead."""
        from ..serving.continuous import PromptTooLong
        from ..serving.disagg import AllPeersDown

        if self._kv_client is None:
            raise RuntimeError("decode role has no prefill peer (set `peer` or call set_peer())")
        b = self.batcher
        # a prefill-side PromptTooLong would come back over TCP as a
        # generic error frame the failover layer reads as peer death:
        # check here, so one unservable request never ejects a peer
        n = len(toks)
        if n >= b.max_seq:
            raise PromptTooLong(f"prompt of {n} exceeds max_seq {b.max_seq}")
        b._check_budget(n, kw.get("max_new_tokens", 32))
        # an overloaded decode pool refuses before the prefill pool and
        # the wire pay for a slab it would refuse on arrival
        b._shed_check(deadline_s, remote=True)
        if covered is None:
            covered = b.remote_covered_len(toks)
            if covered == 0 and b._kv_tier is not None:
                covered = b.consult_tier_covered_len(toks)
            if (covered == 0 and self._kv_tier_peer_lookup and b._prefix_index is not None
                    and n >= b.tier_promote_gate):
                covered = self._peer_prefix_pull(toks, deadline_s)
        request = {"tokens": [int(t) for t in toks], "covered_len": int(covered), **kw}
        try:
            meta, slab = self._kv_client.prefill(request, deadline_s=deadline_s)
        except AllPeersDown as e:
            return self._local_prefill_fallback(toks, kw, deadline_s, on_tokens, str(e))
        return b.admit_remote(slab, meta, on_tokens=on_tokens, deadline_s=deadline_s)

    @caller_thread
    def _local_prefill_fallback(self, toks, kw, deadline_s, on_tokens, reason: str):
        """The whole prefill pool is ejected: serve the prompt with a
        local unified prefill instead of failing it, counted in
        ``degraded_local_prefill`` while the failover layer keeps probing
        the pool back in."""
        b = self.batcher
        with b._export_lock:
            b.stats["degraded_local_prefill"] += 1
        b._flight({"type": "degraded_local_prefill", "tokens": len(toks), "reason": reason})
        logger.warning("prefill pool fully ejected (%s); serving %d-token prompt with "
                       "local unified prefill", reason, len(toks))
        return b.submit(toks, deadline_s=deadline_s, on_tokens=on_tokens, **kw)

    @caller_thread
    def _predict_disagg(self, token_lists, kw, deadline_s, expires_at):
        """Decode-role submit loop: prefill at the peer pool, the slab
        over the KV transport, then the all-or-nothing collection (a
        PrefixGone re-requests the full slab once). A multi-prompt
        request runs its transfers concurrently."""
        from concurrent.futures import ThreadPoolExecutor

        if len(token_lists) == 1:
            futures = [self._remote_submit(token_lists[0], kw, deadline_s)]
        else:
            with ThreadPoolExecutor(max_workers=min(8, len(token_lists)),
                                    thread_name_prefix="kv-transfer") as pool:
                submits = [pool.submit(self._remote_submit, toks, kw, deadline_s)
                           for toks in token_lists]
            err = next((sf.exception() for sf in submits if sf.exception()), None)
            if err is not None:
                # all-or-nothing: cancel every sibling whose slab landed
                for sf in submits:
                    if sf.exception() is None:
                        sf.result().cancel()
                raise err
            futures = [sf.result() for sf in submits]
        retry = lambda i: self._remote_submit(token_lists[i], kw, deadline_s, covered=0)  # noqa: E731
        results = self._collect_results(futures, deadline_s, expires_at, retry=retry)
        return futures, results

    # -- live-lane migration (graceful drain, resume tokens) ------------------

    @caller_thread
    def resume_checkpoint(self, ck, on_tokens=None):
        """Admit one generate checkpoint -- an SGC1 dict, a base64 resume
        token or raw SGC1 bytes -- and continue the generation where it
        stopped (the same tokens, spans never re-sent): the receiving end
        of a drain handoff and of a client's crash-resume retry; the
        engine's ``POST /drain`` import lands here per checkpoint."""
        from ..serving.migration import decode_checkpoint, parse_token

        if self.batcher is None:
            self.load()
        if isinstance(ck, str):
            ck = parse_token(ck)
        elif isinstance(ck, (bytes, bytearray)):
            ck = decode_checkpoint(bytes(ck))
        return self.batcher.submit_checkpoint(ck, on_tokens=on_tokens)

    @staticmethod
    def _settle_migrated(req, peer_future) -> None:
        """Done-callback chaining a migrated request's peer future into
        the original future its client waits on."""
        if req.future.done():
            return
        try:
            req.future.set_result(peer_future.result())
        except Exception as e:  # noqa: BLE001 - relay the typed failure
            req.future.set_exception(e)

    @caller_thread
    def drain_to(self, peer, timeout_s: float = 60.0) -> Dict[str, Any]:
        """Graceful drain: checkpoint every in-flight generation at a
        poll boundary (``ContinuousBatcher.drain``: this member turns
        ``"draining"`` and refuses new work with a 503) and hand the
        checkpoints and queued requests to ``peer``:

        * a live server exposing ``resume_checkpoint`` (loopback): each
          peer future settles the original one, and streamed spans keep
          flowing through the original ``on_tokens`` consumer;
        * a ``"host:port"`` string: the peer engine's ``POST /drain`` over
          TCP (``migration.post_drain``); the final token lists come back
          positionally and a stream consumer gets the tail after its
          checkpoint as one span.

        Every request completes as an uninterrupted run would. Returns
        ``{"drained", "checkpoints", "handed", "failed"}``; a failed
        handoff fails its original futures typed."""
        from ..serving import migration

        if self.batcher is None:
            self.load()
        b = self.batcher
        drained = b.drain(timeout_s=timeout_s)
        cks = [migration.checkpoint_of(req, b.weight_version) for req in drained]
        for req in drained:
            # the work leaves this member: a host-tier K/V checkpoint of
            # an earlier preemption would pin tier budget forever
            b._release_tier_ckpt(req)
        with b._export_lock:
            b.stats["checkpoint_exports"] += len(cks)
        for ck in cks:
            b._flight({"type": "checkpoint_export", "tokens": len(ck["prompt"]),
                       "emitted": len(ck["emitted"]), "weight_version": b.weight_version})
        handed = failed = 0
        if hasattr(peer, "resume_checkpoint"):
            for req, ck in zip(drained, cks):
                try:
                    pf = peer.resume_checkpoint(ck, on_tokens=req.on_tokens)
                except Exception as e:  # noqa: BLE001 - a typed refusal
                    failed += 1
                    if not req.future.done():
                        req.future.set_exception(e)
                    continue
                handed += 1
                pf.add_done_callback(lambda f, req=req: self._settle_migrated(req, f))
        elif cks:
            try:
                results = migration.post_drain(str(peer), cks, timeout_s=timeout_s)
            except Exception as e:  # noqa: BLE001 - a typed refusal
                failed = len(drained)
                for req in drained:
                    if not req.future.done():
                        req.future.set_exception(e)
                results = None
            for req, ck, res in zip(drained, cks, results or ()):
                handed += 1
                if req.on_tokens is not None:
                    # spans at or before stream_pos were already delivered
                    tail = list(res)[len(ck["prompt"]) + ck["stream_pos"]:]
                    if tail:
                        try:
                            req.on_tokens(tail)
                        except Exception:  # noqa: BLE001 - a consumer bug
                            logger.exception("on_tokens relay failed")
                if not req.future.done():
                    req.future.set_result(list(res))
        with b._export_lock:
            b.stats["migrations"] += handed
        if handed:
            b._flight({"type": "migrated_resume",
                       "peer": getattr(peer, "model_uri", None) or str(peer),
                       "handed": handed})
        logger.info("drain_to: %d checkpoint(s) exported, %d handed to the peer, %d failed "
                    "typed", len(cks), handed, failed)
        return {"drained": len(drained), "checkpoints": len(cks), "handed": handed,
                "failed": failed}

    def _make_resume_token(self, req, prompt, delivered, kw, text_mode=False) -> str:
        """The opaque resume token of a live generation: the SGC1 payload
        over prompt + delivered so far, keyless (the resume side
        re-derives the lane key from seed and emitted count), so
        refreshing it per span costs no device sync. ``text_mode`` rides
        along so a resumed strData stream keeps its ``text`` fields."""
        from ..serving.migration import checkpoint_token

        gr = getattr(req, "gen_request", None) or req
        now = time.monotonic()
        submit_t = getattr(gr, "submit_t", 0.0)
        deadline_t = getattr(gr, "deadline_t", None)
        return checkpoint_token({
            "v": 1,
            "prompt": [int(t) for t in prompt],
            "emitted": [int(t) for t in delivered],
            "rng_key": None,
            "text_mode": bool(text_mode),
            "max_new_tokens": int(kw.get("max_new_tokens", 32)),
            "temperature": float(kw.get("temperature", 0.0)),
            "eos_id": kw.get("eos_id"),
            "seed": int(kw.get("seed", 0)),
            "weight_version": self.batcher.weight_version,
            "wait_s": round(max(0.0, now - submit_t), 6) if submit_t else 0.0,
            "submit_wall_us": int(getattr(gr, "submit_wall_us", 0) or 0),
            "deadline_s": max(0.0, deadline_t - now) if deadline_t is not None else None,
            "stream_pos": len(delivered),
        })

    # -- live weight swap ----------------------------------------------------

    @caller_thread
    def hot_swap(self, model_uri: str, wait_s: float = 30.0) -> Dict[str, Any]:
        """Live weight swap: load a checkpoint of the same architecture
        and replace the served weights without a restart or a dropped
        request (the engine's ``/weights/swap`` lands here). The params,
        cast to the serving dtype, go to ``request_weight_swap``: in-flight
        lanes finish on the old version, the flip lands at a poll
        boundary and the prefix cache is re-keyed. Waits up to ``wait_s``
        for the flip; one still draining then returns ``swapped: false``
        and lands on its own."""
        if self.batcher is None:
            self.load()
        if self.batcher.swap_pending():
            # fail before the checkpoint load: it is the slow part
            raise RuntimeError("a weight swap is already pending")
        params = self._load_checkpoint(model_uri, "hot-swap")
        self._swap_count += 1
        version = f"v{self._swap_count}"
        fut = self.batcher.request_weight_swap(params, version=version)
        del params
        swapped = True
        try:
            fut.result(timeout=max(0.001, float(wait_s)))
        except FuturesTimeout:
            swapped = False  # still draining; the flip lands on its own
        return {"version": version, "swapped": swapped, "model_uri": model_uri,
                "weight_version": self.batcher.weight_version}

    def cancel_hot_swap(self) -> Dict[str, Any]:
        """Abort a staged swap whose drain does not converge (admissions
        resume on the next poll)."""
        b = self.batcher
        return {"cancelled": b.cancel_weight_swap() if b is not None else False,
                "weight_version": b.weight_version if b is not None else None}

    def close(self) -> None:
        """Stop the tenant scheduler, the KV transport endpoints and the
        scheduler."""
        if self.tenant_scheduler is not None:
            self.tenant_scheduler.stop()
        if self._kv_server is not None:
            self._kv_server.close()
            self._kv_server = None
        if self._kv_client is not None:
            self._kv_client.close()
            self._kv_client = None
        if self.batcher is not None:
            self.batcher.close()

    @caller_thread
    def predict(self, X, names, meta=None):
        if self.batcher is None:
            self.load()
        if self._role == "prefill":
            raise RuntimeError(
                "this unit is a prefill-role pool member: it serves the KV transport "
                "only — route generate requests at the decode pool"
            )
        body = X if isinstance(X, dict) else None
        if body is None:
            if isinstance(X, str):
                body = {"prompt": X}
            else:
                raise ValueError(
                    "generate expects jsonData {prompt_tokens|prompt, ...} or strData"
                )
        # remaining deadline budget rides the request meta (stamped per
        # hop by the graph executor): the batcher sheds the submit when
        # its admit queue cannot meet it (ShedError -> engine 429)
        deadline_s = deadline_s_from_meta(meta)
        expires_at = time.monotonic() + deadline_s if deadline_s is not None else None
        if body.get("resume_token"):
            return self._predict_resume(str(body["resume_token"]), deadline_s, expires_at)
        token_lists, text_mode, kw = self._parse_prompts(body)
        if self._role == "decode":
            # prefill at the peer pool, the slab over the KV transport,
            # decode here
            futures, results = self._predict_disagg(token_lists, kw, deadline_s, expires_at)
            return self._build_response(futures, results, token_lists, text_mode, kw)
        submit, skw = self.batcher.submit, dict(kw)
        if self.tenant_scheduler is not None:
            # the resident tenant's work passes straight through, the
            # others queue for a page-in; the id comes in the body or in
            # the meta (the engine stamps the Seldon-Tenant header there)
            from ..serving.weightpager import tenant_from_meta

            submit = self.tenant_scheduler.submit
            skw["tenant"] = body.get("tenant") or tenant_from_meta(meta)
        futures = []
        try:
            for toks in token_lists:
                futures.append(submit(toks, deadline_s=deadline_s, **skw))
        except Exception:
            # all-or-nothing: a failed prompt cancels its siblings, which
            # frees their queued slots and decode lanes
            for f in futures:
                f.cancel()
            raise
        results = self._collect_results(futures, deadline_s, expires_at)
        return self._build_response(futures, results, token_lists, text_mode, kw)

    def _predict_resume(self, token: str, deadline_s, expires_at):
        """A crash-resume retry: the token's checkpoint continues where
        the dead member stopped (the same tokens, wait telemetry
        cumulative)."""
        from ..serving.migration import parse_token

        ck = parse_token(token)
        fut = self.batcher.submit_checkpoint(ck)
        gr = fut.gen_request
        prompt = list(gr.tokens)
        results = self._collect_results([fut], deadline_s, expires_at)
        out: Dict[str, Any] = {"tokens": results}
        if ck.get("text_mode"):
            out["text"] = [self._decode(results[0][len(prompt):])]
        if self._resume_tokens:
            out["resume_tokens"] = [self._make_resume_token(
                fut, prompt, results[0][len(prompt):],
                {"max_new_tokens": gr.max_new_tokens, "temperature": gr.temperature,
                 "eos_id": gr.eos_id, "seed": gr.seed},
                text_mode=bool(ck.get("text_mode")))]
        return out

    @caller_thread
    def _collect_results(self, futures, deadline_s, expires_at, retry=None):
        """Await every request future under the remaining deadline budget
        (600 s without one). All-or-nothing: any failure or budget
        exhaustion cancels the sibling futures, reclaiming queued slots
        and mid-decode lanes, before the error surfaces. ``retry(i)``
        (the decode role) re-submits request ``i`` once when its
        suffix-only handoff lost its radix donor (``PrefixGone``)."""
        from ..serving.disagg import PrefixGone

        def remaining() -> float:
            if expires_at is None:
                return 600.0
            return max(0.001, expires_at - time.monotonic())

        try:
            results = []
            for i, f in enumerate(futures):
                try:
                    results.append(f.result(timeout=remaining()))
                except PrefixGone:
                    if retry is None:
                        raise
                    futures[i] = retry(i)
                    results.append(futures[i].result(timeout=remaining()))
            return results
        except (FuturesTimeout, CancelledError):
            for f in futures:
                f.cancel()
            if deadline_s is None:
                raise  # the 600 s safety fallback fired, not a budget
            # the batcher cancels a request at its deadline, the wait
            # times out at the same instant: either way the budget is gone
            raise DeadlineExceeded(
                f"generate ran past its {deadline_s * 1000:.0f}ms budget"
            ) from None
        except BaseException:
            for f in futures:
                f.cancel()
            raise

    @caller_thread
    def stream(self, body: Dict[str, Any]) -> StreamHandle:
        """Streaming generate: validates and SUBMITS eagerly (malformed
        bodies and closed batchers raise HERE, before any response bytes
        exist), then returns a :class:`StreamHandle` whose ``chunks``
        iterator yields ``{"tokens": [...]}`` per credited span and a
        final ``{"done": true, "tokens": [prompt+generated]}``.
        ``handle.cancel()`` (client disconnect) releases the decode lane.
        One prompt per stream; batch prompts belong to unary predict."""
        import queue as _queue

        if self.batcher is None:
            self.load()
        if self._role == "prefill":
            raise RuntimeError("prefill-role pool members serve the KV transport only")
        q: "_queue.Queue" = _queue.Queue()
        resume_base: List[int] = []
        if body.get("resume_token"):
            # crash-resume of an interrupted stream: only NEW spans are
            # yielded (crediting resumes after the checkpoint)
            from ..serving.migration import parse_token

            ck = parse_token(str(body["resume_token"]))
            text_mode = bool(ck.get("text_mode"))
            toks = [int(t) for t in ck["prompt"]]
            kw = dict(max_new_tokens=int(ck.get("max_new_tokens", 32)),
                      temperature=float(ck.get("temperature", 0.0)),
                      eos_id=ck.get("eos_id"), seed=int(ck.get("seed", 0)))
            resume_base = [int(t) for t in ck.get("emitted") or []]
            fut = self.batcher.submit_checkpoint(ck, on_tokens=q.put)
        else:
            token_lists, text_mode, kw = self._parse_prompts(body)
            if len(token_lists) != 1:
                raise ValueError("stream takes ONE prompt")
            toks = token_lists[0]
            if self._role == "decode":
                # the handoff happens before the first byte goes out,
                # always with the FULL slab: a PrefixGone retry cannot be
                # replayed once response bytes exist
                fut = self._remote_submit(toks, kw, None, covered=0, on_tokens=q.put)
            elif self.tenant_scheduler is not None:
                from ..serving.weightpager import tenant_from_meta

                fut = self.tenant_scheduler.submit(
                    toks, tenant=body.get("tenant") or tenant_from_meta(body.get("meta")),
                    on_tokens=q.put, **kw)
            else:
                fut = self.batcher.submit(toks, on_tokens=q.put, **kw)
        fut.add_done_callback(lambda _f: q.put(None))

        def chunks():
            # delivered so far: each span's resume token is the checkpoint
            # over prompt + delivered
            delivered = list(resume_base)
            while True:
                item = q.get()
                if item is None:
                    break
                delivered.extend(int(t) for t in item)
                chunk: Dict[str, Any] = {"tokens": item}
                if text_mode:
                    chunk["text"] = self._decode(item)
                if self._resume_tokens:
                    chunk["resume_token"] = self._make_resume_token(
                        fut, toks, delivered, kw, text_mode=text_mode)
                yield chunk
            result = fut.result(timeout=600.0)
            final: Dict[str, Any] = {"done": True, "tokens": result}
            if text_mode:
                final["text"] = self._decode(result[len(toks):])
            if self.batcher._prefix_index is not None:
                final["cache_hit_tokens"] = fut.gen_request.cache_hit_tokens
            yield final

        return StreamHandle(chunks=chunks(), cancel=fut.cancel, prompt_len=len(toks))

    def _build_response(self, futures, results, token_lists, text_mode, kw):
        out: Dict[str, Any] = {"tokens": results}
        if text_mode:
            out["text"] = [
                self._decode(r[len(p):]) for r, p in zip(results, token_lists)
            ]
        if self._resume_tokens:
            out["resume_tokens"] = [
                self._make_resume_token(f, p, r[len(p):], kw, text_mode=text_mode)
                for f, r, p in zip(futures, results, token_lists)
            ]
        if self.batcher._prefix_index is not None:
            # prompt tokens each request took from the prefix cache
            out["cache_hit_tokens"] = [f.gen_request.cache_hit_tokens for f in futures]
        return out

    def retune(self, knobs: Dict[str, Any], origin: str = "planner",
               wait_s: float = 10.0) -> Dict[str, Any]:
        """A live scheduler retune (the engine's ``POST /retune`` lands
        here): staged through ``ContinuousBatcher.retune`` (validated
        against the boot census on this thread), then waited for until
        the scheduler applies it at a poll boundary. Returns ``{"changed":
        {knob: [old, new]}, "census": {...}, "origin": ...}``;
        ``RetuneError`` propagates (the route answers 409)."""
        from ..serving.continuous import RetuneError

        if self.batcher is None:
            raise RuntimeError("retune before load(): no batcher")
        if not isinstance(knobs, dict):
            raise RetuneError(f"knobs must be an object, got {type(knobs).__name__}")
        fut = self.batcher.retune(origin=str(origin), **knobs)
        changed = fut.result(timeout=wait_s)
        return {"changed": changed, "census": self.batcher.retune_census(),
                "origin": str(origin)}

    def retune_census(self) -> Optional[Dict[str, Any]]:
        """The loaded batcher's boot census (None before load)."""
        return self.batcher.retune_census() if self.batcher is not None else None

    def serving_config(self) -> Optional[Dict[str, Any]]:
        """The batcher's current profile-axis knob values (None before
        load); ``/fleet`` ships it beside the census."""
        return self.batcher.serving_config() if self.batcher is not None else None

    def flight_dump(self, limit: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The ``/flightrecorder`` payload: the recorder's ring plus the
        SLO reservoir summary, a stats snapshot and, where on, the
        pressure ledger, the host tier, the tenants, the device-time
        ledger and the SLO burn verdicts. None when the recorder is off or
        the server is not loaded."""
        b = self.batcher
        if b is None or b.flight is None:
            return None
        if b._kv_tier is not None:
            b.sync_kv_tier_stats()
        out = b.flight.dump(limit)
        out["slo"] = b.slo_summary()
        out["stats"] = dict(b.stats)
        out["weight_version"] = b.weight_version
        pressure = b.pressure_summary()
        if pressure is not None:
            out["pressure"] = pressure
        tier = b.kv_tier_summary()
        if tier is not None:
            out["kv_tier"] = tier
        if self.tenant_pager is not None:
            out["weight_pager"] = self.tenant_pager.summary()
        if self.tenant_scheduler is not None:
            out["tenant_scheduler"] = self.tenant_scheduler.summary()
        if self.profiler is not None and self.profiler.enabled:
            out["profiler"] = self.profiler.summary()
        if self.slo_burn is not None:
            out["slo_burn"] = self.slo_burn.summary()
        return out

    def tags(self) -> Dict:
        tags = {"server": "generateserver"}
        if self.batcher is not None:
            # the served weights' version rides every response's meta
            tags["weight_version"] = str(self.batcher.weight_version)
        return tags

    def health_status(self):
        """A batcher mid-restart or latched dead makes the unit unready."""
        b = self.batcher
        if b is not None and b.health != "serving":
            raise RuntimeError(f"continuous batcher is {b.health}")
        return "ok"

    def metrics(self) -> List[Dict]:
        """Cumulative scheduler totals ship as COUNTER deltas, completed
        requests' queue wait / TTFT / first-token hold / TPOT as TIMER
        samples (ms)."""
        if self.batcher is None:
            return []
        s = self.batcher.stats
        delta = self._deltas.counter
        out = [
            delta("gen_tokens", s["tokens"]),
            delta("gen_steps", s["steps"]),
            delta("gen_finished", s["finished"]),
            delta("gen_admitted", s["admitted"]),
            delta("gen_prefill_steps", s["prefill_steps"]),
            delta("gen_prefill_tokens", s["prefill_tokens"]),
            delta("gen_decode_steps", s["steps"]),
            # modelled device reads of the dispatched decode (sub)bursts:
            # depth groups show as read bytes per token dropping
            delta("gen_burst_reads", s["burst_reads"]),
            delta("gen_burst_read_bytes", s["burst_read_bytes"]),
            {"type": "GAUGE", "key": "gen_batcher_healthy",
             "value": 1.0 if self.batcher.health == "serving" else 0.0},
        ]
        mesh = self.batcher.mesh
        if mesh is not None:
            # sharded serving: the mesh and one position's footprint (the
            # engine's seldon_engine_mesh_* gauges); param_shard_bytes
            # against the global param bytes is the headroom a mesh buys
            out.extend([
                {"type": "GAUGE", "key": "gen_mesh_devices", "value": float(mesh.size)},
                {"type": "GAUGE", "key": "gen_mesh_data",
                 "value": float(mesh.shape.get("data", 1))},
                {"type": "GAUGE", "key": "gen_mesh_model",
                 "value": float(mesh.shape.get("model", 1))},
                {"type": "GAUGE", "key": "gen_mesh_param_shard_bytes",
                 "value": float(self.batcher._param_shard_bytes)},
                {"type": "GAUGE", "key": "gen_mesh_kv_shard",
                 "value": float(self.batcher._kv_shard)},
            ])
        if s.get("prefill_chunks"):
            out.append(delta("gen_prefill_chunks", s["prefill_chunks"]))
        if s.get("fused_dispatches"):
            # their ratio is the realized fused burst length K
            out.extend([
                delta("gen_fused_steps", s["fused_steps"]),
                delta("gen_fused_dispatches", s["fused_dispatches"]),
            ])
        if s.get("group_bursts"):
            out.extend([
                delta("gen_group_bursts", s["group_bursts"]),
                delta("gen_group_lanes", s["group_lanes"]),
                {"type": "GAUGE", "key": "gen_group_occupancy",
                 # real lanes over gathered rows: the pow2 pad overhead
                 "value": round(s["group_lanes"] / max(
                     1, s["group_lanes"] + s["group_pad_lanes"]), 4)},
            ])
        if s.get("shed"):
            out.append(delta("gen_shed_total", s["shed"]))
        if s.get("planner_retunes"):
            # retunes applied at a poll boundary (the engine exports
            # seldon_engine_planner_retunes)
            out.append(delta("gen_planner_retunes", s["planner_retunes"]))
        # live migration and swap: drains, checkpoints exported and
        # handed over, resumes from wire checkpoints or resume tokens,
        # swap straggler preemptions, swaps flipped (the engine exports
        # seldon_engine_drains_total and friends)
        for stat, key in (("weight_swaps", "gen_weight_swaps"), ("drains", "gen_drains"),
                          ("checkpoint_exports", "gen_checkpoint_exports"),
                          ("migrations", "gen_migrations"),
                          ("migrated_resumes", "gen_migrated_resumes"),
                          ("swap_preemptions", "gen_swap_preemptions")):
            if s.get(stat):
                out.append(delta(key, s[stat]))
        if s.get("batcher_restarts"):
            out.append(delta("gen_batcher_restarts", s["batcher_restarts"]))
        # HBM pressure: preemptions, resumes, sheds and the ladder's prefix
        # evictions, plus the ledger's gauges (the engine exports them as
        # seldon_engine_preemptions and friends)
        for stat, key in (("preemptions", "gen_preemptions"),
                          ("preempt_resumes", "gen_preempt_resumes"),
                          ("pressure_sheds", "gen_pressure_sheds"),
                          ("pressure_prefix_evictions", "gen_pressure_prefix_evictions")):
            if s.get(stat):
                out.append(delta(key, s[stat]))
        pressure = self.batcher.pressure_summary()
        if pressure is not None:
            out.extend([
                {"type": "GAUGE", "key": "gen_pressure_used_bytes",
                 "value": float(pressure["used_bytes"])},
                {"type": "GAUGE", "key": "gen_pressure_budget_bytes",
                 "value": float(pressure["budget_bytes"])},
                {"type": "GAUGE", "key": "gen_pressure_active",
                 "value": 1.0 if pressure["active"] else 0.0},
            ])
        if self.batcher._prefix_index is not None:
            out.extend([
                delta("prefix_cache_hits", s["prefix_hits"]),
                delta("prefix_cache_misses", s["prefix_misses"]),
                delta("prefix_cache_evictions", s["prefix_evicted"]),
                delta("prefix_tokens_saved", s["prefix_tokens_saved"]),
                {"type": "GAUGE", "key": "prefix_cache_bytes",
                 "value": float(s["prefix_cache_bytes"])},
            ])
        for stat, key in (("pressure_refused", "gen_pressure_refused"),
                          ("peer_ejections", "gen_peer_ejections"),
                          ("peer_readmissions", "gen_peer_readmissions"),
                          ("degraded_local_prefill", "gen_degraded_local_prefill")):
            if s.get(stat):
                out.append(delta(key, s[stat]))
        if s.get("kv_exports") or s.get("kv_imports"):
            # the engine exports them as seldon_engine_kv_transfer_*
            # {direction} and the dedup savings counter
            out.extend([
                delta("gen_kv_export_slabs", s["kv_exports"]),
                delta("gen_kv_export_bytes", s["kv_export_bytes"]),
                delta("gen_kv_import_slabs", s["kv_imports"]),
                delta("gen_kv_import_bytes", s["kv_import_bytes"]),
                delta("gen_kv_transfer_bytes_saved", s["kv_transfer_bytes_saved"]),
            ])
        if self.batcher._kv_tier is not None:
            # host RAM, not one of the device-pressure gauges
            self.batcher.sync_kv_tier_stats()
            out.extend([
                delta("gen_kv_tier_demotions", s["kv_tier_demotions"]),
                delta("gen_kv_tier_promotions", s["kv_tier_promotions"]),
                delta("gen_kv_tier_hits", s["kv_tier_hits"]),
                delta("gen_kv_tier_evictions", s["kv_tier_evictions"]),
                delta("gen_kv_tier_replay_fallbacks", s["kv_tier_replay_fallbacks"]),
                {"type": "GAUGE", "key": "gen_kv_tier_bytes",
                 "value": float(s["kv_tier_bytes"])},
            ])
        if s.get("spec_rounds"):
            # 1.0 = no draft accepted, gamma + 1 = every draft accepted
            out.append({"type": "GAUGE", "key": "gen_spec_tokens_per_round",
                        "value": round(s["spec_emitted"] / s["spec_rounds"], 4)})
        if self.tenant_pager is not None:
            out.extend(self._tenant_metrics())
        pending = self.batcher.slo_pending
        while pending:
            try:
                queue_wait, ttft, tpot, hold = pending.popleft()
            except IndexError:  # raced another exporter thread
                break
            out.append({"type": "TIMER", "key": "gen_queue_wait_ms",
                        "value": round(queue_wait * 1e3, 4)})
            out.append({"type": "TIMER", "key": "gen_ttft_ms",
                        "value": round(ttft * 1e3, 4)})
            # the part of TTFT from the prefill's enqueue to the host's
            # first read of its token
            out.append({"type": "TIMER", "key": "gen_first_token_hold_ms",
                        "value": round(hold * 1e3, 4)})
            if tpot is not None:
                out.append({"type": "TIMER", "key": "gen_tpot_ms",
                            "value": round(tpot * 1e3, 4)})
            if self.slo_burn is not None:
                # the burn engine rides the same drain: one sample feed,
                # two consumers (histograms and error budgets)
                self.slo_burn.observe("queue_wait", queue_wait)
                self.slo_burn.observe("ttft", ttft)
                self.slo_burn.observe("tpot", tpot)
        out.extend(self._telemetry_metrics())
        return out

    def _telemetry_metrics(self) -> List[Dict]:
        """The device-time ledger's cumulative buckets as COUNTER deltas
        (``gen_device_time_ms``/``_dispatches``/``_bytes`` with kind,
        variant and tenant tags) and its live gauges, then the burn
        engine's per-(tenant, slo) burn rates, remaining budget and
        verdict counts."""
        delta = self._deltas.counter
        out: List[Dict] = []
        if self.profiler is not None and self.profiler.enabled:
            for (kind, variant, tenant), (secs, n, nbytes, _toks) in sorted(
                    self.profiler.buckets().items()):
                tags = {"kind": kind, "variant": variant}
                if tenant:
                    tags["tenant"] = tenant
                out.append(delta("gen_device_time_ms", round(secs * 1e3, 3), tags=tags))
                out.append(delta("gen_device_dispatches", n, tags=tags))
                out.append(delta("gen_device_bytes", nbytes, tags=tags))
            live = self.profiler.gauges()
            for key, name in (("device_busy_frac", "gen_device_busy_frac"),
                              ("mbu_pct", "gen_mbu_pct"),
                              ("dispatch_floor_pct", "gen_dispatch_floor_pct")):
                if live.get(key) is not None:
                    out.append({"type": "GAUGE", "key": name, "value": float(live[key])})
        if self.slo_burn is not None:
            for v in self.slo_burn.verdicts():
                tags = {"slo": v["slo"], "window": "fast"}
                if v["tenant"]:
                    tags["tenant"] = v["tenant"]
                out.append({"type": "GAUGE", "key": "gen_slo_burn_rate",
                            "value": v["fast_burn"], "tags": dict(tags)})
                tags["window"] = "slow"
                out.append({"type": "GAUGE", "key": "gen_slo_burn_rate",
                            "value": v["slow_burn"], "tags": dict(tags)})
                del tags["window"]
                out.append({"type": "GAUGE", "key": "gen_slo_budget_remaining",
                            "value": v["budget_remaining"], "tags": dict(tags)})
            for (t, slo, sev), n in sorted(self.slo_burn.verdict_counts().items()):
                tags = {"slo": slo, "severity": sev}
                if t:
                    tags["tenant"] = t
                out.append(delta("gen_slo_verdicts", n, tags=tags))
        return out

    def _tenant_metrics(self) -> List[Dict]:
        """The pager's counters and levels, and per-tenant request
        counters and SLO TIMERs tagged with the tenant (the engine
        exports seldon_engine_tenant_* and seldon_engine_weight_pager_*,
        the tag as a label)."""
        delta = self._deltas.counter
        pager = self.tenant_pager
        p = pager.stats
        out = [
            delta("gen_weight_page_ins", p["page_ins"]),
            delta("gen_weight_page_outs", p["page_outs"]),
            delta("gen_weight_pager_evictions", p["evictions"]),
            delta("gen_weight_pager_refused", p["refused"]),
            {"type": "GAUGE", "key": "gen_weight_pager_host_bytes",
             "value": float(pager.host_bytes)},
            {"type": "GAUGE", "key": "gen_weight_pager_resident_bytes",
             "value": float(pager.resident_hbm_bytes)},
            {"type": "GAUGE", "key": "gen_tenants_registered",
             "value": float(len(pager.tenants()))},
        ]
        if self.tenant_scheduler is not None:
            out.append(delta("gen_tenant_switches", self.tenant_scheduler.stats["switches"]))
        b = self.batcher
        for t, sums in list(b.tenant_slo.items()):
            out.append(delta("gen_tenant_requests", sums["finished"], tags={"tenant": t}))
        for t, pending in list(b.tenant_slo_pending.items()):
            tags = {"tenant": t}
            while pending:
                try:
                    queue_wait, ttft, tpot, _hold = pending.popleft()
                except IndexError:  # raced another exporter thread
                    break
                out.append({"type": "TIMER", "key": "gen_tenant_queue_wait_ms",
                            "value": round(queue_wait * 1e3, 4), "tags": tags})
                out.append({"type": "TIMER", "key": "gen_tenant_ttft_ms",
                            "value": round(ttft * 1e3, 4), "tags": tags})
                if self.slo_burn is not None:
                    self.slo_burn.observe("queue_wait", queue_wait, t)
                    self.slo_burn.observe("ttft", ttft, t)
                    self.slo_burn.observe("tpot", tpot, t)
                if tpot is not None:
                    out.append({"type": "TIMER", "key": "gen_tenant_tpot_ms",
                                "value": round(tpot * 1e3, 4), "tags": tags})
        return out
