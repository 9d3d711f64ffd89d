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

The JAX server's other parameters (disaggregated roles, the host KV
tier, resume tokens, swap, tenants, the profiler, SLO burn, the flight
recorder, meshes) are not ported yet: each raises when set to
anything but its off value, as does a request's ``resume_token`` or
``tenant``. The fault config's ``pressure`` section (``SELDON_FAULTS``)
drives the ledger's budget mid-run.

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
     "max_new_tokens": 32, "temperature": 0.0, "eos_id": null, "seed": 0}

``prompt_tokens`` may be a list of lists: each prompt is submitted
separately and rides the same in-flight decode batch.

Response (jsonData): ``{"tokens": [[...]], "text": [...],
"cache_hit_tokens": [...]}`` (``text`` only for byte-level string
prompts, ``cache_hit_tokens`` only with the prefix cache on).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from ..device import resolve_device
from ..metrics import CounterDeltas
from ..resilience import DeadlineExceeded, FaultInjector, deadline_s_from_meta
from ..user_model import SeldonComponent
from .torchserver import TorchServer

logger = logging.getLogger(__name__)

# parameters of the JAX GenerateServer whose feature is not ported yet,
# with their off value (other JAX-server parameters, which only act
# through one of these features, are accepted and ignored, as the JAX
# server accepts unknown ones)
_NOT_PORTED = {
    "mesh": None, "mesh_shape": None, "shard_cache_seq": False,
    "flight_recorder": 0, "role": "unified", "peer": None, "kv_port": 0,
    "host_kv_tier_bytes": 0, "resume_tokens": 0,
    "swap_drain_ms": 0, "tenants": None, "weight_pager_host_bytes": 0,
    "profiler": 0, "slo_objectives": None,
}
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


class GenerateServer(SeldonComponent):
    batcher = None

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
        **kwargs,
    ):
        for name, value in kwargs.items():
            if name in _NOT_PORTED and not _is_off(name, value, _NOT_PORTED[name]):
                raise NotImplementedError(
                    f"GenerateServer parameter {name}={value!r} is not ported to "
                    "seldon_core_tpu_torch yet (only its off value "
                    f"{_NOT_PORTED[name]!r} is supported)"
                )
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

        server = TorchServer(self.model_uri, device=self.device)
        _apply, params = server.build()
        self._model = server._model
        if self._model is None or not hasattr(self._model, "decode_step_ragged_list"):
            raise RuntimeError(
                f"model family {getattr(self._model, '__class__', None)} "
                "does not support generate(); use family 'llm'"
            )
        dt = self._model.dtype
        if dt != torch.float32:
            params = self._cast_params_freeing(params, dt)
        draft_model, draft_params = self._build_draft(params)
        self.batcher = ContinuousBatcher(
            self._model,
            params,
            slots=self._slots,
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
        )
        # chaos harness (off without SELDON_FAULTS): the scheduler section
        # wires induced poll death onto the batcher's fault hook, the
        # pressure section a mid-run ledger re-budget (before warm(), so
        # that it captures the resume's replay step)
        faults = FaultInjector.from_env()
        if faults is not None:
            self.batcher.fault_hook = faults.scheduler_hook()
            self.batcher.pressure_hook = faults.pressure_hook()
        if self._warmup_prompt_lens:
            # warm before listen: the first admission wave must not pay
            # the kernel build, the libraries' first-call setup or the
            # capture of the decode-burst CUDA graphs
            self.batcher.warm(
                prompt_lens=self._warmup_prompt_lens,
                max_new_tokens=self._warmup_max_new_tokens,
            )
        self.batcher.start()
        logger.info(
            "generateserver: %s ready on %s (slots=%d, max_seq=%d)",
            self.model_uri, self.device, self._slots, self.batcher.max_seq,
        )

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

    def _encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def _decode(self, tokens: Iterable[int]) -> str:
        return bytes(t for t in tokens if 0 <= t < 256).decode("utf-8", "replace")

    def _parse_prompts(self, body: Dict[str, Any]):
        """Wire-schema parser: returns (token_lists, text_mode, sampling
        kwargs)."""
        for key in ("resume_token", "tenant"):
            if body.get(key):
                err = NotImplementedError(
                    f"generate request field {key!r} is not ported to "
                    "seldon_core_tpu_torch yet"
                )
                err.status = 501  # the engine answers 501, not 500
                raise err
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

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()

    def predict(self, X, names, meta=None):
        if self.batcher is None:
            self.load()
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
        token_lists, text_mode, kw = self._parse_prompts(body)
        futures = []
        try:
            for toks in token_lists:
                futures.append(self.batcher.submit(toks, deadline_s=deadline_s, **kw))
        except Exception:
            # all-or-nothing: a failed prompt cancels its siblings, which
            # frees their queued slots and decode lanes
            for f in futures:
                f.cancel()
            raise
        results = self._collect_results(futures, deadline_s, expires_at)
        return self._build_response(futures, results, token_lists, text_mode)

    @staticmethod
    def _collect_results(futures, deadline_s, expires_at):
        """Await every request future under the remaining deadline budget
        (600 s without one). All-or-nothing: any failure or budget
        exhaustion cancels the sibling futures, reclaiming queued slots
        and mid-decode lanes, before the error surfaces."""

        def remaining() -> float:
            if expires_at is None:
                return 600.0
            return max(0.001, expires_at - time.monotonic())

        try:
            return [f.result(timeout=remaining()) for f in futures]
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
        token_lists, text_mode, kw = self._parse_prompts(body)
        if len(token_lists) != 1:
            raise ValueError("stream takes ONE prompt")
        toks = token_lists[0]
        q: "_queue.Queue" = _queue.Queue()
        fut = self.batcher.submit(toks, on_tokens=q.put, **kw)
        fut.add_done_callback(lambda _f: q.put(None))

        def chunks():
            while True:
                item = q.get()
                if item is None:
                    break
                chunk: Dict[str, Any] = {"tokens": item}
                if text_mode:
                    chunk["text"] = self._decode(item)
                yield chunk
            result = fut.result(timeout=600.0)
            final: Dict[str, Any] = {"done": True, "tokens": result}
            if text_mode:
                final["text"] = self._decode(result[len(toks):])
            if self.batcher._prefix_index is not None:
                final["cache_hit_tokens"] = fut.gen_request.cache_hit_tokens
            yield final

        return StreamHandle(chunks=chunks(), cancel=fut.cancel)

    def _build_response(self, futures, results, token_lists, text_mode):
        out: Dict[str, Any] = {"tokens": results}
        if text_mode:
            out["text"] = [
                self._decode(r[len(p):]) for r, p in zip(results, token_lists)
            ]
        if self.batcher._prefix_index is not None:
            # prompt tokens each request took from the prefix cache
            out["cache_hit_tokens"] = [f.gen_request.cache_hit_tokens for f in futures]
        return out

    def tags(self) -> Dict:
        return {"server": "generateserver"}

    def health_status(self):
        """A batcher mid-restart or latched dead makes the unit unready."""
        b = self.batcher
        if b is not None and b.health != "serving":
            raise RuntimeError(f"continuous batcher is {b.health}")
        return "ok"

    def metrics(self) -> List[Dict]:
        """Cumulative scheduler totals ship as COUNTER deltas, completed
        requests' queue wait / TTFT / TPOT as TIMER samples (ms)."""
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
        if s.get("spec_rounds"):
            # 1.0 = no draft accepted, gamma + 1 = every draft accepted
            out.append({"type": "GAUGE", "key": "gen_spec_tokens_per_round",
                        "value": round(s["spec_emitted"] / s["spec_rounds"], 4)})
        pending = self.batcher.slo_pending
        while pending:
            try:
                queue_wait, ttft, tpot = pending.popleft()
            except IndexError:  # raced another exporter thread
                break
            out.append({"type": "TIMER", "key": "gen_queue_wait_ms",
                        "value": round(queue_wait * 1e3, 4)})
            out.append({"type": "TIMER", "key": "gen_ttft_ms",
                        "value": round(ttft * 1e3, 4)})
            if tpot is not None:
                out.append({"type": "TIMER", "key": "gen_tpot_ms",
                            "value": round(tpot * 1e3, 4)})
        return out
