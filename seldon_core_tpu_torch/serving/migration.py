"""Live-lane migration: the SGC1 generate-checkpoint codec + transports.

The port's own copy of ``seldon_core_tpu/serving/migration.py`` (it
imports nothing of the JAX package). A decode lane's whole resumable
state is a few hundred host-side bytes -- the emitted tokens, the
post-split RNG lane key and the sampling params; the K/V rebuilds
through recompute plus teacher-forced replay
(``ContinuousBatcher._admit_resume``). This module makes that checkpoint
a wire-portable object:

* **graceful drain** -- ``ContinuousBatcher.drain()`` checkpoints every
  live lane at a poll boundary and ``GenerateServer.drain_to`` hands the
  checkpoints (plus queued requests) to a peer, which resumes them;
* **crash survival** -- streams (and unary responses) optionally carry
  an opaque **resume token** (the SGC1 payload, base64) refreshed per
  emitted span; after a member death the token resumes the generation on
  any peer serving the same ``weight_version``, with already-delivered
  spans never re-sent.

Wire format (version ``SGC1``, sibling of SKV1)::

    b"SGC1" | u32 payload_len | u32 crc32(payload) | payload JSON

The frames are byte-identical to the JAX package's: a checkpoint from
one package resumes in the other. Corruption raises
:class:`~.disagg.ChecksumError`, a short buffer
:class:`~.disagg.TruncatedStream`, and a checkpoint taken under another
weight version is refused with :class:`~.disagg.WeightVersionMismatch`,
all before any lane state exists.

Checkpoint fields: prompt tokens, emitted tokens, RNG lane key (exact
when exported by a drain; ``None`` in crash tokens, where the resume
side re-derives it from ``seed`` + emitted count, see
:func:`derive_lane_key`), sampling params, ``weight_version``, the
remaining deadline budget, the cumulative queue-wait anchor
(``wait_s``/``submit_wall_us``) and the stream credit position (spans at
or before it are never re-sent).

Transports: loopback hands the checkpoint dict to a live peer object
(``resume_checkpoint``), TCP ships base64 SGC1 frames to a peer engine's
``POST /drain`` route (``graph/service.py``), the peer's typed refusals
surviving the wire as their HTTP statuses.
"""

from __future__ import annotations

import base64
import json
import struct
import time
import zlib
from typing import Any, Dict, List

from .. import rng
from .disagg import ChecksumError, DisaggError, TruncatedStream, WeightVersionMismatch

MAGIC = b"SGC1"
CHECKPOINT_VERSION = 1


class MigrationError(DisaggError):
    """Base for migration failures; carries the 502 wire status."""


class ResumeTokenError(MigrationError):
    """A client-supplied resume token failed to parse (bad base64,
    corrupt frame, wrong magic/version). Client input: a **400**, not a
    retryable 502 (the same broken token can never succeed)."""

    status = 400


def checkpoint_of(req, weight_version) -> Dict[str, Any]:
    """The wire checkpoint of one drained :class:`~.continuous.GenRequest`.
    Its ``resume`` dict (set by the scheduler's checkpoint at a poll
    boundary) carries the emitted tokens and post-split lane key; a
    request drained while still queued checkpoints with no emitted
    tokens -- a plain re-admit on the peer gives the same stream."""
    now = time.monotonic()
    resume = req.resume or {}
    emitted = [int(t) for t in resume.get("emitted") or []]
    key = resume.get("key")
    return {
        "v": CHECKPOINT_VERSION,
        "prompt": [int(t) for t in req.tokens],
        "emitted": emitted,
        "rng_key": [int(k) for k in key] if key is not None else None,
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": float(req.temperature),
        "eos_id": req.eos_id,
        "seed": int(req.seed),
        "weight_version": weight_version,
        # the peer re-bases submit_t so the queue-wait sample covers both
        # members
        "wait_s": round(max(0.0, now - req.submit_t), 6) if req.submit_t else 0.0,
        "submit_wall_us": int(req.submit_wall_us or 0),
        "deadline_s": (
            max(0.0, req.deadline_t - now) if req.deadline_t is not None else None
        ),
        # spans up to here were delivered and are never re-sent
        "stream_pos": len(emitted),
    }


def encode_checkpoint(ck: Dict[str, Any]) -> bytes:
    """One SGC1 frame: magic | length | CRC | JSON payload."""
    payload = json.dumps(ck, separators=(",", ":")).encode()
    return MAGIC + struct.pack("<II", len(payload), zlib.crc32(payload)) + payload


def decode_checkpoint(data: bytes) -> Dict[str, Any]:
    """Decode and validate one SGC1 frame: bad magic or version raise
    :class:`MigrationError`, a short buffer
    :class:`~.disagg.TruncatedStream`, a CRC mismatch
    :class:`~.disagg.ChecksumError`."""
    if len(data) < 12:
        raise TruncatedStream(f"checkpoint frame is {len(data)} bytes, need >= 12")
    if data[:4] != MAGIC:
        raise MigrationError(f"bad checkpoint magic {data[:4]!r} (want {MAGIC!r})")
    n, crc = struct.unpack("<II", data[4:12])
    payload = data[12:12 + n]
    if len(payload) < n:
        raise TruncatedStream(f"checkpoint payload is {len(payload)} of {n} bytes")
    if zlib.crc32(payload) != crc:
        raise ChecksumError("checkpoint frame failed its checksum")
    ck = json.loads(payload)
    if ck.get("v") != CHECKPOINT_VERSION:
        raise MigrationError(f"unsupported checkpoint version {ck.get('v')!r}")
    if not ck.get("prompt"):
        raise MigrationError("checkpoint carries no prompt tokens")
    return ck


def checkpoint_token(ck: Dict[str, Any]) -> str:
    """Opaque resume token: the SGC1 frame, base64url (CRC-protected: a
    client-side bit flip is refused typed instead of resuming wrong)."""
    return base64.urlsafe_b64encode(encode_checkpoint(ck)).decode()


def parse_token(token: str) -> Dict[str, Any]:
    """Parse a client resume token. Any parse failure -- bad base64, a
    flipped bit, truncation, wrong magic or version -- re-raises as
    :class:`ResumeTokenError` (400)."""
    try:
        raw = base64.urlsafe_b64decode(token.encode())
        return decode_checkpoint(raw)
    except ResumeTokenError:
        raise
    except DisaggError as e:
        raise ResumeTokenError(f"bad resume token: {e}") from e
    except Exception as e:  # noqa: BLE001 - malformed client input
        raise ResumeTokenError(f"resume token is not base64: {e}") from e


def derive_lane_key(seed: int, emitted: int) -> List[int]:
    """The post-split RNG lane key of a lane that has emitted ``emitted``
    tokens, from the request seed alone.

    The scheduler's key chain is deterministic: every admission path
    (whole-prompt, batched, prefix splice, chunked) samples the first
    token with ``key0 = split(PRNGKey(seed))[0]``, and every decode step
    advances ``key_{i+1} = split(key_i)[0]`` -- after N emitted tokens
    the lane key has been split N times in all (at least once). Crash
    tokens ship without a key (reading it per span would cost a device
    sync per span) and the resume side rebuilds it here, on the host.
    Not valid under speculative decoding (its rounds consume other
    splits); the server refuses ``resume_tokens`` with a draft."""
    key = rng.prng_key(int(seed))
    for _ in range(max(1, int(emitted))):
        key = rng.split(key)[0]
    return [int(k) for k in key.tolist()]


def post_drain(addr: str, checkpoints: List[Dict[str, Any]],
               timeout_s: float = 60.0) -> List[Any]:
    """TCP half of the drain handoff: POST the SGC1 frames (base64) to a
    peer engine's ``/drain`` route and return the final token lists,
    positionally. The peer's refusals come back as HTTP statuses and are
    re-raised typed (409 -> WeightVersionMismatch, else MigrationError)."""
    import http.client

    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"drain peer must be host:port, got {addr!r}")
    body = json.dumps({"checkpoints": [checkpoint_token(ck) for ck in checkpoints]}).encode()
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        conn.request("POST", "/drain", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status == 409:
            raise WeightVersionMismatch(
                f"drain peer {addr} refused the checkpoints: {payload[:200]!r}")
        if resp.status != 200:
            raise MigrationError(f"drain peer {addr} answered {resp.status}: {payload[:200]!r}")
        results = json.loads(payload).get("results")
        if not isinstance(results, list) or len(results) != len(checkpoints):
            raise MigrationError(
                f"drain peer {addr} returned {len(results or [])} results for "
                f"{len(checkpoints)} checkpoints")
        return results
    except OSError as e:
        raise MigrationError(f"drain handoff to {addr} failed: {e}") from e
    finally:
        conn.close()
